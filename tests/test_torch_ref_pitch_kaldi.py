"""Counterpart of ``tests/processor/test_pitch_kaldi.py``: the port's
Kaldi pitch and its post-processing on the CPU, on the conftest's
signal, against ``tests/pitch_oracle.py`` with the JAX cases' bounds
(every lag equal to the float64 oracle's or a proven tie, pitch 1e-3
relative, post-processing max-abs 1e-3, the single and the batched
post-processing bit-equal).

``test_post_collection_equals_single`` failed on the port by one ulp of
the pov feature until its single route padded as the batched one does
(ROADMAP C8).

The chunked cases run in ``tests/test_torch_chunked.py`` on the same
30 s and 12 s signals (``_long_audio``), chunk and halo sizes, and
bounds: ``test_chunked_equals_whole`` as
``test_pitch_chunked_equals_whole``, ``test_chunked_auto_routing`` as
``test_pitch_auto_routing``, ``test_chunked_equals_whole_options`` as
``test_pitch_chunked_equals_whole_options``, and
``test_chunked_resample_exact`` as ``test_resample_chunked`` (its JAX
side is the jitted ``_linear_resample_jit``, the port's the eager
whole-signal resample). ``test_chunked_validation`` runs here.
"""

import numpy as np
import pytest

from shennong_tpu_torch import FeaturesCollection
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.processor.pitch_kaldi import (
    KaldiPitchPostProcessor, KaldiPitchProcessor)

from tests import pitch_oracle
from tests.processor.test_pitch_kaldi import _long_audio
from tests.torch_ref import audio, mfcc  # noqa: F401 (fixtures)


@pytest.fixture(scope='module')
def raw_pitch(audio):
    return KaldiPitchProcessor().process(audio, device='cpu')


def test_shape_anchor(audio, raw_pitch):
    assert raw_pitch.shape == (140, 2)
    assert raw_pitch.times.shape == (140, 2)


def test_pitch_in_range(raw_pitch):
    proc = KaldiPitchProcessor()
    assert np.all(raw_pitch.data[:, 1] >= proc.min_f0)
    assert np.all(raw_pitch.data[:, 1] <= proc.max_f0)
    assert np.all(raw_pitch.data[:, 0] >= -1.01)
    assert np.all(raw_pitch.data[:, 0] <= 1.01)


def test_tracks_f0(audio, raw_pitch):
    """F0 = 120 + 30 sin(2 pi 0.7 t) on the voiced frames."""
    times = raw_pitch.times.mean(axis=1)
    expected = 120 + 30 * np.sin(2 * np.pi * 0.7 * times)
    voiced = raw_pitch.data[:, 0] > 0.8
    assert voiced.sum() > 30
    err = np.abs(raw_pitch.data[voiced, 1] - expected[voiced])
    assert np.median(err) < 5.0  # Hz


def test_oracle_parity(audio, raw_pitch):
    signal = audio.data.astype(np.float64)
    ours = raw_pitch.data
    ref = pitch_oracle.compute_pitch(signal)
    same = pitch_oracle.assert_lag_decisions(signal, ours, ref)
    assert np.max(np.abs(ours[same, 1] - ref[same, 1])
                  / ref[same, 1]) < 1e-3


def test_oracle_parity_options(audio):
    kwargs = dict(min_f0=60, max_f0=300, penalty_factor=0.3,
                  nccf_ballast=1000)
    signal = audio.data.astype(np.float64)
    ours = KaldiPitchProcessor(**kwargs).process(audio, device='cpu').data
    ref = pitch_oracle.compute_pitch(signal, **kwargs)
    pitch_oracle.assert_lag_decisions(signal, ours, ref, **kwargs)


def test_signal_checks(audio):
    proc = KaldiPitchProcessor(sample_rate=8000)
    with pytest.raises(ValueError, match='mismatch in sample rates'):
        proc.process(audio, device='cpu')


def test_params():
    proc = KaldiPitchProcessor()
    assert len(proc.get_params()) == 13
    post = KaldiPitchPostProcessor()
    assert len(post.get_params()) == 13
    assert post.ndims == 3


# ------------------------------------------------------------------- post

def test_post_shape(raw_pitch):
    post = KaldiPitchPostProcessor()
    assert post.process(raw_pitch, device='cpu').shape == (140, 3)

    post.add_raw_log_pitch = True
    assert post.process(raw_pitch, device='cpu').shape == (140, 4)

    post = KaldiPitchPostProcessor(
        add_pov_feature=False, add_normalized_log_pitch=False,
        add_delta_pitch=False, add_raw_log_pitch=True)
    assert post.process(raw_pitch, device='cpu').shape == (140, 1)


def test_post_no_feature_selected(raw_pitch):
    post = KaldiPitchPostProcessor(
        add_pov_feature=False, add_normalized_log_pitch=False,
        add_delta_pitch=False, add_raw_log_pitch=False)
    with pytest.raises(ValueError, match='at least one'):
        post.process(raw_pitch, device='cpu')


def test_post_bad_input(mfcc):
    with pytest.raises(ValueError, match='shape must be'):
        KaldiPitchPostProcessor().process(mfcc, device='cpu')


@pytest.mark.parametrize('delay', [0, 3])
def test_post_oracle(raw_pitch, delay):
    """``test_post_oracle`` (delay 0, raw log pitch) and
    ``test_post_oracle_delay``."""
    post = KaldiPitchPostProcessor(
        delta_pitch_noise_stddev=0, delay=delay,
        add_raw_log_pitch=delay == 0)
    ours = post.process(raw_pitch, device='cpu').data
    ref = pitch_oracle.process_pitch(
        raw_pitch.data.astype(np.float64), delay=delay,
        add_raw=delay == 0)
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 1e-3


def test_post_collection_equals_single(audio, raw_pitch):
    """The bucket-batched collection path reproduces the per-utterance
    post-processor output exactly (noise disabled)."""
    short = Audio(audio.data[:12000], audio.sample_rate)
    raw_short = KaldiPitchProcessor().process(short, device='cpu')
    collection = FeaturesCollection(utt1=raw_pitch, utt2=raw_short)

    post = KaldiPitchPostProcessor(
        delta_pitch_noise_stddev=0, add_raw_log_pitch=True)
    batched = post.process_collection(collection, device='cpu')
    for name, raw in collection.items():
        single = post.process(raw, device='cpu')
        assert batched[name].shape == single.shape
        np.testing.assert_array_equal(batched[name].data, single.data)
        np.testing.assert_array_equal(batched[name].times, single.times)
        assert batched[name].properties == single.properties


def test_post_collection_validation(raw_pitch, mfcc):
    post = KaldiPitchPostProcessor(
        add_pov_feature=False, add_normalized_log_pitch=False,
        add_delta_pitch=False, add_raw_log_pitch=False)
    with pytest.raises(ValueError, match='at least one'):
        post.process_collection(
            FeaturesCollection(utt=raw_pitch), device='cpu')
    with pytest.raises(ValueError, match='shape must be'):
        KaldiPitchPostProcessor().process_collection(
            FeaturesCollection(utt=mfcc), device='cpu')


@pytest.mark.parametrize('route', ['process', 'process_collection'])
def test_post_noise(raw_pitch, route):
    """``test_post_noise`` and ``test_post_collection_noise``: with no
    generator each run draws fresh delta noise; the other columns are
    deterministic."""
    post = KaldiPitchPostProcessor()
    if route == 'process':
        outs = [post.process(raw_pitch, device='cpu').data
                for _ in range(2)]
    else:
        collection = FeaturesCollection(utt=raw_pitch)
        outs = [post.process_collection(collection, device='cpu')['utt'].data
                for _ in range(2)]
    assert not np.array_equal(outs[0][:, 2], outs[1][:, 2])
    assert np.array_equal(outs[0][:, :2], outs[1][:, :2])


def test_chunked_validation():
    audio = Audio(_long_audio(2).data, 16000)
    proc = KaldiPitchProcessor()
    with pytest.raises(ValueError, match='chunk_frames'):
        proc.process_chunked(audio, chunk_frames=0, device='cpu')
    with pytest.raises(ValueError, match='halo_frames'):
        proc.process_chunked(audio, halo_frames=-1, device='cpu')
    with pytest.raises(ValueError, match='sample rates'):
        proc.process_chunked(
            Audio(audio.data, audio.sample_rate, validate=False)
            .resample(8000), device='cpu')
