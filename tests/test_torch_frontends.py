"""The port's spectrogram and filterbank front ends, sliding-window
CMVN and host helpers against the JAX package.

Inputs are made with numpy from a seed, every random source is 0, and
the same inputs go through ``shennong_tpu`` and ``shennong_tpu_torch``
on the CPU. Tolerances (max-abs):

- ``fbank_batch``: 1e-4 (FFT and sums in another order, float32;
  linear outputs relative to the row's largest value);
- ``spectrogram_batch``: 1e-4 on the energy column and on the power
  (relative to the frame's largest bin) against JAX, 1e-4 on the log
  power against the float64 Kaldi oracle (``tests/kaldi_oracle.py``):
  the port's frame chain and FFT are float64 there, the reference's
  float32, whose rounding the log of a bin near the floor amplifies
  (up to 9e-4 against Kaldi on test.wav);
- ``sliding_window_cmvn``: 1e-5 on unit-scale features, and against
  Kaldi's float64 arithmetic;
- the processors on tests/data/test.wav: 1e-3 against
  ``golden_real.npz`` and ``tests/kaldi_oracle.py``;
- the pipelines (filterbank + CMVN + deltas, spectrogram + CMVN):
  1e-3 against ``shennong_tpu.pipeline.extract_features``;
- frames, windows and configurations: exact.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shennong_tpu import frames as jframes
from shennong_tpu import pipeline as jpipeline
from shennong_tpu import window as jwindow
from shennong_tpu.audio import Audio as JAudio
from shennong_tpu.features import Features as JFeatures
from shennong_tpu.features_collection import (
    FeaturesCollection as JFeaturesCollection)
from shennong_tpu.ops import framing as jframing
from shennong_tpu.ops import mel as melmod
from shennong_tpu.ops import postops as jpostops
from shennong_tpu.ops import spectral as jspectral
from shennong_tpu.postprocessor import cmvn as jcmvn
from shennong_tpu.processor import filterbank as jfilterbank
from shennong_tpu.processor import spectrogram as jspectrogram
from shennong_tpu.utterances import Utterances as JUtterances
from shennong_tpu_torch import frames, pipeline, window
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.ops import framing, postops, spectral
from shennong_tpu_torch.pipeline_manager import PipelineManager
from shennong_tpu_torch.postprocessor import cmvn
from shennong_tpu_torch.postprocessor.cmvn import (
    SlidingWindowCmvnPostProcessor)
from shennong_tpu_torch.processor.filterbank import FilterbankProcessor
from shennong_tpu_torch.processor.spectrogram import SpectrogramProcessor
from shennong_tpu_torch.utils import dict_equal
from shennong_tpu_torch.utterances import Utterances
from tests import kaldi_oracle
from tests.test_torch_ops import padded_batch
# fixtures: 4 utterances of 2 speakers, the energy VAD without dither
from tests.test_torch_pipeline import corpus, no_energy_dither  # noqa: F401

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_WAV = os.path.join(REPO, 'tests', 'data', 'test.wav')


def assert_rows_close(ours, ref, lengths, opts, tol, relative=False):
    """Valid frames of every row equal at ``tol`` (relative to the
    row's largest value with ``relative``)."""
    assert ours.shape == ref.shape
    for row, length in enumerate(lengths):
        valid = framing.num_frames(int(length), opts.frame)
        scale = np.abs(ref[row, :valid]).max() if relative else 1.0
        assert np.isfinite(ours[row, :valid]).all()
        assert np.abs(ours[row, :valid] - ref[row, :valid]).max() \
            / scale < tol


# ---------------------------------------------------------------- spectral

@pytest.mark.parametrize('options', [
    {}, {'use_power': False}, {'use_log_fbank': False},
    {'use_energy': True, 'htk_compat': True},
    {'use_energy': True, 'raw_energy': False, 'energy_floor': 1e6}])
def test_fbank_batch(options):
    signals, lengths = padded_batch([16000, 9000, 4000])
    jopts = jspectral.FbankOpts(
        frame=jframing.FrameOptions(dither=0.0), **options)
    opts = spectral.FbankOpts(
        frame=framing.FrameOptions(dither=0.0), **options)
    weights, _ = melmod.mel_banks(
        23, 512, 16000.0, 20.0, 0.0, 100.0, -500.0, 1.0)
    nframes_max = framing.num_frames(signals.shape[1], opts.frame)
    ref = np.asarray(jspectral.fbank_batch(
        jnp.asarray(signals.astype(np.float32)), jnp.asarray(lengths),
        jnp.asarray(weights), jopts, nframes_max))
    ours = spectral.fbank_batch(
        torch.from_numpy(signals), torch.from_numpy(lengths), weights,
        opts, nframes_max).numpy()
    assert_rows_close(ours, ref, lengths, opts, 1e-4,
                      relative=not opts.use_log_fbank)


def test_fbank_batch_per_row_warps():
    """[B, M, P] mel banks (one VTLN warp per utterance)."""
    signals, lengths = padded_batch([12000, 8000])
    frame = jframing.FrameOptions(dither=0.0)
    jopts = jspectral.FbankOpts(frame=frame)
    opts = spectral.FbankOpts(frame=framing.FrameOptions(dither=0.0))
    weights = np.stack([melmod.mel_banks(
        23, 512, 16000.0, 20.0, 0.0, 100.0, -500.0, warp)[0]
        for warp in (0.9, 1.1)])
    nframes_max = framing.num_frames(signals.shape[1], opts.frame)
    ref = np.asarray(jspectral.fbank_batch(
        jnp.asarray(signals.astype(np.float32)), jnp.asarray(lengths),
        jnp.asarray(weights), jopts, nframes_max))
    ours = spectral.fbank_batch(
        torch.from_numpy(signals), torch.from_numpy(lengths), weights,
        opts, nframes_max).numpy()
    assert_rows_close(ours, ref, lengths, opts, 1e-4)


@pytest.mark.parametrize('options', [
    {}, {'raw_energy': False}, {'energy_floor': 1e6}])
def test_spectrogram_batch(options):
    """The energy column and the power (relative to each frame's
    largest bin) against the JAX package; the log power against the
    float64 Kaldi oracle of each row. The reference's float32 frame
    chain and FFT are not held in the log domain: the log of a bin near
    the floor amplifies their rounding past 1e-3."""
    signals, lengths = padded_batch([16000, 9000, 4000])
    jopts = jspectral.SpectrogramOpts(
        frame=jframing.FrameOptions(dither=0.0), **options)
    opts = spectral.SpectrogramOpts(
        frame=framing.FrameOptions(dither=0.0), **options)
    nframes_max = framing.num_frames(signals.shape[1], opts.frame)
    ref = np.asarray(jspectral.spectrogram_batch(
        jnp.asarray(signals.astype(np.float32)), jnp.asarray(lengths),
        jopts, nframes_max))
    ours = spectral.spectrogram_batch(
        torch.from_numpy(signals), torch.from_numpy(lengths), opts,
        nframes_max).numpy()
    assert_rows_close(ours[..., :1], ref[..., :1], lengths, opts, 1e-4)

    exact = np.zeros(ours.shape)
    for row, length in enumerate(lengths):
        oracle = kaldi_oracle.spectrogram(
            signals[row, :length].astype(np.float64),
            raw_energy=options.get('raw_energy', True),
            energy_floor=options.get('energy_floor', 0.0))
        exact[row, :len(oracle)] = oracle
    assert_rows_close(ours[..., 1:], exact[..., 1:], lengths, opts, 1e-4)

    power, ref_power = np.exp(ours[..., 1:]), np.exp(ref[..., 1:])
    for row, length in enumerate(lengths):
        valid = framing.num_frames(int(length), opts.frame)
        scale = ref_power[row, :valid].max(axis=-1, keepdims=True)
        assert (np.abs(power[row, :valid] - ref_power[row, :valid])
                / scale).max() < 1e-4


# ------------------------------------------------------------ sliding CMVN

@pytest.mark.parametrize('center,normalize_variance,cmn_window,min_window', [
    (True, False, 600, 100), (False, False, 600, 100),
    (True, True, 50, 10), (False, True, 50, 10), (False, True, 30, 80)])
@pytest.mark.parametrize('offset', [0.0, 15.0])
def test_sliding_window_cmvn(center, normalize_variance, cmn_window,
                             min_window, offset):
    """Utterances longer than the window, shorter than ``min_window``,
    of one and of zero frames. Unit-scale features against the JAX
    package; features with a mean of 15 (a log energy) against Kaldi's
    float64 arithmetic only, where the reference's float32 prefix sums
    lose up to 1e-3."""
    rng = np.random.RandomState(cmn_window)
    feats = (rng.randn(5, 700, 13) + offset).astype(np.float32)
    nframes = np.array([700, 240, 60, 1, 0], dtype=np.int32)
    kwargs = dict(center=center, cmn_window=cmn_window,
                  min_window=min_window,
                  normalize_variance=normalize_variance)
    ours = postops.sliding_window_cmvn(
        torch.from_numpy(feats), torch.from_numpy(nframes), **kwargs).numpy()
    ref = np.asarray(jpostops.sliding_window_cmvn(
        jnp.asarray(feats), jnp.asarray(nframes), **kwargs))
    for row, valid in enumerate(nframes):
        if not offset:
            assert np.abs(ours[row, :valid] - ref[row, :valid]).max(
                initial=0.0) < 1e-5
        if valid:
            oracle = kaldi_oracle.sliding_window_cmn(
                feats[row, :valid], **kwargs)
            assert np.abs(ours[row, :valid] - oracle).max() < 1e-5


def test_sliding_window_cmvn_postprocessor(monkeypatch):
    rng = np.random.RandomState(3)
    collection, ref_collection = FeaturesCollection(), JFeaturesCollection()
    for index, nframes in enumerate([400, 90, 250]):
        data = (rng.randn(nframes, 13) * 3 + 1).astype(np.float32)
        times = np.arange(nframes) * 0.01
        props = {'mfcc': {'num_ceps': 13}}
        collection[f'u{index}'] = Features(data, times, props)
        ref_collection[f'u{index}'] = JFeatures(data, times, props)
    kwargs = dict(center=False, cmn_window=200, normalize_variance=True)
    ours = SlidingWindowCmvnPostProcessor(**kwargs)
    ref = jcmvn.SlidingWindowCmvnPostProcessor(**kwargs)
    assert ours.get_params() == ref.get_params()

    one = ours.process(collection['u0'], device='cpu')
    ref_one = ref.process(ref_collection['u0'])
    assert np.abs(one.data - ref_one.data).max() < 1e-5
    assert dict_equal(one.properties, ref_one.properties)

    monkeypatch.setattr(cmvn, 'BATCH_ROWS', 2)  # two batches
    every = ours.process_all(collection, device='cpu')
    ref_every = ref.process_all(ref_collection)
    # the port keeps the input order, the reference its batch order
    assert list(every.keys()) == list(collection.keys())
    assert sorted(every.keys()) == sorted(ref_every.keys())
    for name in ref_every:
        assert every[name].shape == ref_every[name].shape
        assert np.abs(every[name].data - ref_every[name].data).max() < 1e-5
        assert dict_equal(every[name].properties, ref_every[name].properties)


# --------------------------------------------------------------- processors

@pytest.mark.parametrize('name', ['fbank', 'spectrogram'])
def test_processors_golden_and_oracle(name):
    audio = Audio.load(REAL_WAV)
    golden = np.load(os.path.join(REPO, 'tests', 'data', 'golden_real.npz'))
    signal = audio.data.astype(np.float64)
    if name == 'fbank':
        ours = FilterbankProcessor(dither=0).process(audio, device='cpu')
        ref = jfilterbank.FilterbankProcessor(dither=0).process(
            JAudio.load(REAL_WAV))
        oracle = kaldi_oracle.fbank(signal)
    else:
        ours = SpectrogramProcessor(dither=0).process(audio, device='cpu')
        ref = jspectrogram.SpectrogramProcessor(dither=0).process(
            JAudio.load(REAL_WAV))
        oracle = kaldi_oracle.spectrogram(signal)
    assert ours.shape == golden[name].shape
    assert np.abs(ours.data - golden[name]).max() < 1e-3
    assert np.abs(ours.data - oracle).max() < 1e-3
    # 1e-3 for the log of near-floor spectrogram bins, see above
    assert np.abs(ours.data - ref.data).max() < (
        1e-4 if name == 'fbank' else 1e-3)
    assert dict_equal(ours.properties, ref.properties)


@pytest.mark.parametrize('kwargs', [
    dict(use_energy=True), dict(use_energy=True, htk_compat=True),
    dict(use_power=False), dict(use_log_fbank=False)])
def test_filterbank_options_oracle(kwargs):
    audio = Audio.load(REAL_WAV)
    ours = FilterbankProcessor(dither=0, **kwargs).process(
        audio, 1.1, device='cpu').data
    oracle = kaldi_oracle.fbank(
        audio.data.astype(np.float64), vtln=1.1,
        use_energy=kwargs.get('use_energy', False),
        htk_compat=kwargs.get('htk_compat', False),
        use_power=kwargs.get('use_power', True),
        use_log=kwargs.get('use_log_fbank', True))
    scale = 1.0 if kwargs.get('use_log_fbank', True) else np.abs(
        oracle).max()
    assert np.abs(ours - oracle).max() / scale < 1e-3


def test_processors_params():
    assert (SpectrogramProcessor().get_params()
            == jspectrogram.SpectrogramProcessor().get_params())
    assert (FilterbankProcessor().get_params()
            == jfilterbank.FilterbankProcessor().get_params())
    assert SpectrogramProcessor().ndims == 257
    assert FilterbankProcessor(use_energy=True).ndims == 24


# ------------------------------------------------------- frames and window

@pytest.mark.parametrize('snip_edges', [True, False])
def test_frames(snip_edges):
    signal = np.arange(1000, dtype=np.float64)
    ours = frames.Frames(snip_edges=snip_edges)
    ref = jframes.Frames(snip_edges=snip_edges)
    assert ours.get_params() == ref.get_params()
    for nsamples in (0, 1, 399, 400, 401, 1000, 22713):
        assert ours.nframes(nsamples) == ref.nframes(nsamples)
    assert np.array_equal(ours.times(1000), ref.times(1000))
    assert np.array_equal(ours.boundaries(7), ref.boundaries(7))
    for writeable in (False, True):
        assert np.array_equal(
            ours.make_frames(signal, writeable=writeable),
            ref.make_frames(signal, writeable=writeable))


def test_window():
    assert window.types() == jwindow.types()
    for kind in window.types():
        for length in (1, 2, 3, 400):
            assert np.array_equal(window.window(length, kind),
                                  jwindow.window(length, kind))
    with pytest.raises(ValueError):
        window.window(0)


# ----------------------------------------------------------------- config

@pytest.mark.parametrize('features', ['spectrogram', 'filterbank', 'plp'])
def test_default_config_parity(features):
    kwargs = dict(with_pitch='kaldi', with_cmvn=True, with_delta=True)
    assert dict_equal(
        pipeline.get_default_config(features, **kwargs),
        jpipeline.get_default_config(features, **kwargs))
    assert (pipeline.get_default_config(features, to_yaml=True, **kwargs)
            == jpipeline.get_default_config(features, to_yaml=True,
                                            **kwargs))


def test_manager_resolves_new_classes():
    for name in ('spectrogram', 'filterbank', 'plp', 'sliding_window_cmvn'):
        cls = PipelineManager.get_processor_class(name)
        assert cls.__module__.startswith('shennong_tpu_torch.'), name


# --------------------------------------------------------------- pipeline

@pytest.mark.parametrize('features,delta,columns', [
    ('filterbank', True, 69), ('spectrogram', False, 257)])
def test_pipeline_matches_reference(corpus, no_energy_dither, features,
                                    delta, columns):
    config = pipeline.get_default_config(
        features, with_cmvn=True, with_delta=delta)
    config[features]['dither'] = 0
    ref = jpipeline.extract_features(
        copy.deepcopy(config), JUtterances(corpus))
    ours = pipeline.extract_features(
        copy.deepcopy(config), Utterances(corpus), device='cpu')
    assert list(ours.keys()) == list(ref.keys())
    for name in ref:
        assert ours[name].shape == ref[name].shape, name
        assert ours[name].shape[1] == columns
        assert np.abs(ours[name].data - ref[name].data).max() < 1e-3, name
        assert np.array_equal(ours[name].times, ref[name].times)
        props, ref_props = (copy.deepcopy(f.properties)
                            for f in (ours[name], ref[name]))
        stats, ref_stats = (p['cmvn'].pop('stats') for p in (props, ref_props))
        assert stats[0, -1] == ref_stats[0, -1]
        assert np.abs(stats - ref_stats).max() / stats[0, -1] < 1e-3
        assert dict_equal(props, ref_props), name
