"""Counterpart of ``tests/test_chunked.py``, case for case: the port's
chunked (halo) extraction of long utterances on the CPU, with the JAX
cases' signals and bounds (1e-4 against the whole-signal program,
RASTA-PLP 1e-3, 2e-4 through the executor)."""

import numpy as np
import pytest

from shennong_tpu_torch import Audio
from shennong_tpu_torch.processor import (
    EnergyProcessor, FilterbankProcessor, MfccProcessor, PlpProcessor,
    SpectrogramProcessor)

from tests.conftest import make_speech_like_signal


@pytest.fixture(scope='module')
def long_audio():
    # ~4.2 s: long enough for several chunks at chunk_frames=100
    return Audio(make_speech_like_signal(67000, 16000), 16000)


@pytest.mark.parametrize('snip', [True, False])
@pytest.mark.parametrize('factory', [
    lambda s: MfccProcessor(dither=0, snip_edges=s),
    lambda s: SpectrogramProcessor(dither=0, snip_edges=s),
    lambda s: FilterbankProcessor(dither=0, snip_edges=s),
    lambda s: EnergyProcessor(dither=0, snip_edges=s),
    lambda s: PlpProcessor(dither=0, snip_edges=s)])
def test_chunked_matches_whole(long_audio, factory, snip):
    proc = factory(snip)
    whole = proc.process(long_audio, device='cpu')
    chunked = proc.process_chunked(long_audio, chunk_frames=100, device='cpu')
    assert chunked.shape == whole.shape
    assert np.allclose(chunked.data, whole.data, atol=1e-4), \
        np.abs(chunked.data - whole.data).max()
    assert np.array_equal(chunked.times, whole.times)
    assert chunked.properties == whole.properties


def test_chunked_rasta_halo(long_audio):
    proc = PlpProcessor(dither=0, rasta=True)
    whole = proc.process(long_audio, device='cpu')
    chunked = proc.process_chunked(long_audio, chunk_frames=100, device='cpu')
    assert chunked.shape == whole.shape
    # the IIR halo makes chunk boundaries converge, not exact
    assert np.abs(chunked.data - whole.data).max() < 1e-3


def test_chunked_vtln_warp(long_audio):
    proc = MfccProcessor(dither=0)
    whole = proc.process(long_audio, vtln_warp=1.1, device='cpu')
    chunked = proc.process_chunked(
        long_audio, chunk_frames=100, vtln_warp=1.1, device='cpu')
    assert np.allclose(chunked.data, whole.data, atol=1e-4)
    assert chunked.properties == whole.properties


def test_auto_routing(long_audio, monkeypatch):
    """process() transparently chunks past AUTO_CHUNK_FRAMES."""
    proc = MfccProcessor(dither=0)
    whole = proc.process(long_audio, device='cpu')

    monkeypatch.setattr(MfccProcessor, 'AUTO_CHUNK_FRAMES', 200)
    routed = proc.process(long_audio, device='cpu')
    assert np.allclose(routed.data, whole.data, atol=1e-4)

    monkeypatch.setattr(MfccProcessor, 'AUTO_CHUNK_FRAMES', None)
    assert np.allclose(
        proc.process(long_audio, device='cpu').data, whole.data, atol=0)


def test_short_signal_passthrough(audio):
    """Signals under one chunk go through the regular path."""
    proc = MfccProcessor(dither=0)
    out = proc.process_chunked(audio, chunk_frames=10 ** 6, device='cpu')
    assert np.array_equal(out.data, proc.process(audio, device='cpu').data)


def test_executor_routes_oversize(long_audio, tmpdir, monkeypatch):
    """BatchExecutor sends oversize utterances through chunked
    extraction and batches the rest; outputs match process()."""
    import scipy.io.wavfile
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch.parallel.executor import BatchExecutor

    path = str(tmpdir.join('long.wav'))
    scipy.io.wavfile.write(path, 16000, long_audio.data)

    utterances = Utterances([
        ('big', path, 0.0, 4.1),
        ('small1', path, 0.0, 0.9),
        ('small2', path, 1.0, 2.2)])

    proc = MfccProcessor(dither=0)
    monkeypatch.setattr(MfccProcessor, 'AUTO_CHUNK_FRAMES', 200)
    batched = BatchExecutor(proc, device='cpu').process_all(utterances)
    assert sorted(batched.keys()) == ['big', 'small1', 'small2']
    for utt in utterances:
        single = proc.process_chunked(
            utt.load_audio(), chunk_frames=10**9, device='cpu')
        assert batched[utt.name].shape == single.shape, utt.name
        assert np.allclose(
            batched[utt.name].data, single.data, atol=2e-4), utt.name

    # with per-utterance VTLN warps
    warps = {'big': 1.1, 'small1': 0.9, 'small2': 1.0}
    warped = BatchExecutor(proc, device='cpu').process_all(
        utterances, vtln_warp=warps)
    for utt in utterances:
        single = proc.process_chunked(
            utt.load_audio(), chunk_frames=10**9,
            vtln_warp=warps[utt.name], device='cpu')
        assert np.allclose(
            warped[utt.name].data, single.data, atol=2e-4), utt.name


def test_multi_warp_classes_match_per_warp(wav_file):
    """extract_features_warp_classes equals per-class
    extract_features_warp (one DFT pass vs 41)."""
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch.logger import null_logger
    from shennong_tpu_torch.pipeline import (
        extract_features_warp, extract_features_warp_classes)

    utterances = Utterances([
        ('u1', wav_file, 0.0, 0.8), ('u2', wav_file, 0.5, 1.4)])
    config = {'mfcc': {'dither': 0}}
    warps = [0.9, 1.0, 1.15]
    stacked = extract_features_warp_classes(
        config, utterances, warps, null_logger(), device='cpu')
    assert len(stacked) == 3
    for collection, warp in zip(stacked, warps):
        single = extract_features_warp(
            config, utterances, warp, null_logger(), device='cpu')
        for name in ('u1', 'u2'):
            assert np.allclose(
                collection[name].data, single[name].data,
                atol=1e-4), (warp, name)
            assert collection[name].properties[
                'mfcc']['vtln_warp'] == warp
