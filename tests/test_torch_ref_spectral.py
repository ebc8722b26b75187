"""Counterpart of ``tests/processor/test_spectral.py``, case for case:
the spectrogram, filterbank and energy processors of the port on the
CPU, on the conftest's signals, against ``tests/kaldi_oracle.py`` with
the JAX cases' bounds (max-abs 1e-3; linear filterbanks rtol 1e-4, atol
1e-2).

The spectrogram's oracle cases open with 0.1 s of near-digital
silence, where a float32 frame chain missed Kaldi's 1e-3 (1.064e-3,
ROADMAP C7): the port's spectrogram runs its frame chain and FFT in
float64.
"""

import numpy as np
import pytest

from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.processor import (
    EnergyProcessor, FilterbankProcessor, MfccProcessor,
    SpectrogramProcessor)

from tests import kaldi_oracle
from tests.torch_ref import audio  # noqa: F401 (fixture)


# --------------------------------------------------------------- spectrogram

def test_spectrogram_shape(audio):
    feats = SpectrogramProcessor(dither=0).process(audio, device='cpu')
    assert feats.shape == (140, 257)


@pytest.mark.parametrize('kwargs', [
    dict(),
    dict(raw_energy=False),
    dict(window_type='hanning'),
    dict(energy_floor=1e4),
])
def test_spectrogram_oracle(audio, kwargs):
    """``test_spectrogram_oracle`` (no options) and the three cases of
    ``test_spectrogram_options``."""
    ours = SpectrogramProcessor(dither=0, **kwargs).process(
        audio, device='cpu').data
    ref = kaldi_oracle.spectrogram(
        audio.data.astype(np.float64),
        raw_energy=kwargs.get('raw_energy', True),
        window_type=kwargs.get('window_type', 'povey'),
        energy_floor=kwargs.get('energy_floor', 0.0))
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 1e-3


# ---------------------------------------------------------------- filterbank

def test_fbank_shapes(audio):
    proc = FilterbankProcessor(dither=0)
    assert proc.process(audio, device='cpu').shape == (140, 23)
    proc.use_energy = True
    assert proc.process(audio, device='cpu').shape == (140, 24)


@pytest.mark.parametrize('kwargs', [
    dict(),
    dict(use_energy=True),
    dict(use_energy=True, htk_compat=True),
    dict(use_log_fbank=False),
    dict(use_power=False),
    dict(use_energy=True, raw_energy=False),
])
def test_fbank_oracle(audio, kwargs):
    ours = FilterbankProcessor(dither=0, **kwargs).process(
        audio, device='cpu').data
    ref = kaldi_oracle.fbank(
        audio.data.astype(np.float64),
        use_energy=kwargs.get('use_energy', False),
        raw_energy=kwargs.get('raw_energy', True),
        use_log=kwargs.get('use_log_fbank', True),
        use_power=kwargs.get('use_power', True),
        htk_compat=kwargs.get('htk_compat', False))
    assert ours.shape == ref.shape
    if kwargs.get('use_log_fbank', True):
        assert np.max(np.abs(ours - ref)) < 1e-3
    else:
        assert np.allclose(ours, ref, rtol=1e-4, atol=1e-2)


def test_fbank_vtln(audio):
    plain = FilterbankProcessor(dither=0).process(audio, device='cpu').data
    warped = FilterbankProcessor(dither=0).process(
        audio, vtln_warp=1.1, device='cpu').data
    assert not np.allclose(plain, warped)
    ref = kaldi_oracle.fbank(audio.data.astype(np.float64), vtln=1.1)
    assert np.max(np.abs(warped - ref)) < 1e-3


# -------------------------------------------------------------------- energy

def test_energy_shape(audio):
    feats = EnergyProcessor(dither=0).process(audio, device='cpu')
    assert feats.shape == (140, 1)


def test_energy_equals_mfcc_c0(audio):
    """Energy equals the first MFCC coefficient (same algorithm)."""
    energy = EnergyProcessor(dither=0).process(audio, device='cpu').data
    mfcc = MfccProcessor(dither=0, use_energy=True).process(
        audio, device='cpu').data
    assert np.allclose(energy[:, 0], mfcc[:, 0], atol=1e-4)


def test_energy_compression(audio):
    log_e = EnergyProcessor(dither=0, compression='log').process(
        audio, device='cpu')
    raw_e = EnergyProcessor(dither=0, compression='off').process(
        audio, device='cpu')
    sqrt_e = EnergyProcessor(dither=0, compression='sqrt').process(
        audio, device='cpu')
    assert np.allclose(np.log(raw_e.data), log_e.data, atol=1e-4)
    assert np.allclose(np.sqrt(raw_e.data), sqrt_e.data, rtol=1e-4)
    with pytest.raises(ValueError, match='compression must be'):
        EnergyProcessor(compression='bad')


def test_energy_windowed(audio):
    """raw_energy=False computes energy after preemphasis/windowing."""
    raw = EnergyProcessor(dither=0, raw_energy=True).process(
        audio, device='cpu')
    win = EnergyProcessor(dither=0, raw_energy=False).process(
        audio, device='cpu')
    assert not np.allclose(raw.data, win.data)
    # windowed energy is always lower (window <= 1)
    assert np.mean(win.data) < np.mean(raw.data)


def test_energy_custom_framing(audio):
    proc = EnergyProcessor(
        dither=0, frame_shift=0.02, frame_length=0.05,
        window_type='hanning')
    assert proc.process(audio, device='cpu').shape == (69, 1)


def test_energy_silent_signal():
    """Digital silence must yield finite (floored) energies."""
    silent = Audio(np.zeros(16000, dtype=np.int16), 16000)
    feats = EnergyProcessor(dither=0).process(silent, device='cpu')
    assert np.all(np.isfinite(feats.data))
    feats = EnergyProcessor(dither=0, compression='off').process(
        silent, device='cpu')
    assert np.all(feats.data >= 0)
