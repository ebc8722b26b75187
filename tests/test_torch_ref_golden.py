"""Counterpart of ``tests/test_golden.py``, case for case: every
processor of the port, on the CPU, on the conftest's synthetic signal,
within max-abs 1e-3 of the committed ``tests/data/golden.npz`` (the
JAX package's outputs, oracle-verified when they were frozen).

The spectrogram missed it while its frame chain was float32 (ROADMAP
C7)."""

import os

import numpy as np
import pytest

from shennong_tpu_torch.processor import (
    EnergyProcessor, FilterbankProcessor, KaldiPitchProcessor,
    MfccProcessor, PlpProcessor, SpectrogramProcessor)
from shennong_tpu_torch.processor.pitch_kaldi import (
    KaldiPitchPostProcessor)

from tests.torch_ref import audio  # noqa: F401 (fixture)

GOLDEN = os.path.join(os.path.dirname(__file__), 'data', 'golden.npz')


@pytest.fixture(scope='module')
def golden():
    with np.load(GOLDEN) as data:
        return {k: data[k] for k in data.files}


SPECTRAL = {
    'mfcc': (MfccProcessor, {}),
    'fbank': (FilterbankProcessor, {}),
    'spectrogram': (SpectrogramProcessor, {}),
    'plp': (PlpProcessor, {}),
    'rastaplp': (PlpProcessor, {'rasta': True}),
    'energy': (EnergyProcessor, {}),
}


@pytest.mark.parametrize('name', sorted(SPECTRAL))
def test_spectral_golden(audio, golden, name):
    """The JAX case's loop over the six processors, a case each."""
    cls, kwargs = SPECTRAL[name]
    out = cls(dither=0, **kwargs).process(audio, device='cpu').data
    assert out.shape == golden[name].shape, name
    assert np.max(np.abs(out - golden[name])) < 1e-3, name


def test_pitch_golden(audio, golden):
    pitch = KaldiPitchProcessor().process(audio, device='cpu')
    assert pitch.shape == golden['pitch'].shape
    assert np.max(np.abs(pitch.data - golden['pitch'])) < 1e-3

    post = KaldiPitchPostProcessor(
        delta_pitch_noise_stddev=0).process(pitch, device='cpu')
    assert post.shape == golden['pitch_post'].shape
    assert np.max(np.abs(post.data - golden['pitch_post'])) < 1e-3


def test_chip_smoke_carries_the_conftest_signal():
    """``chip_smoke.py`` runs the goldens on the card, whose machine has
    no jax: its numpy copy of ``make_speech_like_signal`` equals the
    conftest's, for the seeds and rates the suite uses."""
    import chip_smoke
    from tests.conftest import make_speech_like_signal

    for nsamples, rate, seed in ((22713, 16000, 0), (11000, 8000, 1),
                                 (24000, 16000, 4)):
        np.testing.assert_array_equal(
            chip_smoke.make_speech_like_signal(nsamples, rate, seed),
            make_speech_like_signal(nsamples, rate, seed))
