"""Counterpart of ``tests/test_stability.py``, case for case: every
processor and post-processor of the port, run twice on the CPU (same
instance and fresh instance, dither disabled), gives the same bits."""

import numpy as np
import pytest

from shennong_tpu_torch.postprocessor import (
    CmvnPostProcessor, DeltaPostProcessor,
    SlidingWindowCmvnPostProcessor, VadPostProcessor)
from shennong_tpu_torch.processor import (
    EnergyProcessor, FilterbankProcessor, KaldiPitchProcessor,
    MfccProcessor, PlpProcessor, SpectrogramProcessor)

from tests.torch_ref import audio, mfcc  # noqa: F401 (fixtures)

PROCESSORS = [
    (MfccProcessor, dict(dither=0)),
    (FilterbankProcessor, dict(dither=0)),
    (SpectrogramProcessor, dict(dither=0)),
    (PlpProcessor, dict(dither=0)),
    (PlpProcessor, dict(dither=0, rasta=True)),
    (EnergyProcessor, dict(dither=0)),
    (KaldiPitchProcessor, dict()),
]


@pytest.mark.parametrize(
    'cls,kwargs', PROCESSORS,
    ids=lambda p: getattr(p, '__name__', str(p)))
def test_processor_stability(audio, cls, kwargs):
    proc = cls(**kwargs)
    first = proc.process(audio, device='cpu')
    second = proc.process(audio, device='cpu')
    assert np.array_equal(first.data, second.data)

    fresh = cls(**kwargs).process(audio, device='cpu')
    assert np.array_equal(first.data, fresh.data)


POSTPROCESSORS = [
    (DeltaPostProcessor, dict()),
    (SlidingWindowCmvnPostProcessor, dict()),
    (VadPostProcessor, dict()),
]


@pytest.mark.parametrize(
    'cls,kwargs', POSTPROCESSORS,
    ids=lambda p: getattr(p, '__name__', str(p)))
def test_postprocessor_stability(mfcc, cls, kwargs):
    proc = cls(**kwargs)
    first = proc.process(mfcc, device='cpu')
    second = proc.process(mfcc, device='cpu')
    assert np.array_equal(first.data, second.data)

    fresh = cls(**kwargs).process(mfcc, device='cpu')
    assert np.array_equal(first.data, fresh.data)


def test_cmvn_stability(mfcc):
    proc1 = CmvnPostProcessor(mfcc.ndims)
    proc1.accumulate(mfcc)
    proc2 = CmvnPostProcessor(mfcc.ndims)
    proc2.accumulate(mfcc)
    assert np.array_equal(
        proc1.process(mfcc).data, proc2.process(mfcc).data)


def test_batched_stability(audio, wav_file):
    """Batched extraction is deterministic too."""
    from shennong_tpu_torch import Utterances
    utts = Utterances(
        [('u1', wav_file, 0.0, 0.8), ('u2', wav_file, 0.8, 1.4)])
    proc = MfccProcessor(dither=0)
    first = proc.process_all(utts, device='cpu')
    second = proc.process_all(utts, device='cpu')
    for key in first:
        assert np.array_equal(first[key].data, second[key].data)
