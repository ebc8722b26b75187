"""Counterpart of ``tests/processor/test_parallel.py``: the port's
batched extraction (``process_all``) equal to the sequential one, with
the JAX cases' inputs and bounds (2e-4, pitch 1e-4).

``test_sharded_mesh`` and ``test_default_mesh_pipeline`` have no
counterpart: the port has no device mesh (``tests/test_torch_api.py:
EXEMPT``, ``parallel.mesh`` and ``parallel:set_default_mesh``).
"""

import numpy as np
import pytest

from shennong_tpu_torch import Utterances
from shennong_tpu_torch.processor import (
    EnergyProcessor, FilterbankProcessor, KaldiPitchProcessor,
    MfccProcessor, PlpProcessor, SpectrogramProcessor)


@pytest.fixture(scope='module')
def utterances(wav_file):
    return Utterances([
        ('u1', wav_file, 'spk1', 0.0, 0.4),
        ('u2', wav_file, 'spk1', 0.4, 1.0),
        ('u3', wav_file, 'spk2', 1.0, 1.4),
        ('u4', wav_file, 'spk2', 0.1, 1.3)])


@pytest.mark.parametrize('cls', [
    MfccProcessor, FilterbankProcessor, SpectrogramProcessor,
    PlpProcessor, EnergyProcessor])
def test_batched_equals_sequential(utterances, cls):
    proc = cls(dither=0)
    batched = proc.process_all(utterances, device='cpu')

    for utt in utterances:
        single = proc.process(utt.load_audio(), device='cpu')
        assert batched[utt.name].shape == single.shape
        assert np.allclose(
            batched[utt.name].data, single.data, atol=2e-4), cls


def test_pitch_batched_equals_sequential(utterances):
    proc = KaldiPitchProcessor()
    batched = proc.process_all(utterances, device='cpu')
    for utt in utterances:
        single = proc.process(utt.load_audio(), device='cpu')
        assert batched[utt.name].shape == single.shape
        assert np.allclose(
            batched[utt.name].data, single.data, atol=1e-4)


def test_vtln_warps_batched(utterances):
    proc = MfccProcessor(dither=0)
    warps = {'u1': 0.9, 'u2': 1.0, 'u3': 1.1, 'u4': 1.05}
    batched = proc.process_all(utterances, vtln_warp=warps, device='cpu')
    for utt in utterances:
        single = proc.process(
            utt.load_audio(), vtln_warp=warps[utt.name], device='cpu')
        assert np.allclose(
            batched[utt.name].data, single.data, atol=2e-4)
        assert batched[utt.name].properties['mfcc']['vtln_warp'] == \
            warps[utt.name]


def test_kwargs_validation(utterances):
    proc = MfccProcessor(dither=0)
    with pytest.raises(ValueError, match='is not a dict'):
        proc.process_all(utterances, vtln_warp=1.0, device='cpu')
    with pytest.raises(ValueError, match='different names'):
        proc.process_all(
            utterances, vtln_warp={'u1': 1.0}, device='cpu')


def test_njobs_values(utterances):
    proc = MfccProcessor(dither=0)
    out1 = proc.process_all(utterances, njobs=1, device='cpu')
    out2 = proc.process_all(utterances, njobs=2, device='cpu')
    assert out1.is_close(out2)
    with pytest.raises(ValueError, match='strictly positive'):
        proc.process_all(utterances, njobs=0, device='cpu')


def test_sample_rate_checked(utterances):
    proc = MfccProcessor(sample_rate=8000, dither=0)
    with pytest.raises(ValueError, match='mismatch in sample rates'):
        proc.process_all(utterances, device='cpu')
