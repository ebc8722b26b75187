"""The vectorised float64 reference against the frozen per-frame
oracles, at a small size on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench.manifest import HERE
from perfbench.reference import kaldi_oracle, pitch_oracle
from perfbench.reference.frontend import FrontEnd, deltas, vad
from perfbench.reference.pitch import Pitch, post


def pipeline_config(name):
    with open(os.path.join(HERE, 'configs', f'{name}.json')) as handle:
        return json.load(handle)['pipeline']


@pytest.fixture(scope='module')
def signal():
    rng = np.random.default_rng(0)
    t = np.arange(8000) / 16000
    wave = 3000 * np.sin(2 * np.pi * 150 * t * (1 + 0.1 * t))
    return (wave + rng.normal(0, 300, 8000)).astype(np.int16).astype(
        np.float64)


def test_mfcc_deltas_and_vad_match_the_oracle(signal):
    config = pipeline_config('mfcc_pitch')
    feats, energy = FrontEnd('mfcc', config['mfcc'], 16000, 'cpu')(
        torch.tensor(signal))
    oracle = kaldi_oracle.mfcc(signal)
    assert feats.shape == oracle.shape
    np.testing.assert_allclose(feats.numpy(), oracle, rtol=0, atol=1e-10)
    np.testing.assert_allclose(
        deltas(feats, 2, 2).numpy(), kaldi_oracle.compute_deltas(oracle),
        rtol=0, atol=1e-10)
    np.testing.assert_array_equal(
        vad(energy, config['cmvn']['vad']).numpy(),
        kaldi_oracle.vad_energy(oracle))


@pytest.mark.parametrize('rasta', [True, False])
def test_plp_matches_the_oracle(signal, rasta):
    options = dict(pipeline_config('rastaplp_pitch')['plp'], rasta=rasta)
    feats, _ = FrontEnd('plp', options, 16000, 'cpu')(torch.tensor(signal))
    oracle = kaldi_oracle.plp(signal, rasta=rasta,
                              compress=options['compress_factor'])
    np.testing.assert_allclose(feats.numpy(), oracle, rtol=0, atol=1e-10)


def test_pitch_and_post_match_the_oracle(signal):
    config = pipeline_config('mfcc_pitch')['pitch']
    raw = Pitch(config, 16000, 'cpu').raw([torch.tensor(signal)])[0].numpy()
    oracle = pitch_oracle.compute_pitch(signal)
    assert raw.shape == oracle.shape
    np.testing.assert_allclose(raw, oracle, rtol=1e-12, atol=1e-12)
    processed = post(torch.tensor(oracle), config['postprocessing']).numpy()
    np.testing.assert_allclose(
        processed, pitch_oracle.process_pitch(oracle), rtol=0, atol=1e-12)


def test_batched_viterbi_equals_one_at_a_time(signal):
    """Shorter sequences decoded beside a longer one keep their own
    paths."""
    pitch = Pitch(pipeline_config('mfcc_pitch')['pitch'], 16000, 'cpu')
    signals = [torch.tensor(signal), torch.tensor(signal[:5000]),
               torch.tensor(signal[1000:4200])]
    together = pitch.raw(signals)
    for sig, raw in zip(signals, together):
        np.testing.assert_array_equal(raw.numpy(),
                                      pitch.raw([sig])[0].numpy())


def test_dither_moves_the_reference_and_is_seeded(signal):
    front = FrontEnd('mfcc', pipeline_config('mfcc_pitch')['mfcc'], 16000,
                     'cpu')
    x = torch.tensor(signal)
    plain, _ = front(x)
    one, _ = front(x, (1.0, torch.Generator().manual_seed(3)))
    two, _ = front(x, (1.0, torch.Generator().manual_seed(3)))
    assert torch.equal(one, two)
    gap = (one - plain).abs().max()
    assert 0 < gap < 1.0


@pytest.mark.gpu
def test_the_card_decodes_as_the_cpu(signal):
    """The reference on the card (its Viterbi replayed as CUDA graphs)
    gives the CPU's lags and float64 values."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    config = pipeline_config('mfcc_pitch')['pitch']
    signals = [torch.tensor(signal), torch.tensor(signal[:6000])]
    cpu = Pitch(config, 16000, 'cpu').raw(signals)
    card = Pitch(config, 16000, 'cuda').raw([s.cuda() for s in signals])
    for a, b in zip(cpu, card):
        np.testing.assert_array_equal(a[:, 1].numpy(), b[:, 1].cpu().numpy())
        np.testing.assert_allclose(a.numpy(), b.cpu().numpy(), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize('context', [0, 2, 5])
def test_the_vad_with_context_matches_the_oracle(context):
    energy = np.random.default_rng(1).normal(10, 3, 200)
    options = {'frames_context': context, 'energy_threshold': 5.0,
               'energy_mean_scale': 0.5, 'proportion_threshold': 0.6}
    np.testing.assert_array_equal(
        vad(torch.tensor(energy), options).numpy(),
        kaldi_oracle.vad_energy(energy[:, None], frames_context=context))
