"""The port's PLP / RASTA-PLP path against the JAX package.

Inputs are made with numpy from a seed, every random source is 0, and
the same inputs go through ``shennong_tpu`` and ``shennong_tpu_torch``
on the CPU. Tolerances (max-abs):

- ``rasta_filter``: 1e-5 against the JAX scan and against the float64
  streaming ``RastaFilter``, on log-mel inputs of speech magnitude;
- ``durbin`` and ``lpc_to_cepstrum``: 1e-5;
- ``plp_batch``: 1e-4 (FFT and sums in another order, float32);
- the processor on tests/data/test.wav: 1e-3 against
  ``golden_real.npz`` and ``tests/kaldi_oracle.py``;
- the pipeline (PLP with RASTA, Kaldi pitch, CMVN, deltas): 1e-3 against
  ``shennong_tpu.pipeline.extract_features``.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shennong_tpu import pipeline as jpipeline
from shennong_tpu.audio import Audio as JAudio
from shennong_tpu.ops import framing as jframing
from shennong_tpu.ops import mel as melmod
from shennong_tpu.ops import plp as jplp
from shennong_tpu.processor import plp as jplp_processor
from shennong_tpu.utterances import Utterances as JUtterances
from shennong_tpu_torch import pipeline
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.ops import framing, plp, spectral
from shennong_tpu_torch.processor.plp import PlpProcessor, RastaFilter
from shennong_tpu_torch.utils import dict_equal
from shennong_tpu_torch.utterances import Utterances
from tests import kaldi_oracle
from tests.test_torch_ops import padded_batch
# fixtures: 4 utterances of 2 speakers, the energy VAD without dither
from tests.test_torch_pipeline import corpus, no_energy_dither  # noqa: F401

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_WAV = os.path.join(REPO, 'tests', 'data', 'test.wav')


@pytest.fixture(scope='module')
def log_mel():
    """[2, 2000, 23] float32 log-mel energies of speech-like signals
    (values from about 5 to 25, like real speech)."""
    signals, lengths = padded_batch([16000 * 20 + 240] * 2, seed=11)
    opts = spectral.MfccOpts(frame=framing.FrameOptions(dither=0.0))
    power, _ = spectral._power_and_energy(
        torch.from_numpy(signals), torch.from_numpy(lengths), opts, 2000,
        None)
    weights, _ = melmod.mel_banks(
        23, 512, 16000.0, 20.0, 0.0, 100.0, -500.0, 1.0)
    mel = spectral.mel_apply(power, weights)
    return torch.log(mel + float(np.finfo(np.float32).eps)).numpy()


# ------------------------------------------------------------------ RASTA

@pytest.mark.parametrize('nframes', [1, 4, 5, 130, 2000])
def test_rasta_filter(log_mel, nframes):
    x = np.ascontiguousarray(log_mel[:, :nframes])
    ref = np.asarray(jplp.rasta_filter(jnp.asarray(x)))
    ours = plp.rasta_filter(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() < 1e-5
    for row in range(x.shape[0]):
        streaming = RastaFilter(23)
        host = np.stack([
            streaming.filter(frame, do_log=False) for frame in x[row]])
        assert np.abs(ours[row] - host).max() < 1e-5


@pytest.mark.parametrize('block', [1, 7, 128])
def test_rasta_filter_blocks(log_mel, block, monkeypatch):
    """The block size changes the order of the sums only."""
    x = torch.from_numpy(np.ascontiguousarray(log_mel[:, :300]))
    monkeypatch.setattr(plp, 'RASTA_BLOCK', 300)
    ref = plp.rasta_filter(x).numpy()
    monkeypatch.setattr(plp, 'RASTA_BLOCK', block)
    ours = plp.rasta_filter(x).numpy()
    assert np.abs(ours - ref).max() < 1e-5


def test_rasta_filter_masks_padding(log_mel):
    """A non-finite padded frame reaches no valid frame; the valid
    frames equal the filter of the unpadded rows."""
    x = log_mel[:, :300].copy()
    nframes = np.array([300, 120], dtype=np.int32)
    x[1, 120:] = np.nan
    x[1, 250] = np.inf
    ours = plp.rasta_filter(
        torch.from_numpy(x), torch.from_numpy(nframes)).numpy()
    assert np.isfinite(ours).all()
    alone = plp.rasta_filter(torch.from_numpy(
        np.ascontiguousarray(log_mel[1:, :120]))).numpy()
    assert np.array_equal(ours[1, :120], alone[0])


def test_rasta_warm_up_gives_ones():
    """Rows of at most 4 valid frames filter to zeros, ones after the
    exp, as the reference's warm-up and RastaFilter emit: with unit
    equal-loudness weights every mel energy is one, a flat spectrum,
    and the cepstrum is zero."""
    signals, lengths = padded_batch([960, 640, 16000])
    nframes = [framing.num_frames(int(n), framing.FrameOptions())
               for n in lengths]
    assert nframes[:2] == [4, 2]
    weights, _ = melmod.mel_banks(
        23, 512, 16000.0, 20.0, 0.0, 100.0, -500.0, 1.0)
    opts = plp.PlpOpts(frame=framing.FrameOptions(dither=0.0), rasta=True,
                       use_energy=False, cepstral_lifter=0.0)
    feats = plp.plp_batch(
        torch.from_numpy(signals), torch.from_numpy(lengths), weights,
        np.ones(23, dtype=np.float32), opts, nframes[2]).numpy()
    for row, valid in enumerate(nframes[:2]):
        assert np.abs(feats[row, :valid, 1:]).max() < 1e-5
    assert np.abs(feats[2, 4:, 1:]).max() > 0.1
    streaming = RastaFilter(23)
    out = [streaming.filter(np.full(23, 2.0)) for _ in range(4)]
    assert np.array_equal(np.stack(out), np.ones((4, 23)))


def test_rasta_streaming_filter_matches_reference():
    rng = np.random.RandomState(0)
    mel = np.abs(rng.randn(30, 23)) + 0.1
    ours, ref = RastaFilter(23), jplp_processor.RastaFilter(23)
    for frame in mel:
        assert np.array_equal(ours.filter(frame), ref.filter(frame))
    with pytest.raises(ValueError, match='shape'):
        RastaFilter(23).filter(np.zeros(7))


# ----------------------------------------------------------- LPC recursions

@pytest.mark.parametrize('order', [4, 12])
def test_durbin_and_cepstrum(order):
    """Autocorrelations of compressed mel spectra, half of them flat
    and half with one dominant bin, whose recursion hits the 1e-5
    clamp on the prediction-error factor (checked in float64 here)."""
    rng = np.random.RandomState(order)
    mel = np.abs(rng.randn(64, 25)) + 0.05
    mel[32:] = np.abs(rng.randn(32, 25)) * 1e-9
    mel[np.arange(32, 64), rng.randint(2, 23, 32)] = 1.0
    idft = melmod.idft_bases(order + 1, 25).astype(np.float64)
    autocorr = (mel @ idft.T).astype(np.float32)

    lpc, energy = plp.durbin(torch.from_numpy(autocorr), order)
    ref_lpc, ref_energy = jplp.durbin(jnp.asarray(autocorr), order)
    cepstrum = plp.lpc_to_cepstrum(lpc, order).numpy()
    ref = np.asarray(jplp.lpc_to_cepstrum(ref_lpc, order))
    # a peak too sharp for float32 overflows in both packages alike
    finite = np.isfinite(np.asarray(ref_energy))
    assert finite.sum() >= 40
    assert np.array_equal(np.isfinite(energy.numpy()), finite)
    assert np.abs(lpc.numpy()[finite] - np.asarray(ref_lpc)[finite]).max() \
        < 1e-5
    assert np.abs(
        energy.numpy()[finite] - np.asarray(ref_energy)[finite]).max() < 1e-5
    assert np.abs(cepstrum[finite] - ref[finite]).max() < 1e-5
    assert sum(_clamped(row, order) for row in autocorr[finite]) > 0


def _clamped(autocorr, order):
    """Whether the float64 Durbin recursion of one autocorrelation
    vector floors its prediction-error factor at 1e-5."""
    autocorr = autocorr.astype(np.float64)
    energy, lpc, hit = autocorr[0], [], False
    for i in range(order):
        ki = (autocorr[i + 1] + sum(
            lpc[j] * autocorr[i - j] for j in range(i))) / energy
        hit |= 1.0 - ki * ki < 1.0e-5
        energy *= max(1.0 - ki * ki, 1.0e-5)
        lpc = [lpc[j] - ki * lpc[i - j - 1] for j in range(i)] + [-ki]
    return hit


# -------------------------------------------------------------- plp_batch

@pytest.mark.parametrize('options,per_row_eql', [
    ({}, False),
    ({'rasta': True}, False),
    ({'rasta': True, 'htk_compat': True}, False),
    ({'use_energy': False}, False),
    ({'rasta': True, 'use_energy': False, 'raw_energy': False}, True),
    ({'cepstral_lifter': 0.0, 'cepstral_scale': 2.0,
      'energy_floor': 1e3}, True),
])
def test_plp_batch(options, per_row_eql):
    signals, lengths = padded_batch([16000, 9000, 2000, 900])
    frame = dict(dither=0.0)
    jopts = jplp.PlpOpts(frame=jframing.FrameOptions(**frame), **options)
    opts = plp.PlpOpts(frame=framing.FrameOptions(**frame), **options)
    weights, centers = melmod.mel_banks(
        23, 512, 16000.0, 20.0, 0.0, 100.0, -500.0, 1.0)
    eql = melmod.equal_loudness_vector(centers)
    if per_row_eql:
        eql = np.stack([eql * (1.0 + 0.1 * row) for row in range(4)])
    nframes_max = framing.num_frames(signals.shape[1], opts.frame)
    ref = np.asarray(jplp.plp_batch(
        jnp.asarray(signals.astype(np.float32)), jnp.asarray(lengths),
        jnp.asarray(weights), jnp.asarray(eql), jopts, nframes_max))
    ours = plp.plp_batch(
        torch.from_numpy(signals), torch.from_numpy(lengths), weights, eql,
        opts, nframes_max).numpy()
    assert ours.shape == ref.shape
    for row, length in enumerate(lengths):
        valid = framing.num_frames(int(length), opts.frame)
        assert np.isfinite(ours[row, :valid]).all()
        assert np.abs(ours[row, :valid] - ref[row, :valid]).max() < 1e-4


# -------------------------------------------------------------- processor

def test_processor_params_and_options():
    ours, ref = PlpProcessor(rasta=True), jplp_processor.PlpProcessor(
        rasta=True)
    assert ours.get_params() == ref.get_params()
    assert dataclasses_equal(ours.options(), ref.options())
    assert np.array_equal(ours.equal_loudness(1.1), ref.equal_loudness(1.1))
    with pytest.raises(ValueError, match='num_ceps <= lpc_order'):
        PlpProcessor(lpc_order=10, num_ceps=12)


def dataclasses_equal(ours, ref):
    import dataclasses
    return dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize('name,rasta', [('plp', False), ('rastaplp', True)])
def test_processor_golden_and_oracle(name, rasta):
    audio = Audio.load(REAL_WAV)
    golden = np.load(os.path.join(REPO, 'tests', 'data', 'golden_real.npz'))
    ours = PlpProcessor(dither=0, rasta=rasta).process(audio, device='cpu')
    assert ours.shape == golden[name].shape
    assert np.abs(ours.data - golden[name]).max() < 1e-3
    oracle = kaldi_oracle.plp(audio.data.astype(np.float64), rasta=rasta)
    assert np.abs(ours.data - oracle).max() < 1e-3
    ref = jplp_processor.PlpProcessor(dither=0, rasta=rasta).process(
        JAudio.load(REAL_WAV))
    assert np.abs(ours.data - ref.data).max() < 1e-4
    assert dict_equal(ours.properties, ref.properties)


def test_processor_vtln_warp():
    audio = Audio.load(REAL_WAV)
    ours = PlpProcessor(dither=0).process(audio, 1.1, device='cpu').data
    oracle = kaldi_oracle.plp(audio.data.astype(np.float64), vtln=1.1)
    assert np.abs(ours - oracle).max() < 1e-3


# --------------------------------------------------------------- pipeline

def test_rasta_plp_pitch_slice_matches_reference(corpus, no_energy_dither):
    """RASTA-PLP + Kaldi pitch + CMVN + deltas: 42 columns, 1e-3."""
    config = pipeline.get_default_config(
        'plp', with_pitch='kaldi', with_cmvn=True, with_delta=True)
    config['plp']['rasta'] = True
    config['plp']['dither'] = 0
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    ref = jpipeline.extract_features(
        copy.deepcopy(config), JUtterances(corpus))
    ours = pipeline.extract_features(
        copy.deepcopy(config), Utterances(corpus), device='cpu')
    assert list(ours.keys()) == list(ref.keys())
    for name in ref:
        assert ours[name].shape == ref[name].shape, name
        assert ours[name].shape[1] == 42
        assert np.abs(ours[name].data - ref[name].data).max() < 1e-3, name
        assert np.array_equal(ours[name].times, ref[name].times)
        props, ref_props = (copy.deepcopy(f.properties)
                            for f in (ours[name], ref[name]))
        # sums over the group's frames of features equal at 1e-4 (the
        # features of test_plp_batch): means equal at 1e-4
        stats, ref_stats = (p['cmvn'].pop('stats') for p in (props, ref_props))
        assert stats[0, -1] == ref_stats[0, -1]
        assert np.abs(stats - ref_stats).max() / stats[0, -1] < 1e-4
        assert dict_equal(props, ref_props), name
