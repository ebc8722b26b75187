"""Randomized option fuzzing of the port against the Kaldi oracles.

Counterpart of ``tests/test_fuzz_parity.py``, case for case: the same
signals (its ``_random_signal``), seeds and option draws go through the
port's processors and ops on the CPU and are held against the literal
oracles ``tests/kaldi_oracle.py`` and ``tests/pitch_oracle.py`` with the
same bounds: max-abs 1e-3, every pitch lag exact or a tie proven by the
float64 oracle's path costs, framing bit-equal to Kaldi's while-loop.
On the CPU the port's pitch runs the plain versions of its Viterbi
kernels; ``chip_smoke.py``'s ``pitch options`` phase runs the same
lag counts (133 to 417) through the kernels on the card.
"""

import numpy as np
import pytest
import torch

from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.features import Features
from shennong_tpu_torch.ops import framing, pitch
from shennong_tpu_torch.postprocessor.cmvn import (
    SlidingWindowCmvnPostProcessor)
from shennong_tpu_torch.processor import MfccProcessor, PlpProcessor

from tests import kaldi_oracle, pitch_oracle
from tests.test_fuzz_parity import _random_signal

torch.set_num_threads(2)


@pytest.mark.parametrize('seed', range(8))
def test_mfcc_fuzz(seed):
    rng = np.random.RandomState(seed)
    audio = Audio(_random_signal(rng), 16000)

    kwargs = dict(
        dither=0,
        frame_shift=float(rng.choice([0.008, 0.01, 0.015])),
        frame_length=float(rng.choice([0.02, 0.025, 0.032])),
        preemph_coeff=float(rng.choice([0.0, 0.9, 0.97])),
        remove_dc_offset=bool(rng.randint(2)),
        window_type=str(rng.choice(
            ['povey', 'hamming', 'hanning', 'blackman'])),
        snip_edges=bool(rng.randint(2)),
        num_bins=int(rng.choice([15, 23, 30])),
        low_freq=float(rng.choice([20, 60, 120])),
        high_freq=float(rng.choice([0, -200, 7000])),
        num_ceps=int(rng.choice([10, 13])),
        use_energy=bool(rng.randint(2)),
        raw_energy=bool(rng.randint(2)),
        cepstral_lifter=float(rng.choice([0.0, 22.0])),
        htk_compat=bool(rng.randint(2)))

    ours = MfccProcessor(**kwargs).process(audio, device='cpu').data
    ref = kaldi_oracle.mfcc(
        audio.data.astype(np.float64),
        shift_s=kwargs['frame_shift'], length_s=kwargs['frame_length'],
        preemph=kwargs['preemph_coeff'],
        remove_dc=kwargs['remove_dc_offset'],
        window_type=kwargs['window_type'],
        snip_edges=kwargs['snip_edges'], num_bins=kwargs['num_bins'],
        low=kwargs['low_freq'], high=kwargs['high_freq'],
        num_ceps=kwargs['num_ceps'], use_energy=kwargs['use_energy'],
        raw_energy=kwargs['raw_energy'],
        cepstral_lifter=kwargs['cepstral_lifter'],
        htk_compat=kwargs['htk_compat'])
    assert ours.shape == ref.shape, kwargs
    assert np.max(np.abs(ours - ref)) < 1e-3, kwargs


@pytest.mark.parametrize('seed', range(4))
def test_plp_fuzz(seed):
    rng = np.random.RandomState(100 + seed)
    audio = Audio(_random_signal(rng), 16000)

    kwargs = dict(
        dither=0,
        rasta=bool(rng.randint(2)),
        num_bins=int(rng.choice([17, 23])),
        lpc_order=int(rng.choice([10, 12])),
        use_energy=bool(rng.randint(2)),
        compress_factor=float(rng.choice([1 / 3, 0.25])),
        cepstral_lifter=float(rng.choice([0.0, 22.0])))
    kwargs['num_ceps'] = int(
        rng.randint(5, kwargs['lpc_order'] + 2))

    ours = PlpProcessor(**kwargs).process(audio, device='cpu').data
    ref = kaldi_oracle.plp(
        audio.data.astype(np.float64),
        rasta=kwargs['rasta'], num_bins=kwargs['num_bins'],
        lpc_order=kwargs['lpc_order'], num_ceps=kwargs['num_ceps'],
        use_energy=kwargs['use_energy'],
        compress=kwargs['compress_factor'],
        cepstral_lifter=kwargs['cepstral_lifter'])
    assert ours.shape == ref.shape, kwargs
    assert np.max(np.abs(ours - ref)) < 1e-3, kwargs


@pytest.mark.parametrize('seed', range(4))
def test_pitch_fuzz(seed):
    """Random pitch option combinations against the literal oracle:
    every lag decision identical, or provably a tie (the float64
    min-cost path through our lag within 1e-4 of the optimum). The
    draws of ``min_f0``, ``max_f0`` and ``delta_pitch`` give the
    Viterbi between 133 and 417 lags."""
    rng = np.random.RandomState(200 + seed)
    sig = _random_signal(rng, nsamples=9600).astype(np.float64)

    kwargs = dict(
        min_f0=float(rng.choice([50.0, 80.0])),
        max_f0=float(rng.choice([300.0, 400.0])),
        soft_min_f0=float(rng.choice([5.0, 10.0])),
        penalty_factor=float(rng.choice([0.05, 0.1, 0.2])),
        delta_pitch=float(rng.choice([0.005, 0.01])),
        nccf_ballast=float(rng.choice([1000.0, 7000.0])))

    opts = pitch.PitchOpts(**kwargs)
    fmax = pitch.num_pitch_frames(9600, opts)
    ours = pitch.compute_pitch(
        torch.from_numpy(sig[None].astype(np.float32)),
        torch.tensor([9600], dtype=torch.int32), opts, fmax)[0].numpy()
    ref = pitch_oracle.compute_pitch(sig, **kwargs)
    assert ours.shape == ref.shape, kwargs

    same = pitch_oracle.assert_lag_decisions(sig, ours, ref, **kwargs)
    if not same.all():
        assert same.mean() > 0.99, (kwargs, same.mean())


@pytest.mark.parametrize('seed', range(6))
def test_sliding_cmvn_fuzz(seed):
    """Random sliding-CMVN window geometries against the oracle."""
    rng = np.random.RandomState(300 + seed)
    nframes = int(rng.randint(5, 400))
    data = rng.randn(nframes, int(rng.randint(2, 20))) * 10
    feats = Features(
        data, np.arange(nframes, dtype=float)[:, None] * [1, 1] * 0.01)

    kwargs = dict(
        center=bool(rng.randint(2)),
        cmn_window=int(rng.randint(3, 700)),
        normalize_variance=bool(rng.randint(2)))
    kwargs['min_window'] = int(rng.randint(1, kwargs['cmn_window'] + 1))

    ours = SlidingWindowCmvnPostProcessor(**kwargs).process(
        feats, device='cpu')
    ref = kaldi_oracle.sliding_window_cmn(
        data.astype(np.float64), **kwargs)
    assert ours.shape == ref.shape, kwargs
    assert np.max(np.abs(ours.data - ref)) < 1e-3, kwargs


@pytest.mark.parametrize('seed', range(4))
def test_process_pitch_fuzz(seed):
    """Random pitch post-processing options against the oracle."""
    rng = np.random.RandomState(400 + seed)
    nframes = int(rng.randint(20, 300))
    raw = np.stack([
        rng.uniform(-1, 1, nframes),           # NCCF
        rng.uniform(60, 350, nframes)], axis=1)  # pitch Hz

    kwargs = dict(
        pitch_scale=float(rng.choice([1.0, 2.0])),
        pov_scale=float(rng.choice([1.0, 2.0])),
        pov_offset=float(rng.choice([0.0, -0.5])),
        delta_pitch_scale=float(rng.choice([5.0, 10.0])),
        normalization_left_context=int(rng.randint(10, 100)),
        normalization_right_context=int(rng.randint(10, 100)),
        delta_window=int(rng.randint(1, 5)),
        delay=int(rng.randint(0, 4)),
        add_pov_feature=True, add_normalized_log_pitch=True,
        add_delta_pitch=True, add_raw_log_pitch=bool(rng.randint(2)))

    opts = pitch.ProcessPitchOpts(delta_pitch_noise_stddev=0.0, **kwargs)
    ours = pitch.process_pitch(
        torch.from_numpy(raw[None].astype(np.float32)),
        torch.tensor([nframes], dtype=torch.int32), opts)[0].numpy()
    ref = pitch_oracle.process_pitch(
        raw,
        pitch_scale=kwargs['pitch_scale'],
        pov_scale=kwargs['pov_scale'],
        pov_offset=kwargs['pov_offset'],
        delta_pitch_scale=kwargs['delta_pitch_scale'],
        left=kwargs['normalization_left_context'],
        right=kwargs['normalization_right_context'],
        delta_window=kwargs['delta_window'],
        delay=kwargs['delay'],
        add_pov=True, add_norm=True, add_delta=True,
        add_raw=kwargs['add_raw_log_pitch'])
    assert ours.shape == ref.shape, kwargs
    assert np.abs(ours - ref).max() < 1e-3, (
        kwargs, np.abs(ours - ref).max())


def kaldi_frame(signal, first, length):
    """One frame by Kaldi's edge reflection: the actual while-loop, not
    a bounded number of rounds (short signals under long windows reflect
    more than once)."""
    nsamples = len(signal)
    ref = np.empty(length, np.float32)
    for k in range(length):
        i = first + k
        while i < 0 or i >= nsamples:
            i = -i - 1 if i < 0 else 2 * nsamples - 1 - i
        ref[k] = signal[i]
    return ref


def port_frames(signal, opts, nframes):
    """The port's frames of one utterance, zero-padded to the frames'
    extent as the batched path pads it."""
    nsamples = len(signal)
    padded = np.zeros(max(nsamples, (nframes - 1) * opts.window_shift
                          + opts.window_size), dtype=np.float32)
    padded[:nsamples] = signal
    return framing.extract_frames(
        torch.from_numpy(padded[None]),
        torch.tensor([nsamples], dtype=torch.int32), opts, nframes)[0].numpy()


@pytest.mark.parametrize('seed', range(8))
def test_framing_fuzz(seed):
    """Random frame geometries: the port's framing equals a literal
    numpy reimplementation of Kaldi NumFrames/first_sample."""
    rng = np.random.RandomState(500 + seed)
    rate = 16000.0
    shift_ms = float(rng.choice([5.0, 7.0, 10.0, 25.0, 50.0]))
    length_ms = float(rng.choice([10.0, 20.0, 25.0, 31.0, 40.0]))
    snip = bool(rng.randint(2))
    nsamples = int(rng.randint(50, 9000))

    opts = framing.FrameOptions(
        sample_rate=rate, frame_shift_ms=shift_ms,
        frame_length_ms=length_ms, dither=0.0, snip_edges=snip)
    shift, length = opts.window_shift, opts.window_size

    if snip:
        expected = 0 if nsamples < length else 1 + (
            nsamples - length) // shift
    else:
        expected = (nsamples + shift // 2) // shift
    nf = framing.num_frames(nsamples, opts)
    assert nf == expected, (shift_ms, length_ms, snip, nsamples)
    if nf == 0:
        return

    signal = rng.randn(nsamples).astype(np.float32) * 100
    frames = port_frames(signal, opts, nf)
    for t in rng.choice(nf, size=min(nf, 5), replace=False):
        first = (t * shift if snip
                 else t * shift + shift // 2 - length // 2)
        assert np.array_equal(frames[t], kaldi_frame(signal, first, length)), (
            shift_ms, length_ms, snip, nsamples, t)


def test_framing_reflection_beyond_two_rounds():
    """An 80-sample utterance under the default 400-sample window
    (snip_edges=False) needs more than two reflection rounds at the
    frame edges; the port's reflection must match Kaldi's while-loop
    exactly for every sample of every frame."""
    nsamples = 80
    opts = framing.FrameOptions(dither=0.0, snip_edges=False)
    shift, length = opts.window_shift, opts.window_size
    nf = framing.num_frames(nsamples, opts)
    assert nf >= 1

    rng = np.random.RandomState(3)
    signal = rng.randn(nsamples).astype(np.float32) * 100
    frames = port_frames(signal, opts, nf)
    for t in range(nf):
        first = t * shift + shift // 2 - length // 2
        np.testing.assert_array_equal(
            frames[t], kaldi_frame(signal, first, length), err_msg=str(t))
