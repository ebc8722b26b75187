"""The port's ops (``shennong_tpu_torch.ops``) against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX
function and its PyTorch counterpart on the CPU. Tolerances:

- frame extraction, frame counts, windows and VAD masks: exact;
- processed frames, MFCC and frame energies: max-abs 1e-4 (sums and
  FFTs in another order, float32), relative to the row's largest value
  for the linear and square-root energies;
- the resample: 1e-5 on unit-scale signals;
- pitch: every lag exact, or a tie proven by the float64 oracle's
  path costs (margin 1e-4, tests/pitch_oracle.py);
- pitch post-processing: 1e-3 (cumulative sums in another order);
- deltas and CMVN: 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shennong_tpu.ops import framing as jframing
from shennong_tpu.ops import mel as melmod
from shennong_tpu.ops import pitch as jpitch
from shennong_tpu.ops import postops as jpostops
from shennong_tpu.ops import resample as jresample
from shennong_tpu.ops import spectral as jspectral
from shennong_tpu.parallel import fused as jfused
from shennong_tpu_torch.ops import framing, pitch, postops, resample, spectral
from shennong_tpu_torch.parallel import fused
from tests.pitch_oracle import assert_lag_decisions

torch.set_num_threads(2)


def speech_like(nsamples, seed):
    """Int16 voiced harmonics under a syllabic envelope, plus noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(nsamples) / 16000
    f0 = 110 + 40 * rng.rand() + 25 * np.sin(2 * np.pi * 0.8 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    voiced = sum((0.6 ** k) * np.sin((k + 1) * phase) for k in range(6))
    envelope = (0.5 * (1 + np.sin(2 * np.pi * 3.0 * t))) ** 2
    signal = voiced * envelope + rng.randn(nsamples) * 0.05
    return (signal / np.abs(signal).max() * 20000).astype(np.int16)


def padded_batch(lengths, seed=0):
    """([B, T] int16 zero-padded signals, [B] int32 lengths)"""
    signals = np.zeros((len(lengths), max(lengths)), dtype=np.int16)
    for row, length in enumerate(lengths):
        signals[row, :length] = speech_like(length, seed + row)
    return signals, np.asarray(lengths, dtype=np.int32)


def unit_batch(lengths, seed=0):
    """Unit-scale float32 padded signals, for absolute tolerances"""
    rng = np.random.RandomState(seed)
    signals = np.zeros((len(lengths), max(lengths)), dtype=np.float32)
    for row, length in enumerate(lengths):
        signals[row, :length] = rng.randn(length)
    return signals, np.asarray(lengths, dtype=np.int32)


def frame_opts(**kwargs):
    jax_opts = jframing.FrameOptions(**kwargs)
    return jax_opts, framing.FrameOptions(**kwargs)


# ---------------------------------------------------------------- framing

@pytest.mark.parametrize('window', framing.WINDOW_TYPES)
def test_window_function(window):
    assert np.array_equal(
        framing.window_function(window, 400),
        jframing.window_function(window, 400))


@pytest.mark.parametrize('snip_edges', [True, False])
def test_extract_frames(snip_edges):
    signals, lengths = unit_batch([5000, 3001, 401, 150])
    jopts, opts = frame_opts(snip_edges=snip_edges)
    nframes_max = framing.num_frames(signals.shape[1], opts)
    assert nframes_max == jframing.num_frames(signals.shape[1], jopts)
    ref = np.asarray(jframing.extract_frames(
        jnp.asarray(signals), jnp.asarray(lengths), jopts, nframes_max))
    ours = framing.extract_frames(
        torch.from_numpy(signals), torch.from_numpy(lengths), opts,
        nframes_max).numpy()
    assert ours.shape == ref.shape
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize('options', [
    {}, {'window_type': 'hamming', 'preemph_coeff': 0.0},
    {'remove_dc_offset': False, 'round_to_power_of_two': False}])
def test_process_frames(options):
    signals, lengths = unit_batch([4000, 2500])
    jopts, opts = frame_opts(dither=0.0, **options)
    nframes_max = framing.num_frames(signals.shape[1], opts)
    frames = np.array(jframing.extract_frames(
        jnp.asarray(signals), jnp.asarray(lengths), jopts, nframes_max))
    ref, ref_energy = jframing.process_frames(jnp.asarray(frames), jopts)
    ours, energy = framing.process_frames(torch.from_numpy(frames), opts)
    assert ours.shape == ref.shape
    assert np.abs(ours.numpy() - np.asarray(ref)).max() < 1e-4
    assert np.abs(energy.numpy() - np.asarray(ref_energy)).max() < 1e-4
    assert np.abs(
        framing.windowed_log_energy(ours).numpy()
        - np.asarray(jframing.windowed_log_energy(ref))).max() < 1e-4


def test_dither_is_seeded():
    """The dither comes from the given generator: the same seed gives
    the same frames, another seed others, and the noise is a unit
    gaussian times ``dither``."""
    signals, lengths = unit_batch([16000])
    _, plain = frame_opts(
        dither=0.0, remove_dc_offset=False, preemph_coeff=0.0,
        window_type='rectangular', round_to_power_of_two=False)
    dithered = dataclasses.replace(plain, dither=2.0)
    frames = framing.extract_frames(
        torch.from_numpy(signals), torch.from_numpy(lengths), plain,
        framing.num_frames(16000, plain))

    def run(opts, seed):
        generator = None
        if seed is not None:
            generator = torch.Generator().manual_seed(seed)
        return framing.process_frames(frames, opts, generator=generator)[0]

    first, again, other = run(dithered, 7), run(dithered, 7), run(dithered, 8)
    assert torch.equal(first, again)
    assert not torch.equal(first, other)
    noise = (first - run(plain, None)).numpy().ravel()
    assert abs(noise.std() / 2.0 - 1.0) < 0.02
    assert abs(noise.mean()) < 0.02
    with pytest.raises(ValueError):
        run(dithered, None)


# --------------------------------------------------------------- spectral

def _mfcc_opts(**frame):
    jopts = jspectral.MfccOpts(frame=jframing.FrameOptions(**frame))
    opts = spectral.MfccOpts(frame=framing.FrameOptions(**frame))
    return jopts, opts


@pytest.mark.parametrize('snip_edges', [True, False])
def test_mfcc_batch(snip_edges):
    signals, lengths = padded_batch([16000, 9000, 4000])
    jopts, opts = _mfcc_opts(dither=0.0, snip_edges=snip_edges)
    weights, _ = melmod.mel_banks(23, 512, 16000.0, 20.0, 0.0, 100.0,
                                  -500.0, 1.0)
    nframes_max = framing.num_frames(signals.shape[1], opts.frame)
    ref = np.asarray(jspectral.mfcc_batch(
        jnp.asarray(signals.astype(np.float32)), jnp.asarray(lengths),
        weights, jopts, nframes_max))
    ours = spectral.mfcc_batch(
        torch.from_numpy(signals), torch.from_numpy(lengths), weights,
        opts, nframes_max).numpy()
    for row, length in enumerate(lengths):
        valid = framing.num_frames(int(length), opts.frame)
        assert np.abs(ours[row, :valid] - ref[row, :valid]).max() < 1e-4


@pytest.mark.parametrize('compression', ['log', 'sqrt', 'off'])
def test_energy_batch(compression):
    signals, lengths = padded_batch([12000, 7000])
    frame = dict(dither=0.0, preemph_coeff=0.0, window_type='rectangular')
    jopts = jspectral.EnergyOpts(frame=jframing.FrameOptions(**frame))
    opts = spectral.EnergyOpts(frame=framing.FrameOptions(**frame))
    nframes_max = framing.num_frames(signals.shape[1], opts.frame)
    ref = np.asarray(jspectral.energy_batch(
        jnp.asarray(signals.astype(np.float32)), jnp.asarray(lengths),
        jopts, nframes_max, compression=compression))
    ours = spectral.energy_batch(
        torch.from_numpy(signals), torch.from_numpy(lengths), opts,
        nframes_max, compression=compression).numpy()
    for row, length in enumerate(lengths):
        valid = framing.num_frames(int(length), opts.frame)
        scale = 1.0 if compression == 'log' else np.abs(
            ref[row, :valid]).max()
        assert np.abs(
            ours[row, :valid] - ref[row, :valid]).max() / scale < 1e-4


# --------------------------------------------------------------- resample

@pytest.mark.parametrize('rate_out,cutoff,zeros', [
    (4000.0, 1000.0, 1), (6000.0, 2500.0, 4)])
def test_linear_resample(rate_out, cutoff, zeros):
    signals, _ = unit_batch([8000, 8000])
    ref = np.asarray(jresample.linear_resample(
        jnp.asarray(signals), signals.shape[1], 16000.0, rate_out,
        cutoff, zeros))
    ours = resample.linear_resample(
        torch.from_numpy(signals), signals.shape[1], 16000.0, rate_out,
        cutoff, zeros).numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() < 1e-5


def test_resample_plans():
    for args in [(8000, 16000.0, 4000.0, 1000.0, 1),
                 (7001, 16000.0, 6000.0, 2500.0, 4)]:
        for ours, ref in zip(resample.linear_resample_plan(*args),
                             jresample.linear_resample_plan(*args)):
            assert np.array_equal(ours, ref)
    points = tuple(np.linspace(0.0, 0.01, 17))
    assert np.array_equal(
        resample.arbitrary_resample_matrix(71, 4000.0, points, 2000.0, 5),
        jresample.arbitrary_resample_matrix(71, 4000.0, points, 2000.0, 5))


# ------------------------------------------------------------------ pitch

@pytest.fixture(scope='module')
def pitch_batch():
    """A padded batch of three utterances and the reference pitch."""
    signals, lengths = padded_batch([16000, 11000, 6000], seed=3)
    opts = jpitch.PitchOpts()
    nframes_max = jpitch.num_pitch_frames(signals.shape[1], opts)
    ref = np.array(jpitch.compute_pitch(
        jnp.asarray(signals.astype(np.float32)), jnp.asarray(lengths),
        opts, nframes_max))
    return signals, lengths, nframes_max, ref


def test_compute_pitch(pitch_batch):
    signals, lengths, nframes_max, ref = pitch_batch
    opts = pitch.PitchOpts()
    ours = pitch.compute_pitch(
        torch.from_numpy(signals), torch.from_numpy(lengths), opts,
        nframes_max).numpy()
    assert ours.shape == ref.shape
    for row, length in enumerate(lengths):
        valid = pitch.num_pitch_frames(int(length), opts)
        assert_lag_decisions(
            signals[row, :length].astype(np.float64),
            ours[row, :valid], ref[row, :valid])


def test_pitch_frame_counts():
    lengths = np.array([0, 1, 399, 400, 401, 4000, 22713, 96000, 96003],
                       dtype=np.int32)
    opts = pitch.PitchOpts()
    jopts = jpitch.PitchOpts()
    num_rs = pitch.resampled_lengths(torch.from_numpy(lengths), opts)
    ref_rs = np.asarray(jfused._resampled_len(jnp.asarray(lengths), jopts))
    assert np.array_equal(num_rs.numpy(), ref_rs)
    counts = pitch.pitch_num_frames_device(num_rs, opts).numpy()
    assert np.array_equal(counts, np.asarray(
        jpitch.pitch_num_frames_device(jnp.asarray(ref_rs), jopts)))
    assert list(counts) == [
        jpitch.num_pitch_frames(int(n), jopts) for n in lengths]
    for snip in (True, False):
        jopts, opts = frame_opts(snip_edges=snip)
        assert list(fused.frame_counts(
            torch.from_numpy(lengths), opts).numpy()) == [
                jframing.num_frames(int(n), jopts) for n in lengths]


@pytest.mark.parametrize('delay', [0, 3, -2])
def test_process_pitch(pitch_batch, delay):
    signals, lengths, _, raw = pitch_batch
    opts = pitch.ProcessPitchOpts(delay=delay)
    jopts = jpitch.ProcessPitchOpts(delay=delay)
    nframes = np.asarray(
        [pitch.num_pitch_frames(int(n), pitch.PitchOpts())
         for n in lengths], dtype=np.int32)
    noise = np.random.RandomState(5).randn(*raw.shape[:2]).astype(
        np.float32)
    ref = np.asarray(jpitch.process_pitch(
        jnp.asarray(raw), jnp.asarray(nframes), jopts,
        noise=jnp.asarray(noise)))
    ours = pitch.process_pitch(
        torch.from_numpy(raw), torch.from_numpy(nframes), opts,
        noise=torch.from_numpy(noise)).numpy()
    for row, valid in enumerate(nframes):
        assert np.abs(ours[row, :valid] - ref[row, :valid]).max() < 1e-3


# ---------------------------------------------------------------- postops

@pytest.mark.parametrize('context,mean_scale', [(0, 0.5), (2, 0.0), (3, 1.0)])
def test_vad_energy(context, mean_scale):
    rng = np.random.RandomState(context)
    log_energy = (rng.randn(4, 300) * 4 + 12).astype(np.float32)
    nframes = np.array([300, 250, 1, 0], dtype=np.int32)
    kwargs = dict(energy_threshold=np.float32(5.0),
                  energy_mean_scale=np.float32(mean_scale),
                  frames_context=context,
                  proportion_threshold=np.float32(0.6))
    ref = np.asarray(jpostops.compute_vad_energy(
        jnp.asarray(log_energy), jnp.asarray(nframes), **kwargs))
    ours = postops.compute_vad_energy(
        torch.from_numpy(log_energy), torch.from_numpy(nframes), **kwargs)
    assert ours.dtype == torch.uint8
    for row, valid in enumerate(nframes):
        assert np.array_equal(ours.numpy()[row, :valid], ref[row, :valid])


@pytest.mark.parametrize('order,window', [(1, 2), (2, 2), (2, 3)])
def test_deltas(order, window):
    rng = np.random.RandomState(order * 10 + window)
    feats = rng.randn(3, 80, 13).astype(np.float32) * 10
    nframes = np.array([80, 31, 1], dtype=np.int32)
    ref = np.asarray(jpostops.compute_deltas(
        jnp.asarray(feats), jnp.asarray(nframes), order=order,
        window=window))
    ours = postops.compute_deltas(
        torch.from_numpy(feats), torch.from_numpy(nframes), order=order,
        window=window).numpy()
    arrays = [feats[row, :n] for row, n in enumerate(nframes)]
    host = postops.compute_deltas_host(arrays, order=order, window=window)
    ref_host = jpostops.compute_deltas_host(
        arrays, order=order, window=window)
    for row, valid in enumerate(nframes):
        assert np.abs(ours[row, :valid] - ref[row, :valid]).max() < 1e-5
        assert np.abs(host[row] - ref_host[row]).max() < 1e-5
        assert np.abs(host[row] - ref[row, :valid]).max() < 1e-5


@pytest.mark.parametrize('norm_vars,skip_dims,reverse', [
    (True, None, False), (False, None, False), (True, [0, 3], False),
    (True, None, True)])
def test_cmvn(norm_vars, skip_dims, reverse):
    rng = np.random.RandomState(0)
    feats = (rng.randn(120, 13) * 3 + 2).astype(np.float32)
    weights = (rng.rand(120) > 0.3).astype(np.float32)
    stats = postops.accumulate_cmvn_stats(feats, weights=weights)
    ref_stats = jpostops.accumulate_cmvn_stats(feats, weights=weights)
    assert np.abs(stats - ref_stats).max() < 1e-5
    ours = postops.apply_cmvn(feats, stats, norm_vars=norm_vars,
                              skip_dims=skip_dims, reverse=reverse)
    ref = jpostops.apply_cmvn(feats, ref_stats, norm_vars=norm_vars,
                              skip_dims=skip_dims, reverse=reverse)
    assert ours.dtype == ref.dtype
    assert np.abs(ours - ref).max() < 1e-5
