"""Batched spectrogram, filterbank, MFCC (one warp, or every warp class
at once) and frame-energy computers.

Counterpart of :mod:`shennong_tpu.ops.spectral`: frame gather ->
window processing -> rFFT -> power spectrum -> mel and DCT matmuls ->
liftering and the energy column. The power spectrum is
``torch.fft.rfft``, the reference's non-TPU branch; its TPU-only
DFT-as-matmul branches are not ported.
"""

import dataclasses
import math

import numpy as np
import torch

from shennong_tpu_torch.ops import mel as melmod
from shennong_tpu_torch.ops import framing
from shennong_tpu_torch.ops.framing import FLT_EPSILON, FrameOptions

_SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class SpectrogramOpts:
    frame: FrameOptions = FrameOptions()
    energy_floor: float = 0.0
    raw_energy: bool = True


@dataclasses.dataclass(frozen=True)
class MelOpts:
    num_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0
    vtln_low: float = 100.0
    vtln_high: float = -500.0


@dataclasses.dataclass(frozen=True)
class FbankOpts:
    frame: FrameOptions = FrameOptions()
    mel: MelOpts = MelOpts()
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    htk_compat: bool = False
    use_log_fbank: bool = True
    use_power: bool = True


@dataclasses.dataclass(frozen=True)
class MfccOpts:
    frame: FrameOptions = FrameOptions()
    mel: MelOpts = MelOpts()
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    htk_compat: bool = False


@dataclasses.dataclass(frozen=True)
class EnergyOpts:
    frame: FrameOptions = FrameOptions()
    raw_energy: bool = True
    compression: str = 'log'


def power_spectrum(frames, padded_size):
    """|rfft|^2 of processed frames: [B, F, W] -> [B, F, P//2 + 1]."""
    spectrum = torch.fft.rfft(frames, n=padded_size, dim=-1)
    return spectrum.real ** 2 + spectrum.imag ** 2


def _power_and_energy(signals, nsamples, opts, nframes_max, generator,
                      dtype=torch.float32):
    """Power spectrum and frame log energy (raw, pre-window, or
    windowed according to ``opts.raw_energy``), float32.

    The frame chain and the FFT run in ``dtype``.
    """
    frames = framing.extract_frames(
        signals.to(dtype), nsamples, opts.frame, nframes_max)
    processed, raw_log_energy = framing.process_frames(
        frames, opts.frame, generator=generator)
    if opts.raw_energy:
        log_energy = raw_log_energy
    else:
        log_energy = framing.windowed_log_energy(processed)
    power = power_spectrum(processed, opts.frame.padded_window_size)
    return power.to(torch.float32), log_energy.to(torch.float32)


def _floor_energy(log_energy, energy_floor):
    if energy_floor > 0.0:
        return torch.clamp_min(log_energy, math.log(energy_floor))
    return log_energy


def mel_apply(power, mel_weights):
    """Power spectrum [B, F, P] -> mel energies [B, F, M].

    ``mel_weights`` is a shared [M, P] matrix or per-utterance
    [B, M, P] matrices (per-utterance VTLN warps in one batch), a
    numpy array or a tensor; it moves to the power's device.
    """
    mel = torch.as_tensor(
        mel_weights, dtype=torch.float32, device=power.device)
    subscripts = 'bfp,bmp->bfm' if mel.ndim == 3 else 'bfp,mp->bfm'
    return torch.einsum(subscripts, power, mel)


def spectrogram_batch(signals, nsamples, opts, nframes_max, generator=None):
    """Log power spectrum, column 0 replaced by the frame log energy.

    Output shape [B, nframes_max, padded_window_size // 2 + 1].

    The frame chain (extraction, dither, DC removal, raw energy,
    pre-emphasis, window) and the FFT run in float64; the output is
    float32. Every bin's log is an output, and the log of a low bin of
    a near-silent frame amplifies float32 rounding: a float32 FFT
    (cuFFT's reached 1.0e-3 against Kaldi's float64 arithmetic on
    tests/data/test.wav, at the Nyquist bin) and a float32 frame
    chain (1.06e-3 on a signal that opens with near-digital silence)
    both missed Kaldi's 1e-3. The dither is still drawn in float32, so
    seeded runs keep their noise. Filterbank, MFCC, PLP and energy keep
    the float32 chain: their mel sums and DCT average the low bins'
    error away, and they hold Kaldi's 1e-3 as they are.
    """
    power, log_energy = _power_and_energy(
        signals, nsamples, opts, nframes_max, generator,
        dtype=torch.float64)
    feats = torch.log(torch.clamp_min(power, FLT_EPSILON))
    feats[..., 0] = _floor_energy(log_energy, opts.energy_floor)
    return feats


def fbank_batch(signals, nsamples, mel_weights, opts, nframes_max,
                generator=None):
    """Mel filterbank features, optional energy column.

    Output dim is num_bins (+1 with energy); the energy column sits
    first, or last in HTK-compatible mode. ``mel_weights`` is as in
    :func:`mel_apply`.
    """
    power, log_energy = _power_and_energy(
        signals, nsamples, opts, nframes_max, generator)
    if not opts.use_power:
        power = torch.sqrt(power)

    mel_energies = mel_apply(power, mel_weights)
    if opts.use_log_fbank:
        mel_energies = torch.log(torch.clamp_min(mel_energies, FLT_EPSILON))

    if not opts.use_energy:
        return mel_energies

    log_energy = _floor_energy(log_energy, opts.energy_floor)[..., None]
    if opts.htk_compat:
        return torch.cat([mel_energies, log_energy], dim=-1)
    return torch.cat([log_energy, mel_energies], dim=-1)


def mfcc_batch(signals, nsamples, mel_weights, opts, nframes_max,
               generator=None):
    """MFCC features [B, nframes_max, num_ceps].

    ``mel_weights`` is as in :func:`mel_apply`. Pipeline:
    frames -> rFFT -> power -> mel matmul -> log -> DCT-II matmul ->
    cepstral lifter -> energy/C0 handling -> HTK reorder.
    """
    device = signals.device
    power, log_energy = _power_and_energy(
        signals, nsamples, opts, nframes_max, generator)

    log_mel = torch.log(torch.clamp_min(
        mel_apply(power, mel_weights), FLT_EPSILON))

    dct = torch.as_tensor(
        melmod.dct_matrix(opts.num_ceps, opts.mel.num_bins),
        dtype=torch.float32, device=device)
    feats = torch.einsum('bfm,cm->bfc', log_mel, dct)

    if opts.cepstral_lifter != 0.0:
        feats = feats * torch.as_tensor(
            melmod.lifter_coeffs(opts.cepstral_lifter, opts.num_ceps),
            dtype=torch.float32, device=device)

    if opts.use_energy:
        feats[..., 0] = _floor_energy(log_energy, opts.energy_floor)

    if opts.htk_compat:
        first = feats[..., :1]
        if not opts.use_energy:
            first = first * _SQRT2  # C0 scaling for HTK
        feats = torch.cat([feats[..., 1:], first], dim=-1)

    return feats


def mfcc_multi_warp_batch(signals, nsamples, mel_weights, opts,
                          nframes_max, generator=None):
    """MFCC for every VTLN warp class in one pass.

    ``mel_weights`` is a [C, M, P] stack of warped mel banks: the
    framing and the FFT run once and only the mel application fans out
    over the classes (LVTLN base-transform training). Output
    [C, B, nframes_max, num_ceps].
    """
    device = signals.device
    power, log_energy = _power_and_energy(
        signals, nsamples, opts, nframes_max, generator)

    mel = torch.as_tensor(mel_weights, dtype=torch.float32, device=device)
    log_mel = torch.log(torch.clamp_min(
        torch.einsum('bfp,cmp->cbfm', power, mel), FLT_EPSILON))

    dct = torch.as_tensor(
        melmod.dct_matrix(opts.num_ceps, opts.mel.num_bins),
        dtype=torch.float32, device=device)
    feats = torch.einsum('cbfm,km->cbfk', log_mel, dct)

    if opts.cepstral_lifter != 0.0:
        feats = feats * torch.as_tensor(
            melmod.lifter_coeffs(opts.cepstral_lifter, opts.num_ceps),
            dtype=torch.float32, device=device)

    if opts.use_energy:
        feats[..., 0] = _floor_energy(log_energy, opts.energy_floor)

    if opts.htk_compat:
        first = feats[..., :1]
        if not opts.use_energy:
            first = first * _SQRT2
        feats = torch.cat([feats[..., 1:], first], dim=-1)

    return feats


def energy_batch(signals, nsamples, opts, nframes_max, compression='log',
                 generator=None):
    """Frame energies [B, nframes_max] with 'log', 'sqrt' or 'off'
    compression (``raw_energy`` is encoded in ``opts`` by the caller:
    no pre-emphasis and a rectangular window)."""
    frames = framing.extract_frames(
        signals, nsamples, opts.frame, nframes_max)
    processed, _ = framing.process_frames(
        frames, opts.frame, generator=generator)
    # floor with the smallest float32 normal, as the reference does
    energy = torch.clamp_min(
        (processed * processed).sum(dim=-1),
        float(np.finfo(np.float32).tiny))
    if compression == 'log':
        return torch.log(energy)
    if compression == 'sqrt':
        return torch.sqrt(energy)
    return energy
