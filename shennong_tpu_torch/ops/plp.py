"""Batched PLP / RASTA-PLP computer.

Counterpart of :mod:`shennong_tpu.ops.plp`: power spectrum -> mel ->
optional RASTA filter -> equal-loudness -> power-law compression ->
IDFT to autocorrelations -> Levinson-Durbin LPC -> LPC-to-cepstrum ->
liftering, over a padded utterance batch.

The Durbin and cepstrum recursions are unrolled over the (small) LPC
order in the reference's order of operations. The reference runs the
RASTA filter as a ``lax.scan`` over frames; here it is the scan's
closed form (:func:`rasta_filter`): a 5-tap FIR followed by the
first-order IIR computed in blocks of frames, with no Python loop over
frames.

The RASTA filter and the Durbin + cepstrum recursions run under the
profiler spans ``plp.rasta`` and ``plp.durbin``
(:func:`torch.profiler.record_function`), which cost nothing
measurable when no profiler runs.
"""

import dataclasses
import math

import numpy as np
import torch

from shennong_tpu_torch.ops import mel as melmod
from shennong_tpu_torch.ops import spectral
from shennong_tpu_torch.ops.framing import FrameOptions, frame_counts
from shennong_tpu_torch.ops.spectral import MelOpts

DBL_EPSILON = float(np.finfo(np.float64).eps)

# RASTA bandpass filter: numerator [-2..2]/sum(j^2), denominator [1, -0.94]
_RASTA_NUM = (-np.arange(-2, 3) / np.sum(np.arange(-2, 3) ** 2)).astype(
    np.float32)
_RASTA_DEN1 = -0.94  # a1 coefficient

# frames per block of the blocked IIR in rasta_filter
RASTA_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class PlpOpts:
    frame: FrameOptions = FrameOptions()
    mel: MelOpts = MelOpts()
    rasta: bool = False
    lpc_order: int = 12
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 1.0 / 3.0
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0
    htk_compat: bool = False


def _lfilter_zi_fir(num):
    """scipy.signal.lfilter_zi for a pure-FIR filter: steady-state
    direct-form-II-transposed state for a unit step input."""
    # z[i] = sum of taps after position i
    return np.cumsum(num[::-1])[::-1][1:].astype(np.float32)


def _decay_powers(decay, exponents):
    """``decay ** exponents`` in float64, rounded to float32 (made on
    the exponents' device: no host-to-device copy)."""
    return torch.pow(decay, exponents.to(torch.float64)).to(torch.float32)


def rasta_filter(log_mel, nframes=None):
    """RASTA filtering in the log domain.

    ``log_mel`` is [B, F, M]. The first four output frames are zero
    (the reference emits zeros while buffering the warm-up frames).
    ``nframes`` [B], when given, marks frames at and after each row's
    count as padding: they are set to 0 before filtering, so a
    non-finite padded frame cannot reach a valid one.

    The reference's frame-recursive filter forgets its initial state
    within the four warm-up frames, so for t >= 4 its output is the
    closed form ``y_t = sum_{s=4..t} 0.94^(t-s) v_s`` of the 5-tap FIR
    ``v_s = sum_k num_k x_(s-k)``. The FIR is two weighted frame
    differences; the IIR runs in blocks of ``RASTA_BLOCK`` frames, one
    batched matmul by the [block, block] decay matrix for every block
    at once, then a carry of the last output from block to block (a
    loop over F / block blocks, on [B, M] tensors).
    """
    bsz, total, nbins = log_mel.shape
    if total <= 4:
        return torch.zeros_like(log_mel)
    x = log_mel
    if nframes is not None:
        t = torch.arange(total, device=x.device)
        valid = t[None, :, None] < nframes.to(torch.int64)[:, None, None]
        x = torch.where(valid, x, 0.0)

    steps = total - 4
    # the taps are antisymmetric (num_k = -num_(4-k), num_2 = 0): the
    # FIR is two weighted differences of nearby frames, which cancel
    # with less rounding than five products of the larger log-mels
    fir = (float(_RASTA_NUM[0]) * (x[:, 4:] - x[:, :steps])
           + float(_RASTA_NUM[1]) * (x[:, 3:3 + steps] - x[:, 1:1 + steps]))

    decay = float(np.float32(-_RASTA_DEN1))
    block = min(RASTA_BLOCK, steps)
    nblocks = -(-steps // block)
    fir = torch.nn.functional.pad(fir, (0, 0, 0, nblocks * block - steps))
    fir = fir.reshape(bsz, nblocks, block, nbins)
    # [block, block] lower-triangular decay ** (i - j)
    index = torch.arange(block, device=x.device)
    lags = index[:, None] - index[None, :]
    decays = torch.where(
        lags >= 0, _decay_powers(decay, lags.clamp_min(0)), 0.0)
    local = torch.matmul(decays, fir)

    # carry[n] is the output just before block n
    carries = [torch.zeros_like(local[:, 0, 0])]
    for previous in range(nblocks - 1):
        carries.append(
            local[:, previous, -1] + decay ** block * carries[-1])
    carry = torch.stack(carries, dim=1)[:, :, None, :]
    powers = _decay_powers(decay, index + 1)[None, None, :, None]
    ys = (local + powers * carry).reshape(bsz, nblocks * block, nbins)

    return torch.cat(
        [torch.zeros_like(x[:, :4]), ys[:, :steps]], dim=1)


def durbin(autocorr, order):
    """Levinson-Durbin recursion, unrolled over ``order``.

    ``autocorr`` is [..., order+1]; returns (lpc [..., order],
    residual_energy [...]). Matches Kaldi's Durbin routine including
    the 1e-5 floor on the prediction-error update factor, in the
    reference's float32 order of operations.
    """
    energy = autocorr[..., 0]
    lpc = []
    for i in range(order):
        ki = autocorr[..., i + 1]
        for j in range(i):
            ki = ki + lpc[j] * autocorr[..., i - j]
        ki = ki / energy
        clamp = torch.clamp_min(1.0 - ki * ki, 1.0e-5)
        energy = energy * clamp
        new_lpc = [lpc[j] - ki * lpc[i - j - 1] for j in range(i)]
        new_lpc.append(-ki)
        lpc = new_lpc
    return torch.stack(lpc, dim=-1), energy


def lpc_to_cepstrum(lpc, order):
    """Kaldi Lpc2Cepstrum, unrolled."""
    cepstrum = []
    for i in range(order):
        acc = 0.0
        for j in range(i):
            acc = acc + (i - j) * lpc[..., j] * cepstrum[i - j - 1]
        cepstrum.append(-lpc[..., i] - acc / (i + 1))
    return torch.stack(cepstrum, dim=-1)


def plp_batch(signals, nsamples, mel_weights, equal_loudness, opts,
              nframes_max, generator=None):
    """PLP features [B, nframes_max, num_ceps].

    ``mel_weights`` is [M, P] or per-utterance [B, M, P] and
    ``equal_loudness`` [M] or [B, M], numpy arrays or tensors; both
    move to the signals' device. Padded frames may hold NaN (0/0 in
    the Durbin recursion); valid frames never depend on them.
    """
    device = signals.device
    power, log_energy = spectral._power_and_energy(
        signals, nsamples, opts, nframes_max, generator)
    mel_energies = spectral.mel_apply(power, mel_weights)

    if opts.rasta:
        log_mel = torch.log(mel_energies + float(np.finfo(np.float32).eps))
        with torch.profiler.record_function('plp.rasta'):
            filtered = rasta_filter(
                log_mel, frame_counts(nsamples, opts.frame))
        mel_energies = torch.exp(filtered)

    equal_loudness = torch.as_tensor(
        equal_loudness, dtype=torch.float32, device=device)
    if equal_loudness.ndim == 2:
        equal_loudness = equal_loudness[:, None, :]
    mel_energies = mel_energies * equal_loudness
    mel_energies = torch.pow(mel_energies, opts.compress_factor)

    # duplicate first and last mel bins, then IDFT to autocorrelations
    duplicated = torch.cat([
        mel_energies[..., :1], mel_energies, mel_energies[..., -1:]],
        dim=-1)
    idft = torch.as_tensor(
        melmod.idft_bases(opts.lpc_order + 1, opts.mel.num_bins + 2),
        device=device)
    autocorr = torch.einsum('bfm,cm->bfc', duplicated, idft)

    with torch.profiler.record_function('plp.durbin'):
        lpc, residual = durbin(autocorr, opts.lpc_order)
        cepstrum = lpc_to_cepstrum(lpc, opts.lpc_order)
    # Kaldi's ComputeLpc returns 0.5 * log(E), which the reference
    # floors with DBL epsilon in the LOG domain
    residual_log_energy = torch.clamp_min(
        0.5 * torch.log(residual), DBL_EPSILON)

    feats = torch.cat([
        residual_log_energy[..., None],
        cepstrum[..., :opts.num_ceps - 1]], dim=-1)

    if opts.cepstral_lifter != 0.0:
        feats = feats * torch.as_tensor(melmod.lifter_coeffs(
            opts.cepstral_lifter, opts.num_ceps), device=device)
    if opts.cepstral_scale != 1.0:
        feats = feats * opts.cepstral_scale

    if opts.use_energy:
        if opts.energy_floor > 0.0:
            log_energy = torch.clamp_min(
                log_energy, math.log(opts.energy_floor))
        feats[..., 0] = log_energy

    if opts.htk_compat:
        # plain rotation with NO sqrt(2) energy scaling: PLP differs
        # from MFCC here, in the reference as in Kaldi
        feats = torch.cat([feats[..., 1:], feats[..., :1]], dim=-1)

    return feats
