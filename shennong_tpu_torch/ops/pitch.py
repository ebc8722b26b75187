"""Kaldi pitch tracker (Ghahremani & Povey 2014), batched in PyTorch.

Counterpart of :mod:`shennong_tpu.ops.pitch`:

- bandlimited downsampling to the analysis rate,
- NCCF over integer lags via FFT cross-correlation (the reference's
  non-TPU branch; its TPU-only DFT-as-matmul branch is not ported),
- lag upsampling onto the geometric lag grid as one matmul,
- the Viterbi lag selection (:mod:`shennong_tpu_torch.ops.cuda_viterbi`:
  CUDA kernels for CUDA tensors, the plain version for CPU tensors),
- pitch post-processing (POV mapping, POV-weighted moving-window mean
  subtraction, noised delta) as windowed prefix-sum ops.
"""

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from shennong_tpu_torch.ops import cuda_viterbi, resample

#: the plain Viterbi, counterpart of ``shennong_tpu.ops.pitch._viterbi_lags``
_viterbi_lags = cuda_viterbi.viterbi_lags_plain


@dataclasses.dataclass(frozen=True)
class PitchOpts:
    """Static options of the pitch extractor (Kaldi
    PitchExtractionOptions)."""
    sample_rate: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    soft_min_f0: float = 10.0
    penalty_factor: float = 0.1
    lowpass_cutoff: float = 1000.0
    resample_freq: float = 4000.0
    delta_pitch: float = 0.005
    nccf_ballast: float = 7000.0
    lowpass_filter_width: int = 1
    upsample_filter_width: int = 5
    snip_edges: bool = True

    @property
    def frame_shift_samples(self):
        """Frame shift at the analysis rate"""
        return int(self.resample_freq * 0.001 * self.frame_shift_ms)

    @property
    def window_size_samples(self):
        """NCCF window size at the analysis rate"""
        return int(self.resample_freq * 0.001 * self.frame_length_ms)

    @property
    def first_lag(self):
        return int(math.ceil(self.resample_freq / self.max_f0))

    @property
    def last_lag(self):
        return int(math.floor(self.resample_freq / self.min_f0))


@dataclasses.dataclass(frozen=True)
class ProcessPitchOpts:
    """Static options of the pitch post-processor (Kaldi
    ProcessPitchOptions)."""
    pitch_scale: float = 2.0
    pov_scale: float = 2.0
    pov_offset: float = 0.0
    delta_pitch_scale: float = 10.0
    delta_pitch_noise_stddev: float = 0.005
    normalization_left_context: int = 75
    normalization_right_context: int = 75
    delta_window: int = 2
    delay: int = 0
    add_pov_feature: bool = True
    add_normalized_log_pitch: bool = True
    add_delta_pitch: bool = True
    add_raw_log_pitch: bool = False


@functools.lru_cache(maxsize=None)
def select_lags(min_f0, max_f0, delta_pitch):
    """The geometric grid of candidate lags, in seconds."""
    lags = []
    lag = 1.0 / max_f0
    while lag <= 1.0 / min_f0:
        lags.append(lag)
        lag *= 1.0 + delta_pitch
    return np.asarray(lags, dtype=np.float64)


def num_pitch_frames(nsamples, opts):
    """Frames produced for ``nsamples`` input samples (Kaldi
    NumFramesAvailable with the input finished)."""
    num_rs = resample.linear_resample_num_samples(
        nsamples, opts.sample_rate, opts.resample_freq)
    shift = opts.frame_shift_samples
    length = opts.window_size_samples
    if num_rs < length:
        return 0
    if not opts.snip_edges:
        return int(num_rs / shift + 0.5)
    return (num_rs - length) // shift + 1


@functools.lru_cache(maxsize=None)
def _energy_band(width, window_size, first_lag, last_lag):
    """0/1 matrix [width, 1 + nlags] summing the first window
    (column 0) and each lag-shifted window (columns 1+)."""
    nlags = last_lag + 1 - first_lag
    band = np.zeros((width, 1 + nlags), dtype=np.float32)
    band[:window_size, 0] = 1.0
    for k, lag in enumerate(range(first_lag, last_lag + 1)):
        band[lag:lag + window_size, 1 + k] = 1.0
    return band


def _nccf_correlations(windows, window_size, first_lag, last_lag):
    """Inner products and energies for the NCCF.

    ``windows`` is [B, F, W] (W = window_size + last_lag) with the
    mean of the first ``window_size`` samples already removed.
    Returns (inner [B, F, nlags], e1 [B, F], e2 [B, F, nlags]).
    """
    device = windows.device
    width = windows.shape[-1]
    energies = torch.einsum(
        'bfw,wk->bfk', windows * windows,
        torch.as_tensor(_energy_band(width, window_size, first_lag,
                                     last_lag), device=device))
    e1 = energies[..., 0]
    e2 = energies[..., 1:]

    # cross-correlation inner[lag] = sum_i w1[i] * w[i + lag] by FFT
    fft_size = 1 << (width - 1).bit_length()
    w1 = torch.where(
        torch.arange(width, device=device) < window_size, windows, 0.0)
    spec_w = torch.fft.rfft(windows, n=fft_size, dim=-1)
    spec_w1 = torch.fft.rfft(w1, n=fft_size, dim=-1)
    corr = torch.fft.irfft(spec_w * torch.conj(spec_w1), n=fft_size, dim=-1)
    inner = corr[..., first_lag:last_lag + 1]
    return inner, e1, e2


def resampled_lengths(nsamples, opts):
    """Per-utterance resampled lengths [B] int32 (Kaldi's tick
    arithmetic: last = floor(n * out / in), decremented when exact,
    plus one), through n = q * in_r + r so nothing overflows int32."""
    gcd = math.gcd(int(opts.sample_rate), int(opts.resample_freq))
    out_r = int(opts.resample_freq) // gcd
    in_r = int(opts.sample_rate) // gcd
    n32 = nsamples.to(torch.int32)
    quot = torch.div(n32, in_r, rounding_mode='floor')
    rem = n32 - quot * in_r
    last = quot * out_r + torch.div(rem * out_r, in_r, rounding_mode='floor')
    exact = (rem * out_r) % in_r == 0
    return (last - exact.to(torch.int32) + 1).to(torch.int32)


def compute_pitch(signals, nsamples, opts, nframes_max):
    """Batched Kaldi pitch: [B, T] signals -> [B, F, 2] (NCCF, pitch).

    ``signals`` are int16-range samples padded to a common length,
    ``nsamples`` the true per-utterance sample counts.
    """
    # 1. downsample to the analysis rate
    resampled = resample.linear_resample(
        signals, signals.shape[1], opts.sample_rate, opts.resample_freq,
        opts.lowpass_cutoff, opts.lowpass_filter_width)
    num_rs = resampled_lengths(nsamples, opts)

    # zero out the padding of the resampled signal
    t = torch.arange(resampled.shape[1], device=resampled.device)[None, :]
    resampled = torch.where(t < num_rs[:, None], resampled, 0.0)

    # mean square over the real samples (for the NCCF ballast)
    denom = torch.clamp_min(num_rs.to(torch.float32), 1.0)
    mean = resampled.sum(dim=1) / denom
    mean_square = (resampled * resampled).sum(dim=1) / denom - mean * mean

    nframes = pitch_num_frames_device(num_rs, opts)
    return pitch_from_resampled(
        resampled, nframes, mean_square, opts, nframes_max)


def pitch_from_resampled(resampled, nframes, mean_square, opts,
                         nframes_max):
    """NCCF + Viterbi lag selection on an already-resampled signal.

    ``resampled`` is [B, R] at ``opts.resample_freq`` with zeros
    beyond each row's valid samples, ``nframes`` the per-row valid
    frame counts (frames past it are Viterbi pass-through) and
    ``mean_square`` the per-row ballast statistic. Returns
    [B, nframes_max, 2].
    """
    device = resampled.device
    shift = opts.frame_shift_samples
    window_size = opts.window_size_samples
    first_lag, last_lag = opts.first_lag, opts.last_lag
    full_window = window_size + last_lag

    # 2. outer windows start at multiples of the shift: strided views
    # of the zero-padded resampled buffer (the zeros beyond each
    # utterance are Kaldi's zero padding of tail windows)
    needed = max(nframes_max - 1, 0) * shift + full_window
    if resampled.shape[1] < needed:
        resampled = F.pad(resampled, (0, needed - resampled.shape[1]))
    windows = resampled.unfold(1, full_window, shift)[:, :nframes_max]

    # subtract the mean of the first window_size samples (Kaldi
    # ComputeCorrelation's zero_mean_wave)
    windows = windows - windows[..., :window_size].mean(
        dim=-1, keepdim=True)

    # 3. NCCF at integer lags
    inner, e1, e2 = _nccf_correlations(
        windows, window_size, first_lag, last_lag)
    norm = e1[..., None] * e2
    ballast = ((mean_square * window_size) ** 2
               * opts.nccf_ballast)[:, None, None]
    nccf_pitch = torch.where(
        norm + ballast > 0.0,
        inner / torch.sqrt(torch.clamp_min(norm + ballast, 1e-30)), 0.0)
    nccf_pov = torch.where(
        norm > 0.0, inner / torch.sqrt(torch.clamp_min(norm, 1e-30)), 0.0)

    # 4. upsample the NCCF onto the geometric lag grid
    lags = select_lags(opts.min_f0, opts.max_f0, opts.delta_pitch)
    lags_offset = tuple(
        float(l - first_lag / opts.resample_freq) for l in lags)
    upsample = torch.as_tensor(resample.arbitrary_resample_matrix(
        last_lag + 1 - first_lag, opts.resample_freq, lags_offset,
        opts.resample_freq * 0.5, opts.upsample_filter_width),
        device=device)
    nccf_pitch_rs = torch.einsum('bfl,gl->bfg', nccf_pitch, upsample)

    # 5. Viterbi lag selection
    lags_f32 = torch.as_tensor(lags, dtype=torch.float32, device=device)
    local_cost = (
        1.0 - nccf_pitch_rs
        + opts.soft_min_f0 * lags_f32[None, None, :] * nccf_pitch_rs)
    inter_frame_factor = (
        opts.penalty_factor * math.log(1.0 + opts.delta_pitch) ** 2)
    best = cuda_viterbi.viterbi_lags(
        local_cost, inter_frame_factor, nframes).to(torch.int64)

    # 6. (NCCF, pitch); the POV-ballast NCCF is only needed at the
    # selected lag, so its upsampling evaluates one matrix row per frame
    pitch = 1.0 / lags_f32[best]
    rows = upsample[best]  # [B, F, nlags_int]
    nccf_out = (nccf_pov * rows).sum(dim=-1)
    return torch.stack([nccf_out, pitch], dim=-1)


def pitch_num_frames_device(num_rs, opts):
    """Per-utterance frame counts from resampled lengths (tensor
    counterpart of :func:`num_pitch_frames`)."""
    shift = opts.frame_shift_samples
    length = opts.window_size_samples
    if not opts.snip_edges:
        nframes = (num_rs.to(torch.float32) / shift + 0.5).to(torch.int32)
    else:
        nframes = torch.div(num_rs - length, shift,
                            rounding_mode='floor') + 1
    return torch.clamp_min(
        torch.where(num_rs < length, 0, nframes), 0).to(torch.int32)


# ---------------------------------------------------------------- post

def _nccf_to_pov(nccf):
    """Probability of voicing from NCCF (Kaldi NccfToPov)."""
    ndash = torch.clamp_max(torch.abs(nccf), 1.0)
    r = (-5.2 + 5.4 * torch.exp(7.5 * (ndash - 1.0)) + 4.8 * ndash
         - 2.0 * torch.exp(-10.0 * ndash)
         + 4.2 * torch.exp(20.0 * (ndash - 1.0)))
    return 1.0 / (1.0 + torch.exp(-r))


def _nccf_to_pov_feature(nccf):
    """Warped NCCF feature (Kaldi NccfToPovFeature)."""
    n = torch.clamp(nccf, -1.0, 1.0)
    return torch.pow(1.0001 - n, 0.15) - 1.0


def process_pitch(raw_pitch, nframes, opts, noise=None):
    """Turn raw (NCCF, pitch) into trainable features.

    ``raw_pitch`` is [B, F, 2]; returns [B, F, ndims] with columns
    (pov_feature, normalized_log_pitch, delta_pitch, raw_log_pitch)
    filtered by the ``add_*`` flags. ``noise`` optionally supplies the
    [B, F] standard gaussian noise added to the delta (scaled by
    ``delta_pitch_noise_stddev``).
    """
    from shennong_tpu_torch.ops.postops import compute_deltas

    bsz, maxframes, _ = raw_pitch.shape
    device = raw_pitch.device
    nccf = raw_pitch[..., 0]
    pitch = raw_pitch[..., 1]

    t = torch.arange(maxframes, dtype=torch.int64, device=device)[None, :]
    n = nframes.to(torch.int64)[:, None]
    valid = t < n

    # the frame delay, clamped to the valid frame range so a negative
    # delay repeats the last real frame
    if opts.delay != 0:
        delayed = torch.minimum(
            torch.clamp_min(t - opts.delay, 0), torch.clamp_min(n - 1, 0))
        delayed = delayed.expand(bsz, maxframes)
        nccf = torch.gather(nccf, 1, delayed)
        pitch = torch.gather(pitch, 1, delayed)

    log_pitch = torch.log(torch.clamp_min(pitch, 1e-10))
    columns = []

    if opts.add_pov_feature:
        columns.append(
            opts.pov_scale * _nccf_to_pov_feature(nccf) + opts.pov_offset)

    if opts.add_normalized_log_pitch:
        pov = torch.where(valid, _nccf_to_pov(nccf), 0.0)
        weighted = pov * torch.where(valid, log_pitch, 0.0)
        zeros = pov.new_zeros((bsz, 1))
        cpov = torch.cat([zeros, torch.cumsum(pov, dim=1)], dim=1)
        cwlp = torch.cat([zeros, torch.cumsum(weighted, dim=1)], dim=1)
        begin = torch.clamp_min(
            t - opts.normalization_left_context, 0).expand(bsz, maxframes)
        end = torch.minimum(
            t + opts.normalization_right_context + 1, n)
        sum_pov = torch.gather(cpov, 1, end) - torch.gather(cpov, 1, begin)
        sum_wlp = torch.gather(cwlp, 1, end) - torch.gather(cwlp, 1, begin)
        avg = sum_wlp / torch.clamp_min(sum_pov, 1e-20)
        columns.append((log_pitch - avg) * opts.pitch_scale)

    if opts.add_delta_pitch:
        delta = compute_deltas(
            log_pitch[..., None], nframes, order=1,
            window=opts.delta_window)[..., 1]
        if noise is not None:
            delta = delta + noise * opts.delta_pitch_noise_stddev
        columns.append(delta * opts.delta_pitch_scale)

    if opts.add_raw_log_pitch:
        columns.append(log_pitch)

    return torch.stack(columns, dim=-1)
