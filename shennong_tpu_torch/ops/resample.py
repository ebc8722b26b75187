"""Bandlimited sinc resampling (Kaldi LinearResample /
ArbitraryResample equivalents).

Counterpart of :mod:`shennong_tpu.ops.resample`. Filter matrices and
index grids are built once on the host (numpy, cached); the signal
path is a weighted sum of strided slices for integer decimation ratios
(the pitch tracker's 16k -> 4k) and a gather + dot otherwise. The
reference's TPU-only strided-convolution branch is not ported.
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def filter_func(delta_t, filter_cutoff, num_zeros):
    """Kaldi's windowed-sinc interpolation filter: a sinc at
    ``filter_cutoff`` Hz under a raised-cosine (Hanning) window
    supported on |t| < num_zeros / (2 * filter_cutoff)."""
    delta_t = np.asarray(delta_t, dtype=np.float64)
    width = num_zeros / (2.0 * filter_cutoff)
    window = np.where(
        np.abs(delta_t) < width,
        0.5 * (1 + np.cos(2 * math.pi * filter_cutoff / num_zeros
                          * delta_t)),
        0.0)
    sinc = np.where(
        delta_t != 0,
        np.sin(2 * math.pi * filter_cutoff * delta_t)
        / (math.pi * np.where(delta_t == 0, 1.0, delta_t)),
        2 * filter_cutoff)
    return (window * sinc).astype(np.float64)


def linear_resample_num_samples(nsamples_in, rate_in, rate_out):
    """Output sample count of Kaldi's LinearResample with flush
    (LinearResample::GetNumOutputSamples tick arithmetic)."""
    tick_freq = _lcm(int(rate_in), int(rate_out))
    ticks_per_in = tick_freq // int(rate_in)
    interval = int(nsamples_in) * ticks_per_in
    ticks_per_out = tick_freq // int(rate_out)
    last = interval // ticks_per_out
    if last * ticks_per_out == interval:
        last -= 1
    return last + 1


def _lcm(a, b):
    return a * b // math.gcd(a, b)


@functools.lru_cache(maxsize=None)
def linear_resample_plan(nsamples_in, rate_in, rate_out, filter_cutoff,
                         num_zeros):
    """Precompute (indices, weights, nsamples_out) for a resample.

    indices/weights have shape [nsamples_out, max_taps]; out-of-range
    taps carry zero weight (Kaldi truncates the filter at the signal
    boundaries, equivalent to zero padding).
    """
    nout = linear_resample_num_samples(nsamples_in, rate_in, rate_out)
    width = num_zeros / (2.0 * filter_cutoff)
    times = np.arange(nout, dtype=np.float64) / rate_out

    first = np.ceil((times - width) * rate_in).astype(np.int64)
    max_taps = int(np.floor(2 * width * rate_in)) + 2
    taps = np.arange(max_taps, dtype=np.int64)
    indices = first[:, None] + taps[None, :]

    delta_t = indices / rate_in - times[:, None]
    weights = filter_func(delta_t, filter_cutoff, num_zeros)
    in_range = (indices >= 0) & (indices < nsamples_in)
    weights = np.where(in_range, weights, 0.0) / rate_in
    indices = np.clip(indices, 0, nsamples_in - 1)
    return (indices.astype(np.int64), weights.astype(np.float32), nout)


def linear_resample(signals, nsamples_in_max, rate_in, rate_out,
                    filter_cutoff, num_zeros):
    """Batched bandlimited resample: [B, T_in] -> [B, T_out].

    ``nsamples_in_max`` must equal signals.shape[1] (the padded
    length); per-utterance lengths are the caller's (zero padding is
    exactly Kaldi's truncation of the filter at the signal end).
    Integer decimation ratios sum ``taps`` strided views weighted by
    the one shared filter phase, in the reference's order.
    """
    signals = signals.to(torch.float32)
    indices, weights, nout = linear_resample_plan(
        int(nsamples_in_max), float(rate_in), float(rate_out),
        float(filter_cutoff), int(num_zeros))

    ratio = float(rate_in) / float(rate_out)
    if ratio == int(ratio):
        step = int(ratio)
        width = num_zeros / (2.0 * filter_cutoff)
        first0 = int(np.ceil(-width * rate_in))
        taps_idx = first0 + np.arange(
            int(np.floor(width * rate_in)) - first0 + 1)
        shared = (filter_func(
            taps_idx / rate_in, filter_cutoff, num_zeros)
            / rate_in).astype(np.float32)

        lead = max(0, -first0)
        tail = max(0, int(taps_idx[-1]) + (nout - 1) * step + 1
                   - signals.shape[1])
        padded = F.pad(signals, (lead, tail))

        out = torch.zeros((signals.shape[0], nout), dtype=torch.float32,
                          device=signals.device)
        for d, weight in zip(taps_idx, shared):
            if weight == 0.0:
                continue
            start = lead + int(d)
            sliced = padded[:, start:start + (nout - 1) * step + 1:step]
            out = out + float(weight) * sliced
        return out

    gathered = signals[:, torch.as_tensor(indices, device=signals.device)]
    return torch.einsum(
        'bot,ot->bo', gathered,
        torch.as_tensor(weights, device=signals.device))


def linear_resample_chunked(signal, rate_in, rate_out, filter_cutoff,
                            num_zeros, chunk_samples=1 << 21, *, device):
    """Resample a long 1-D signal in aligned chunks on ``device``.

    Bounds device memory for hour-scale audio: the signal is cut at
    input samples that are multiples of rate_in/gcd (so every chunk's
    outputs land on the global 1/rate_out grid) and each chunk carries
    a halo covering the whole sinc support, zeros beyond the signal
    edges being Kaldi's boundary truncation. For integer decimation
    ratios (the pitch tracker's 16k -> 4k: one shared filter phase,
    summed elementwise in a fixed order) the result is bit-identical to
    :func:`linear_resample` on the whole signal; for other ratios the
    per-chunk filter weights are evaluated at other absolute times,
    leaving last-ulp (< 1e-6) differences. ``signal`` is a 1-D numpy
    array; returns a [nout] float32 numpy array.
    """
    signal = np.ascontiguousarray(signal, dtype=np.float32)
    rate_in_i, rate_out_i = int(rate_in), int(rate_out)
    g = math.gcd(rate_in_i, rate_out_i)
    in_r, out_r = rate_in_i // g, rate_out_i // g
    n = signal.shape[0]
    nout = linear_resample_num_samples(n, rate_in_i, rate_out_i)

    def run(piece):
        out = linear_resample(
            torch.as_tensor(piece, device=device)[None], piece.shape[0],
            float(rate_in), float(rate_out), float(filter_cutoff),
            int(num_zeros))
        return out[0].cpu().numpy()

    width = num_zeros / (2.0 * filter_cutoff)
    extent = int(math.ceil(width * rate_in_i)) + 2
    halo_in = -(-extent // in_r) * in_r
    chunk_in = max(in_r, int(chunk_samples) // in_r * in_r)
    if n <= chunk_in:
        return run(signal)

    halo_out = halo_in // in_r * out_r
    chunk_out = chunk_in // in_r * out_r
    slice_len = chunk_in + 2 * halo_in
    padded = np.zeros(halo_in + n + chunk_in + halo_in, np.float32)
    padded[halo_in:halo_in + n] = signal

    out = np.empty(nout, np.float32)
    start = 0  # global input sample at which the kept range begins
    while start < n:
        # padded[start:start + slice_len] is the global range
        # [start - halo_in, start + chunk_in + halo_in)
        local = run(padded[start:start + slice_len])
        o0 = start // in_r * out_r
        keep = min(chunk_out, nout - o0)
        out[o0:o0 + keep] = local[halo_out:halo_out + keep]
        start += chunk_in
    return out


@functools.lru_cache(maxsize=None)
def arbitrary_resample_matrix(num_samples_in, rate, sample_points,
                              filter_cutoff, num_zeros):
    """Dense [len(sample_points), num_samples_in] resampling matrix
    (Kaldi ArbitraryResample: the filter evaluated at the input sample
    times, truncated to the valid index range)."""
    points = np.asarray(sample_points, dtype=np.float64)
    n = np.arange(num_samples_in, dtype=np.float64)
    delta_t = n[None, :] / rate - points[:, None]
    weights = filter_func(delta_t, filter_cutoff, num_zeros) / rate
    return weights.astype(np.float32)
