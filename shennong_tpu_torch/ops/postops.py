"""Batched post-processing ops: deltas, CMVN, sliding CMVN, energy VAD.

Counterpart of :mod:`shennong_tpu.ops.postops`. Deltas are
shifted-weighted sums with Kaldi's polynomial-fit coefficients (on a
device in :func:`compute_deltas`, in numpy on the host in
:func:`compute_deltas_host`), CMVN statistics and their application
are float64 host math, sliding-window CMVN takes its window statistics
from float64 prefix sums on the device, and the energy VAD is a windowed vote
on the device.
"""

import functools
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from shennong_tpu_torch.ops.framing import bucket_size


def batch_ragged(arrays, minimum=128, batch_rows=16):
    """Group ragged [T_i, D] matrices into padded masked batches.

    Yields (indices, stacked [B, bucket, D] float32 numpy, nframes [B]
    int32 numpy) with indices into ``arrays``; grouping is by (frame
    bucket, dim), so each batch holds matrices of similar lengths.
    Padding rows carry one zero frame.
    """
    groups = {}
    for index, data in enumerate(arrays):
        key = (bucket_size(data.shape[0], minimum=minimum),
               data.shape[1])
        groups.setdefault(key, []).append(index)

    for (bucket, dim), indices in sorted(groups.items()):
        for start in range(0, len(indices), batch_rows):
            chunk = indices[start:start + batch_rows]
            rows = (batch_rows if len(indices) > batch_rows
                    else len(chunk))
            stacked = np.zeros((rows, bucket, dim), dtype=np.float32)
            nframes = np.ones(rows, dtype=np.int32)
            for row, index in enumerate(chunk):
                data = arrays[index]
                stacked[row, :data.shape[0]] = data
                nframes[row] = data.shape[0]
            yield chunk, stacked, nframes


def pad_frame_axis(data, minimum=128):
    """Pad a [nframes, dim] matrix to a frame-count bucket: returns
    (padded [1, bucket, dim] float32, nframes [1] int32), numpy."""
    nframes = data.shape[0]
    bucket = bucket_size(nframes, minimum=minimum)
    padded = np.zeros((1, bucket, data.shape[1]), dtype=np.float32)
    padded[0, :nframes] = data
    return padded, np.array([nframes], dtype=np.int32)


# ------------------------------------------------------------------- deltas

@functools.lru_cache(maxsize=None)
def delta_scales(order, window):
    """Kaldi's polynomial-fit delta coefficients for every order.

    Returns a tuple of float32 numpy vectors; scales[k] has length
    2*k*window + 1 and computes the k-th order derivative by
    correlation with the (edge-replicated) feature sequence.
    """
    scales = [np.array([1.0])]
    for i in range(1, order + 1):
        prev = scales[i - 1]
        prev_offset = (len(prev) - 1) // 2
        cur_offset = prev_offset + window
        cur = np.zeros(len(prev) + 2 * window)
        normalizer = 0.0
        for j in range(-window, window + 1):
            normalizer += j * j
            for k in range(-prev_offset, prev_offset + 1):
                cur[j + k + cur_offset] += j * prev[k + prev_offset]
        scales.append(cur / normalizer)
    return tuple(s.astype(np.float32) for s in scales)


def compute_deltas(feats, nframes, order=2, window=2):
    """Append time derivatives: [B, T, D] -> [B, T, (order+1)*D].

    Edges replicate the first/last *valid* frame of each utterance
    (``nframes`` gives the true frame counts; frames beyond are
    padding and do not leak into valid outputs).
    """
    bsz, maxframes, dim = feats.shape
    max_offset = order * window

    # replicate the last valid frame into the padding, then the edges
    idx = torch.arange(maxframes, device=feats.device)[None, :]
    last = (nframes.to(torch.int64) - 1)[:, None]
    clamped = torch.clamp_min(torch.minimum(idx, last), 0)
    feats = torch.gather(
        feats, 1, clamped[:, :, None].expand(bsz, maxframes, dim))
    padded = F.pad(feats.transpose(1, 2), (max_offset, max_offset),
                   mode='replicate').transpose(1, 2)

    outputs = []
    for k, scale in enumerate(delta_scales(order, window)):
        offset = k * window
        acc = torch.zeros_like(feats)
        for j, coeff in enumerate(scale):
            start = max_offset + j - offset  # shift in [-offset, offset]
            acc = acc + float(coeff) * padded[:, start:start + maxframes]
        outputs.append(acc)
    return torch.cat(outputs, dim=-1)


def compute_deltas_host(arrays, order=2, window=2):
    """Time derivatives of many [T_i, D] matrices on the host (numpy,
    float32), the twin of :func:`compute_deltas`: same filters, same
    edge replication. Returns the [T_i, (order+1)*D] float32 outputs
    in order."""
    scales = delta_scales(order, window)
    max_offset = order * window
    outputs = []
    for data in arrays:
        data = np.asarray(data, dtype=np.float32)
        nframes, ndim = data.shape
        if nframes == 0:
            outputs.append(np.zeros((0, (order + 1) * ndim), np.float32))
            continue
        padded = np.concatenate([
            np.repeat(data[:1], max_offset, axis=0), data,
            np.repeat(data[-1:], max_offset, axis=0)])
        out = np.empty((nframes, (order + 1) * ndim), np.float32)
        for k, scale in enumerate(scales):
            offset = k * window
            block = out[:, k * ndim:(k + 1) * ndim]
            for j, coeff in enumerate(scale):
                start = max_offset + j - offset
                term = padded[start:start + nframes] * np.float32(coeff)
                if j == 0:
                    block[...] = term
                else:
                    block += term
        outputs.append(out)
    return outputs


# --------------------------------------------------------------------- CMVN

def accumulate_cmvn_stats(feats, weights=None):
    """CMVN statistics of one features matrix, Kaldi layout.

    Returns a [2, dim+1] float64 array: row 0 = per-dim weighted sums
    with the total weight in the last column, row 1 = weighted sums of
    squares (last column zero).
    """
    feats = np.asarray(feats, dtype=np.float64)
    nframes, dim = feats.shape
    if weights is None:
        weights = np.ones(nframes)
    weights = np.asarray(weights, dtype=np.float64)

    stats = np.zeros((2, dim + 1))
    stats[0, :dim] = weights @ feats
    stats[1, :dim] = weights @ (feats * feats)
    stats[0, dim] = weights.sum()
    return stats


def cmvn_affine(stats, norm_vars=True, skip_dims=None):
    """The per-dim affine ``(scale, offset)`` (float64) of accumulated
    CMVN statistics, :func:`apply_cmvn` applies ``x * scale + offset``.

    A non-positive variance floors to 1e-20 with a warning and a
    non-finite scale raises; ``skip_dims`` get the identity.
    """
    stats = np.asarray(stats, dtype=np.float64)
    dim = stats.shape[1] - 1
    count = stats[0, dim]

    mean = stats[0, :dim] / count
    if norm_vars:
        var = stats[1, :dim] / count - mean * mean
        floored = var < 1.0e-20
        if floored.any():
            warnings.warn(
                'flooring zero cepstral variance to 1e-20 in dims '
                f'{np.flatnonzero(floored).tolist()} (constant '
                'feature dimension?)')
        var = np.maximum(var, 1.0e-20)
        scale = 1.0 / np.sqrt(var)
        if not np.isfinite(scale).all():
            raise ValueError(
                'NaN or infinity in CMVN variance normalization')
    else:
        scale = np.ones(dim)
    offset = -mean * scale

    if skip_dims:
        scale = scale.copy()
        offset = offset.copy()
        scale[list(skip_dims)] = 1.0
        offset[list(skip_dims)] = 0.0
    return scale, offset


def apply_cmvn(feats, stats, norm_vars=True, skip_dims=None,
               reverse=False):
    """Apply accumulated CMVN statistics to a features matrix.

    Kaldi's ApplyCmvn/ApplyCmvnReverse: a per-dim affine transform from
    the mean (and optionally variance) in ``stats``
    (:func:`cmvn_affine`); ``skip_dims`` leaves the listed dimensions
    untouched.
    """
    scale, offset = cmvn_affine(stats, norm_vars, skip_dims)
    feats = np.asarray(feats)
    if reverse:
        return ((feats - offset) / scale).astype(feats.dtype)
    return (feats * scale + offset).astype(feats.dtype)


# ------------------------------------------------------------- sliding CMVN

def sliding_window_cmvn(feats, nframes, center=True, cmn_window=600,
                        min_window=100, normalize_variance=False):
    """Per-frame sliding-window mean (and variance) normalization.

    ``feats`` is [B, T, D], ``nframes`` [B] the true frame counts.
    Implements Kaldi's SlidingWindowCmn window placement: a window of
    ``cmn_window`` frames centered on (or trailing) the current frame,
    shifted to stay inside the utterance, with ``min_window`` lookahead
    at the start in the non-centered case. Windowed sums come from
    prefix sums, one pass for the whole batch.
    """
    bsz, maxframes, dim = feats.shape
    device = feats.device
    n = nframes.to(device=device, dtype=torch.int64)[:, None]  # [B, 1]
    t = torch.arange(maxframes, dtype=torch.int64, device=device)[None, :]

    if center:
        start = t - cmn_window // 2
        end = start + cmn_window
    else:
        start = t - cmn_window
        end = t + 1

    # shift the window inside [0, n)
    end = torch.where(start < 0, end - start, end)
    start = torch.clamp_min(start, 0)
    if not center:
        end = torch.where(end > t, torch.clamp_min(t + 1, min_window), end)
    shift = torch.clamp_min(end - n, 0)
    start = torch.clamp_min(start - shift, 0)
    end = torch.minimum(end, n)

    # windowed sums as prefix-sum differences, accumulated in float64
    # as Kaldi does: in float32 the difference of two prefix sums loses
    # up to 1e-3 on features with a mean of ~15 (a log energy), and
    # differs between a sequential and a parallel scan
    valid = (t < n)[:, :, None]
    feats64 = torch.where(valid, feats, 0.0).to(torch.float64)
    zeros = feats64.new_zeros((bsz, 1, dim))
    csum = torch.cat([zeros, torch.cumsum(feats64, dim=1)], dim=1)

    def window_sum(cs):
        upper = torch.gather(cs, 1, end[:, :, None].expand(-1, -1, dim))
        lower = torch.gather(cs, 1, start[:, :, None].expand(-1, -1, dim))
        return upper - lower

    counts = torch.clamp_min((end - start).to(torch.float64), 1.0)[:, :, None]
    mean = window_sum(csum) / counts
    out = feats.to(torch.float64) - mean

    if normalize_variance:
        csumsq = torch.cat(
            [zeros, torch.cumsum(feats64 * feats64, dim=1)], dim=1)
        variance = torch.clamp_min(
            window_sum(csumsq) / counts - mean * mean, 1.0e-10)
        out = torch.where(counts <= 1.0, 0.0, out * torch.rsqrt(variance))

    return out.to(feats.dtype)


# ---------------------------------------------------------------------- VAD

def compute_vad_energy(log_energy, nframes, energy_threshold=5.0,
                       energy_mean_scale=0.5, frames_context=0,
                       proportion_threshold=0.6):
    """Energy-based voice activity detection (Kaldi ComputeVadEnergy).

    ``log_energy`` is [B, T]; the decision for each frame is a
    proportion vote of frames above the cutoff within
    +-``frames_context`` frames. Returns [B, T] uint8.
    """
    bsz, maxframes = log_energy.shape
    device = log_energy.device
    n = nframes.to(torch.int64)[:, None]
    t = torch.arange(maxframes, dtype=torch.int64, device=device)[None, :]
    valid = t < n

    cutoff = torch.full((bsz, 1), float(energy_threshold),
                        dtype=torch.float32, device=device)
    if energy_mean_scale != 0.0:
        mean = (torch.where(valid, log_energy, 0.0).sum(dim=1, keepdim=True)
                / torch.clamp_min(n.to(log_energy.dtype), 1))
        cutoff = cutoff + energy_mean_scale * mean

    above = torch.where(valid, (log_energy > cutoff).to(torch.float32), 0.0)
    in_range = valid.to(torch.float32)

    num = torch.zeros_like(above)
    den = torch.zeros_like(above)
    for offset in range(-frames_context, frames_context + 1):
        mask = _shift_mask(t, n, offset)
        num = num + torch.roll(above, -offset, dims=1) * mask
        den = den + torch.roll(in_range, -offset, dims=1) * mask

    # float32 comparison on purpose: Kaldi does num >= den * proportion
    # in BaseFloat, so boundary frames round the same way
    return (num >= den * proportion_threshold).to(torch.uint8)


def _shift_mask(t, n, offset):
    """1 where frame t+offset is a valid frame index, else 0"""
    shifted = t + offset
    return ((shifted >= 0) & (shifted < n)).to(torch.float32)
