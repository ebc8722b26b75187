"""Machine-ABX phone discriminability on extracted features.

Counterpart of :mod:`shennong_tpu.eval.abx`. The ABX task asks: given a
segment X of phone p, a segment A of the same phone and a segment B of
another phone q, is X closer to A than to B? The error rate over many
triplets measures how well a feature representation separates phone
categories.

* frame-to-frame costs are one batched matrix product per batch of
  segment pairs (``torch.bmm`` in float32, TF32 off);
* the DTW recursion runs in :mod:`shennong_tpu_torch.ops.dtw`: a
  hand-written CUDA kernel for a CUDA tensor, its plain PyTorch
  version for a CPU tensor;
* :func:`pairwise_distances` uploads the segment store once, gathers
  each batch's pairs on the device and fetches the divergences once at
  the end;
* the triplet aggregation (collapse over speaker pairs, then phone
  pairs) is host numpy on the resulting distance matrix, a copy of the
  JAX package's.

Divergences are normalized by the **realized path length**, the
number of cells on the optimal alignment path (ABXpy's normalizer);
of several paths with the minimum cost the shortest one is used.
"""

import numpy as np
import torch

from shennong_tpu_torch.ops import dtw


# ------------------------------------------------------------------- DTW

def _frame_costs(x, y, metric):
    """Pairwise frame costs [B, Ta, Tb] of segment batches [B, T, D]."""
    if metric == 'cosine':
        xn = x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)
        yn = y / torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True) + 1e-12)
        return 1.0 - torch.bmm(xn, yn.transpose(1, 2))
    if metric == 'euclidean':
        sq = (torch.sum(x * x, dim=-1)[:, :, None]
              + torch.sum(y * y, dim=-1)[:, None, :]
              - 2.0 * torch.bmm(x, y.transpose(1, 2)))
        return torch.sqrt(torch.clamp_min(sq, 0.0))
    raise ValueError(f'unknown metric: {metric}')


def dtw_divergences(x, nx, y, ny, metric='cosine'):
    """Batched DTW divergence between padded segment pairs.

    Parameters
    ----------
    x : tensor [B, Ta, D]
        First segments, zero-padded along the frame axis.
    nx : int tensor [B]
        Valid frame counts of ``x``, in [1, Ta] (a count outside
        raises ``ValueError``).
    y : tensor [B, Tb, D]
        Second segments, zero-padded, on the device of ``x``.
    ny : int tensor [B]
        Valid frame counts of ``y``, in [1, Tb].
    metric : 'cosine' or 'euclidean'
        Frame-to-frame cost.

    Returns
    -------
    div : float32 tensor [B] on the device of ``x``: the DTW path cost
        (steps right/down/diagonal) divided by the realized path
        length. Ties in cost resolve to the shortest path. The costs
        are computed on the device of ``x``, and the recursion
        launches the DTW kernel for a CUDA tensor (or raises) and runs
        its plain version for a CPU tensor.
    """
    costs = _frame_costs(
        x.to(torch.float32), y.to(torch.float32), metric)
    return dtw.dtw_divergences(costs, nx, ny)


# ----------------------------------------------------- distance matrices

def pairwise_distances(segments, metric='cosine', batch=512, *, device):
    """Symmetric DTW divergence matrix over a list of segments.

    Parameters
    ----------
    segments : list of [T_i, D] arrays
        Feature segments (e.g. one per phone token). Every segment
        needs at least one frame.
    metric : 'cosine' or 'euclidean'
    batch : int
        Segment pairs per device batch.
    device : str or torch.device
        Where the costs and the DTW run.

    Returns
    -------
    distances : [N, N] float numpy array, zero diagonal.
    """
    segments = [np.asarray(seg, dtype=np.float32) for seg in segments]
    if not segments:
        return np.zeros((0, 0))
    for index, seg in enumerate(segments):
        if seg.ndim != 2 or seg.shape[0] == 0:
            raise ValueError(
                f'segment {index} must be a non-empty [T, D] array')
    device = torch.device(device)
    count = len(segments)
    lengths = np.array([seg.shape[0] for seg in segments], np.int32)
    padded = np.zeros(
        (count, int(lengths.max()), segments[0].shape[1]), np.float32)
    for index, seg in enumerate(segments):
        padded[index, :seg.shape[0]] = seg

    # the segment store and the pair indices cross to the device once;
    # every batch gathers its pairs there, and the divergences come
    # back in one copy at the end
    store = torch.from_numpy(padded).to(device)
    store_lengths = torch.from_numpy(lengths).to(device)
    left, right = np.triu_indices(count, k=1)
    left_dev = torch.from_numpy(left).to(device)
    right_dev = torch.from_numpy(right).to(device)
    parts = []
    for start in range(0, len(left), batch):
        li = left_dev[start:start + batch]
        ri = right_dev[start:start + batch]
        parts.append(dtw_divergences(
            store.index_select(0, li), store_lengths.index_select(0, li),
            store.index_select(0, ri), store_lengths.index_select(0, ri),
            metric=metric))
    distances = np.zeros((count, count), np.float64)
    if parts:
        distances[left, right] = torch.cat(parts).cpu().numpy()
    return distances + distances.T


def segments_from_alignment(features, alignment, tokens=None,
                            min_frames=1):
    """Cut a Features matrix into per-token segments.

    Parameters
    ----------
    features : Features
        Frame features with times (1-D centers or [nframes, 2]
        onset/offset pairs).
    alignment : Alignment
        Time-aligned tokens over the same recording.
    tokens : set, optional
        Keep only these tokens (default: all).
    min_frames : int
        Drop segments with fewer frames.

    Returns
    -------
    list of (token, data) with ``data`` the [T, D] segment.
    """
    times = np.asarray(features.times)
    centers = times.mean(axis=1) if times.ndim == 2 else times
    out = []
    for (onset, offset), token in zip(
            alignment.times, alignment.tokens):
        if tokens is not None and token not in tokens:
            continue
        mask = (centers >= onset) & (centers < offset)
        if mask.sum() >= min_frames:
            out.append((token, np.asarray(features.data)[mask]))
    return out


# ------------------------------------------------------------ ABX score

def _cell_score(d_ax, d_bx, exclude_diagonal=False):
    """Mean over (a, b, x) of [d(a,x) < d(b,x)] with 0.5 for ties.

    ``exclude_diagonal`` drops the a == x comparisons (within-speaker
    task, where X is drawn from the A set).
    """
    wins = (d_ax[:, None, :] < d_bx[None, :, :]).astype(np.float64)
    wins += 0.5 * (d_ax[:, None, :] == d_bx[None, :, :])
    if not exclude_diagonal:
        return wins.mean()
    n_a, n_b, n_x = wins.shape
    if n_a < 2:
        return None
    diag = np.eye(n_a, n_x, dtype=bool)
    total = wins.sum() - wins[diag[:, None, :] * np.ones(
        (1, n_b, 1), bool)].sum()
    return total / (n_b * n_a * (n_x - 1))


def abx_error(distances, phones, speakers, task='across'):
    """ABX discrimination error from a segment distance matrix.

    Parameters
    ----------
    distances : [N, N] array
        Pairwise segment divergences (:func:`pairwise_distances`).
    phones : length-N sequence
        Phone label of each segment.
    speakers : length-N sequence
        Speaker label of each segment.
    task : 'across' or 'within'
        'across': A and B share a speaker, X is the same phone as A
        from a different speaker. 'within': A, B and X all share one
        speaker (X a different token than A).

    Returns
    -------
    error : float
        Aggregated ABX error in [0, 1] (0.5 = chance). Cells
        collapse over speaker pairs, then over ordered phone pairs —
        the ABXpy aggregation scheme.

    Raises
    ------
    ValueError if no valid (phone pair, speaker) cell exists.
    """
    if task not in ('across', 'within'):
        raise ValueError(f'unknown task: {task}')
    distances = np.asarray(distances)
    phones = np.asarray(phones)
    speakers = np.asarray(speakers)
    phone_set = sorted(set(phones.tolist()))
    speaker_set = sorted(set(speakers.tolist()))
    by_cell = {
        (phone, speaker): np.flatnonzero(
            (phones == phone) & (speakers == speaker))
        for phone in phone_set for speaker in speaker_set}

    pair_scores = []
    for p in phone_set:
        for q in phone_set:
            if p == q:
                continue
            cells = []
            for s1 in speaker_set:
                a_idx = by_cell[(p, s1)]
                b_idx = by_cell[(q, s1)]
                if not len(a_idx) or not len(b_idx):
                    continue
                if task == 'across':
                    for s2 in speaker_set:
                        if s2 == s1:
                            continue
                        x_idx = by_cell[(p, s2)]
                        if not len(x_idx):
                            continue
                        cells.append(_cell_score(
                            distances[np.ix_(a_idx, x_idx)],
                            distances[np.ix_(b_idx, x_idx)]))
                elif task == 'within':
                    score = _cell_score(
                        distances[np.ix_(a_idx, a_idx)],
                        distances[np.ix_(b_idx, a_idx)],
                        exclude_diagonal=True)
                    if score is not None:
                        cells.append(score)
                else:
                    raise ValueError(f'unknown task: {task}')
            if cells:
                pair_scores.append(float(np.mean(cells)))
    if not pair_scores:
        raise ValueError(
            'no valid ABX cell: need at least two phones and, for '
            'the across task, the same phone from two speakers')
    return 1.0 - float(np.mean(pair_scores))
