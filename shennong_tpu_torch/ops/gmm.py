"""Batched diagonal-covariance GMM operations.

Counterpart of :mod:`shennong_tpu.ops.gmm`. The device functions take
float32 tensors on one device and never synchronize with the host:
log-likelihoods are two matrix products, EM statistics masked
reductions, gaussian selection a stable descending sort (the top-k of
``jax.lax.top_k``, ties lowest index first). The products are plain
float32 ``torch`` matmuls (TF32 is off, see :mod:`shennong_tpu_torch`).
:func:`mle_update` and :func:`split_gmm` stay host numpy in float64,
drawing from the caller's ``np.random.RandomState``.

The log-normalizer of a zero-weight (padding) component is -inf: it is
added after the products, as the reference does, so no ``0 * -inf``
reaches a matmul.
"""

import math

import numpy as np
import torch


def gconsts(weights, means, inv_vars):
    """Per-component log-normalizers of a diagonal GMM.

    gconst_g = log w_g - 0.5 (D log 2pi + sum_d (log var_gd +
    mean_gd^2 / var_gd)).
    """
    dim = means.shape[1]
    return (
        torch.log(weights)
        - 0.5 * (dim * math.log(2 * math.pi)
                 - torch.log(inv_vars).sum(dim=1)
                 + (means * means * inv_vars).sum(dim=1)))


def log_likelihoods(feats, weights, means, inv_vars):
    """Per-frame, per-component log-likelihoods: [N, D] -> [N, G]."""
    consts = gconsts(weights, means, inv_vars)
    linear = feats @ (means * inv_vars).T
    quadratic = (feats * feats) @ inv_vars.T
    return consts[None, :] + linear - 0.5 * quadratic


def top_k(values, k):
    """Indices of the ``k`` largest entries of each row, best first,
    ties lowest index first (the order of ``jax.lax.top_k``)."""
    order = torch.sort(values, dim=-1, descending=True, stable=True)[1]
    return order[..., :k]


def selected_loglikes(feats, indices, weights, means, inv_vars):
    """Log-likelihoods [N, k] of each frame's selected components."""
    consts = gconsts(weights, means, inv_vars)
    sel_means = means[indices]           # [N, k, D]
    sel_inv = inv_vars[indices]
    linear = torch.einsum('nd,nkd->nk', feats, sel_means * sel_inv)
    quadratic = torch.einsum('nd,nkd->nk', feats * feats, sel_inv)
    return consts[indices] + linear - 0.5 * quadratic


def gaussian_selection(feats, weights, means, inv_vars, num_gselect):
    """Top-k component indices per frame, best first.

    Returns (loglike [N], indices [N, k] int32): the per-frame full-GMM
    log-likelihood and the selected component indices.
    """
    loglikes = log_likelihoods(feats, weights, means, inv_vars)
    per_frame = torch.logsumexp(loglikes, dim=1)
    return per_frame, top_k(loglikes, num_gselect).to(torch.int32)


def gaussian_selection_preselect(feats, preselect, weights, means,
                                 inv_vars, num_gselect):
    """Top-k restricted to each frame's preselected components.

    Kaldi gmm-gselect with --gselect: the refined selection is the best
    ``num_gselect`` of the previous per-frame subset ``preselect``
    [N, k_prev]. Returns (loglike [N] over the preselected components,
    indices [N, num_gselect] int32, best first).
    """
    preselect = preselect.to(torch.int64)
    loglikes = selected_loglikes(
        feats, preselect, weights, means, inv_vars)
    per_frame = torch.logsumexp(loglikes, dim=1)
    pos = top_k(loglikes, num_gselect)
    return per_frame, torch.gather(preselect, 1, pos).to(torch.int32)


def posteriors_preselect(feats, indices, weights, means, inv_vars):
    """Posteriors restricted to preselected components.

    Returns (loglike_per_frame [N], posteriors [N, k]), the posteriors
    softmax-normalized over the selected components only (Kaldi
    gmm-global-gselect-to-post).
    """
    loglikes = selected_loglikes(
        feats, indices.to(torch.int64), weights, means, inv_vars)
    norm = torch.logsumexp(loglikes, dim=1)
    return norm, torch.exp(loglikes - norm[:, None])


def accumulate_stats(feats, frame_weights, weights, means, inv_vars):
    """EM statistics of a feature matrix under the current model.

    Returns (tot_like, occupancy [G], mean_acc [G, D], var_acc [G, D])
    with per-frame ``frame_weights`` applied (Kaldi
    AccumDiagGmm::AccumulateFromDiag).
    """
    loglikes = log_likelihoods(feats, weights, means, inv_vars)
    norm = torch.logsumexp(loglikes, dim=1)
    gamma = torch.exp(loglikes - norm[:, None]) * frame_weights[:, None]
    occupancy = gamma.sum(dim=0)
    mean_acc = gamma.T @ feats
    var_acc = gamma.T @ (feats * feats)
    tot_like = (norm * frame_weights).sum()
    return tot_like, occupancy, mean_acc, var_acc


def em_step(feats, frame_weights, weights, means, inv_vars,
            min_gaussian_weight=1e-4, min_gaussian_occupancy=10.0,
            min_variance=0.001, reduce=None):
    """One full EM iteration on the device: accumulate + MLE update.

    Kaldi MleDiagGmmUpdate: a floored component keeps its mean and
    variance while its weight becomes max(occupancy share, min weight),
    with no renormalization. A component with exactly zero weight and
    zero occupancy is padding (the init loop pads the model to its
    final size) and stays dead.

    ``reduce``, when given, maps the tuple of statistics (tot_like,
    occupancy, mean_acc, var_acc) to their sums over every process
    before the update (the multi-process trainer,
    :mod:`shennong_tpu_torch.parallel.distributed`).

    Returns (tot_like, new_weights, new_means, new_inv_vars).
    """
    stats = accumulate_stats(feats, frame_weights, weights, means, inv_vars)
    if reduce is not None:
        stats = reduce(stats)
    tot_like, occupancy, mean_acc, var_acc = stats
    total = occupancy.sum()
    prob = torch.where(
        total > 0, occupancy / torch.clamp_min(total, 1e-10),
        1.0 / occupancy.shape[0])
    updatable = ((occupancy > min_gaussian_occupancy)
                 & (prob > min_gaussian_weight))
    dead = (weights == 0) & (occupancy == 0)
    new_weights = torch.where(
        updatable, prob, torch.clamp_min(prob, float(min_gaussian_weight)))
    new_weights = torch.where(dead, 0.0, new_weights)
    safe_occ = torch.clamp_min(occupancy, 1e-10)[:, None]
    new_means = torch.where(updatable[:, None], mean_acc / safe_occ, means)
    variances = var_acc / safe_occ - (mean_acc / safe_occ) ** 2
    variances = torch.clamp_min(variances, min_variance)
    new_inv = torch.where(updatable[:, None], 1.0 / variances, inv_vars)
    return tot_like, new_weights, new_means, new_inv


def em_steps(feats, frame_weights, weights, means, inv_vars, num_iters,
             min_gaussian_weight=1e-4, min_gaussian_occupancy=10.0,
             min_variance=0.001, reduce=None):
    """``num_iters`` EM iterations, enqueued back to back on the device
    with no host synchronization between them (but ``reduce``'s, see
    :func:`em_step`). Returns (tot_like of the last iteration, weights,
    means, inv_vars)."""
    tot_like = torch.zeros((), dtype=feats.dtype, device=feats.device)
    for _ in range(num_iters):
        tot_like, weights, means, inv_vars = em_step(
            feats, frame_weights, weights, means, inv_vars,
            min_gaussian_weight=min_gaussian_weight,
            min_gaussian_occupancy=min_gaussian_occupancy,
            min_variance=min_variance, reduce=reduce)
    return tot_like, weights, means, inv_vars


def mle_update(occupancy, mean_acc, var_acc, weights, means, inv_vars,
               min_gaussian_weight=1e-4, min_gaussian_occupancy=10.0,
               min_variance=0.001, remove_low_count_gaussians=False):
    """Maximum-likelihood update from accumulated statistics (numpy,
    float64).

    Components whose occupancy falls under the floors keep their old
    mean and variance (or are dropped when
    ``remove_low_count_gaussians``), Kaldi MleDiagGmmUpdate semantics.
    """
    occupancy = np.asarray(occupancy, dtype=np.float64)
    mean_acc = np.asarray(mean_acc, dtype=np.float64)
    var_acc = np.asarray(var_acc, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    means = np.asarray(means, dtype=np.float64)
    inv_vars = np.asarray(inv_vars, dtype=np.float64)

    total = occupancy.sum()
    prob = (occupancy / total if total > 0
            else np.full_like(occupancy, 1.0 / len(occupancy)))
    updatable = (
        (occupancy > min_gaussian_occupancy)
        & (prob > min_gaussian_weight))

    dead = (weights == 0) & (occupancy == 0)
    new_weights = np.where(
        updatable, prob, np.maximum(prob, min_gaussian_weight))
    new_weights = np.where(dead, 0.0, new_weights)
    safe_occ = np.maximum(occupancy, 1e-10)[:, None]
    new_means = np.where(
        updatable[:, None], mean_acc / safe_occ, means)
    variances = var_acc / safe_occ - new_means ** 2
    variances = np.maximum(variances, min_variance)
    new_inv = np.where(updatable[:, None], 1.0 / variances, inv_vars)

    if remove_low_count_gaussians and not updatable.all():
        keep = updatable.copy()
        if not keep.any():
            # Kaldi removes starved components in index order while
            # to_remove.size() < num_gauss-1: the last live one survives
            live = np.flatnonzero(~dead)
            if live.size == 0:
                raise ValueError(
                    'every GMM component is dead padding: nothing to keep')
            keep[live[-1]] = True
        new_weights = new_weights[keep]
        new_means = new_means[keep]
        new_inv = new_inv[keep]
        total_kept = new_weights.sum()
        assert total_kept > 0, 'kept components have zero total weight'
        new_weights = new_weights / total_kept

    return new_weights, new_means, new_inv


def split_gmm(weights, means, inv_vars, target, perturb_factor, rng):
    """Split the heaviest components until reaching ``target``.

    Kaldi DiagGmm::Split: each split halves the weight and perturbs the
    two means by +-perturb_factor * std * N(0, 1), drawn from ``rng``
    (a ``np.random.RandomState``).
    """
    weights = list(np.asarray(weights, dtype=np.float64))
    means = list(np.asarray(means, dtype=np.float64))
    inv_vars = list(np.asarray(inv_vars, dtype=np.float64))

    while len(weights) < target:
        heaviest = int(np.argmax(weights))
        weights[heaviest] /= 2.0
        weights.append(weights[heaviest])
        std = 1.0 / np.sqrt(inv_vars[heaviest])
        noise = rng.randn(means[heaviest].shape[0]) * std * perturb_factor
        means.append(means[heaviest] + noise)
        means[heaviest] = means[heaviest] - noise
        inv_vars.append(inv_vars[heaviest].copy())

    return (np.asarray(weights), np.asarray(means),
            np.asarray(inv_vars))
