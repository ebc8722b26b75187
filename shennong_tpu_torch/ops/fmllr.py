"""fMLLR statistics and linear-VTLN transform estimation.

Counterpart of :mod:`shennong_tpu.ops.fmllr`. On the device, in float32
``torch`` with no host synchronization: the warp-class moments of a
signal batch (:func:`warp_class_mapping_moments`), the grouped fMLLR
statistics (:func:`fmllr_stats_groups`), the per-(group, class)
objective maximization (:func:`solve_warp_classes`) and the whole
LVTLN estimation loop (:func:`lvtln_rounds`). On the host, in float64
numpy where Kaldi sums in double: the merge of per-batch moments and
the base-transform solve, :class:`FmllrStats` and the per-group
:class:`LinearVtln` solves.
"""

import numpy as np
import torch

from shennong_tpu_torch.ops import gmm as gmm_ops


def warp_class_mapping_moments(signals, nsamples, nframes, mel_weights,
                               weights, opts, nframes_max,
                               delta_order=None, delta_window=None,
                               generator=None):
    """Weighted first and second moments of every warp class.

    The warped MFCC(+delta) features of a signal batch for all C
    classes plus the unwarped reference (``mel_weights[C]`` is the
    unwarped bank, framing and FFT shared) are reduced against the
    frame-selection ``weights`` [B, T] (VAD and subsampling) on the
    device; the features never reach the host. The features are
    float32; the moments are accumulated in float64 (a departure from
    the JAX package's float32): the base-transform solve amplifies
    their rounding by the covariance's condition number, and float32
    moments put a transform 2.4e-3 from a float64 least-squares solve
    on the same features. The second moments are centered at the batch
    means; :func:`merge_moments` merges batches in float64.

    Returns (beta, mu_x [D], mu_y [C, D], Cxx [D, D], Cyx [C, D, D]).
    """
    from shennong_tpu_torch.ops import postops, spectral

    feats = spectral.mfcc_multi_warp_batch(
        signals, nsamples, mel_weights, opts, nframes_max,
        generator=generator)
    nclasses1, bsz, maxframes, dim = feats.shape

    if delta_order is not None:
        flat = postops.compute_deltas(
            feats.reshape(nclasses1 * bsz, maxframes, dim),
            nframes.repeat(nclasses1), order=delta_order,
            window=delta_window)
        feats = flat.reshape(nclasses1, bsz, maxframes, -1)

    feats = feats.to(torch.float64)
    weights = weights.to(torch.float64)
    x = feats[-1]        # [B, T, D] unwarped
    y = feats[:-1]       # [C, B, T, D] warped

    beta = weights.sum()
    # a batch whose selection weights are all zero (a tail batch fully
    # rejected by the VAD) contributes zero moments, not NaN
    safe_beta = torch.clamp_min(beta, 1e-30)
    mu_x = torch.einsum('bt,btd->d', weights, x) / safe_beta
    mu_y = torch.einsum('bt,cbtd->cd', weights, y) / safe_beta

    xc = x - mu_x
    yc = y - mu_y[:, None, None, :]
    wxc = (xc * weights[:, :, None]).reshape(-1, xc.shape[-1])
    cxx = wxc.T @ xc.reshape(-1, xc.shape[-1])
    cyx = torch.einsum(
        'cnd,ne->cde', yc.reshape(yc.shape[0], -1, yc.shape[-1]), wxc)
    return beta, mu_x, mu_y, cxx, cyx


def merge_moments(moments):
    """Merge per-batch centered moments into one equivalent tuple.

    ``moments`` is a list of :func:`warp_class_mapping_moments` tuples
    (numpy, any dtype), merged in float64 with the parallel-covariance
    corrections. Returns one (beta, mu_x, mu_y, Cxx, Cyx) float64
    tuple.
    """
    moments = [
        tuple(np.asarray(m, dtype=np.float64) for m in batch)
        for batch in moments]
    beta = sum(m[0] for m in moments)
    if not beta > 0:
        raise ValueError(
            'no selected frames in any batch, cannot estimate the '
            'warp-class transforms')
    mu_x = sum(m[0] * m[1] for m in moments) / beta
    mu_y = sum(m[0] * m[2] for m in moments) / beta

    nclasses, dim = moments[0][2].shape
    Cxx = np.zeros((dim, dim))
    Cyx = np.zeros((nclasses, dim, dim))
    for beta_b, mu_x_b, mu_y_b, Cxx_b, Cyx_b in moments:
        dx = mu_x_b - mu_x
        Cxx += Cxx_b + beta_b * np.outer(dx, dx)
        Cyx += Cyx_b + beta_b * np.einsum(
            'cd,e->cde', mu_y_b - mu_y, dx)
    return beta, mu_x, mu_y, Cxx, Cyx


def solve_mapping_from_moments(moments):
    """Merge per-batch centered moments and solve every warp class
    (float64). Returns the [C, D, D] transforms, each row scaled by the
    per-dimension variance normalization of
    :func:`compute_mapping_transform`."""
    beta, mu_x, mu_y, Cxx, Cyx = merge_moments(moments)
    nclasses, dim = mu_y.shape

    Cxx_inv = np.linalg.inv(Cxx)
    transforms = np.zeros((nclasses, dim, dim))
    x_var = np.diag(Cxx) / beta
    for c in range(nclasses):
        A = Cyx[c] @ Cxx_inv
        y_var = np.einsum('de,ef,df->d', A, Cxx, A) / beta
        transforms[c] = A * np.sqrt(x_var / y_var)[:, None]
    return transforms


def _grouped_rows(onehot, values):
    """[N, S * D]: each frame's ``values`` [N, D] in its group's block."""
    n = values.shape[0]
    return (onehot[:, :, None] * values[:, None, :]).reshape(n, -1)


def _group_stats(onehot, post, wm, wi, xplus, xx, num_groups):
    """(beta [S], K [S, D, D+1], G [S, D, D+1, D+1]) of weighted
    posteriors ``post``, the posterior-weighted means-times-precisions
    ``wm`` and precisions ``wi`` [N, D]."""
    dim = wm.shape[1]
    beta = onehot.T @ post.sum(dim=1)
    K = (_grouped_rows(onehot, wm).T @ xplus).reshape(
        num_groups, dim, dim + 1)
    G = (_grouped_rows(onehot, wi).T @ xx).reshape(
        num_groups, dim, dim + 1, dim + 1)
    return beta, K, G


def _xplus(feats):
    """[N, D+1] features with a constant 1 appended, and their
    [N, (D+1)^2] outer products."""
    n = feats.shape[0]
    xplus = torch.cat([feats, feats.new_ones((n, 1))], dim=1)
    xx = (xplus[:, :, None] * xplus[:, None, :]).reshape(n, -1)
    return xplus, xx


def fmllr_stats_groups(feats, post_idx, post_val, groups, means,
                       inv_vars, num_groups):
    """fMLLR statistics of many speakers at once, on the device.

    ``feats`` [N, D] are concatenated frames, ``post_idx``/``post_val``
    [N, k] the preselected posteriors, ``groups`` [N] the speaker index
    of each frame. Returns (beta [S], K [S, D, D+1],
    G [S, D, D+1, D+1]); callers chunk the frame axis (the Gram rows
    are N x (D+1)^2) and sum the chunks in float64.
    """
    post_idx = post_idx.to(torch.int64)
    xplus, xx = _xplus(feats)
    sel_means = means[post_idx]          # [N, k, D]
    sel_inv = inv_vars[post_idx]
    weighted_mean = torch.einsum('nk,nkd->nd', post_val, sel_means * sel_inv)
    weighted_inv = torch.einsum('nk,nkd->nd', post_val, sel_inv)
    onehot = torch.nn.functional.one_hot(
        groups.to(torch.int64), num_groups).to(feats.dtype)
    return _group_stats(onehot, post_val, weighted_mean, weighted_inv,
                        xplus, xx, num_groups)


class FmllrStats:
    """fMLLR sufficient statistics for a diagonal GMM.

    beta (scalar), K [D, D+1] and G [D, D+1, D+1] such that the fMLLR
    auxiliary function of an affine transform W is
    sum_d (w_d . k_d - 0.5 w_d G_d w_d^T) + beta log|det A|.
    """

    def __init__(self, dim):
        self.dim = dim
        self.beta = 0.0
        self.K = np.zeros((dim, dim + 1))
        self.G = np.zeros((dim, dim + 1, dim + 1))

    def accumulate(self, feats, post_indices, post_values, gmm):
        """Accumulate from frames and preselected posteriors (float64
        numpy). feats [N, D]; post_indices/post_values [N, k] give the
        selected GMM components and their posteriors per frame."""
        feats = np.asarray(feats, dtype=np.float64)
        nframes = feats.shape[0]
        xplus = np.concatenate([feats, np.ones((nframes, 1))], axis=1)

        inv_vars = gmm.inv_vars[post_indices]       # [N, k, D]
        means = gmm.means[post_indices]             # [N, k, D]
        post = np.asarray(post_values, dtype=np.float64)

        self.beta += post.sum()
        weighted_mean = np.einsum('nk,nkd->nd', post, inv_vars * means)
        self.K += weighted_mean.T @ xplus
        weighted_inv = np.einsum('nk,nkd->nd', post, inv_vars)
        xx = np.einsum('ne,nf->nef', xplus, xplus).reshape(nframes, -1)
        self.G += (weighted_inv.T @ xx).reshape(
            self.dim, self.dim + 1, self.dim + 1)

    def copy(self):
        out = FmllrStats(self.dim)
        out.beta = self.beta
        out.K = self.K.copy()
        out.G = self.G.copy()
        return out


def apply_transform_to_stats(matrix, stats):
    """Transform fMLLR stats as if features went through x -> A x
    (Kaldi ApplyFeatureTransformToStats with an affine [A | 0])."""
    dim = stats.dim
    aplus = np.eye(dim + 1)
    aplus[:dim, :dim] = matrix

    out = FmllrStats(dim)
    out.beta = stats.beta
    out.K = stats.K @ aplus.T
    out.G = aplus @ stats.G @ aplus.T
    return out


def auxf(transform, stats):
    """fMLLR auxiliary function of an affine transform [D, D+1]."""
    dim = stats.dim
    square = transform[:, :dim]
    sign, logdet = np.linalg.slogdet(square)
    if sign <= 0:
        return -np.inf
    quad = sum(
        transform[d] @ stats.K[d]
        - 0.5 * transform[d] @ stats.G[d] @ transform[d]
        for d in range(dim))
    return stats.beta * logdet + quad


def solve_offset(stats):
    """Best offset-only secondary transform: W = [I | b], with
    b_d = (k_d[D] - G_d[D, d]) / G_d[D, D]."""
    dim = stats.dim
    transform = np.concatenate([np.eye(dim), np.zeros((dim, 1))], axis=1)
    for d in range(dim):
        gdd = stats.G[d][dim, dim]
        if gdd > 0:
            transform[d, dim] = (
                stats.K[d][dim] - stats.G[d][dim, d]) / gdd
    return transform


def solve_diagonal(stats):
    """Best diagonal secondary transform: W = [diag(a) | b], with the
    closed-form positive root a = (q + sqrt(q^2 + 4 p beta)) / (2 p)
    per dimension."""
    dim = stats.dim
    transform = np.zeros((dim, dim + 1))
    for d in range(dim):
        k1 = stats.K[d][d]
        k2 = stats.K[d][dim]
        g11 = stats.G[d][d, d]
        g12 = stats.G[d][d, dim]
        g22 = stats.G[d][dim, dim]
        p = g11 - g12 * g12 / g22
        q = k1 - g12 * k2 / g22
        a = (q + np.sqrt(q * q + 4 * p * stats.beta)) / (2 * p)
        b = (k2 - a * g12) / g22
        transform[d, d] = a
        transform[d, dim] = b
    return transform


class LinearVtln:
    """Per-warp-class linear transforms (Kaldi LinearVtln)."""

    def __init__(self, dim, num_classes, default_class):
        self.dim = dim
        self.num_classes = num_classes
        self.default_class = default_class
        # each class starts at identity
        self.transforms = np.tile(np.eye(dim), (num_classes, 1, 1))
        self.warps = np.ones(num_classes)

    def set_transform(self, class_idx, matrix):
        self.transforms[class_idx] = np.asarray(matrix)

    def set_warp(self, class_idx, warp):
        self.warps[class_idx] = float(warp)

    def get_warp(self, class_idx):
        return float(self.warps[class_idx])

    def compute_transform(self, stats, norm_type='offset',
                          logdet_scale=0.0):
        """Pick the warp class and secondary transform maximizing the
        fMLLR objective (Kaldi gmm-global-est-lvtln-trans).

        Returns (class_idx, logdet, transform [D, D+1], objf_impr,
        count), the improvement against the default class.
        """
        if norm_type not in ('none', 'offset', 'diag'):
            raise ValueError(f'Invalid norm type {norm_type}')
        if stats.beta == 0:
            raise ValueError('no stats accumulated')

        dim = self.dim
        objf_per_class = np.zeros(self.num_classes)
        transforms = []
        for c in range(self.num_classes):
            transformed = apply_transform_to_stats(self.transforms[c], stats)
            if norm_type == 'none':
                secondary = np.concatenate(
                    [np.eye(dim), np.zeros((dim, 1))], axis=1)
            elif norm_type == 'offset':
                secondary = solve_offset(transformed)
            else:
                secondary = solve_diagonal(transformed)

            objf = auxf(secondary, transformed)
            _, logdet = np.linalg.slogdet(self.transforms[c])
            objf_per_class[c] = objf + logdet_scale * stats.beta * logdet

            # compose: x -> secondary(A_c x)
            transforms.append(np.concatenate([
                secondary[:, :dim] @ self.transforms[c],
                secondary[:, dim:]], axis=1))

        best = int(np.argmax(objf_per_class))
        objf_impr = objf_per_class[best] - objf_per_class[self.default_class]
        _, logdet = np.linalg.slogdet(self.transforms[best])
        return best, logdet, transforms[best], objf_impr, stats.beta

    def save(self, path):
        """Save the transforms and warps to an npz checkpoint (through
        an open file: np.savez appends '.npz' to other names)"""
        with open(path, 'wb') as fp:
            np.savez(
                fp, transforms=self.transforms, warps=self.warps,
                default_class=self.default_class)

    @classmethod
    def load(cls, path):
        with np.load(path) as data:
            transforms = data['transforms']
            out = cls(
                transforms.shape[1], transforms.shape[0],
                int(data['default_class']))
            out.transforms = transforms
            out.warps = data['warps']
        return out


def compute_mapping_transform(feats_pairs, dim, weights=None):
    """Least-squares linear map from unwarped to warped features.

    ``feats_pairs`` iterates over (x [N, D], y [N, D], w [N] or None)
    triplets; returns the [D, D] matrix minimizing ||y - A x+||^2 with
    per-dimension variance normalization (Kaldi
    gmm-train-lvtln-special), in float64.
    """
    Q = np.zeros((dim + 1, dim + 1))
    L = np.zeros((dim, dim + 1))
    beta = 0.0
    sum_xplus = np.zeros(dim + 1)
    sumsq_x = np.zeros(dim)

    for x, y, w in feats_pairs:
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = x.shape[0]
        w = np.ones(n) if w is None else np.asarray(w, dtype=np.float64)
        xplus = np.concatenate([x, np.ones((n, 1))], axis=1)

        Q += (xplus * w[:, None]).T @ xplus
        L += (y * w[:, None]).T @ xplus
        beta += w.sum()
        sum_xplus += w @ xplus
        sumsq_x += w @ (x * x)

    Qinv = np.linalg.inv(Q)
    A = np.zeros((dim, dim))
    for d in range(dim):
        w_d = Qinv @ L[d]
        x_var = sumsq_x[d] / beta - (sum_xplus[d] / beta) ** 2
        y_var = (w_d @ Q @ w_d) / beta - ((w_d @ sum_xplus) / beta) ** 2
        A[d] = w_d[:dim] * np.sqrt(x_var / y_var)
    return A


def solve_warp_classes(beta, K, G, base, warps, valid_base,
                       logdet_base, norm_type='offset',
                       logdet_scale=0.0, default_class=0):
    """Per-(group, warp-class) objective maximization from fMLLR stats.

    Kaldi ``LinearVtln::ComputeTransform`` for every group at once:
    the statistics go through each class's base matrix, the secondary
    offset or diagonal problem is solved in closed form, and the class
    maximizing the fMLLR auxiliary function wins. Only five entries of
    the transformed statistics are needed per (group, class, dim):
    K'[d, d] = K[s, d, :D] . A_c[d], K'[d, D], G'[d, d, d] =
    A_c[d] G[s, d, :D, :D] A_c[d], G'[d, d, D] = A_c[d] G[s, d, :D, D]
    and G'[d, D, D].

    ``beta`` [S], ``K`` [S, D, D+1] and ``G`` [S, D, D+1, D+1] come from
    :func:`fmllr_stats_groups`; ``base`` [C, D, D] are the class base
    transforms, ``valid_base`` [C] / ``logdet_base`` [C] their
    determinant signs and log-determinants. Ties of the objective go to
    the lowest class.

    Returns (transforms [S, D, D+1], warps_out [S], best_class [S],
    objf_impr [S], beta [S]).
    """
    num_groups, dim = K.shape[0], K.shape[1]
    num_classes = base.shape[0]

    Kdd = torch.einsum('sde,cde->scd', K[..., :dim], base)
    KdD = K[:, :, dim][:, None, :]
    # A_c[d] G[s, d] A_c[d]: G through the base rows, then the dot with
    # the same rows
    Gb = torch.einsum('sdef,cdf->scde', G[:, :, :dim, :dim], base)
    Gddd = (Gb * base[None]).sum(dim=-1)
    GddD = torch.einsum('cde,sde->scd', base, G[:, :, :dim, dim])
    GdDD = G[:, :, dim, dim][:, None, :]

    safe_g = torch.where(GdDD > 0, GdDD, 1.0)
    zeros = K.new_zeros((num_groups, num_classes))
    if norm_type == 'offset':
        a = torch.ones_like(Kdd)
        b = torch.where(GdDD > 0, (KdD - GddD) / safe_g, 0.0)
        sec_logdet = zeros
    elif norm_type == 'none':
        a = torch.ones_like(Kdd)
        b = torch.zeros_like(Kdd)
        sec_logdet = zeros
    else:  # diag
        p = Gddd - GddD * GddD / safe_g
        q = Kdd - GddD * KdD / safe_g
        safe_p = torch.where(p > 0, p, 1.0)
        a = (q + torch.sqrt(q * q + 4.0 * safe_p * beta[:, None, None])) \
            / (2.0 * safe_p)
        b = (KdD - a * GddD) / safe_g
        sec_logdet = torch.log(torch.clamp_min(a, 1e-20)).sum(dim=-1)

    quadterm = (a * Kdd + b * KdD
                - 0.5 * (a * a * Gddd + 2.0 * a * b * GddD + b * b * GdDD))
    objf = quadterm.sum(dim=-1)
    objf = objf + beta[:, None] * sec_logdet
    objf = objf + logdet_scale * beta[:, None] * logdet_base[None, :]
    objf = torch.where(valid_base[None, :], objf, -torch.inf)

    best = torch.argmax(objf, dim=1)
    rows = torch.arange(num_groups, device=K.device)
    impr = objf[rows, best] - objf[:, default_class]
    a_best = a[rows, best]                       # [S, D]
    b_best = b[rows, best]                       # [S, D]
    linear = a_best[:, :, None] * base[best]     # [S, D, D]
    transforms = torch.cat([linear, b_best[..., None]], dim=2)
    return transforms, warps[best], best, impr, beta


def lvtln_rounds(feats, fweights, gid, gsel, base, warps,
                 gmm_weights, gmm_means, gmm_inv_vars,
                 num_groups, num_iters, norm_type='offset',
                 logdet_scale=0.0, default_class=0,
                 min_gaussian_weight=1e-4, reduce=None):
    """The whole LVTLN estimation loop on the device.

    The reference's per-iteration sequence (apply the transforms,
    re-estimate the UBM, posteriors, per-speaker fMLLR statistics,
    per-class objective maximization) as ``num_iters`` rounds enqueued
    back to back, with no host synchronization: the features, the
    gaussian selection, the GMM and the transforms stay on the device.

    ``feats`` [N, D] are the concatenated original frames (padded;
    ``fweights`` [N] zero on padding), ``gid`` [N] the speaker group of
    each frame, ``gsel`` [N, k] the fixed gaussian selection, ``base``
    [C, D, D] the warp-class base transforms and ``warps`` [C].

    ``reduce``, when given, maps a tuple of statistics to their sums
    over every process: each round's fMLLR statistics (beta, K, G) and
    EM accumulators (:func:`shennong_tpu_torch.ops.gmm.em_step`) go
    through it, so that processes holding a shard of the frames each
    step the same model (:mod:`shennong_tpu_torch.parallel.distributed`).

    Returns (weights, means, inv_vars, transforms [S, D, D+1],
    warps_out [S], best_class [S], objf_impr [S], beta [S]).
    """
    n, dim = feats.shape
    gid = gid.to(torch.int64)
    gsel = gsel.to(torch.int64)
    onehot = torch.nn.functional.one_hot(gid, num_groups).to(feats.dtype)
    xplus, xx = _xplus(feats)

    sign_b, logdet_base = torch.linalg.slogdet(base)
    # a non-positive-determinant base transform is degenerate: a finite
    # zero logdet, and the class is excluded in the objective itself
    valid_base = sign_b > 0
    logdet_base = torch.where(valid_base, logdet_base, 0.0)

    def estimate_transforms(params, x_for_post):
        w_, m_, iv_ = params
        # posteriors over the preselected components on the transformed
        # features with the current model (gmm-global-gselect-to-post)
        loglikes = gmm_ops.selected_loglikes(x_for_post, gsel, w_, m_, iv_)
        post = torch.softmax(loglikes, dim=1) * fweights[:, None]
        # fMLLR statistics against the original features
        sel_m = m_[gsel]
        sel_iv = iv_[gsel]
        wm = torch.einsum('nk,nkd->nd', post, sel_iv * sel_m)
        wi = torch.einsum('nk,nkd->nd', post, sel_iv)
        beta, K, G = _group_stats(onehot, post, wm, wi, xplus, xx,
                                  num_groups)
        if reduce is not None:
            beta, K, G = reduce((beta, K, G))
        return solve_warp_classes(
            beta, K, G, base, warps, valid_base, logdet_base,
            norm_type=norm_type, logdet_scale=logdet_scale,
            default_class=default_class)

    def apply_transforms(transforms):
        # every group's linear part at once, then each frame keeps its
        # own group's row
        z = (feats @ transforms[:, :, :dim].reshape(-1, dim).T).reshape(
            n, num_groups, dim)
        z = z.gather(1, gid[:, None, None].expand(n, 1, dim))[:, 0]
        return z + transforms[gid, :, dim]

    params = (gmm_weights, gmm_means, gmm_inv_vars)
    est = estimate_transforms(params, feats)
    for _ in range(num_iters):
        x = apply_transforms(est[0])
        _, *params = gmm_ops.em_step(
            x, fweights, *params, min_gaussian_weight=min_gaussian_weight,
            reduce=reduce)
        params = tuple(params)
        est = estimate_transforms(params, x)
    return params + est
