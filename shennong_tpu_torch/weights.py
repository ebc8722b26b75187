"""Parameter carriers: models trained elsewhere, as the port's objects.

The UBM-GMM and the LVTLN transforms are the port's only trained
parameters. These take them as numpy arrays -- the fields of the JAX
package's ``DiagGmm`` (weights, means, inv_vars) and of its
``LinearVtln`` (transforms, warps, default_class), or a Kaldi model's
-- and build the port's objects, which compute the same
log-likelihoods and pick the same warp classes. Files written by the
JAX package (npz or Kaldi binary) load directly through
:meth:`DiagUbmProcessor.load` and :meth:`VtlnProcessor.load`.
"""

import numpy as np

from shennong_tpu_torch.ops.fmllr import LinearVtln
from shennong_tpu_torch.processor.ubm import DiagGmm


def gmm_from_numpy(weights, means, inv_vars):
    """A :class:`DiagGmm` from weights [G], means [G, D] and inverse
    variances [G, D] (any float dtype, kept as float64)."""
    weights = np.asarray(weights, dtype=np.float64)
    means = np.asarray(means, dtype=np.float64)
    inv_vars = np.asarray(inv_vars, dtype=np.float64)
    if weights.ndim != 1 or means.ndim != 2 or means.shape != inv_vars.shape \
            or means.shape[0] != weights.shape[0]:
        raise ValueError(
            f'inconsistent GMM shapes: weights {weights.shape}, means '
            f'{means.shape}, inv_vars {inv_vars.shape}')
    return DiagGmm(weights, means, inv_vars)


def lvtln_from_numpy(transforms, warps, default_class):
    """A :class:`LinearVtln` from the class transforms [C, D, D], their
    warps [C] and the default class index."""
    transforms = np.asarray(transforms, dtype=np.float64)
    warps = np.asarray(warps, dtype=np.float64)
    num_classes, dim = transforms.shape[0], transforms.shape[1]
    if transforms.shape != (num_classes, dim, dim) \
            or warps.shape != (num_classes,):
        raise ValueError(
            f'inconsistent LVTLN shapes: transforms {transforms.shape}, '
            f'warps {warps.shape}')
    if not 0 <= int(default_class) < num_classes:
        raise ValueError(
            f'default class {default_class} out of [0, {num_classes})')
    lvtln = LinearVtln(dim, num_classes, int(default_class))
    lvtln.transforms = transforms.copy()
    lvtln.warps = warps.copy()
    return lvtln
