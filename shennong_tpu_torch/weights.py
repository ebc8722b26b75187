"""Parameter carriers: models trained elsewhere, as the port's objects.

These take trained parameters as numpy arrays and build the port's
objects, checking that the shapes agree:

- the UBM-GMM and the LVTLN transforms, from the fields of the JAX
  package's ``DiagGmm`` (weights, means, inv_vars) and ``LinearVtln``
  (transforms, warps, default_class) or a Kaldi model's; files written
  by the JAX package (npz or Kaldi binary) load directly through
  :meth:`DiagUbmProcessor.load` and :meth:`VtlnProcessor.load`;
- the CREPE CNN, from the JAX package's keras-layout parameter dict
  (the npz files of ``share/crepe/``);
- the BUT/Phonexia stacked-bottleneck networks, from the BUT npz
  layout.
"""

import numpy as np
import torch

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


def crepe_from_numpy(params):
    """A :class:`shennong_tpu_torch.models.crepe.Crepe` from the keras
    layout of the JAX package: ``conv{i}/kernel`` [W, Cin, Cout],
    ``conv{i}/{bias, gamma, beta, mean, var}`` [Cout] for i = 1..6,
    ``classifier/kernel`` [4 * Cout6, 360] and ``classifier/bias``
    [360]. Raises ValueError on a missing key or inconsistent shapes."""
    from shennong_tpu_torch.models import crepe

    def array(name):
        if name not in params:
            raise ValueError(f'CREPE parameters miss {name}')
        return np.asarray(params[name], dtype=np.float32)

    channels, cin = [], 1
    for i, width in enumerate(crepe.LAYER_WIDTHS, start=1):
        kernel = array(f'conv{i}/kernel')
        if kernel.ndim != 3 or kernel.shape[:2] != (width, cin):
            raise ValueError(
                f'conv{i}/kernel has shape {kernel.shape}, expected '
                f'({width}, {cin}, Cout)')
        cin = kernel.shape[2]
        for part in ('bias', 'gamma', 'beta', 'mean', 'var'):
            if array(f'conv{i}/{part}').shape != (cin,):
                raise ValueError(
                    f'conv{i}/{part} has shape '
                    f'{array(f"conv{i}/{part}").shape}, expected ({cin},)')
        channels.append(cin)
    kernel, bias = array('classifier/kernel'), array('classifier/bias')
    if kernel.shape != (4 * cin, crepe.BINS) or bias.shape != (crepe.BINS,):
        raise ValueError(
            f'classifier kernel {kernel.shape} and bias {bias.shape}, '
            f'expected ({4 * cin}, {crepe.BINS}) and ({crepe.BINS},)')

    model = crepe.Crepe(channels)
    with torch.no_grad():
        for i, conv in enumerate(model.convs, start=1):
            # [W, Cin, Cout] -> PyTorch's [Cout, Cin, W]
            conv.weight.copy_(torch.tensor(
                array(f'conv{i}/kernel').transpose(2, 1, 0)))
            conv.bias.copy_(torch.tensor(array(f'conv{i}/bias')))
            model.set_batch_norm(
                i - 1, *(array(f'conv{i}/{part}')
                         for part in ('gamma', 'beta', 'mean', 'var')))
        model.classifier.weight.copy_(torch.tensor(kernel.T))
        model.classifier.bias.copy_(torch.tensor(bias))
    return model.eval().requires_grad_(False)


def bottleneck_from_numpy(params):
    """The parameters of a stacked-bottleneck network as float32 CPU
    tensors, from the BUT npz layout: ``context``, ``input_mean`` and
    ``input_std`` [D], the first stage ``W1``..``W3`` / ``b1``..``b3``
    (its last layer the bottleneck B), ``bn_mean`` and ``bn_std``
    [5 B] (the 5-offset stagger stacking), the second stage ``W5``.. /
    ``b5``.. Returns (tensors by name, context). Raises ValueError on
    a missing key or inconsistent shapes."""
    for name in ('context', 'input_mean', 'input_std', 'bn_mean',
                 'bn_std'):
        if name not in params:
            raise ValueError(f'bottleneck parameters miss {name}')
    tensors = {
        name: torch.tensor(np.asarray(value, dtype=np.float32))
        for name, value in params.items() if name != 'context'}

    def chain(indices, width, what):
        if not indices:
            raise ValueError(f'bottleneck parameters have no {what}')
        for index in indices:
            weight = tensors[f'W{index}']
            bias = tensors.get(f'b{index}')
            if weight.ndim != 2 or weight.shape[0] != width \
                    or bias is None or bias.shape != (weight.shape[1],):
                raise ValueError(
                    f'W{index} {tuple(weight.shape)} and b{index} '
                    f'{None if bias is None else tuple(bias.shape)} do not '
                    f'follow a {width}-wide input')
            width = weight.shape[1]
        return width

    layers = sorted(int(name[1:]) for name in tensors
                    if name.startswith('W'))
    dim = tensors['input_mean'].shape[0]
    if tensors['input_mean'].ndim != 1 \
            or tensors['input_std'].shape != (dim,):
        raise ValueError(
            f'input_mean {tuple(tensors["input_mean"].shape)} and input_std '
            f'{tuple(tensors["input_std"].shape)} are not one [D] vector each')
    bottleneck = chain([i for i in layers if i <= 3], dim, 'first stage')
    stacked = 5 * bottleneck
    for name in ('bn_mean', 'bn_std'):
        if tensors[name].shape != (stacked,):
            raise ValueError(
                f'{name} has shape {tuple(tensors[name].shape)}, expected '
                f'({stacked},)')
    chain([i for i in layers if i >= 5], stacked, 'second stage')
    return tensors, int(params['context'])
