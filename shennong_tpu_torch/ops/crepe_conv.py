"""One conv block of the CREPE CNN ('SAME' padding, convolution, bias,
ReLU, inference batch norm, max-pooling by 2): a hand-written CUDA
kernel and its plain PyTorch version.

Replaces no TPU kernel: the JAX package's CNN
(:mod:`shennong_tpu.models.crepe`) is XLA's ``lax.conv``.
:func:`conv_block` dispatches by the device of its input: a CPU tensor
takes :func:`conv_block_plain`, the chain :class:`Crepe
<shennong_tpu_torch.models.crepe.Crepe>` ran before the kernel existed;
a CUDA tensor launches ``csrc/crepe_conv.cu`` (a
:class:`~shennong_tpu_torch.native.Library`, built at first use) or
raises: nothing falls back to cuDNN. Every launch adds one to
``counters['launches.crepe_conv']``, and a launch of the first block
(stride 4) adds its frames to ``counters['crepe_conv_kernel_frames']``
(:mod:`shennong_tpu_torch.parallel.profiler`): the network's later
blocks take the same frames, in the kernel or not at all.

The kernel takes the weights repacked once into [sub-channel, tap,
Cout] (:func:`pack_weight`, cached on the ``Conv1d`` by
:func:`packed_weight`): a width-64 block's [Cin, 64, Cout], and the
first block's width 512 at stride 4 as 8 sub-channels of 64 taps, its
input's residue classes modulo 4 (``csrc/crepe_conv.cu`` states the
arithmetic). Both versions add the bias, apply ReLU and batch norm in
the same order, each step rounded on its own; they sum the products in
other orders, so they differ by float32 rounding.
"""

import ctypes
import typing

import torch
import torch.nn.functional as F

from shennong_tpu_torch import native
from shennong_tpu_torch.parallel.profiler import counters

_P, _INT = ctypes.c_void_p, ctypes.c_int

#: the kernel library, its entry point and its (restype, argtypes)
_KERNELS = native.Library(['csrc/crepe_conv.cu'], {
    'shennong_crepe_conv': (_INT, [
        _P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
        _P]),
}, errors='shennong_crepe_conv_error_string')

#: taps of a sub-channel of the packed weights
TAPS = 64


class Block(typing.NamedTuple):
    """One conv block: its ``Conv1d`` and its batch norm's [Cout]
    mean, scale (gamma / sqrt(var + eps)) and beta."""

    conv: torch.nn.Conv1d
    mean: torch.Tensor
    scale: torch.Tensor
    beta: torch.Tensor


def same_padding(size, stride, width):
    """(left, right) zeros of TensorFlow's 'SAME' padding: ceil(size /
    stride) outputs, the odd sample on the right."""
    total = max((-(-size // stride) - 1) * stride + width - size, 0)
    return total // 2, total - total // 2


def conv_block_plain(x, block):
    """The block as tensor operations on any device: 'SAME' padding,
    ``Conv1d``, then ReLU and batch norm in place (the first block's
    activation is the network's largest tensor), then max-pooling."""
    conv = block.conv
    x = conv(F.pad(x, same_padding(
        x.shape[-1], conv.stride[0], conv.kernel_size[0])))
    x.relu_()
    x.sub_(block.mean[:, None])
    x.mul_(block.scale[:, None])
    x.add_(block.beta[:, None])
    return F.max_pool1d(x, 2)


def pack_weight(weight, stride):
    """A ``Conv1d`` weight [Cout, Cin, W] -> the kernel's [C, 64, Cout]:
    for stride 1 (W = 64) ``[ci, k, co]``; for stride 4 over one input
    channel, sub-channel ``4 h + r`` holds taps ``4 (64 h + j) + r``,
    j < 64."""
    cout, cin, width = weight.shape
    if stride == 1:
        return weight.permute(1, 2, 0).contiguous()
    halves = width // (TAPS * stride)
    return (weight[:, 0, :].reshape(cout, halves, TAPS, stride)
            .permute(1, 3, 2, 0).reshape(-1, TAPS, cout).contiguous())


def packed_weight(conv):
    """The kernel's weights of ``conv`` (:func:`pack_weight`), repacked
    once and kept on the module beside its weight, again where the
    weight's storage or version has changed."""
    weight = conv.weight
    key = (weight.data_ptr(), weight._version, weight.device)
    cached = getattr(conv, '_packed_weight', None)
    if cached is None or cached[0] != key:
        cached = (key, pack_weight(weight.detach(), conv.stride[0]))
        conv._packed_weight = cached
    return cached[1]


def output_times(x, block):
    """The block's output times before pooling for input ``x``, or
    ValueError unless ``x`` is a float32 contiguous [N, Cin, T] tensor
    of a shape the kernel takes: a width-64 block at stride 1 over T a
    power of two in [8, 128], or the width-512 block at stride 4 over
    one channel with T / 4 a multiple of 128; the output channels a
    multiple of 8."""
    conv = block.conv
    stride, width = conv.stride[0], conv.kernel_size[0]
    cin, cout = conv.in_channels, conv.out_channels
    if x.dtype != torch.float32 or x.ndim != 3 or x.shape[1] != cin:
        raise ValueError(
            f'the block takes [N, {cin}, T] float32, not {x.dtype} of shape '
            f'{tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError('the block takes a contiguous input')
    size = x.shape[-1]
    times = size // stride
    if (stride, width) == (1, TAPS):
        taken = 8 <= times <= 128 and times & (times - 1) == 0
    elif (stride, width) == (4, 512) and cin == 1:
        taken = size % 4 == 0 and times % 128 == 0
    else:
        raise ValueError(
            f'no kernel for a block of width {width} at stride {stride} '
            f'over {cin} channels')
    if not taken or cout % 8:
        raise ValueError(
            f'no kernel for {size} samples into {cout} channels through a '
            f'block of width {width} at stride {stride}')
    return times


def conv_block(x, block):
    """The pooled output of a conv block for ``x`` [N, Cin, T]:
    [N, Cout, T' / 2] with T' = ceil(T / stride).

    A CPU tensor takes :func:`conv_block_plain`; a CUDA tensor launches
    the kernel (:func:`output_times` gives the shapes it takes, and
    anything else raises ValueError); another device raises."""
    if x.device.type == 'cpu':
        return conv_block_plain(x, block)
    if x.device.type != 'cuda':
        raise ValueError(f'no CREPE conv kernel for device {x.device}')
    times = output_times(x, block)
    conv = block.conv
    nframes, cout = x.shape[0], conv.out_channels
    out = torch.empty((nframes, cout, times // 2), dtype=torch.float32,
                      device=x.device)
    if nframes == 0:
        return out
    weight = packed_weight(conv)
    params = [t.detach().to(torch.float32).contiguous() for t in (
        conv.bias, block.mean, block.scale, block.beta)]
    lib = _KERNELS.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.shennong_crepe_conv(
            x.data_ptr(), weight.data_ptr(), *(t.data_ptr() for t in params),
            out.data_ptr(), nframes, conv.in_channels, x.shape[-1], cout,
            conv.kernel_size[0], conv.stride[0],
            same_padding(x.shape[-1], conv.stride[0], conv.kernel_size[0])[0],
            stream)
    _KERNELS.check(code, 'crepe_conv')
    counters.add('launches.crepe_conv')
    if conv.stride[0] == 4:
        counters.add('crepe_conv_kernel_frames', nframes)
    return out
