"""The CREPE conv block's plain path, weight packing and counters on the
CPU (the kernel itself runs on the card: ``tests/test_torch_gpu.py``).

- ``ops.crepe_conv.conv_block`` on a CPU tensor, block by block and
  through ``Crepe``, equals the chain ``Crepe._features`` ran before the
  kernel existed, bit for bit;
- ``pack_weight`` round-trips through its inverse, and the packed
  weights read as the kernel reads them (its staged samples, windows of
  64 taps over sub-channels) give the convolution;
- the wrapper's checks, and its refusal of a device without a kernel;
- the reader of ``crepe_conv_kernel_pct``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench.manifest import Manifest
from perfbench.tracing import TracedRun
from shennong_tpu_torch.models import crepe
from shennong_tpu_torch.ops import crepe_conv
from shennong_tpu_torch.parallel.profiler import counters
from shennong_tpu_torch.weights import crepe_from_numpy

torch.set_num_threads(2)


def seeded_params(capacity, seed):
    """Seeded CREPE parameters at a capacity's widths, keras layout."""
    rng = np.random.RandomState(seed)
    mult = crepe.CAPACITY_MULTIPLIER[capacity]
    params, cin = {}, 1
    for i, (filters, width) in enumerate(
            zip(crepe.LAYER_FILTERS, crepe.LAYER_WIDTHS), start=1):
        cout = filters * mult
        params[f'conv{i}/kernel'] = (rng.randn(width, cin, cout)
                                     / np.sqrt(width * cin)).astype(np.float32)
        for name, values in (('bias', 0.01 * rng.randn(cout)),
                             ('gamma', 1 + 0.1 * rng.randn(cout)),
                             ('beta', 0.1 * rng.randn(cout)),
                             ('mean', 0.1 * rng.rand(cout)),
                             ('var', 0.5 + rng.rand(cout))):
            params[f'conv{i}/{name}'] = values.astype(np.float32)
        cin = cout
    params['classifier/kernel'] = (rng.randn(4 * cin, 360)
                                   / np.sqrt(4 * cin)).astype(np.float32)
    params['classifier/bias'] = np.zeros(360, np.float32)
    return params


def old_features(model, frames):
    """``Crepe._features`` as it was before the conv kernel."""
    x = frames[:, None, :]
    for i, conv in enumerate(model.convs):
        size = x.shape[-1]
        stride, width = conv.stride[0], conv.kernel_size[0]
        total = max((-(-size // stride) - 1) * stride + width - size, 0)
        x = conv(F.pad(x, (total // 2, total - total // 2)))
        x.relu_()
        x.sub_(getattr(model, f'bn{i}_mean')[:, None])
        x.mul_(getattr(model, f'bn{i}_scale')[:, None])
        x.add_(getattr(model, f'bn{i}_beta')[:, None])
        x = F.max_pool1d(x, 2)
    return x.transpose(1, 2).reshape(x.shape[0], -1)


def block_input(model, layer, nframes, seed):
    """A random input of block ``layer`` at the network's shape."""
    shape = (1, 1024) if layer == 0 else (
        model.channels[layer - 1], 128 >> (layer - 1))
    return torch.from_numpy(np.random.RandomState(seed).randn(
        nframes, *shape).astype(np.float32))


@pytest.fixture(scope='module')
def tiny():
    return crepe.load_model('tiny', 'cpu')


@pytest.mark.parametrize('layer', range(6))
def test_a_block_on_the_cpu_is_the_old_chain(tiny, layer):
    x = block_input(tiny, layer, 5, layer)
    with torch.no_grad():
        ours = crepe_conv.conv_block(x, tiny.block(layer))
        # the old chain's step for this block, from a network of one block
        old = crepe_conv.conv_block_plain(x.clone(), tiny.block(layer))
        conv = tiny.convs[layer]
        total = max((-(-x.shape[-1] // conv.stride[0]) - 1) * conv.stride[0]
                    + conv.kernel_size[0] - x.shape[-1], 0)
        ref = conv(F.pad(x, (total // 2, total - total // 2)))
        ref.relu_()
        ref.sub_(getattr(tiny, f'bn{layer}_mean')[:, None])
        ref.mul_(getattr(tiny, f'bn{layer}_scale')[:, None])
        ref.add_(getattr(tiny, f'bn{layer}_beta')[:, None])
        ref = F.max_pool1d(ref, 2)
    assert torch.equal(old, ref)
    assert torch.equal(ours, ref)


@pytest.mark.parametrize('capacity', ['tiny', 'small'])
def test_the_network_on_the_cpu_is_the_old_chain(tiny, capacity):
    model = tiny if capacity == 'tiny' else crepe_from_numpy(
        seeded_params(capacity, 3))
    frames = torch.from_numpy(np.random.RandomState(4).randn(
        9, 1024).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(model._features(frames),
                           old_features(model, frames))
        # a non-contiguous view of frames, as a one-row chunk gives
        strided = torch.randn(4000).unfold(0, 1024, 160)
        assert torch.equal(model._features(strided),
                           old_features(model, strided))


def unpack_weight(packed, stride):
    """The inverse of ``pack_weight``: [C, 64, Cout] -> [Cout, Cin, W]."""
    channels, taps, cout = packed.shape
    if stride == 1:
        return packed.permute(2, 0, 1)
    halves = channels // stride
    return packed.reshape(halves, stride, taps, cout).permute(
        3, 0, 2, 1).reshape(cout, 1, halves * taps * stride)


@pytest.mark.parametrize('capacity', list(crepe.CAPACITY_MULTIPLIER))
def test_packed_weights_round_trip(capacity):
    model = crepe_from_numpy(seeded_params(capacity, 5))
    for conv in model.convs:
        weight = conv.weight.detach()
        packed = crepe_conv.pack_weight(weight, conv.stride[0])
        subchannels = conv.in_channels * conv.kernel_size[0] // 64
        assert packed.shape == (subchannels, 64, conv.out_channels)
        assert packed.is_contiguous()
        assert torch.equal(
            unpack_weight(packed, conv.stride[0]), weight)


def staged_convolution(x, block):
    """The convolution and bias as the kernel computes them, in float64:
    sub-channel c of the packed weights [C, 64, Cout] slides over staged
    samples, sample i of c being x[S i + off(c)] (zero outside), with
    off(c) = -pad at stride 1 and 256 (c // 4) + c % 4 - pad at stride
    4 over one channel."""
    conv = block.conv
    stride = conv.stride[0]
    nframes, _, size = x.shape
    times = size // stride
    pad = crepe_conv.same_padding(size, stride, conv.kernel_size[0])[0]
    packed = crepe_conv.pack_weight(conv.weight.detach(), stride).double()
    y = conv.bias.detach().double()[None, :, None].repeat(nframes, 1, times)
    for c in range(packed.shape[0]):
        channel = c if stride == 1 else 0
        offset = -pad if stride == 1 else (
            stride * 64 * (c // stride) + c % stride - pad)
        where = stride * torch.arange(times + 64) + offset
        inside = (where >= 0) & (where < size)
        staged = torch.zeros(nframes, times + 64, dtype=torch.float64)
        staged[:, inside] = x[:, channel, where[inside]].double()
        windows = staged.unfold(1, 64, 1)[:, :times]
        y += torch.einsum('ntj,jo->not', windows, packed[c])
    return y


@pytest.mark.parametrize('layer', range(6))
def test_the_kernels_reading_of_packed_weights_is_the_convolution(
        tiny, layer):
    x = block_input(tiny, layer, 3, 10 + layer)
    block = tiny.block(layer)
    conv = block.conv
    exact = F.conv1d(
        F.pad(x.double(), crepe_conv.same_padding(
            x.shape[-1], conv.stride[0], conv.kernel_size[0])),
        conv.weight.detach().double(), conv.bias.detach().double(),
        stride=conv.stride[0])
    assert float((staged_convolution(x, block) - exact).abs().max()) < 1e-9


def test_the_packed_weight_is_kept_until_the_weight_changes():
    model = crepe_from_numpy(seeded_params('tiny', 6))
    conv = model.convs[1]
    first = crepe_conv.packed_weight(conv)
    assert crepe_conv.packed_weight(conv) is first
    with torch.no_grad():
        conv.weight.mul_(2)
    again = crepe_conv.packed_weight(conv)
    assert again is not first
    assert torch.equal(again, 2 * first)
    assert 'packed' not in ''.join(model.state_dict())


@pytest.mark.parametrize('case', [
    'dtype', 'channels', 'times', 'contiguous', 'first_times', 'width'])
def test_the_wrapper_checks_what_the_kernel_takes(tiny, case):
    block = tiny.block(1)
    x = torch.zeros(2, 128, 128)
    assert crepe_conv.output_times(x, block) == 128
    assert crepe_conv.output_times(torch.zeros(2, 1, 1024),
                                   tiny.block(0)) == 256
    bad = {
        'dtype': (x.double(), block),
        'channels': (x[:, :64].contiguous(), block),
        'times': (x[..., :96].contiguous(), block),
        'contiguous': (x.transpose(1, 2), block),
        'first_times': (torch.zeros(2, 1, 1000), tiny.block(0)),
        'width': (x, crepe_conv.Block(
            torch.nn.Conv1d(128, 16, 32), *block[1:])),
    }[case]
    with pytest.raises(ValueError):
        crepe_conv.output_times(*bad)


def test_another_device_raises_and_the_cpu_counts_no_launch(tiny):
    counters.reset()
    x = torch.zeros(2, 128, 128)
    with torch.no_grad():
        crepe_conv.conv_block(x, tiny.block(1))
        crepe_conv.conv_block(torch.zeros(2, 1, 1024), tiny.block(0))
    assert 'launches.crepe_conv' not in counters.snapshot()
    assert 'crepe_conv_kernel_frames' not in counters.snapshot()
    with pytest.raises(ValueError):
        crepe_conv.conv_block(x.to('meta'), tiny.block(1))


def window(counters_):
    return TracedRun(
        audio_s=1800.0, calls=[(0.0, 10e6), (10e6, 20e6)],
        counters=counters_, spans=[], device=[], span_totals={}, work={})


def test_crepe_conv_kernel_pct():
    read = Manifest().reader('crepe_conv_kernel_pct')
    assert read(window({})) is None
    assert read(window({'crepe_cnn_frames': 1000.0})) is None
    assert read(window({'crepe_conv_kernel_frames': 10.0})) is None
    assert read(window({'crepe_cnn_frames': 1000.0,
                        'crepe_conv_kernel_frames': 1000.0})) == 100.0
    entry = {m['name']: m for m in Manifest().data['per_layer']}[
        'crepe_conv_kernel_pct']
    assert entry['layer'] == 'CREPE CNN' and entry['moves'] == 'card_xrt'
    assert entry['workloads'] == ['crepe_pitch.test_clean_2spk']
