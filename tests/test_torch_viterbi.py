"""The port's pitch Viterbi against the JAX reference.

The plain PyTorch versions (what CPU tensors run) must give exactly
the reference's lags (``_viterbi_lags`` and the Pallas kernels run in
the Pallas interpreter) and a bit-equal forward history. The CUDA
kernels are held against the plain versions on the card in
tests/test_torch_gpu.py.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shennong_tpu.ops.pallas_viterbi import (
    viterbi_forward_pallas, viterbi_lags_pallas)
from shennong_tpu.ops.pitch import _viterbi_lags as jax_viterbi_lags
from shennong_tpu_torch.ops import cuda_viterbi

torch.set_num_threads(2)

FACTOR = 2.5e-3

# the shapes of tests/test_pallas_viterbi.py, plus rows of 0 and 1
# valid frames and a single-frame batch
CASES = [
    ((5, 37, 50), [37, 30, 37, 5, 1]),
    ((1, 10, 417), [10]),
    ((8, 64, 130), [64] * 8),
    ((3, 100, 7), [100, 99, 50]),
    ((4, 20, 33), [20, 0, 1, 7]),
    ((2, 1, 417), [1, 0]),
]


def _inputs(shape, bounds, seed=0):
    rng = np.random.RandomState(seed)
    local_cost = rng.rand(*shape).astype(np.float32)
    return local_cost, np.asarray(bounds, dtype=np.int32)


@pytest.mark.parametrize('shape,bounds', CASES)
def test_plain_matches_reference(shape, bounds):
    local_cost, nframes = _inputs(shape, bounds)
    cost_t, nframes_t = torch.from_numpy(local_cost), torch.from_numpy(nframes)

    hist = cuda_viterbi.viterbi_forward_plain(cost_t, nframes_t, FACTOR)
    ref_hist = np.asarray(viterbi_forward_pallas(
        jnp.asarray(local_cost), _penalty(shape[2]), jnp.asarray(nframes),
        interpret=True))
    # bit-equal over every frame (pass-through frames included)
    assert hist.numpy().tobytes() == ref_hist.tobytes()

    ours = cuda_viterbi.viterbi_lags_plain(cost_t, FACTOR, nframes_t).numpy()
    scan = np.asarray(jax_viterbi_lags(
        jnp.asarray(local_cost), FACTOR, jnp.asarray(nframes)))
    pallas = np.asarray(viterbi_lags_pallas(
        jnp.asarray(local_cost), FACTOR, jnp.asarray(nframes),
        interpret=True))
    assert ours.dtype == np.int32 and ours.shape == shape[:2]
    for row, bound in enumerate(bounds):
        assert np.array_equal(ours[row, :bound], scan[row, :bound]), row
        assert np.array_equal(ours[row, :bound], pallas[row, :bound]), row


def _penalty(nlags):
    """The reference's penalty matrix (viterbi_lags_pallas)"""
    idx = jnp.arange(nlags)
    return (idx[:, None] - idx[None, :]).astype(jnp.float32) ** 2 * FACTOR


def test_structured_costs():
    """A cost landscape with a clear path: the plain version tracks the
    moving minimum, like the reference."""
    bsz, nframes_max, nlags = 2, 60, 40
    local_cost = np.full((bsz, nframes_max, nlags), 5.0, dtype=np.float32)
    path = np.linspace(5, 35, nframes_max).astype(int)
    local_cost[:, np.arange(nframes_max), path] = 0.0
    nframes = np.full(bsz, nframes_max, dtype=np.int32)

    ours = cuda_viterbi.viterbi_lags_plain(
        torch.from_numpy(local_cost), 1e-4, torch.from_numpy(nframes))
    assert np.abs(ours.numpy()[0] - path).max() <= 1
    ref = np.asarray(jax_viterbi_lags(
        jnp.asarray(local_cost), 1e-4, jnp.asarray(nframes)))
    assert np.array_equal(ours.numpy(), ref)


def test_wrapper_dispatch_on_cpu():
    """CPU tensors take the plain version and launch nothing."""
    local_cost, nframes = _inputs((3, 12, 20), [12, 5, 0])
    cost_t, nframes_t = torch.from_numpy(local_cost), torch.from_numpy(nframes)
    cuda_viterbi.reset_launches()
    lags = cuda_viterbi.viterbi_lags(cost_t, FACTOR, nframes_t)
    assert cuda_viterbi.LAUNCHES == {
        'viterbi_forward': 0, 'viterbi_backtrace': 0}
    assert torch.equal(
        lags, cuda_viterbi.viterbi_lags_plain(cost_t, FACTOR, nframes_t))


@pytest.mark.parametrize('case', ['dtype', 'nframes_dtype', 'rows', 'device'])
def test_wrapper_checks(case):
    cost = torch.zeros((2, 4, 5))
    nframes = torch.full((2,), 4, dtype=torch.int32)
    if case == 'dtype':
        cost = cost.to(torch.float64)
    elif case == 'nframes_dtype':
        nframes = nframes.to(torch.int64)
    elif case == 'rows':
        nframes = nframes[:1]
    else:
        cost, nframes = cost.to('meta'), nframes.to('meta')
    with pytest.raises(ValueError):
        cuda_viterbi.viterbi_forward(cost, nframes, FACTOR)
    with pytest.raises(ValueError):
        cuda_viterbi.viterbi_backtrace(
            cost.transpose(0, 1).contiguous(), nframes, FACTOR)


@pytest.mark.parametrize('case', ['ndim', 'nframes_ndim', 'mixed_devices'])
def test_wrapper_shape_checks(case):
    cost = torch.zeros((2, 4, 5))
    nframes = torch.full((2,), 4, dtype=torch.int32)
    if case == 'ndim':
        cost = cost[0]
    elif case == 'nframes_ndim':
        nframes = nframes[:, None]
    else:
        nframes = nframes.to('meta')
    with pytest.raises(ValueError):
        cuda_viterbi.viterbi_forward(cost, nframes, FACTOR)
    with pytest.raises(ValueError):
        cuda_viterbi.viterbi_backtrace(
            cost.transpose(0, 1).contiguous() if cost.ndim == 3 else cost,
            nframes, FACTOR)


# ------------------------------------------------------- the kernels' host side

@pytest.mark.parametrize('factor', [FACTOR, 0.1 * np.log(1.005) ** 2])
@pytest.mark.parametrize('nlags', [1, 7, 50, 417])
def test_penalty_table(nlags, factor):
    """The kernels' mirrored table, built in numpy float32 as the kernels
    build it (entry m holds fl(fl(k * k) * factor) for k = m - (L - 1)),
    holds the plain versions' and the reference's penalty bit for bit:
    entry i - j + L - 1 for lags (i, j)."""
    steps = np.arange(-(nlags - 1), nlags).astype(np.float32)
    table = (steps * steps) * np.float32(factor)
    assert table.dtype == np.float32 and table.shape == (2 * nlags - 1,)
    idx = np.arange(nlags)
    mirrored = table[idx[:, None] - idx[None, :] + nlags - 1]
    plain = cuda_viterbi.transition_penalty(nlags, factor).numpy()
    assert mirrored.tobytes() == plain.tobytes()
    ref = (jnp.arange(nlags)[:, None] - jnp.arange(nlags)[None, :]).astype(
        jnp.float32) ** 2 * np.float32(factor)
    assert mirrored.tobytes() == np.asarray(ref).tobytes()
    assert (table >= 0).all() and not np.signbit(table).any()


# clusters of C forward blocks an H100 80GB HBM3 holds at once, one
# block per SM (cudaOccupancyMaxActiveClusters for C = 1 .. 16, as
# chip_smoke.py prints them)
H100_CLUSTERS = dict(enumerate(
    [660, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7], start=1))


@pytest.mark.parametrize('nlags,expected', [
    (1, {1: 1, 3: 1, 8: 1, 64: 1, 128: 1}),
    (7, {1: 7, 3: 7, 8: 7, 64: 2, 128: 1}),
    (417, {1: 16, 3: 16, 8: 9, 64: 2, 128: 1}),
])
def test_cluster_size(nlags, expected):
    """The largest cluster with a lag for every block, one wave of one
    block per SM, and room for every row's cluster at once."""
    for batch, size in expected.items():
        assert cuda_viterbi.cluster_size(
            batch, nlags, 132, H100_CLUSTERS.get) == size, batch
    # with room for any cluster, only the lags and the SMs bound it
    assert cuda_viterbi.cluster_size(8, 417, 132, lambda size: 1000) == 16
    assert cuda_viterbi.cluster_size(64, 417, 132, lambda size: 1000) == 2
    assert cuda_viterbi.cluster_size(8, 417, 132, lambda size: 0) == 1


def test_backtrace_scores_nonnegative(monkeypatch):
    """On the costs of tests/data/test.wav, every score the backtrace
    reduces (history plus penalty) is >= +0, never -0: their float bits
    order as unsigned ints, which the kernel's argmin relies on."""
    from shennong_tpu_torch.audio import Audio
    from shennong_tpu_torch.ops import pitch
    from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchProcessor

    seen = []
    real = pitch.cuda_viterbi.viterbi_lags

    def recording(local_cost, factor, nframes):
        seen.append((local_cost.clone(), factor, nframes.clone()))
        return real(local_cost, factor, nframes)

    monkeypatch.setattr(pitch.cuda_viterbi, 'viterbi_lags', recording)
    wav = os.path.join(os.path.dirname(__file__), 'data', 'test.wav')
    KaldiPitchProcessor().process(Audio.load(wav), device='cpu')
    assert seen
    for local_cost, factor, nframes in seen:
        nframes = nframes.to(torch.int32)
        hist = cuda_viterbi.viterbi_forward_plain(local_cost, nframes, factor)
        best = cuda_viterbi.viterbi_backtrace_plain(hist, nframes, factor)
        penalty = cuda_viterbi.transition_penalty(hist.shape[2], factor)
        assert not torch.signbit(hist).any()
        for t in range(hist.shape[0] - 1):
            scores = hist[t] + penalty[best[t + 1].long()]
            assert not torch.signbit(scores).any(), t
