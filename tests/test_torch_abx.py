"""The port's ABX evaluator against the JAX package, on the CPU.

``shennong_tpu_torch.eval.abx`` (frame costs, DTW divergences,
pairwise distance matrices, segments from alignments, ABX scoring) and
the DTW recursion of ``shennong_tpu_torch.ops.dtw`` are held against
``shennong_tpu.eval.abx`` on the same numpy inputs made from a seed.
Tolerances:

- DTW divergences on real-valued features: 1e-5 absolute (both sum in
  float32, the port's ``torch.cumsum`` in another order than XLA's);
- integer-valued costs (one-hot features under the cosine metric,
  integer cost matrices): equal, since every sum is exact; on them the
  plain version also equals the DTW kernel's cell-by-cell recurrence,
  written here in numpy;
- ABX errors and segments on the same distances and features: equal.

A CPU tensor never launches the DTW kernel (its launch count stays 0).
The float64 near-tie proof that ``chip_smoke.py`` and the GPU tests
apply to a kernel divergence past 1e-5 (``chip_smoke.dtw_near_tie``)
is held here on a tie and on random costs.
"""

import numpy as np
import pytest
import torch

from chip_smoke import dtw_near_tie, launch_counts, reset_counters
from shennong_tpu.alignment import Alignment as JAlignment
from shennong_tpu.eval import abx as jabx
from shennong_tpu.features import Features as JFeatures
from shennong_tpu_torch.alignment import Alignment
from shennong_tpu_torch.eval import abx
from shennong_tpu_torch.features import Features
from shennong_tpu_torch.ops import dtw

TOL = 1e-5


def ragged_pairs(lengths, dim, seed):
    """Zero-padded [B, Ta, D] and [B, Tb, D] float32 segments of the
    given (na, nb) lengths, and their counts."""
    rng = np.random.RandomState(seed)
    max_a = max(a for a, _ in lengths)
    max_b = max(b for _, b in lengths)
    xs = np.zeros((len(lengths), max_a, dim), np.float32)
    ys = np.zeros((len(lengths), max_b, dim), np.float32)
    for row, (na, nb) in enumerate(lengths):
        xs[row, :na] = rng.randn(na, dim)
        ys[row, :nb] = rng.randn(nb, dim)
    nx = np.array([a for a, _ in lengths], np.int32)
    ny = np.array([b for _, b in lengths], np.int32)
    return xs, nx, ys, ny


def port_dtw(xs, nx, ys, ny, metric):
    return abx.dtw_divergences(
        torch.from_numpy(xs), torch.from_numpy(nx), torch.from_numpy(ys),
        torch.from_numpy(ny), metric).numpy()


def dtw_oracle(x, y, metric='cosine'):
    """Literal O(Ta*Tb) DTW in float64 with steps right/down/diagonal,
    the realized path length as normalizer and cost ties to the
    shortest path (the oracle of tests/test_abx.py). Returns
    (divergence, cost, length)."""
    if metric == 'cosine':
        xn = x / np.maximum(
            np.linalg.norm(x, axis=1, keepdims=True), 1e-6)
        yn = y / np.maximum(
            np.linalg.norm(y, axis=1, keepdims=True), 1e-6)
        costs = 1.0 - xn @ yn.T
    else:
        costs = np.sqrt(np.maximum(
            (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
            - 2 * x @ y.T, 0))
    rows, cols = costs.shape
    acc = np.full((rows, cols), np.inf)
    plen = np.zeros((rows, cols), np.int64)
    acc[0, 0] = costs[0, 0]
    plen[0, 0] = 1
    for j in range(1, cols):
        acc[0, j] = acc[0, j - 1] + costs[0, j]
        plen[0, j] = j + 1
    for i in range(1, rows):
        acc[i, 0] = acc[i - 1, 0] + costs[i, 0]
        plen[i, 0] = i + 1
        for j in range(1, cols):
            best = min(
                (acc[i - 1, j], plen[i - 1, j]),
                (acc[i, j - 1], plen[i, j - 1]),
                (acc[i - 1, j - 1], plen[i - 1, j - 1]))
            acc[i, j] = costs[i, j] + best[0]
            plen[i, j] = best[1] + 1
    return (acc[-1, -1] / plen[-1, -1], acc[-1, -1],
            int(plen[-1, -1]))


def cellwise(costs, n, m):
    """The DTW kernel's recurrence in float32, cell by cell: D[i, j] =
    c[i, j] + the lexicographic (cost, length) minimum of the cells
    above, diagonal and left, one rounded add a cell."""
    acc = np.zeros((n, m), np.float32)
    plen = np.zeros((n, m), np.int64)
    for i in range(n):
        for j in range(m):
            if i == 0 and j == 0:
                acc[0, 0], plen[0, 0] = costs[0, 0], 1
                continue
            cands = [(acc[a, b], plen[a, b])
                     for a, b in ((i - 1, j), (i - 1, j - 1), (i, j - 1))
                     if a >= 0 and b >= 0]
            cost, length = min(cands)
            acc[i, j] = np.float32(costs[i, j]) + cost
            plen[i, j] = length + 1
    return np.float32(acc[-1, -1]) / np.float32(plen[-1, -1])


# ------------------------------------------------------------------- DTW

@pytest.mark.parametrize('metric', ['cosine', 'euclidean'])
@pytest.mark.parametrize('lengths,dim', [
    # ragged benchmark-like segments, counts from 1
    ([(1, 1), (1, 24), (24, 1), (24, 24), (3, 17), (17, 3), (9, 9),
      (24, 20), (2, 2), (13, 24)], 13),
    ([(64, 64), (64, 1), (1, 64), (40, 63), (64, 33)], 13),
    ([(300, 280)], 5),
])
def test_dtw_matches_jax(metric, lengths, dim):
    xs, nx, ys, ny = ragged_pairs(lengths, dim, seed=len(lengths))
    want = np.asarray(jabx.dtw_divergences(xs, nx, ys, ny, metric=metric))
    got = port_dtw(xs, nx, ys, ny, metric)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_dtw_matches_literal_oracle():
    lengths = [(1, 1), (1, 7), (5, 1), (12, 12), (23, 9), (8, 31)]
    xs, nx, ys, ny = ragged_pairs(lengths, 4, seed=0)
    for metric in ('cosine', 'euclidean'):
        got = port_dtw(xs, nx, ys, ny, metric)
        oracle = [dtw_oracle(xs[r, :na], ys[r, :nb], metric)
                  for r, (na, nb) in enumerate(lengths)]
        np.testing.assert_allclose(
            got, [div for div, _, _ in oracle], rtol=1e-5, atol=1e-6)
        # the normalizer is the realized path length: shorter than the
        # full staircase on some pair, within its bounds on all
        assert any(length < na + nb for (_, _, length), (na, nb)
                   in zip(oracle, lengths) if na > 1 and nb > 1)
        assert all(max(na, nb) <= length <= na + nb - 1
                   or (na, nb) == (1, 1)
                   for (_, _, length), (na, nb) in zip(oracle, lengths))


def tie_cases():
    """One-hot segments with {0, 1} cosine costs, whose optimal paths
    tie in cost at several lengths (tests/test_abx.py's cases and
    more)."""
    eye = np.eye(4, dtype=np.float32)
    cases = [
        ([0, 0, 0, 0, 0], [0, 0, 0]),
        ([1, 1, 1], [2, 2, 2, 2, 2, 2]),
        ([0, 0, 1, 1, 3], [0, 1, 1, 3]),
        ([0, 1, 0, 1], [1, 0, 1, 0, 1]),
        ([2], [2, 3, 2]),
        ([0, 1, 2, 3, 0, 1], [0]),
        ([3, 3, 0, 0, 3, 3, 1], [3, 0, 3, 1, 1]),
    ]
    max_a = max(len(a) for a, _ in cases)
    max_b = max(len(b) for _, b in cases)
    xs = np.zeros((len(cases), max_a, 4), np.float32)
    ys = np.zeros((len(cases), max_b, 4), np.float32)
    for row, (a, b) in enumerate(cases):
        xs[row, :len(a)] = eye[a]
        ys[row, :len(b)] = eye[b]
    nx = np.array([len(a) for a, _ in cases], np.int32)
    ny = np.array([len(b) for _, b in cases], np.int32)
    return xs, nx, ys, ny


def test_dtw_cost_ties_resolve_to_shortest_path():
    xs, nx, ys, ny = tie_cases()
    got = port_dtw(xs, nx, ys, ny, 'cosine')
    np.testing.assert_array_equal(
        got, np.asarray(jabx.dtw_divergences(xs, nx, ys, ny)))
    want = [dtw_oracle(xs[r, :na], ys[r, :nb])[0]
            for r, (na, nb) in enumerate(zip(nx, ny))]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # every monotone path of the all-ones case costs its length
    assert got[1] == 1.0


@pytest.mark.parametrize('shape', [
    (3, 1, 1), (4, 1, 11), (4, 11, 1), (16, 24, 24), (3, 64, 64),
    (2, 40, 33)])
def test_integer_costs_equal_cellwise_recurrence(shape):
    """On integer-valued costs the plain version, the JAX scan and the
    kernel's cell-by-cell recurrence agree exactly (ties in cost go to
    the shortest path in all three)."""
    rng = np.random.RandomState(sum(shape))
    costs = rng.randint(0, 3, shape).astype(np.float32)
    bsz, rows, cols = shape
    nx = np.r_[rows, rng.randint(1, rows + 1, bsz - 1)].astype(np.int32)
    ny = np.r_[cols, rng.randint(1, cols + 1, bsz - 1)].astype(np.int32)
    got = dtw.dtw_divergences(
        torch.from_numpy(costs), torch.from_numpy(nx),
        torch.from_numpy(ny)).numpy()
    want = np.array([cellwise(costs[b], nx[b], ny[b])
                     for b in range(bsz)], np.float32)
    np.testing.assert_array_equal(got, want)


def test_near_tie_proof():
    """A near-tie needs two path lengths of (nearly) the least cost,
    each explaining one of the divergences: the integer costs below,
    where a path of 2 cells and one of 3 both cost 2, are one. A
    divergence and itself are not (one length), nor a value off every
    length's least cost, nor, on random costs, the best divergence
    against that of a path a cell longer or shorter at the same
    cost."""
    costs = np.array([[1, 0], [0, 1]], np.float32)
    assert dtw_near_tie(costs, 2, 2, 1.0, 2 / 3)
    assert not dtw_near_tie(costs, 2, 2, 1.0, 1.0)
    assert not dtw_near_tie(costs, 2, 2, 1.0, 2 / 3 + 1e-3)
    rng = np.random.RandomState(5)
    for rows, cols in ((1, 1), (6, 9), (24, 24)):
        costs = rng.rand(rows, cols).astype(np.float32)
        div = float(dtw.dtw_divergences_plain(
            torch.from_numpy(costs[None]), [rows], [cols])[0])
        cost, length = dtw_oracle_costs(costs)
        assert abs(cost / length - div) < 1e-6
        assert not dtw_near_tie(costs, rows, cols, div, div)
        if rows > 1 and cols > 1:
            for other in (div * (1 + 1e-3), cost / (length - 1),
                          cost / (length + 1)):
                assert not dtw_near_tie(costs, rows, cols, div, other)


def dtw_oracle_costs(costs):
    """(cost, length) of the lexicographic best path of a cost matrix,
    in float64."""
    rows, cols = costs.shape
    acc = {}
    for i in range(rows):
        for j in range(cols):
            cands = [acc[a, b] for a, b in ((i - 1, j), (i - 1, j - 1),
                                             (i, j - 1)) if (a, b) in acc]
            cost, length = min(cands) if cands else (0.0, 0)
            acc[i, j] = (cost + float(costs[i, j]), length + 1)
    return acc[rows - 1, cols - 1]


def test_dtw_identical_segments_are_closest():
    rng = np.random.RandomState(1)
    seg = rng.randn(10, 6).astype(np.float32)
    other = rng.randn(10, 6).astype(np.float32)
    n = np.array([10, 10], np.int32)
    div = port_dtw(np.stack([seg, seg]), n, np.stack([seg, other]), n,
                   'cosine')
    assert div[0] < 1e-5
    assert div[1] > div[0]


def test_cpu_tensors_never_launch_the_kernel():
    xs, nx, ys, ny = ragged_pairs([(5, 7), (24, 24)], 13, seed=3)
    reset_counters()
    port_dtw(xs, nx, ys, ny, 'cosine')
    abx.pairwise_distances([xs[0, :5], ys[0, :7], xs[1]], device='cpu')
    assert launch_counts('dtw') == {'dtw': 0}


def test_dtw_wrapper_checks_its_inputs():
    costs = torch.zeros((2, 3, 4))
    counts = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match='float32'):
        dtw.dtw_divergences(costs.double(), counts, counts)
    with pytest.raises(ValueError, match='shape'):
        dtw.dtw_divergences(costs, torch.ones(3), counts)
    for nx, ny in ((counts - 1, counts), (counts, counts + 4)):
        with pytest.raises(ValueError, match='must lie in'):
            dtw.dtw_divergences(costs, nx, ny)
    with pytest.raises(ValueError, match='no DTW kernel'):
        dtw.dtw_divergences(costs.to('meta'), counts, counts)
    assert dtw.dtw_divergences(
        torch.zeros((0, 3, 4)), counts[:0], counts[:0]).shape == (0,)


def test_pairwise_distances_checks_counts_on_the_host(monkeypatch):
    """pairwise_distances checks the frame counts once on its numpy copy
    and hands every batch to the unchecked dispatch (never the checked
    entry point, whose test of counts on the card makes the host wait);
    the unchecked dispatch gives the checked one's divergences, and the
    host check raises on a count outside [1, T]."""
    rng = np.random.RandomState(5)
    segments = [rng.randn(rng.randint(1, 12), 13) for _ in range(9)]
    want = abx.pairwise_distances(segments, batch=5, device='cpu')
    hosts = []
    check = dtw.check_counts

    def recording(nx, ny, rows, cols):
        hosts.append(isinstance(nx, np.ndarray))
        return check(nx, ny, rows, cols)

    def checked(*args):
        raise AssertionError('a batch took the checked entry point')

    monkeypatch.setattr(dtw, 'check_counts', recording)
    monkeypatch.setattr(dtw, 'dtw_divergences', checked)
    assert np.array_equal(
        abx.pairwise_distances(segments, batch=5, device='cpu'), want)
    assert hosts[0] and hosts.count(True) == 1
    monkeypatch.undo()
    xs, nx, ys, ny = ragged_pairs([(5, 7), (11, 3), (1, 9)], 13, seed=6)
    costs = abx._frame_costs(torch.from_numpy(xs), torch.from_numpy(ys),
                             'cosine')
    counts = (torch.from_numpy(nx), torch.from_numpy(ny))
    assert torch.equal(dtw.divergences_unchecked(costs, *counts),
                       dtw.dtw_divergences(costs, *counts))
    with pytest.raises(ValueError, match='must lie in'):
        dtw.check_counts(np.array([0, 3]), np.array([2, 2]), 5, 5)


# ----------------------------------------------------- distance matrices

@pytest.mark.parametrize('metric', ['cosine', 'euclidean'])
def test_pairwise_distances_match_jax(metric):
    rng = np.random.RandomState(2)
    segments = [rng.randn(rng.randint(1, 25), 13) for _ in range(17)]
    got = abx.pairwise_distances(segments, metric, batch=40, device='cpu')
    want = jabx.pairwise_distances(segments, metric, batch=40)
    assert got.shape == (17, 17)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.array_equal(got, got.T)
    assert np.all(np.diag(got) == 0)
    assert (got[~np.eye(17, dtype=bool)] > 0).all()
    # one batch or many, the same divergences
    np.testing.assert_array_equal(
        abx.pairwise_distances(segments, metric, batch=4096, device='cpu'),
        got)


def test_pairwise_distances_edges():
    with pytest.raises(ValueError, match='non-empty'):
        abx.pairwise_distances([np.zeros((0, 3))], device='cpu')
    with pytest.raises(TypeError):
        abx.pairwise_distances([np.ones((2, 3))] * 2)
    assert abx.pairwise_distances([], device='cpu').shape == (0, 0)
    one = abx.pairwise_distances([np.ones((2, 3))], device='cpu')
    assert one.shape == (1, 1) and one[0, 0] == 0


# --------------------------------------------------------- ABX scoring

def cluster_corpus(separation, nspeakers=3, tokens=4, seed=0):
    """Segments from 2 phones x speakers x tokens around noisy cluster
    centers (tests/test_abx.py's corpus)."""
    rng = np.random.RandomState(seed)
    centers = {'a': rng.randn(6), 'b': rng.randn(6)}
    segments, phones, speakers = [], [], []
    for phone, center in centers.items():
        for speaker in range(nspeakers):
            for _ in range(tokens):
                frames = rng.randint(4, 9)
                segments.append(
                    separation * center
                    + rng.randn(frames, 6).astype(np.float32))
                phones.append(phone)
                speakers.append(f's{speaker}')
    return segments, phones, speakers


@pytest.mark.parametrize('task', ['across', 'within'])
@pytest.mark.parametrize('separation', [0.0, 0.7, 40.0])
def test_abx_error_matches_jax(task, separation):
    segments, phones, speakers = cluster_corpus(
        separation, nspeakers=4, tokens=5)
    distances = jabx.pairwise_distances(segments, metric='euclidean')
    got = abx.abx_error(distances, phones, speakers, task=task)
    assert got == jabx.abx_error(distances, phones, speakers, task=task)
    ours = abx.pairwise_distances(segments, 'euclidean', device='cpu')
    if separation < 1:
        # on the port's own distances, within the DTW tolerance
        np.testing.assert_allclose(ours, distances, rtol=0, atol=TOL)
    else:
        # far apart clusters put |x|^2 near 1e4, where the euclidean
        # cost's square |x|^2 + |y|^2 - 2 x.y rounds at about eps32 *
        # 2e4 = 2.4e-3 in either package: on a cell within a cluster
        # (square near 12, cost near 3.5) 1e-4 of the cost, 2e-4
        # between two packages that round apart (measured 1.7e-4)
        np.testing.assert_allclose(ours, distances, rtol=5e-4, atol=0)
        assert abx.abx_error(ours, phones, speakers, task=task) < 0.02


def test_abx_error_rejects_bad_input():
    dist = np.zeros((4, 4))
    with pytest.raises(ValueError, match='no valid ABX cell'):
        abx.abx_error(dist, ['a'] * 4, ['s0', 's0', 's1', 's1'])
    with pytest.raises(ValueError, match='unknown task'):
        abx.abx_error(dist, ['a', 'b'] * 2, ['s0'] * 4, task='other')


@pytest.mark.parametrize('times_2d', [False, True])
def test_segments_from_alignment_matches_jax(times_2d):
    rng = np.random.RandomState(4)
    nframes = 130
    data = rng.randn(nframes, 5).astype(np.float32)
    centers = 0.0125 + 0.01 * np.arange(nframes)
    times = (np.stack([centers - 0.0125, centers + 0.0125], axis=1)
             if times_2d else centers)
    triplets = [(0.0, 0.4, 'x'), (0.4, 0.8, 'y'), (0.8, 1.2, 'x'),
                (1.2, 1.21, 'z')]
    for tokens, min_frames in ((None, 1), ({'x'}, 1), (None, 2)):
        got = abx.segments_from_alignment(
            Features(data, times), Alignment.from_list(triplets),
            tokens=tokens, min_frames=min_frames)
        want = jabx.segments_from_alignment(
            JFeatures(data, times), JAlignment.from_list(triplets),
            tokens=tokens, min_frames=min_frames)
        assert [t for t, _ in got] == [t for t, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
