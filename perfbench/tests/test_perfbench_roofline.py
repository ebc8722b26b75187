"""The Viterbi's work is counted from the utterances, not the batch
plan, with chip_smoke.bound's arithmetic."""

import random

from perfbench import roofline


def test_the_work_does_not_depend_on_the_batch_plan():
    frames = [598, 310, 3498, 128, 742, 1]
    one = roofline.viterbi_work(frames, 417)
    shuffled = frames[:]
    random.Random(0).shuffle(shuffled)
    # another plan: the same utterances in other batches and order
    batches = [shuffled[:2], shuffled[2:5], shuffled[5:]]
    parts = [roofline.viterbi_work(b, 417) for b in batches]
    total = {k: tuple(sum(p[k][i] for p in parts) for i in range(2))
             for k in one}
    assert total == one
    assert roofline.bound_s(total) == roofline.bound_s(one)


def smoke_bound(name, shape, bounds):
    """``chip_smoke.bound`` as it stood when the yardstick was copied
    (seconds): the forward's add and min per lag pair of each computed
    frame, its costs read once and its history written once; the
    backtrace's history rows read once and lags written once."""
    bsz, frames, lags = shape
    last = [min(max(n, 1), frames) for n in bounds]
    steps = sum(n - 1 for n in last)
    if name == 'viterbi_forward':
        ops = 2 * steps * lags * lags
        nbytes = 4 * (sum(last) * lags + frames * bsz * lags + bsz)
    else:
        ops = 2 * steps * lags
        nbytes = 4 * (sum(last) * lags + frames * bsz + bsz)
    return max(ops / 67e12, nbytes / 3.35e12)


def test_the_arithmetic_of_chip_smoke_on_an_unpadded_batch():
    """On a batch with no padding the bound is chip_smoke's."""
    bsz, n, lags = 64, 598, 417
    work = roofline.viterbi_work([n] * bsz, lags)
    expected = sum(smoke_bound(name, (bsz, n, lags), [n] * bsz)
                   for name in ('viterbi_forward', 'viterbi_backtrace'))
    assert abs(roofline.bound_s(work) - expected) < 1e-15
    ops, nbytes = work['viterbi_forward_kernel']
    assert ops / roofline.PEAK_FLOPS_FP32 > nbytes / roofline.PEAK_BYTES
    ops, nbytes = work['viterbi_backtrace_kernel']
    assert ops / roofline.PEAK_FLOPS_FP32 < nbytes / roofline.PEAK_BYTES
