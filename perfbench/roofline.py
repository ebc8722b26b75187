"""The least time an H100 needs for the Kaldi pitch Viterbi of a corpus.

The arithmetic of ``chip_smoke.bound``, counted per utterance from its
real pitch frame count ``n`` and the lag count ``L`` (padding, chunk
halos and the batch plan are waste, not work):

- forward (``viterbi_forward_kernel``): an add and a min per lag pair
  of each frame after the first, 2 (n - 1) L^2 operations; the local
  costs read once and the backpointers written once, 4 (2 n L + 1)
  bytes;
- backtrace (``viterbi_backtrace_kernel``): 2 (n - 1) L operations;
  the backpointers read once, the lags written once, 4 (n L + n + 1)
  bytes.

Each kernel's bound is the larger of its operations over the float32
peak and its bytes over the HBM bandwidth. The peaks are NVIDIA's data
sheet for the H100 SXM at its 700 W power limit; a card set below that
limit runs slower, so the run reports the limit beside the share.
"""

#: float32 outside the tensor cores, FLOP/s
PEAK_FLOPS_FP32 = 67e12
#: HBM3, bytes/s
PEAK_BYTES = 3.35e12
#: the power limit the peaks assume, W
PEAK_POWER_W = 700.0


def viterbi_work(frames, lags):
    """{kernel: (operations, bytes)} of the Viterbi over utterances of
    ``frames`` pitch frames each."""
    fwd_ops = fwd_bytes = bt_ops = bt_bytes = 0
    for n in frames:
        if n < 1:
            continue
        fwd_ops += 2 * (n - 1) * lags * lags
        fwd_bytes += 4 * (2 * n * lags + 1)
        bt_ops += 2 * (n - 1) * lags
        bt_bytes += 4 * (n * lags + n + 1)
    return {'viterbi_forward_kernel': (fwd_ops, fwd_bytes),
            'viterbi_backtrace_kernel': (bt_ops, bt_bytes)}


def bound_s(work):
    """Seconds the work of :func:`viterbi_work` needs at the peaks."""
    return sum(max(ops / PEAK_FLOPS_FP32, nbytes / PEAK_BYTES)
               for ops, nbytes in work.values())
