"""Executor (``parallel/fused.py``): wall milliseconds of enqueuing a
batch's pitch, its Viterbi, noise draw and post-processing (counter
``dispatch_pitch_s``, span ``pass1.pitch``) per batch (counter
``dispatches``)."""


def read(run):
    count = run.counters.get('dispatches', 0)
    if 'dispatch_pitch_s' not in run.counters or not count:
        return None
    return 1e3 * run.counters['dispatch_pitch_s'] / count
