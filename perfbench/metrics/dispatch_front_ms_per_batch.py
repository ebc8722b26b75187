"""Executor (``parallel/fused.py``): wall milliseconds of enqueuing a
batch's features front end (counter ``dispatch_front_s``, span
``pass1.front``) per batch (counter ``dispatches``)."""


def read(run):
    count = run.counters.get('dispatches', 0)
    if 'dispatch_front_s' not in run.counters or not count:
        return None
    return 1e3 * run.counters['dispatch_front_s'] / count
