"""Executor (``parallel/executor.py``): wall milliseconds of enqueuing a
batch's upload and program (counters ``dispatch_s`` / ``dispatches``)."""


def read(run):
    count = run.counters.get('dispatches', 0)
    if not count:
        return None
    return 1e3 * run.counters['dispatch_s'] / count
