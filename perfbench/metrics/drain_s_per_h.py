"""Executor (``parallel/executor.py``): wall seconds of the host work on
a landed batch after its fetch, each utterance's copies, CMVN
statistics and hand-off to pass 2 (counter ``drain_s``), per hour of
audio."""


def read(run):
    if 'drain_s' not in run.counters or not run.hours:
        return None
    return run.counters['drain_s'] / run.hours
