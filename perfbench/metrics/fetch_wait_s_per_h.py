"""Executor, host blocked on the device: wall seconds waiting for a
batch's outputs (counter ``fetch_s``) per hour of audio."""


def read(run):
    if 'fetch_s' not in run.counters or not run.hours:
        return None
    return run.counters['fetch_s'] / run.hours
