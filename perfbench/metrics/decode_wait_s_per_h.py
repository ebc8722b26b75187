"""Decode (``parallel/stream.py``): wall seconds pass 1 blocked on the
next decoded batch (counter ``decode_wait_s``) per hour of audio."""


def read(run):
    if 'decode_wait_s' not in run.counters or not run.hours:
        return None
    return run.counters['decode_wait_s'] / run.hours
