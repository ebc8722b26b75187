"""Decode (``parallel/stream.py``, ``parallel/batch.py``): thread
seconds of the audio decode (counter ``decode_s``) per hour of audio."""


def read(run):
    if 'decode_s' not in run.counters or not run.hours:
        return None
    return run.counters['decode_s'] / run.hours
