"""Pipeline pass 2 (``pipeline._pass_two`` on the thread ``pass-two``):
thread seconds of its unpacking (counter ``pass2_unpack_s``, span
``pass2.unpack``: each utterance's checks, Features and properties)
per hour of audio."""


def read(run):
    if 'pass2_unpack_s' not in run.counters or not run.hours:
        return None
    return run.counters['pass2_unpack_s'] / run.hours
