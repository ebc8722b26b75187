"""Pipeline pass 2 (``pipeline._pass_two`` on the thread ``pass-two``):
thread seconds of its deltas (counter ``pass2_delta_s``, span
``pass2.delta``) per hour of audio."""


def read(run):
    if 'pass2_delta_s' not in run.counters or not run.hours:
        return None
    return run.counters['pass2_delta_s'] / run.hours
