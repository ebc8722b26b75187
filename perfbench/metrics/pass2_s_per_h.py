"""Pipeline pass 2 (``pipeline._pass_two`` on the thread ``pass-two``):
its thread seconds (counter ``pass2_s``) per hour of audio."""


def read(run):
    if 'pass2_s' not in run.counters or not run.hours:
        return None
    return run.counters['pass2_s'] / run.hours
