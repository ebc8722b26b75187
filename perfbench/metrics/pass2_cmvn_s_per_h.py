"""Pipeline pass 2 (``pipeline._pass_two`` on the thread ``pass-two``):
thread seconds of its CMVN apply (counter ``pass2_cmvn_s``, span
``pass2.cmvn``) per hour of audio."""


def read(run):
    if 'pass2_cmvn_s' not in run.counters or not run.hours:
        return None
    return run.counters['pass2_cmvn_s'] / run.hours
