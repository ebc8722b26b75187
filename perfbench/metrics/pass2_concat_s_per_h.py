"""Pipeline pass 2 (``pipeline._pass_two`` on the thread ``pass-two``):
thread seconds of its pitch concatenation (counter ``pass2_concat_s``, span
``pass2.concat``) per hour of audio."""


def read(run):
    if 'pass2_concat_s' not in run.counters or not run.hours:
        return None
    return run.counters['pass2_concat_s'] / run.hours
