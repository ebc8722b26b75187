"""Pipeline pass 2 (``pipeline._pass_two`` on the thread ``pass-two``):
thread seconds of its computation (counter ``pass2_compute_s``,
span ``pass2.compute``: the kernel ``csrc/pass_two.cu``, or the plain
version on the CPU, up to the output rows' landing on the host) per
hour of audio."""


def read(run):
    if 'pass2_compute_s' not in run.counters or not run.hours:
        return None
    return run.counters['pass2_compute_s'] / run.hours
