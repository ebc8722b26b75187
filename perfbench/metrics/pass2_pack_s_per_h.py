"""Pipeline pass 2 (``pipeline._pass_two`` on the thread ``pass-two``):
thread seconds of its packing (counter ``pass2_pack_s``, span
``pass2.pack``: the CMVN affines, the group packed unpadded into
page-locked memory and uploaded) per hour of audio."""


def read(run):
    if 'pass2_pack_s' not in run.counters or not run.hours:
        return None
    return run.counters['pass2_pack_s'] / run.hours
