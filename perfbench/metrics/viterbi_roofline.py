"""Kernels B1 and B2 (``csrc/viterbi.cu`` through ``ops/cuda_viterbi.py``):
the least time an H100 needs for the Viterbi work of the window's
utterances (:mod:`perfbench.roofline`, counted from each utterance's
real pitch frames) over the device time of ``viterbi_forward_kernel``
and ``viterbi_backtrace_kernel``, in percent."""

from perfbench import roofline


def read(run):
    work = roofline.viterbi_work(run.pitch_frames, run.lags)
    device = sum(run.kernel_s(kernel) for kernel in work)
    if not device:
        return None
    return 100.0 * roofline.bound_s(work) / device
