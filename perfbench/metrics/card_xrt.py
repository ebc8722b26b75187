"""The card: audio seconds of the window's calls over the seconds in
which a kernel ran on the card, the union of the kernels' intervals in
a trace of the device (copies and fills, which the copy engines run
beside the kernels, left out). It is the rate at which one card would
extract the corpus if enough host processes kept it fed, and is blind
to the host's share of a call, which ``corpus_xrt`` and the per-layer
metrics of the host's layers read."""

from perfbench import tracing


def read(run):
    busy = run.busy_us(tracing.is_kernel)
    if not busy:
        return None
    return run.audio_s / (busy / 1e6)
