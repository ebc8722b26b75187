"""RASTA-PLP stages (``ops/plp.py``): device milliseconds of the kernels
launched inside the spans ``plp.rasta`` and ``plp.durbin``, per hour of
audio."""

SPANS = ('plp.rasta', 'plp.durbin')


def read(run):
    device = [run.span_totals[s][1] for s in SPANS if s in run.span_totals]
    if not device or not sum(device) or not run.hours:
        return None
    return 1e3 * sum(device) / run.hours
