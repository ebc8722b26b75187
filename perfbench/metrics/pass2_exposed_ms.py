"""Pass 2 not hidden behind pass 1: per call, from the end of its last
pass-1 span (``pass1.wait``, ``batch.wait`` or ``batch.chunked``) to
the end of the harness's call span; the mean over the window's calls,
in milliseconds."""

PASS_ONE = ('pass1.wait', 'batch.wait', 'batch.chunked')


def read(run):
    exposed = []
    for start, end in run.calls:
        ends = [hi for name, lo, hi in run.spans
                if name in PASS_ONE and start <= lo and hi <= end]
        if ends:
            exposed.append((end - max(ends)) / 1e3)
    if not exposed:
        return None
    return sum(exposed) / len(exposed)
