"""Entry: audio seconds of the traced window's calls over the wall from
the first call's start to the last call's end (the spans
``perfbench.call``), as the untraced window's rate was taken until it
left the end-to-end metrics; the profiler's host work slows it."""


def read(run):
    window = run.window_us
    if not window:
        return None
    return run.audio_s / (window / 1e6)
