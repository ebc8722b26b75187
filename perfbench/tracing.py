"""What a traced run gives the per-layer metrics: the port's counters,
its profiler spans, the device's operations and the harness's own span
around each call.

The spans are the ones the port records (``parallel/profiler.py``'s
docstring lists them): :data:`SPANS`, which the metrics read, and
:data:`LABELS`, which name what the host did in an idle gap of the
device. The harness adds ``perfbench.call`` around each
``extract_features`` call. Times are the profiler's, in microseconds
on one clock for host and device. What the pipeline's harness gives
(:meth:`perfbench.harness.Harness.trace_inputs`: the pitch frames, the
lag count, other work) rides along for the readers.
"""

import dataclasses

CALL_SPAN = 'perfbench.call'
#: the port's spans the metrics read, each with the device time of the
#: kernels launched inside it; their names on the device's timeline are
#: annotations, not device operations
SPANS = ('pass1.dispatch', 'pass1.wait', 'pass2', 'batch.dispatch',
         'batch.wait', 'batch.chunked', 'plp.rasta', 'plp.durbin')
#: spans that label what the host did while the device idled: the
#: call's planning (its own, the executor's and the batch plan's), the
#: wait for decoded audio, pass 1's enqueue, its front end and pitch, its
#: wait and drain, and pass 2's steps and join
LABELS = ('pipeline.plan', 'pass1.plan', 'stream.plan', 'decode.wait',
          'pass1.dispatch', 'pass1.front', 'pass1.pitch', 'pass1.wait',
          'pass1.drain', 'pass2', 'pass2.pack', 'pass2.compute',
          'pass2.unpack', 'pass2.join', 'batch.dispatch', 'batch.wait',
          'batch.chunked')
#: entries of each breakdown list
TOP = 10


@dataclasses.dataclass
class TracedRun:
    """A traced window: what a metric's ``read(run)`` receives."""
    #: audio seconds of the window's calls
    audio_s: float
    #: [(start_us, end_us)] of each call, in order
    calls: list
    #: the port's counters over the window
    counters: dict
    #: [(name, start_us, end_us)] of the port's spans (every thread)
    spans: list
    #: [(name, start_us, end_us)] of the device's operations
    device: list
    #: span name -> (host seconds, device seconds of the kernels
    #: launched inside it)
    span_totals: dict
    #: pitch frames of each utterance of each call
    pitch_frames: list = dataclasses.field(default_factory=list)
    #: the Viterbi's lag count
    lags: int = 0
    #: what a pipeline's harness counts of the window's work, for its
    #: readers (the operations of a model, for instance)
    work: dict = dataclasses.field(default_factory=dict)

    @property
    def hours(self):
        return self.audio_s / 3600.0

    @property
    def window_us(self):
        return (self.calls[-1][1] - self.calls[0][0]) if self.calls else 0.0

    def busy_intervals(self, select=None):
        """The union of the intervals of the device operations (those
        whose name ``select`` takes, where given) inside the window,
        sorted and disjoint. A trace of the device alone has no call
        span: its window is the whole trace."""
        if not self.device:
            return []
        lo, hi = ((self.calls[0][0], self.calls[-1][1]) if self.calls
                  else (float('-inf'), float('inf')))
        merged = []
        for _, start, end in sorted(
                (d for d in self.device if select is None or select(d[0])),
                key=lambda d: d[1]):
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    def busy_us(self, select=None):
        return sum(end - start
                   for start, end in self.busy_intervals(select))

    def kernel_s(self, name):
        """Device seconds of the operations whose name holds ``name``."""
        return sum(end - start for op, start, end in self.device
                   if name in op) / 1e6


def is_kernel(name):
    """Whether a device operation is a kernel, not a copy or a fill."""
    return not name.startswith(('Memcpy', 'Memset'))


def collect(prof, audio_s, counters, inputs):
    """A :class:`TracedRun` from a finished ``torch.profiler.profile``,
    with the harness's ``inputs`` (keyword fields of the run).

    It reads the profiler's raw events (``kineto_results``), not the
    event tree that ``prof.events()`` builds, which takes minutes over a
    window of a million events. A device operation belongs to a span
    when the host operation that launched it (its linked correlation
    id) started inside that span on the same thread."""
    import bisect

    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    # the annotations appear on the device's timeline too, and are no
    # device operation
    annotations = set(SPANS + (CALL_SPAN,))
    hosts = set(SPANS + LABELS)
    spans, device, calls, launched = [], [], [], set()
    for event in events:
        name = event.name()
        start = event.start_ns() / 1e3
        interval = (start, start + event.duration_ns() / 1e3)
        if event.device_type() == DeviceType.CPU:
            if name == CALL_SPAN:
                calls.append(interval)
            elif name in hosts:
                spans.append((name,) + interval + (event.start_thread_id(),))
        elif name not in annotations and not getattr(
                event, "is_user_annotation", lambda: False)():
            device.append((name,) + interval)
            launched.add(event.linked_correlation_id())
    launch = {}
    for event in events:
        if (event.device_type() == DeviceType.CPU
                and event.correlation_id() in launched):
            launch[event.correlation_id()] = (
                event.start_ns() / 1e3, event.start_thread_id())
    # the labels' spans only name idle gaps
    metered = [span for span in spans if span[0] in SPANS]
    by_span = {}
    for name, lo, hi, thread in metered:
        by_span.setdefault((name, thread), []).append((lo, hi))
    for intervals in by_span.values():
        intervals.sort()
    totals = {name: [0.0, 0.0] for name, _, _, _ in metered}
    for name, lo, hi, _ in metered:
        totals[name][0] += (hi - lo) / 1e6
    for event in events:
        if (event.device_type() == DeviceType.CPU
                or event.linked_correlation_id() not in launch):
            continue
        at, thread = launch[event.linked_correlation_id()]
        for (name, owner), intervals in by_span.items():
            if owner != thread:
                continue
            i = bisect.bisect_right(intervals, (at, float('inf'))) - 1
            if i >= 0 and intervals[i][0] <= at < intervals[i][1]:
                totals[name][1] += event.duration_ns() / 1e9
    return TracedRun(audio_s=audio_s, calls=sorted(calls),
                     counters=counters,
                     spans=[(n, lo, hi) for n, lo, hi, _ in spans],
                     device=device,
                     span_totals={k: tuple(v) for k, v in totals.items()},
                     **inputs)


def breakdown(run):
    """The device operations that took most time, and the longest idle
    gaps labelled by the port's spans open at their middle."""
    by_name = {}
    for name, start, end in run.device:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    busy = run.busy_intervals()
    gaps = []
    if busy and run.calls:
        edges = ([(run.calls[0][0], busy[0][0])]
                 + [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
                 + [(busy[-1][1], run.calls[-1][1])])
        edges = sorted((e for e in edges if e[1] > e[0]),
                       key=lambda e: e[0] - e[1])[:TOP]
        for start, end in edges:
            middle = (start + end) / 2
            open_ = sorted({name for name, lo, hi in run.spans
                            if name in LABELS and lo <= middle < hi})
            gaps.append(['+'.join(open_) or 'none', (end - start) / 1e6])
    return {'device_ops': [[name[:120], s] for name, s in ops],
            'idle_gaps': gaps}
