"""What a traced run gives the per-layer metrics: the port's counters,
its profiler spans, the device's operations and the harness's own span
around each call.

The spans are the ones the port records (``pass1.dispatch``,
``pass1.wait``, ``pass2`` on the thread ``pass-two``, ``batch.*``,
``plp.*``); the harness adds ``perfbench.call`` around each
``extract_features`` call. Times are the profiler's, in microseconds
on one clock for host and device.
"""

import dataclasses

CALL_SPAN = 'perfbench.call'
#: the port's spans the metrics and the idle-gap labels read
SPANS = ('pass1.dispatch', 'pass1.wait', 'pass2', 'batch.dispatch',
         'batch.wait', 'batch.chunked', 'plp.rasta', 'plp.durbin')
#: spans that label what the host did while the device idled
LABELS = ('pass1.dispatch', 'pass1.wait', 'pass2', 'batch.dispatch',
          'batch.wait', 'batch.chunked')
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
    pitch_frames: list
    #: the Viterbi's lag count
    lags: int

    @property
    def hours(self):
        return self.audio_s / 3600.0

    @property
    def window_us(self):
        return (self.calls[-1][1] - self.calls[0][0]) if self.calls else 0.0

    def busy_intervals(self):
        """The union of the device operations' intervals inside the
        window, sorted and disjoint."""
        if not self.calls:
            return []
        lo, hi = self.calls[0][0], self.calls[-1][1]
        merged = []
        for _, start, end in sorted(self.device, key=lambda d: d[1]):
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    def busy_us(self):
        return sum(end - start for start, end in self.busy_intervals())

    def kernel_s(self, name):
        """Device seconds of the operations whose name holds ``name``."""
        return sum(end - start for op, start, end in self.device
                   if name in op) / 1e6


def collect(prof, audio_s, counters, pitch_frames, lags):
    """A :class:`TracedRun` from a finished ``torch.profiler.profile``.

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
    spans, device, calls, launched = [], [], [], set()
    for event in events:
        name = event.name()
        start = event.start_ns() / 1e3
        interval = (start, start + event.duration_ns() / 1e3)
        if event.device_type() == DeviceType.CPU:
            if name == CALL_SPAN:
                calls.append(interval)
            elif name in SPANS:
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
    by_span = {}
    for name, lo, hi, thread in spans:
        by_span.setdefault((name, thread), []).append((lo, hi))
    for intervals in by_span.values():
        intervals.sort()
    totals = {name: [0.0, 0.0] for name, _, _, _ in spans}
    for name, lo, hi, _ in spans:
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
                     pitch_frames=pitch_frames, lags=lags)


def breakdown(run):
    """The device operations that took most time, and the longest idle
    gaps labelled by the port's spans open at their middle."""
    by_name = {}
    for name, start, end in run.device:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    busy = run.busy_intervals()
    gaps = []
    if busy:
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
