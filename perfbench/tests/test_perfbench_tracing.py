"""The idle gaps are named by the port's spans of the call's accounting,
and reading those spans changes neither the device's operations nor any
per-layer reader's value."""

import pytest
from torch.autograd import DeviceType

from perfbench import tracing
from perfbench.manifest import Manifest
from perfbench.tests.test_perfbench_metrics import READERS, window

#: spans that only label idle gaps, on the main thread (1) and pass 2's (2)
LABELLED = [('pipeline.plan', 0.0, 0.3e6, 1), ('stream.plan', 0.3e6, 0.6e6, 1),
            ('pass1.plan', 0.6e6, 0.9e6, 1), ('decode.wait', 0.9e6, 1e6, 1),
            ('pass1.front', 1.1e6, 1.3e6, 1), ('pass1.pitch', 1.3e6, 1.9e6, 1),
            ('pass1.drain', 4e6, 5e6, 1), ('pass2.pack', 2e6, 3e6, 2),
            ('pass2.compute', 3e6, 3.5e6, 2), ('pass2.unpack', 5.5e6, 7e6, 2),
            ('pass2.join', 7e6, 10e6, 1)]


class Event:
    """An event of the profiler's raw list, as :func:`tracing.collect`
    reads it."""

    def __init__(self, name, start_us, end_us, kind, thread=1,
                 correlation=0, linked=0, annotation=False):
        self._name, self._kind, self._thread = name, kind, thread
        self._start, self._end = start_us, end_us
        self._correlation, self._linked = correlation, linked
        self._annotation = annotation

    def name(self):
        return self._name

    def start_ns(self):
        return int(self._start * 1e3)

    def duration_ns(self):
        return int((self._end - self._start) * 1e3)

    def device_type(self):
        return self._kind

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._correlation

    def linked_correlation_id(self):
        return self._linked

    def is_user_annotation(self):
        return self._annotation


class Profile:
    """What :func:`tracing.collect` reads of a ``torch.profiler.profile``."""

    def __init__(self, events):
        class Results:
            def events(self):
                return events

        class Profiler:
            kineto_results = Results()
        self.profiler = Profiler()


def host(name, lo, hi, thread=1, correlation=0):
    return Event(name, lo, hi, DeviceType.CPU, thread, correlation)


def card(name, lo, hi, linked, annotation=False):
    return Event(name, lo, hi, DeviceType.CUDA, linked=linked,
                 annotation=annotation)


def events(labelled):
    """One 10 s call: a kernel launched in ``pass1.dispatch``, one in
    ``plp.rasta`` and one in pass 2's ``pass2.pack`` (inside ``pass2``);
    the annotations' copies on the device's timeline, one of them not
    marked as an annotation; with ``labelled``, the label spans and
    theirs."""
    out = [host(tracing.CALL_SPAN, 0.0, 10e6),
           host('pass1.dispatch', 1e6, 2e6),
           host('cudaLaunchKernel', 1.5e6, 1.51e6, correlation=7),
           card('viterbi_forward_kernel', 1.6e6, 1.7e6, 7),
           host('plp.rasta', 1.1e6, 1.2e6),
           host('cudaLaunchKernel', 1.15e6, 1.16e6, correlation=8),
           card('rasta_kernel', 1.2e6, 1.25e6, 8),
           host('pass2', 1.5e6, 9e6, thread=2),
           host('cudaLaunchKernel', 2.5e6, 2.51e6, thread=2, correlation=9),
           card('pass_two_kernel', 2.6e6, 2.8e6, 9),
           card('pass1.dispatch', 1e6, 2e6, 0, annotation=True),
           card('pass2', 1.5e6, 9e6, 0)]
    if labelled:
        out += [host(name, lo, hi, thread) for name, lo, hi, thread
                in LABELLED]
        out += [card(name, lo, hi, 0, annotation=True)
                for name, lo, hi, _ in LABELLED]
    return out


def collected(labelled):
    return tracing.collect(Profile(events(labelled)), 3600.0, {},
                           {'pitch_frames': [598] * 4, 'lags': 417})


def test_the_labels_take_nothing_from_the_device_or_the_spans_totals():
    before, after = collected(False), collected(True)
    assert after.device == before.device
    assert [op for op, _, _ in before.device] == [
        'viterbi_forward_kernel', 'rasta_kernel', 'pass_two_kernel']
    assert after.span_totals == before.span_totals
    assert before.span_totals['plp.rasta'] == pytest.approx((0.1, 0.05))
    assert before.span_totals['pass1.dispatch'] == pytest.approx((1.0, 0.15))
    assert before.span_totals['pass2'] == pytest.approx((7.5, 0.2))
    assert after.calls == before.calls
    assert {name for name, _, _ in after.spans} - {
        name for name, _, _ in before.spans} == {n for n, *_ in LABELLED}
    for name in READERS:
        read = Manifest().reader(name)
        assert read(after) == read(before), name


def test_an_idle_gap_is_named_by_the_spans_open_in_it():
    gaps = tracing.breakdown(collected(True))['idle_gaps']
    # busy 1.2-1.25, 1.6-1.7 and 2.6-2.8 s; a gap is named at its middle
    assert [name for name, _ in gaps] == [
        'pass2+pass2.unpack', 'pass1.plan', 'pass2+pass2.pack',
        'pass1.dispatch+pass1.pitch']
    assert [s for _, s in gaps] == pytest.approx([7.2, 1.2, 0.9, 0.35])
    unlabelled = tracing.breakdown(collected(False))['idle_gaps']
    assert [name for name, _ in unlabelled] == [
        'pass2', 'none', 'pass2', 'pass1.dispatch']


def test_every_reader_reads_the_same_beside_the_label_spans():
    """The synthetic window of the readers' tests, with and without the
    spans that only label idle gaps."""
    plain = window()
    labelled = window(spans=plain.spans + [s[:3] for s in LABELLED])
    for name in READERS:
        read = Manifest().reader(name)
        assert read(labelled) == read(plain), name


def test_the_labels_are_the_spans_of_the_call_s_accounting():
    assert {'pipeline.plan', 'pass1.plan', 'stream.plan', 'pass1.front',
            'pass1.pitch', 'pass1.drain', 'decode.wait', 'pass2.join',
            'pass2.pack', 'pass2.compute', 'pass2.unpack'} <= set(
                tracing.LABELS)
