"""The port's accounting of an extraction call: its counters and spans.

One CPU ``extract_features`` over a two-speaker corpus on the fused
path, under :func:`shennong_tpu_torch.parallel.profiler.trace`: every
counter of the call's seams is written, the disjoint intervals of the
call's thread fit inside its wall, pass 2 counts every utterance and
its steps fit inside it, and the trace names every span, nested where
the seams nest and on the thread that runs them. And
:func:`~shennong_tpu_torch.parallel.profiler.span` adds to a counter
only when given one.
"""

import copy
import glob
import json
import threading

import numpy as np
import pytest
import scipy.io.wavfile

from shennong_tpu_torch import pipeline
from shennong_tpu_torch.parallel import profiler
from shennong_tpu_torch.utterances import Utterances

#: the counters a fused call adds beside the JAX package's
NEW_COUNTERS = (
    'calls', 'call_s', 'plan_s', 'decode_wait_s', 'dispatch_front_s',
    'dispatch_pitch_s', 'drain_s', 'pass2_join_s', 'pass2_utts',
    'pass2_backlog_utts', 'pass2_pack_s', 'pass2_compute_s', 'pass2_unpack_s',
    'pass2_kernel_utts')

#: disjoint intervals of the call's own thread
MAIN_THREAD = ('plan_s', 'decode_wait_s', 'dispatch_s', 'fetch_s',
               'drain_s', 'pass2_join_s')

NEW_SPANS = (
    'extract_features', 'pipeline.plan', 'pass1.plan', 'stream.plan',
    'decode', 'decode.wait', 'pass1.front', 'pass1.vad', 'pass1.pitch',
    'pass1.pack', 'pass1.drain', 'pass2.join', 'pass2.pack', 'pass2.compute',
    'pass2.unpack')

#: two speakers, one batch
DURATIONS = (9000, 17000, 12500, 30000, 22000, 16000)


@pytest.fixture(scope='module')
def call(tmp_path_factory):
    """(counters, the trace's spans as {name: [(tid, start, end)]}, the
    native id of the thread ``pass-two``) of one traced CPU call."""
    path = tmp_path_factory.mktemp('tracing')
    rng = np.random.RandomState(7)
    entries = []
    for index, nsamples in enumerate(DURATIONS):
        t = np.arange(nsamples) / 16000
        signal = np.sin(2 * np.pi * (120 + 15 * index) * t) * (
            0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + rng.randn(nsamples) * 0.05
        wav = str(path / f'u{index}.wav')
        scipy.io.wavfile.write(
            wav, 16000, (signal / np.abs(signal).max() * 12000).astype(
                np.int16))
        entries.append((f'u{index}', wav, f'spk{index % 2}'))
    config = pipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)

    threads = set()
    pass_two = pipeline._pass_two

    def recorded(*args, **kwargs):
        threads.add((threading.current_thread().name,
                     threading.get_native_id()))
        return pass_two(*args, **kwargs)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(pipeline, '_pass_two', recorded)
        profiler.counters.reset()
        with profiler.trace(str(path / 'trace')):
            features = pipeline.extract_features(
                copy.deepcopy(config), Utterances(entries), device='cpu')
        counts = profiler.counters.snapshot()
    assert sorted(features.keys()) == sorted(name for name, _, _ in entries)

    files = glob.glob(str(path / 'trace' / '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as stream:
        events = json.load(stream)['traceEvents']
    spans = {}
    for event in events:
        if event.get('ph') == 'X' and event.get('cat') == 'user_annotation':
            spans.setdefault(event['name'], []).append(
                (event['tid'], event['ts'], event['ts'] + event['dur']))
    (name, tid), = threads
    assert name == 'pass-two'
    return counts, spans, tid


def inside(inner, outer):
    """Whether every ``inner`` span lies inside an ``outer`` one on the
    same thread."""
    return all(any(tid == otid and ostart <= start and end <= oend
                   for otid, ostart, oend in outer)
               for tid, start, end in inner)


def test_every_new_counter_is_written(call):
    counts, _, _ = call
    for key in NEW_COUNTERS:
        assert key in counts, key
    assert counts['calls'] == 1
    # the CPU launches no hand-written kernel
    assert not [key for key in counts if key.startswith('launches.')]
    assert counts['pass2_kernel_utts'] == 0


def test_pass_two_counts_every_utterance(call):
    counts, _, _ = call
    assert counts['pass2_utts'] == len(DURATIONS)
    assert 0 <= counts['pass2_backlog_utts'] <= counts['pass2_utts']


def test_pass_two_steps_fit_inside_pass_two(call):
    counts, _, _ = call
    steps = ('pass2_pack_s', 'pass2_compute_s', 'pass2_unpack_s')
    assert all(counts[key] > 0 for key in steps)
    assert sum(counts[key] for key in steps) <= counts['pass2_s']


def test_stage_enqueues_fit_inside_the_dispatch(call):
    counts, _, _ = call
    assert counts['dispatch_front_s'] > 0 and counts['dispatch_pitch_s'] > 0
    assert (counts['dispatch_front_s'] + counts['dispatch_pitch_s']
            <= counts['dispatch_s'])


def test_main_thread_intervals_fit_inside_the_call(call):
    counts, _, _ = call
    assert all(counts[key] > 0 for key in MAIN_THREAD)
    assert sum(counts[key] for key in MAIN_THREAD) <= counts['call_s']


def test_trace_names_every_new_span(call):
    _, spans, _ = call
    for name in NEW_SPANS:
        assert name in spans, name
    assert len(spans['extract_features']) == 1


def test_stage_spans_nest_in_the_dispatch_on_its_thread(call):
    _, spans, _ = call
    for name in ('pass1.front', 'pass1.vad', 'pass1.pitch', 'pass1.pack'):
        assert inside(spans[name], spans['pass1.dispatch']), name
    assert inside(spans['pass1.dispatch'], spans['extract_features'])


def test_pass_two_steps_nest_in_pass_two_on_its_thread(call):
    _, spans, pass_two = call
    for name in ('pass2', 'pass2.pack', 'pass2.compute', 'pass2.unpack'):
        assert {tid for tid, _, _ in spans[name]} == {pass_two}, name
    for name in ('pass2.pack', 'pass2.compute', 'pass2.unpack'):
        assert inside(spans[name], spans['pass2']), name
    # the caller waits for the worker on its own thread
    assert inside(spans['pass2.join'], spans['extract_features'])


def test_decode_runs_off_the_waiting_thread(call):
    _, spans, _ = call
    waiting = {tid for tid, _, _ in spans['decode.wait']}
    decoding = {tid for tid, _, _ in spans['decode']}
    assert waiting == {tid for tid, _, _ in spans['extract_features']}
    assert not waiting & decoding


def test_span_adds_to_its_key_only_when_given_one(monkeypatch):
    counters = profiler.Counters()
    monkeypatch.setattr(profiler, 'counters', counters)
    with profiler.span('alone'):
        sum(range(1000))
    assert counters.snapshot() == {}
    with profiler.span('timed', 'timed_s'):
        sum(range(1000))
    with profiler.span('timed', 'timed_s'):
        pass
    snap = counters.snapshot()
    assert list(snap) == ['timed_s'] and snap['timed_s'] > 0
    with pytest.raises(ValueError):
        with profiler.span('failing', 'failing_s'):
            raise ValueError('the block failed')
    assert counters.snapshot()['failing_s'] >= 0
