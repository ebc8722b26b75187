"""The readers of the port's call accounting: each a value from a traced
window with known counters, and nothing from a window without them (as
a program without those counters gives)."""

import pytest

from perfbench.harness import DEFAULT
from perfbench.manifest import Manifest
from perfbench.tracing import TracedRun

#: two calls over 1.8 h of audio each, 50 batches
COUNTERS = {
    'calls': 2.0, 'call_s': 20.0, 'plan_s': 0.8, 'decode_wait_s': 1.8,
    'dispatch_s': 5.0, 'dispatches': 50.0, 'dispatch_front_s': 1.5,
    'dispatch_pitch_s': 2.5, 'fetch_s': 0.36, 'drain_s': 2.7,
    'pass2_join_s': 5.4, 'pass2_utts': 400.0, 'pass2_backlog_utts': 340.0,
    'pass2_s': 7.2}

EXPECTED = {
    'plan_ms_per_call': 400.0,
    'main_unaccounted_pct': 100 * (1 - (0.8 + 1.8 + 5.0 + 0.36 + 2.7 + 5.4)
                                   / 20.0),
    'decode_wait_s_per_h': 0.5,
    'drain_s_per_h': 0.75,
    'dispatch_front_ms_per_batch': 30.0,
    'dispatch_pitch_ms_per_batch': 50.0,
    'pass2_join_ms_per_call': 2700.0,
    'pass2_backlog_pct': 85.0,
}


def window(counters):
    return TracedRun(
        audio_s=2 * 6480.0, calls=[(0.0, 10e6), (10e6, 20e6)],
        counters=counters, spans=[], device=[], span_totals={},
        pitch_frames=[], lags=417)


def read(name, counters):
    return Manifest().reader(name)(window(counters))


def test_every_reader_is_in_the_manifest():
    manifest = Manifest()
    entries = {m['name']: m for m in manifest.data['per_layer']}
    # the cells of the Kaldi pipeline, whose fused route has the counters
    # that some of these readers read alone
    kaldi = {cell['name'] for cell in manifest.data['workloads']
             if manifest.cell(cell['name']).config.get(
                 'harness', DEFAULT) == DEFAULT}
    assert kaldi
    for name in EXPECTED:
        assert entries[name]['source'] == 'program_counter', name
        assert entries[name]['moves'] == 'setup_s', name
        listed = entries[name].get('workloads')
        if listed is not None:
            assert listed and set(listed) <= kaldi, name


@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_a_reader_reads_its_counters(name):
    assert read(name, COUNTERS) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_a_reader_without_its_counters_returns_nothing(name):
    assert read(name, {}) is None
    # the counters of a program that does not split its calls
    parent = {key: COUNTERS[key] for key in (
        'dispatch_s', 'dispatches', 'fetch_s', 'pass2_s')}
    assert read(name, parent) is None
