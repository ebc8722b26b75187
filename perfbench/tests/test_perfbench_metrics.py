"""Each per-layer metric's reader: a value from a traced window, and
nothing where the window had nothing for it to read."""

import os

import pytest

from perfbench import roofline, tracing
from perfbench.manifest import HERE, Manifest
from perfbench.tracing import TracedRun, breakdown

READERS = sorted(p[:-3] for p in os.listdir(os.path.join(HERE, 'metrics'))
                 if p.endswith('.py'))


def window(**changes):
    """Two calls of 10 s over 1.8 h of audio each; the device busy 1 s
    of the 20 s."""
    run = dict(
        audio_s=2 * 6480.0, calls=[(0.0, 10e6), (10e6, 20e6)],
        counters={'pass2_s': 7.2, 'decode_s': 1.8, 'dispatch_s': 0.5,
                  'dispatches': 50.0, 'fetch_s': 0.36},
        spans=[('pass1.wait', 1e6, 6e6), ('pass2', 2e6, 9e6),
               ('pass1.wait', 11e6, 17e6), ('batch.chunked', 12e6, 13e6)],
        device=[('void viterbi_forward_kernel<7>', 1e6, 1.6e6),
                ('void viterbi_backtrace_kernel<16>', 1.6e6, 1.7e6),
                ('Memcpy HtoD', 11e6, 11.3e6)],
        span_totals={'plp.rasta': (0.2, 0.01), 'plp.durbin': (0.3, 0.02),
                     'batch.chunked': (1.8, 0.5)},
        pitch_frames=[598] * 64, lags=417)
    run.update(changes)
    return TracedRun(**run)


def test_every_metric_of_the_manifest_has_a_reader():
    """Every per-layer metric, and every end-to-end metric of the
    device's trace (the host's clock gives the others)."""
    data = Manifest().data
    names = {m['name'] for m in data['per_layer']} | {
        m['name'] for m in data['end_to_end']
        if m['source'] == 'device_trace'}
    assert names <= set(READERS)


def test_the_readers_values():
    run = window()
    read = {name: Manifest().reader(name)(run) for name in READERS}
    assert read['pass2_s_per_h'] == pytest.approx(7.2 / 3.6)
    assert read['decode_s_per_h'] == pytest.approx(1.8 / 3.6)
    assert read['dispatch_ms_per_batch'] == pytest.approx(10.0)
    assert read['fetch_wait_s_per_h'] == pytest.approx(0.1)
    # calls end 4 s and 3 s after their last pass1.wait
    assert read['pass2_exposed_ms'] == pytest.approx(3500.0)
    assert read['plp_device_ms_per_h'] == pytest.approx(30.0 / 3.6)
    assert read['device_idle'] == pytest.approx(100 * (1 - 1.0 / 20))
    work = roofline.viterbi_work([598] * 64, 417)
    assert read['viterbi_roofline'] == pytest.approx(
        100 * roofline.bound_s(work) / 0.7)
    assert read['corpus_xrt'] == pytest.approx(2 * 6480.0 / 20)
    # the kernels' 0.7 s of the 1 s busy
    assert read['card_xrt'] == pytest.approx(2 * 6480.0 / 0.7)


def test_a_reader_with_nothing_to_read_returns_nothing():
    run = window(counters={}, spans=[], device=[], span_totals={})
    for name in READERS:
        if name != 'corpus_xrt':  # the calls are there to read
            assert Manifest().reader(name)(run) is None, name
    run = window(calls=[], counters={}, spans=[], device=[], span_totals={})
    for name in READERS:
        assert Manifest().reader(name)(run) is None, name


def test_a_trace_of_the_device_alone_is_busy_over_all_of_it():
    """Without the host's call spans the window is the whole trace; the
    kernels' union leaves the copies out."""
    run = window(calls=[], spans=[])
    assert run.busy_us() == pytest.approx(1e6)
    assert run.busy_us(tracing.is_kernel) == pytest.approx(0.7e6)
    assert Manifest().reader('card_xrt')(run) == pytest.approx(
        2 * 6480.0 / 0.7)
    assert Manifest().reader('corpus_xrt')(run) is None
    assert breakdown(run)['idle_gaps'] == []


def test_the_breakdown_labels_idle_gaps_by_the_open_spans():
    parts = breakdown(window())
    assert parts['device_ops'][0][0] == 'void viterbi_forward_kernel<7>'
    assert len(parts['idle_gaps']) <= 10
    (first, long_), (second, next_) = parts['idle_gaps'][:2]
    # 1.7-11 s, pass 2 open at its middle; 11.3-20 s, pass1.wait open
    assert first == 'pass2' and long_ == pytest.approx(9.3)
    assert second == 'pass1.wait' and next_ == pytest.approx(8.7)
