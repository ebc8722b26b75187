"""The readers of pass 2's packed route: each a value from a traced
window with known counters, and nothing from a window without them (as
a program without those counters gives)."""

import pytest

from perfbench.manifest import Manifest
from perfbench.tests.test_perfbench_counter_metrics import COUNTERS, read

#: pass 2's steps over the same window (1.8 h of audio a call, 2 calls),
#: 400 utterances finished, 300 of them in the kernel
STEPS = dict(COUNTERS, pass2_pack_s=0.36, pass2_compute_s=0.18,
             pass2_unpack_s=1.08, pass2_kernel_utts=300.0)

EXPECTED = {
    'pass2_pack_s_per_h': 0.1,
    'pass2_compute_s_per_h': 0.05,
    'pass2_unpack_s_per_h': 0.3,
    'pass2_kernel_pct': 75.0,
}


def test_every_reader_is_in_the_manifest():
    entries = {m['name']: m for m in Manifest().data['per_layer']}
    for name in EXPECTED:
        assert entries[name]['source'] == 'program_counter', name
        assert entries[name]['layer'] == 'pipeline pass 2', name
        assert entries[name]['moves'] == 'setup_s', name
        assert 'workloads' not in entries[name], name


@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_a_reader_reads_its_counters(name):
    assert read(name, STEPS) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_a_reader_without_its_counters_returns_nothing(name):
    assert read(name, {}) is None
    # the call's accounting without pass 2's steps
    assert read(name, COUNTERS) is None


def test_the_cpu_reads_no_kernel():
    assert read('pass2_kernel_pct', dict(STEPS, pass2_kernel_utts=0.0)) == 0
