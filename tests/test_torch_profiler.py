"""The port's observability layer against the JAX package's.

``StageTimer`` and ``Counters`` behave as ``shennong_tpu``'s (the
contract of tests/test_profiler.py), ``Counters`` keeps its count under
concurrent adds, and ``trace`` writes a trace file that names the
``pass2`` span of a CPU extraction, recorded on the thread
``pass-two``.
"""

import glob
import json
import logging
import sys
import threading

import numpy as np
import pytest
import scipy.io.wavfile

from shennong_tpu.parallel import profiler as jprofiler
from shennong_tpu_torch import pipeline
from shennong_tpu_torch.parallel import profiler
from shennong_tpu_torch.utterances import Utterances


def run_stages(module, caplog, name):
    log = logging.getLogger(name)
    timer = module.StageTimer(log=log)
    with timer.stage('alpha'):
        sum(range(1000))
    with timer.stage('beta'):
        pass
    with timer.stage('alpha'):
        pass
    with caplog.at_level(logging.INFO, logger=name):
        stages = timer.report(audio_seconds=10.0)
        timer.report()
    return stages, [r.getMessage() for r in caplog.records
                    if r.name == name]


def test_stage_timer(caplog):
    ours, our_lines = run_stages(profiler, caplog, 'timer-ours')
    theirs, their_lines = run_stages(jprofiler, caplog, 'timer-theirs')
    assert set(ours) == set(theirs) == {'alpha', 'beta'}
    assert ours['alpha'] > 0
    assert len(our_lines) == len(their_lines) == 4
    # the same lines but for the measured times
    for mine, ref in zip(our_lines, their_lines):
        assert mine.split()[:2] == ref.split()[:2]
        assert ('real-time' in mine) == ('real-time' in ref)


def test_counters_match_jax():
    ours, theirs = profiler.Counters(), jprofiler.Counters()
    for counters in (ours, theirs):
        counters.add('dispatches')
        counters.add('dispatches', 2)
        counters.add('bytes_up', 4096)
        with counters.timed('decode_s'):
            sum(range(1000))
    snap, ref = ours.snapshot(), theirs.snapshot()
    assert snap.keys() == ref.keys()
    assert snap['dispatches'] == ref['dispatches'] == 3.0
    assert snap['bytes_up'] == ref['bytes_up'] == 4096.0
    assert snap['decode_s'] > 0
    snap['dispatches'] = 0  # a snapshot is a copy
    assert ours.snapshot()['dispatches'] == 3.0
    ours.reset()
    assert ours.snapshot() == {}


def test_counters_keep_count_under_concurrent_adds():
    counters = profiler.Counters()
    workers, adds = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counters.add('n') for _ in range(adds)])
            for _ in range(workers)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
            assert not thread.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert counters.snapshot()['n'] == workers * adds


def test_process_counters_are_global():
    assert isinstance(profiler.counters, profiler.Counters)


@pytest.fixture(scope='module')
def two_utterances(tmp_path_factory):
    path = tmp_path_factory.mktemp('trace')
    rng = np.random.RandomState(0)
    entries = []
    for index, nsamples in enumerate((16000, 20000)):
        t = np.arange(nsamples) / 16000
        signal = np.sin(2 * np.pi * 140 * t) * (
            0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + rng.randn(nsamples) * 0.05
        wav = str(path / f'u{index}.wav')
        scipy.io.wavfile.write(
            wav, 16000, (signal / np.abs(signal).max() * 12000).astype(
                np.int16))
        entries.append((f'u{index}', wav, 'spk'))
    return entries


def test_trace_names_the_pass2_span(tmp_path, two_utterances):
    config = pipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
    logdir = tmp_path / 'trace'
    with profiler.trace(str(logdir)):
        pipeline.extract_features(
            config, Utterances(two_utterances), device='cpu')
    files = glob.glob(str(logdir / '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as stream:
        events = json.load(stream)['traceEvents']
    spans = {event.get('name'): event for event in events}
    for name in ('pass2', 'pass1.dispatch'):
        assert name in spans, name
    # pass 2 ran on another thread than pass 1's dispatch
    assert spans['pass2']['tid'] != spans['pass1.dispatch']['tid']
