"""Counterpart of ``tests/test_profiler.py``, case for case: the
port's stage timer and tracing helpers."""

import logging

from shennong_tpu_torch.parallel.profiler import StageTimer


def test_stage_timer(caplog):
    log = logging.getLogger('timer-test')
    timer = StageTimer(log=log)
    with timer.stage('alpha'):
        sum(range(1000))
    with timer.stage('beta'):
        pass
    with timer.stage('alpha'):
        pass

    with caplog.at_level(logging.INFO, logger='timer-test'):
        stages = timer.report(audio_seconds=10.0)
    assert set(stages) == {'alpha', 'beta'}
    assert stages['alpha'] > 0
    assert any("alpha" in r.getMessage() for r in caplog.records)
