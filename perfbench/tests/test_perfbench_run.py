"""A run driven on the CPU at a tiny size: the harness's look for a card
is skipped, the rest runs as on the card. A sound run is correct; a run
whose timed path is broken, or the control, is not."""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from perfbench import bench
from perfbench.manifest import ROOT
from perfbench.tests.helpers import copy_checkout, tiny_manifest

CELL = 'mfcc_pitch.tiny'
KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']
SEED = 2 ** 31 + 17


@pytest.fixture(scope='module')
def manifest(tmp_path_factory):
    return tiny_manifest(str(tmp_path_factory.mktemp('checkout')))


def drive(manifest, tmp_path, cell=CELL, trace=0, seconds=0.01):
    return bench.measure(manifest.cell(cell), SEED, seconds, trace, 'cpu',
                         time.perf_counter(), str(tmp_path))


def test_the_run_refuses_to_measure_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload',
         'mfcc_pitch.test_clean', '--seed', '1', '--seconds', '1',
         '--trace', '0'], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ''
    assert 'no CUDA device' in out.stderr


def test_without_the_program_the_run_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and perfbench/."""
    root = copy_checkout(str(tmp_path))
    code = ('import time, tempfile\n'
            'from perfbench import bench\n'
            'from perfbench.manifest import Manifest\n'
            'from perfbench.tests.helpers import TINY\n'
            'cell = Manifest().cell("mfcc_pitch.test_clean")\n'
            'cell.traffic = TINY\n'
            'bench.measure(cell, 1, 0.01, 0, "cpu", time.perf_counter(), '
            'tempfile.mkdtemp())\n'
            'print("{}")\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ''
    assert 'shennong_tpu_torch' in out.stderr


@pytest.mark.parametrize('trace', [0, 1])
def test_a_sound_run_is_correct_and_its_line_has_the_contract_s_keys(
        manifest, tmp_path, trace):
    result, checks, lines = drive(manifest, tmp_path, trace=trace)
    assert result['correct'], checks
    assert result['failed'] == 0 and result['attempted'] >= 8
    cell = manifest.cell(CELL)
    line = bench.result_line(result, checks, 'a card', 1, '700.00 W')
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == 'checks'
    assert set(keys) == set(KEYS) | {'checks'} | (
        {'breakdown'} if trace else set())
    device = line['device']
    assert device['platform'] == 'gpu' and device['count'] == 1
    assert {'busy_s', 'window_s'} <= set(device) if trace else True
    expected = cell.per_layer if trace else cell.end_to_end
    names = {m['name'] for m in expected}
    assert set(line['metrics']) <= names
    if not trace:
        # a run on the CPU has no device's trace to read
        assert set(line['metrics']) == {
            m['name'] for m in expected if m['source'] != 'device_trace'}
        assert line['metrics']['setup_s']['unit'] == 's'
        assert any(' xrt ' in text for text in lines)
    else:
        assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
    assert set(checks) == {'feat_rms', 'pitch_off', 'failed'}
    for name, check in checks.items():
        assert set(check) == {'value', 'limit'}
    json.dumps(line)


def perturb_answers(original):
    """Pass 2 with one utterance's answer altered: its first cepstrum
    off by 0.05 in every frame."""
    def broken(manager, triplets, log, tolerance=2):
        finished = original(manager, triplets, log, tolerance)
        features = finished[min(finished)]
        features.data[:, 1] += 0.05
        return finished
    return broken


def scale_delta_pitch(original, factor):
    """Pass 2 with every utterance's delta pitch (the last column)
    scaled by ``factor``: -1 a wrong sign, 0.1 the scale left out."""
    def broken(manager, triplets, log, tolerance=2):
        finished = original(manager, triplets, log, tolerance)
        for features in finished.values():
            features.data[:, -1] *= factor
        return finished
    return broken


def identity_affine(stats, *args, **kwargs):
    """CMVN skipped: every group's affine the identity, so pass 2 leaves
    the features as pass 1 gave them."""
    dim = np.asarray(stats).shape[1] - 1
    return np.ones(dim), np.zeros(dim)


def half_the_statistics(original):
    """Every second utterance left out of its CMVN group's mean."""
    count = {'n': 0}

    def broken(feats, weights=None):
        count['n'] += 1
        stats = original(feats, weights=weights)
        return stats * 0 if count['n'] % 2 else stats
    return broken


@pytest.mark.parametrize('fault', [
    'answer_altered', 'half_left_out_of_the_mean', 'state_unchanged',
    'control_bfloat16_fetch', 'delta_pitch_sign', 'delta_pitch_scale'])
def test_a_broken_timed_path_is_not_correct(manifest, tmp_path, monkeypatch,
                                            fault):
    from shennong_tpu_torch import pipeline

    if fault == 'answer_altered':
        monkeypatch.setattr(pipeline, '_pass_two',
                            perturb_answers(pipeline._pass_two))
    elif fault == 'half_left_out_of_the_mean':
        monkeypatch.setattr(pipeline, 'accumulate_cmvn_stats',
                            half_the_statistics(
                                pipeline.accumulate_cmvn_stats))
    elif fault.startswith('delta_pitch'):
        monkeypatch.setattr(pipeline, '_pass_two', scale_delta_pitch(
            pipeline._pass_two, -1.0 if fault.endswith('sign') else 0.1))
    elif fault == 'state_unchanged':
        # where pass 2 reads each CMVN group's statistics
        monkeypatch.setattr(pipeline, 'cmvn_affine', identity_affine)
    else:
        monkeypatch.setattr(pipeline, 'extract_features', functools.partial(
            pipeline.extract_features, fetch_dtype='bfloat16'))
    result, checks, _ = drive(manifest, tmp_path)
    assert not result['correct'], checks
    assert any(c['value'] > c['limit'] for c in checks.values())


def test_a_missing_answer_counts_as_failed(manifest, tmp_path, monkeypatch):
    from shennong_tpu_torch import pipeline

    original = pipeline.extract_features

    def drop_one(*args, **kwargs):
        collection = original(*args, **kwargs)
        del collection[sorted(collection.keys())[0]]
        return collection
    monkeypatch.setattr(pipeline, 'extract_features', drop_one)
    result, checks, _ = drive(manifest, tmp_path)
    assert not result['correct']
    assert checks['failed']['value'] >= 1


def test_the_rastaplp_cell_runs(manifest, tmp_path):
    result, checks, _ = drive(manifest, tmp_path, cell='rastaplp_pitch.tiny')
    assert result['correct'], checks
    assert np.isfinite(result['metrics']['setup_s']['value'])


def read_control(manifest, tmp_path, control, device):
    from perfbench import control as script

    cell = manifest.cell(CELL)
    (tmp_path / 'sound').mkdir()
    (tmp_path / 'control').mkdir()
    sound = script.readings(cell, SEED, device, str(tmp_path / 'sound'),
                            warm=True)
    broken = script.readings(cell, SEED, device, str(tmp_path / 'control'),
                             control=control)
    return cell, sound, broken


def test_the_control_script_reads_a_control_past_the_limits(manifest,
                                                            tmp_path):
    """The bfloat16 fetch, at a test size on the CPU, fails a number of
    the cell, and the program's own call does not (TF32, the cells'
    control, exists only on the card)."""
    cell, sound, broken = read_control(manifest, tmp_path,
                                       'program_bfloat16_fetch', 'cpu')
    assert all(sound[k] <= cell.limits[k] for k in cell.limits)
    assert any(broken[k] > cell.limits[k] for k in cell.limits)


@pytest.mark.gpu
def test_the_tf32_control_fails_on_the_card(manifest, tmp_path):
    """The cells' control: the port with TF32 matrix products back on."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    cell, sound, broken = read_control(manifest, tmp_path, 'program_tf32',
                                       'cuda')
    assert all(sound[k] <= cell.limits[k] for k in cell.limits)
    assert any(broken[k] > cell.limits[k] for k in cell.limits)
