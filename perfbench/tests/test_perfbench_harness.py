"""A configuration of a new shape enters through new files alone: its
own harness module, found by the configuration file's ``"harness"`` key,
decides the set-up beside the corpus, the expected shapes, the numbers
of ``correct`` and the trace's inputs. Runs on the CPU at a tiny size,
the harness's look for a card skipped."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import bench, check, control, corpus
from perfbench.tests.helpers import add_file, copy_checkout, tiny_manifest

SEED = 2 ** 31 + 29
#: the stand-in: MFCC, CMVN by speaker with the VAD, deltas, no pitch,
#: a shape the Kaldi pitch harness refuses
CONFIG = 'mfcc_cmvn'
CELL = f'{CONFIG}.tiny'

#: the stand-in's harness module; ``{override}``, ``{columns}`` and
#: ``{shift}`` make its faulty variants
MODULE = '''
import os

import numpy as np
import torch

from perfbench.harness import Harness
from perfbench.reference.frontend import (
    FrontEnd, apply_cmvn, cmvn_stats, deltas, vad)
from perfbench.reference.pipeline import read_wav

#: the delta order the program is set to in set-up
ORDER = 2


class MfccCmvn(Harness):

    def prepare(self, seed, workdir, device):
        with open(os.path.join(workdir, 'prepared.txt'), 'w') as out:
            out.write(str(seed))
        return {override}

    def expected_shape(self, nsamples):
        front = FrontEnd('mfcc', self.config['mfcc'], self.sample_rate,
                         'cpu')
        return (front.num_frames(nsamples),
                (ORDER + 1) * int(self.config['mfcc']['num_ceps'])
                + {columns})

    def compare(self, entries, compared, outputs, device, seed):
        front = FrontEnd('mfcc', self.config['mfcc'], self.sample_rate,
                         device)
        members = {{}}
        for name, path, speaker in entries:
            members.setdefault(speaker, []).append((name, path))
        wanted, plain = set(compared), {{}}
        for group in members.values():
            if not any(name in wanted for name, _ in group):
                continue
            stats, raws = None, {{}}
            for name, path in group:
                samples, _ = read_wav(path)
                raw, energy = front(torch.as_tensor(
                    samples.astype(np.float64), device=device))
                part = cmvn_stats(raw, vad(energy, self.config['cmvn']['vad']))
                stats = part if stats is None else tuple(
                    a + b for a, b in zip(stats, part))
                if name in wanted:
                    raws[name] = raw
            for name, raw in raws.items():
                plain[name] = deltas(
                    apply_cmvn(raw, stats), ORDER,
                    int(self.config['delta']['window'])).cpu().numpy()
        squares, count = 0.0, 0
        for call in outputs:
            for name, ref in plain.items():
                if call.get(name) is None or call[name].shape != ref.shape:
                    continue
                gap = call[name].astype(np.float64) - ref
                squares += float((gap * gap).sum())
                count += gap.size
        return ({{'feat_gap': (squares / max(count, 1)) ** 0.5 + {shift}}},
                {{'compared': len(plain)}})

    def trace_inputs(self, samples):
        return {{'work': {{'samples': sum(samples)}}}}


def build(config, sample_rate):
    return MfccCmvn(config, sample_rate)
'''
SOUND = {'override': "{'delta': {'order': ORDER}}", 'columns': 0,
         'shift': 0.0}
#: the stand-in's limit: its sound runs read 9.0e-7 to 9.5e-7 (3 seeds),
#: one utterance's first cepstrum moved by 0.05 reads 4.1e-3
LIMIT = 1e-3


def stand_in(directory, limits=None, **variant):
    """A checkout with the tiny cells and the stand-in's cell, its
    harness module written with ``variant``'s changes to :data:`SOUND`,
    and a reader of the harness's ``work``."""
    os.makedirs(directory, exist_ok=True)
    manifest = tiny_manifest(directory)
    root = manifest.root
    with open(os.path.join(root, 'perfbench/configs/mfcc_pitch.json')) as f:
        config = json.load(f)
    pipeline = config['pipeline']
    del pipeline['pitch']
    # the file's order; the harness's set-up sets the program's to 2
    pipeline['delta']['order'] = 1
    pipeline['mfcc']['dither'] = 0.0
    config['harness'] = CONFIG
    add_file(root, f'perfbench/configs/{CONFIG}.json', config)
    add_file(root, f'perfbench/harness/{CONFIG}.py',
             MODULE.format(**dict(SOUND, **variant)))
    add_file(root, f'perfbench/checks/{CELL}.json', {
        'control': 'program_bfloat16_fetch',
        'limits': limits or {'feat_gap': LIMIT}})
    add_file(root, 'perfbench/metrics/window_samples.py',
             'def read(run):\n    return run.work.get("samples")\n')
    path = os.path.join(root, 'BENCHMARK.json')
    with open(path) as handle:
        data = json.load(handle)
    data['configs'].append({
        'name': CONFIG, 'source': 'a test', 'file':
        f'perfbench/configs/{CONFIG}.json', 'reduced': [], 'why': 'a test'})
    data['workloads'].append({
        'name': CELL, 'config': CONFIG, 'traffic': 'tiny', 'chips': 1,
        'why': 'a test size'})
    data['per_layer'].append({
        'name': 'window_samples', 'unit': 'samples', 'better': 'higher',
        'source': 'program_counter', 'layer': 'harness', 'moves': 'setup_s',
        'workloads': [CELL]})
    with open(path, 'w') as handle:
        json.dump(data, handle)
    return type(manifest)(root)


def drive(manifest, workdir, trace=0):
    return bench.measure(manifest.cell(CELL), SEED, 0.01, trace, 'cpu',
                         time.perf_counter(), str(workdir))


@pytest.fixture(scope='module')
def sound(tmp_path_factory):
    """The stand-in's checkout and one untraced and one traced run."""
    manifest = stand_in(str(tmp_path_factory.mktemp('checkout')))
    runs = []
    for trace in (0, 1):
        workdir = tmp_path_factory.mktemp(f'run{trace}')
        runs.append((drive(manifest, workdir, trace), workdir))
    return manifest, runs


def test_a_new_shape_runs_through_its_own_harness(sound):
    manifest, runs = sound
    for (result, checks, lines), workdir in runs:
        assert result['correct'], checks
        assert result['failed'] == 0 and result['attempted'] >= 8
        assert set(checks) == {'feat_gap', 'failed'}
        assert checks['feat_gap']['limit'] == LIMIT
        # prepare ran in set-up, in the run's directory, with the seed
        assert (workdir / 'prepared.txt').read_text() == str(SEED)
        assert any('compared ' in line for line in lines)
    (untraced, _, _), _ = runs[0]
    # the card's rate is read from the device's trace, which a run on
    # the CPU does not have
    assert set(untraced['metrics']) == {'setup_s'}


def test_the_harness_s_work_reaches_its_reader(sound):
    manifest, runs = sound
    (traced, _, _), _ = runs[1]
    mix = manifest.cell(CELL).traffic
    # every seed extracts the same set of lengths
    lengths = sum(int(round(d * corpus.RATE)) for d in corpus.durations(mix))
    calls = traced['attempted'] // mix['utterances']
    assert traced['metrics']['window_samples']['value'] == calls * lengths


@pytest.mark.parametrize('variant, failed, correct', [
    # set-up's override left out: the program computes order 1, 26
    # columns where 39 are expected
    ({'override': '{}'}, 'all', False),
    # the harness expects a column more than the program gives
    ({'columns': 1}, 'all', False),
    # the harness's own number above its limit
    ({'shift': 1.0}, 'none', False),
], ids=['override_left_out', 'shape_expected_wrong', 'number_over_limit'])
def test_the_harness_decides_failed_and_correct(tmp_path, variant, failed,
                                                correct):
    manifest = stand_in(str(tmp_path / 'checkout'), **variant)
    (tmp_path / 'run').mkdir()
    result, checks, _ = drive(manifest, tmp_path / 'run')
    assert result['correct'] is correct, checks
    want = result['attempted'] if failed == 'all' else 0
    assert result['failed'] == want


@pytest.mark.parametrize('limits', [
    {'feat_gap': LIMIT, 'pitch_off': 0.15}, {'other': 1.0}],
    ids=['a_limit_without_a_number', 'a_number_without_a_limit'])
def test_numbers_and_limits_that_differ_end_the_run(tmp_path, limits):
    manifest = stand_in(str(tmp_path / 'checkout'), limits=limits)
    (tmp_path / 'run').mkdir()
    with pytest.raises(ValueError, match='limits'):
        drive(manifest, tmp_path / 'run')


def test_a_missing_harness_module_exits_with_2(tmp_path):
    root = copy_checkout(str(tmp_path))
    config = os.path.join(root, 'perfbench', 'configs', 'mfcc_pitch.json')
    with open(config) as handle:
        data = json.load(handle)
    data['harness'] = 'absent'
    with open(config, 'w') as handle:
        json.dump(data, handle)
    out = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload',
         'mfcc_pitch.test_clean', '--seed', '1', '--seconds', '1',
         '--trace', '0'], cwd=root, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert out.stdout == ''
    assert 'perfbench/harness/absent.py' in out.stderr


# --- the Kaldi pitch cells, through the default harness and through the
# functions the harness replaced, copied here as they were


def parent_expected_rows(reference, nsamples):
    return min(reference.front.num_frames(nsamples),
               reference.pitch.num_frames(nsamples))


def parent_compare(cell, entries, compared, outputs, device, seed):
    from perfbench.reference.pipeline import Reference

    config = cell.config['pipeline']
    rate = int(cell.config['sample_rate'])
    plain = Reference(config, rate, device).extract(entries, compared)
    generator = torch.Generator(device=device).manual_seed(int(seed) + 2)
    dithered = Reference(config, rate, device, generator=generator)
    front = {name: block.cpu().numpy() for name, block in
             dithered.front_end(entries, compared).items()}
    columns = next(iter(front.values())).shape[1]
    reach = check.dither_rms(plain, front, columns)
    numbers, delta_rms = check.numbers(
        outputs, plain, reach,
        check.noise_reach(config['pitch']['postprocessing']))
    return numbers, delta_rms


def parent_shapes_and_trace(cell, samples):
    from perfbench.reference.pipeline import Reference

    config = cell.config['pipeline']
    rate = int(cell.config['sample_rate'])
    reference = Reference(config, rate, 'cpu')
    columns = (int(config['delta']['order']) + 1) * int(
        config[reference.kind]['num_ceps']) + check.PITCH_COLUMNS
    shapes = [(parent_expected_rows(reference, n), columns)
              for n in samples]
    frames = [reference.pitch.num_frames(n) for n in samples]
    return shapes, frames, int(reference.pitch.lags.shape[0])


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    return tiny_manifest(str(tmp_path_factory.mktemp('kaldi')))


@pytest.mark.parametrize('config', ['mfcc_pitch', 'rastaplp_pitch'])
def test_the_default_harness_reads_as_the_functions_it_replaced(
        tiny, tmp_path, config):
    cell = tiny.cell(f'{config}.tiny')
    harness = cell.harness
    entries, samples = corpus.write_corpus(cell.traffic, SEED,
                                           str(tmp_path), 'cpu')
    lengths = list(samples.values())
    shapes, frames, lags = parent_shapes_and_trace(cell, lengths * 2)
    assert [harness.expected_shape(n) for n in lengths * 2] == shapes
    assert harness.trace_inputs(lengths * 2) == {
        'pitch_frames': frames, 'lags': lags}
    assert harness.prepare(SEED, str(tmp_path), 'cpu') == {}

    compared = check.compared_names(samples, entries, cell.traffic, SEED)
    outputs = control.outputs_of(cell.pipeline, entries, compared, SEED,
                                 'cpu', None)
    numbers, details = bench.compare(cell, entries, compared, [outputs],
                                     'cpu', SEED)
    parent, delta_rms = parent_compare(cell, entries, compared, [outputs],
                                       'cpu', SEED)
    assert numbers == parent
    assert details == {'delta_rms': delta_rms}
    assert np.isfinite(list(numbers.values())).all()
