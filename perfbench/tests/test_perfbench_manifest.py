"""``BENCHMARK.json`` keeps the contract's shape, and the harness finds
every file by name, new ones too."""

import json
import os
import re

import pytest

from perfbench.harness import Harness
from perfbench.harness.kaldi_pitch import KaldiPitch
from perfbench.manifest import ROOT, Manifest
from perfbench.tests.helpers import add_file, copy_checkout

#: the characters the contract allows in a name and a unit
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')

TOP = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
       'end_to_end', 'per_layer'}
ENTRY = {
    'configs': {'name', 'source', 'file', 'reduced', 'why'},
    'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}
LINE = re.compile(r'^[^\n\t]{1,200}$')


@pytest.fixture(scope='module')
def manifest():
    return Manifest()


def test_keys_names_and_units(manifest):
    data = manifest.data
    assert set(data) == TOP
    assert data['command'] == ['python3', 'perfbench/run.py']
    assert data['paths'] == ['perfbench']
    assert 1 <= data['run_seconds'] <= 51
    names = []
    for section, keys in ENTRY.items():
        for entry in data[section]:
            extra = set(entry) - keys
            assert keys <= set(entry) and extra <= {'workloads'}, entry
            assert NAME.match(entry['name']), entry['name']
            names.append(entry['name'])
            for key in ('why', 'layer'):
                if key in entry:
                    assert LINE.match(entry[key]), entry[key]
            if section == 'configs':
                assert LINE.match(entry['source']), entry['source']
            elif section == 'per_layer':
                assert entry['source'] in (
                    'device_trace', 'program_span', 'program_counter',
                    'host_clock')
            if 'unit' in entry:
                assert UNIT.match(entry['unit']), entry['unit']
                assert entry['better'] in ('lower', 'higher')
    assert len(names) == len(set(names))
    assert 'setup_s' in {m['name'] for m in data['end_to_end']}
    for metric in data['end_to_end']:
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= metric['bound'] <= 0.25
    for workload in data['workloads']:
        assert NAME.match(workload['config'])
        assert NAME.match(workload['traffic'])
        assert workload['chips'] in (1, 4)
    for config in data['configs']:
        assert config['file'].startswith('perfbench/')
        assert len(config['reduced']) <= 16
        assert all(NAME.match(key) for key in config['reduced'])
    ends = {m['name'] for m in data['end_to_end']}
    cells = {w['name'] for w in data['workloads']}
    for metric in data['per_layer']:
        assert metric['moves'] in ends
        assert set(metric.get('workloads', cells)) <= cells
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) < 64 << 10


def test_every_cell_finds_its_files(manifest):
    for workload in manifest.data['workloads']:
        cell = manifest.cell(workload['name'])
        assert 'pipeline' in cell.config
        assert isinstance(cell.harness, Harness)
        assert cell.traffic['utterances'] > 0
        assert cell.limits
        assert cell.end_to_end and cell.per_layer
        for metric in cell.per_layer:
            assert callable(manifest.reader(metric['name']))


def test_new_files_are_taken_without_editing_any(tmp_path):
    """A configuration, a mix, a metric and a cell's limits added as
    files, and entries added to the manifest, make a new cell."""
    root = copy_checkout(str(tmp_path))
    before = {
        p: open(os.path.join(root, 'perfbench', sub, p)).read()
        for sub in ('configs', 'traffic', 'metrics', 'checks')
        for p in os.listdir(os.path.join(root, 'perfbench', sub))
        if p.endswith(('.json', '.py'))}
    config = json.load(open(os.path.join(
        root, 'perfbench', 'configs', 'mfcc_pitch.json')))
    config['pipeline']['mfcc']['num_bins'] = 40
    add_file(root, 'perfbench/configs/mfcc40_pitch.json', config)
    add_file(root, 'perfbench/traffic/short.json', {
        'law': 'lognormal', 'utterances': 16, 'speakers': 4,
        'ln_mean': 0.7, 'ln_sd': 0.3, 'clip_s': [1.0, 3.0],
        'compared_speakers': 1})
    add_file(root, 'perfbench/metrics/calls.py',
             'def read(run):\n    return float(len(run.calls))\n')
    add_file(root, 'perfbench/checks/mfcc40_pitch.short.json',
             {'control': 'program_bfloat16_fetch',
              'limits': {'feat_rms': 1.0, 'pitch_off': 0.1}})
    path = os.path.join(root, 'BENCHMARK.json')
    data = json.load(open(path))
    data['configs'].append({
        'name': 'mfcc40_pitch', 'source': 'a test',
        'file': 'perfbench/configs/mfcc40_pitch.json',
        'reduced': [], 'why': 'a test'})
    data['workloads'].append({
        'name': 'mfcc40_pitch.short', 'config': 'mfcc40_pitch',
        'traffic': 'short', 'chips': 1, 'why': 'a test'})
    data['per_layer'].append({
        'name': 'calls', 'unit': 'calls', 'better': 'higher',
        'source': 'host_clock', 'layer': 'harness', 'moves': 'setup_s',
        'workloads': ['mfcc40_pitch.short']})
    json.dump(data, open(path, 'w'))

    manifest = Manifest(root)
    cell = manifest.cell('mfcc40_pitch.short')
    assert cell.config['pipeline']['mfcc']['num_bins'] == 40
    assert cell.traffic['utterances'] == 16
    assert cell.limits == {'feat_rms': 1.0, 'pitch_off': 0.1}
    assert 'calls' in [m['name'] for m in cell.per_layer]
    assert 'calls' not in [
        m['name'] for m in manifest.cell('mfcc_pitch.test_clean').per_layer]

    class Run:
        calls = [(0, 1), (1, 2)]
    assert manifest.reader('calls')(Run()) == 2.0
    for name, text in before.items():
        sub = next(s for s in ('configs', 'traffic', 'metrics', 'checks')
                   if os.path.exists(os.path.join(root, 'perfbench', s,
                                                  name)))
        assert open(os.path.join(root, 'perfbench', sub, name)).read() == text


def test_a_configuration_without_a_harness_key_takes_kaldi_pitch(manifest):
    for name in ('mfcc_pitch', 'rastaplp_pitch'):
        cell = manifest.cell(f'{name}.test_clean')
        assert 'harness' not in cell.config
        # loaded by path: a class of its own, of the same name
        assert type(cell.harness).__name__ == KaldiPitch.__name__
        assert cell.harness.config is cell.pipeline
        assert cell.harness.sample_rate == 16000
