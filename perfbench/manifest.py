"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; a per-layer metric is a module of its own. Each lives in a file
named after it, so a later change adds a configuration, a mix, a metric
or a cell's limits as new files and entries, and edits none:

- ``perfbench/configs/<config>.json`` (the ``file`` of the entry);
- ``perfbench/traffic/<traffic>.json``;
- ``perfbench/metrics/<metric>.py``, with ``read(run)``: the value, or
  None where the run had nothing to read;
- ``perfbench/checks/<workload>.json``: the limits of the numbers that
  decide ``correct``.
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path):
    with open(path) as handle:
        return json.load(handle)


class Cell:
    """One workload: its entry, configuration, traffic mix and limits."""

    def __init__(self, manifest, entry):
        self.manifest = manifest
        self.entry = entry
        self.name = entry['name']
        self.chips = int(entry['chips'])
        config = manifest.config(entry['config'])
        self.config_name = config['name']
        self.config = _load_json(os.path.join(manifest.root, config['file']))
        self.traffic_name = entry['traffic']
        self.traffic = _load_json(os.path.join(
            manifest.here, 'traffic', f'{entry["traffic"]}.json'))
        self.limits = _load_json(os.path.join(
            manifest.here, 'checks', f'{self.name}.json'))['limits']
        self.end_to_end = [
            m for m in manifest.data['end_to_end'] if applies(m, self.name)]
        self.per_layer = [
            m for m in manifest.data['per_layer'] if applies(m, self.name)]


def applies(metric, cell):
    """Whether a metric is reported in ``cell`` (every cell when it has
    no ``workloads`` key)."""
    return 'workloads' not in metric or cell in metric['workloads']


class Manifest:
    """The benchmark's manifest at ``root`` (the checkout)."""

    def __init__(self, root=ROOT):
        self.root = root
        self.here = os.path.join(root, 'perfbench')
        self.data = _load_json(os.path.join(root, 'BENCHMARK.json'))

    def config(self, name):
        return next(c for c in self.data['configs'] if c['name'] == name)

    def cell(self, name):
        entry = next((w for w in self.data['workloads'] if w['name'] == name),
                     None)
        if entry is None:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json')
        return Cell(self, entry)

    def reader(self, metric):
        """The ``read(run)`` function of a per-layer metric's module."""
        path = os.path.join(self.here, 'metrics', f'{metric}.py')
        spec = importlib.util.spec_from_file_location(
            f'perfbench.metrics.{metric}', path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
