"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; a per-layer metric is a module of its own, and so is the shape of
a configuration's pipeline. Each lives in a file named after it, so a
later change adds a configuration, a mix, a metric, a cell's limits or
a pipeline of a new shape as new files and entries, and edits none:

- ``perfbench/configs/<config>.json`` (the ``file`` of the entry): the
  configuration as it is run, with ``pipeline`` (the configuration
  ``extract_features`` takes), ``sample_rate``, and ``harness``, the
  name of its harness module (:data:`perfbench.harness.DEFAULT`,
  ``kaldi_pitch``, where it has none);
- ``perfbench/harness/<harness>.py``, with ``build(config,
  sample_rate)``: a :class:`perfbench.harness.Harness`, which makes
  what set-up needs beside the corpus (``prepare``), gives each
  utterance's expected shape (``expected_shape``), the numbers that
  decide ``correct`` from its plain reference (``compare``) and what
  the trace's readers need (``trace_inputs``);
- ``perfbench/traffic/<traffic>.json``;
- ``perfbench/metrics/<metric>.py``, with ``read(run)``: the value, or
  None where the run had nothing to read;
- ``perfbench/checks/<workload>.json``: the limits of the numbers that
  decide ``correct``, one for each number the harness's ``compare``
  gives.

A configuration of a new shape, CREPE 'full' pitch for instance, adds:

1. ``perfbench/configs/crepe_pitch.json``, with ``"harness":
   "crepe_pitch"``, and its entry in ``configs``;
2. ``perfbench/harness/crepe_pitch.py``: ``prepare`` writes the weights
   drawn from the seed under the run's directory and returns the
   override that points the program at them; ``expected_shape``,
   ``compare`` against a plain reference (float64 torch or numpy kept
   beside it, importing nothing of the program) and ``trace_inputs``
   (the operations of the CNN in ``work``);
3. ``perfbench/traffic/<traffic>.json``, unless a mix that is there
   serves, and the cell's entry in ``workloads``;
4. ``perfbench/checks/crepe_pitch.<traffic>.json``: the limits of the
   numbers its ``compare`` gives;
5. ``perfbench/metrics/crepe_mfu.py``, reading ``run.work``, and its
   entry in ``per_layer``.
"""

import importlib.util
import json
import os
import re

from perfbench.harness import DEFAULT

#: a name as ``BENCHMARK.json`` and the files it names allow it
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path):
    with open(path) as handle:
        return json.load(handle)


class Cell:
    """One workload: its entry, configuration, harness, traffic mix and
    limits."""

    def __init__(self, manifest, entry):
        self.manifest = manifest
        self.entry = entry
        self.name = entry['name']
        self.chips = int(entry['chips'])
        config = manifest.config(entry['config'])
        self.config_name = config['name']
        self.config = _load_json(os.path.join(manifest.root, config['file']))
        self.pipeline = self.config['pipeline']
        self.harness = manifest.harness(self.config.get('harness', DEFAULT))(
            self.pipeline, self.config['sample_rate'])
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
        return self._module('metrics', metric).read

    def harness(self, name):
        """The ``build(config, sample_rate)`` function of a harness
        module; FileNotFoundError where there is none."""
        return self._module('harness', name).build

    def _module(self, folder, name):
        """``perfbench/<folder>/<name>.py``, loaded by path."""
        if not NAME.match(name):
            raise ValueError(f'{name!r} is not a name of the benchmark')
        path = os.path.join(self.here, folder, f'{name}.py')
        if not os.path.isfile(path):
            raise FileNotFoundError(f'no module perfbench/{folder}/'
                                    f'{name}.py')
        spec = importlib.util.spec_from_file_location(
            f'perfbench.{folder}.{name}', path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
