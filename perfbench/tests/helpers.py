"""A temporary checkout of the benchmark with a tiny cell of each
configuration, for runs on the CPU."""

import json
import os
import shutil

from perfbench.manifest import ROOT, Manifest

#: a mix small enough for the CPU: 8 utterances of 1.3-2.5 s, 2 speakers
TINY = {'source': 'a test size', 'law': 'lognormal', 'utterances': 8,
        'speakers': 2, 'ln_mean': 0.5, 'ln_sd': 0.3, 'clip_s': [1.3, 2.5],
        'compared_speakers': 1}


def copy_checkout(directory):
    """``BENCHMARK.json`` and ``perfbench/`` copied under ``directory``."""
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), directory)
    shutil.copytree(os.path.join(ROOT, 'perfbench'),
                    os.path.join(directory, 'perfbench'),
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    return directory


def add_file(root, relative, content):
    path = os.path.join(root, relative)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as handle:
        handle.write(content if isinstance(content, str)
                     else json.dumps(content))
    return path


def tiny_manifest(directory):
    """A copy of the benchmark with ``<config>.tiny`` cells (the limits
    of the configuration's first cell), and its :class:`Manifest`."""
    root = copy_checkout(directory)
    path = os.path.join(root, 'BENCHMARK.json')
    with open(path) as handle:
        data = json.load(handle)
    add_file(root, 'perfbench/traffic/tiny.json', TINY)
    for config in data['configs']:
        cell = f'{config["name"]}.tiny'
        real = next(w['name'] for w in data['workloads']
                    if w['config'] == config['name'])
        data['workloads'].append(
            {'name': cell, 'config': config['name'], 'traffic': 'tiny',
             'chips': 1, 'why': 'a test size'})
        shutil.copy(
            os.path.join(root, 'perfbench', 'checks', f'{real}.json'),
            os.path.join(root, 'perfbench', 'checks', f'{cell}.json'))
    with open(path, 'w') as handle:
        json.dump(data, handle)
    return Manifest(root)
