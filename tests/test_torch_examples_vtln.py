"""The port's VTLN examples against the JAX package, on the CPU.

``vtln_warps`` and ``features_abx`` run in process with
``device='cpu'`` beside the JAX examples themselves, with the same
small trainer in both (a 4-gaussian UBM, 3 warp classes, the JAX
example module's ``VtlnProcessor`` swapped for it) and every random
source at 0: the warps equal, the warps files equal, the features of
every stage within 1e-3. ``training_bench`` runs the same small models
over the synthetic corpus of ``features_abx`` (the JAX example's files
byte for byte) against the JAX package's trainers: the warps equal, the
UBM within 1e-3 (relative to the largest entry, as
tests/test_torch_ubm.py holds it).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from shennong_tpu.processor import energy as jenergy
from shennong_tpu.processor import ubm as jubm
from shennong_tpu.processor import vtln as jvtln
from shennong_tpu.utterances import Utterances as JUtterances
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.processor import energy
from shennong_tpu_torch.processor.vtln import VtlnProcessor
from tests.test_torch_examples_scripts import load

torch.set_num_threads(2)

TOL = 1e-3
REAL_WAV = os.path.join(os.path.dirname(__file__), 'data', 'test.wav')
# small models: a 4-gaussian UBM, 3 warp classes, 2 rounds, no dither
UBM = {'num_gauss': 4, 'num_iters': 1, 'num_iters_init': 2,
       'num_frames': 1000}
VTLN = dict(num_iters=2, subsample=2, min_warp=0.95, max_warp=1.05,
            warp_step=0.05, ubm=UBM)


@pytest.fixture
def no_energy_dither(monkeypatch):
    """The energy VAD's dither at 0 in both packages."""
    for cls in (jenergy.EnergyProcessor, energy.EnergyProcessor):
        defaults = list(cls.__init__.__defaults__)
        defaults[3] = 0.0
        monkeypatch.setattr(cls.__init__, '__defaults__', tuple(defaults))


def small(cls):
    """``cls`` (either package's VtlnProcessor) with the small models of
    :data:`VTLN`, its features' dither at 0."""
    proc = cls(**copy.deepcopy(VTLN))
    proc.features['mfcc']['dither'] = 0
    proc.ubm = dict(proc.ubm, features=copy.deepcopy(proc.features))
    proc.set_logger('error')
    return proc


def swap_trainer(monkeypatch, module):
    """The JAX example ``module`` trains :func:`small` models and
    extracts without MFCC dither (the test's fixture zeroes the energy
    VAD's), whether it imports those names at its top or in its
    ``main``."""
    from shennong_tpu import pipeline as jpipeline
    from shennong_tpu import processor as jprocessor
    from shennong_tpu import utils as jutils

    real = jpipeline.get_default_config

    def no_dither(*args, **kwargs):
        config = real(*args, **kwargs)
        config['mfcc']['dither'] = 0
        return config

    def trainer():
        return small(jvtln.VtlnProcessor)

    for target in (module, jprocessor):
        monkeypatch.setattr(target, 'VtlnProcessor', trainer, raising=False)
    for target in (module, jpipeline):
        monkeypatch.setattr(target, 'get_default_config', no_dither,
                            raising=False)
    monkeypatch.setattr(jutils, 'enable_compilation_cache',
                        lambda *a, **k: None)


def assert_close(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        assert ours[name].shape == theirs[name].shape, name
        assert np.abs(ours[name].data - theirs[name].data).max() < TOL, name


def test_vtln_warps(tmp_path, monkeypatch, no_energy_dither):
    """Two speakers of two utterances each, cut from test.wav."""
    pytest.importorskip('h5py')
    index = str(tmp_path / 'utterances.txt')
    with open(index, 'w') as stream:
        for i, (start, stop) in enumerate(
                [(0.0, 0.35), (0.35, 0.7), (0.7, 1.05), (1.05, 1.42)]):
            stream.write(f'u{i} {REAL_WAV} s{i // 2} {start} {stop}\n')
    module = load('vtln_warps', jax=True)
    swap_trainer(monkeypatch, module)
    monkeypatch.setattr(sys, 'argv', [
        'vtln_warps.py', index, str(tmp_path / 'jwarps.yaml'),
        str(tmp_path / 'jfeatures.h5f')])
    module.main()

    ours = load('vtln_warps')
    config = ours.get_default_config('mfcc', with_cmvn=True, with_delta=True)
    config['mfcc']['dither'] = 0
    report = ours.train(
        index, str(tmp_path / 'warps.yaml'), str(tmp_path / 'features.h5f'),
        device='cpu', vtln=small(VtlnProcessor), config=config)
    with open(tmp_path / 'jwarps.yaml') as theirs, \
            open(tmp_path / 'warps.yaml') as ours:
        assert yaml.safe_load(theirs) == yaml.safe_load(ours)
    assert set(report['warps']) == {'s0', 's1'}
    theirs = FeaturesCollection.load(str(tmp_path / 'jfeatures.h5f'))
    assert_close(report['features'], theirs)
    assert_close(FeaturesCollection.load(str(tmp_path / 'features.h5f')),
                 theirs)


@pytest.fixture(scope='module')
def synthetic(tmp_path_factory):
    """The 4-utterance synthetic corpus of features_abx, written by both
    packages' examples."""
    path = tmp_path_factory.mktemp('synthetic')
    ours = load('features_abx').make_synthetic_corpus(str(path / 'ours'), 4)
    theirs = load('features_abx', jax=True).make_synthetic_corpus(
        str(path / 'theirs'), 4)
    return path, ours, theirs


def test_synthetic_corpus_is_the_jax_examples(synthetic):
    _, ours, theirs = synthetic
    assert [(n, s) for n, _, s in ours] == [(n, s) for n, _, s in theirs]
    for (_, mine, _), (_, ref, _) in zip(ours, theirs):
        with open(mine, 'rb') as a, open(ref, 'rb') as b:
            assert a.read() == b.read()


def test_features_abx(tmp_path, monkeypatch, no_energy_dither):
    """Every stage: the warps, then the three feature sets and their
    files, against the JAX example's."""
    pytest.importorskip('h5py')
    module = load('features_abx', jax=True)
    swap_trainer(monkeypatch, module)
    monkeypatch.setattr(sys, 'argv', [
        'features_abx.py', str(tmp_path / 'jax'), '--synthetic', '4'])
    module.main()

    report = load('features_abx').prepare(
        str(tmp_path / 'torch'), synthetic=4, device='cpu',
        vtln=small(VtlnProcessor), dither=0)
    assert list(report['timings']) == [
        'vtln training', 'extract mfcc', 'extract mfcc_cmvn',
        'extract mfcc_vtln_cmvn']
    assert report['seconds'] == 4.0 + 5.0 + 6.0 + 7.0
    with open(tmp_path / 'jax' / 'warps.yaml') as a, \
            open(tmp_path / 'torch' / 'warps.yaml') as b:
        assert yaml.safe_load(a) == yaml.safe_load(b) == report['warps']
    for name, path in report['outputs'].items():
        assert path == str(tmp_path / 'torch' / f'{name}.h5f')
        theirs = FeaturesCollection.load(str(tmp_path / 'jax' / f'{name}.h5f'))
        assert_close(report['features'][name], theirs)
        assert_close(FeaturesCollection.load(path), theirs)
    warped = report['features']['mfcc_vtln_cmvn']
    assert {f.properties['mfcc']['vtln_warp'] for f in warped.values()} \
        <= {0.95, 1.0, 1.05}


def test_training_bench(synthetic):
    """One run of each model over the synthetic corpus, against the JAX
    package's trainers on the same utterances."""
    path, ours, _ = synthetic
    vtln = small(VtlnProcessor)
    report = load('training_bench').bench(
        str(path / 'bench'), 4, runs=1, device='cpu',
        ubm=dict(UBM, features=vtln.features), vtln=vtln.get_params())
    assert len(report['ubm']) == len(report['vtln']) == 1
    assert report['seconds'] == 22.0

    entries = [(n, str(path / 'bench' / 'corpus' / os.path.basename(p)), s)
               for n, p, s in ours]
    jubm_proc = jubm.DiagUbmProcessor(**dict(
        UBM, features=small(jvtln.VtlnProcessor).features))
    jubm_proc.process(JUtterances(entries))
    for name in ('weights', 'means', 'inv_vars'):
        a = getattr(report['ubm_model'].gmm, name)
        b = getattr(jubm_proc.gmm, name)
        assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < TOL, name
    jwarps = small(jvtln.VtlnProcessor).process(
        JUtterances(entries), group_by='speaker')
    assert report['warps'] == jwarps
