"""The port stands alone: it imports nothing of the JAX package.

1. No module of ``shennong_tpu_torch``, not ``chip_smoke.py``, no
   script of ``examples/torch/`` and not the port's site generator
   ``doc/torch/gen_docs.py`` imports ``shennong_tpu`` or ``jax`` (an AST
   walk, deferred imports and ``importlib`` calls included). One module
   of ``shennong_tpu_torch``, ``native``, builds and loads its compiled
   libraries (another AST walk).
2. With both blocked in ``sys.modules``, a child process imports the
   port, runs a small MFCC + Kaldi pitch + CMVN + delta
   ``extract_features(device='cpu')``, imports the UBM/VTLN trainers
   and the parameter carriers, runs CREPE pitch (its CNN, host and
   device decodes) and the bottleneck front end, imports the rest of
   the CREPE and bottleneck modules, runs a one-hot encoding of an
   alignment and the ABX evaluator's distances over segments cut by
   it, and runs the CLI's ``config --vtln`` and ``config bottleneck``.
   Another child, with both blocked too, imports every script of
   ``examples/torch/``, runs ``serve_throughput`` and
   ``extract_corpus`` on the CPU, and builds the port's site.
3. The port's own host layer writes the same files as the JAX
   package's: a ``FeaturesCollection`` saved by either loads in the
   other with equal arrays, dtypes and properties.
"""

import ast
import copy
import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.io.wavfile

from shennong_tpu.features import Features as JFeatures
from shennong_tpu.features_collection import (
    FeaturesCollection as JFeaturesCollection)
from shennong_tpu_torch import native
from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.utils import dict_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('shennong_tpu', 'jax', 'jaxlib')


def _blocked(module):
    return module is not None and module.split('.')[0] in BLOCKED


def _imports(path):
    """(line, module) of every import in ``path``, with the modules named
    to importlib.import_module and __import__ as string constants."""
    with open(path) as stream:
        tree = ast.parse(stream.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, alias.name) for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append((node.lineno, node.module))
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, 'attr', getattr(node.func, 'id', None))
              in ('import_module', '__import__')):
            found.append((node.lineno, node.args[0].value))
    return found


def test_no_import_of_the_jax_package():
    paths = sorted(glob.glob(
        os.path.join(REPO, 'shennong_tpu_torch', '**', '*.py'),
        recursive=True)) + [os.path.join(REPO, name) for name in (
            'chip_smoke.py',
            os.path.join('doc', 'torch', 'gen_docs.py'))] + sorted(glob.glob(
                os.path.join(REPO, 'examples', 'torch', '*.py')))
    assert len(paths) > 45
    offending = [
        f'{os.path.relpath(path, REPO)}:{line} imports {module}'
        for path in paths for line, module in _imports(path)
        if _blocked(module)]
    assert not offending, '\n'.join(offending)


#: the names that open a shared library through ctypes or build one
LOADERS = {'CDLL', 'PyDLL', 'cdll', 'pydll', 'LoadLibrary', 'cpp_extension',
           'load_inline'}
#: the compilers, as the literal a command line would name them by
COMPILERS = {'g++', 'gcc', 'c++', 'clang', 'clang++', 'nvcc'}


def _builds_or_loads(path):
    """Whether ``path`` names a ctypes loader or a compiler."""
    with open(path) as stream:
        tree = ast.parse(stream.read(), path)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and node.attr in LOADERS
                or isinstance(node, ast.Name) and node.id in LOADERS
                or isinstance(node, ast.alias) and node.name in LOADERS
                or isinstance(node, ast.Constant)
                and node.value in COMPILERS):
            return True
    return False


def test_one_module_builds_and_loads_compiled_code():
    paths = sorted(glob.glob(
        os.path.join(REPO, 'shennong_tpu_torch', '**', '*.py'),
        recursive=True))
    found = [os.path.relpath(path, REPO) for path in paths
             if _builds_or_loads(path)]
    assert found == [os.path.join('shennong_tpu_torch', 'native',
                                  '__init__.py')], found


def test_a_failed_build_is_none_on_the_host_and_raises_for_cuda(tmp_path):
    if shutil.which('g++') is None:
        pytest.skip('no g++ on this machine')
    (tmp_path / 'broken.cpp').write_text('not C++\n')
    (tmp_path / 'broken.cu').write_text('not CUDA\n')
    host = native.Library([str(tmp_path / 'broken.cpp')], {})
    with pytest.raises(RuntimeError, match=r'g\+\+ failed to build'):
        host.build()
    assert host.load() is None
    assert not os.path.exists(host.path)
    with pytest.raises((RuntimeError, OSError)):
        native.Library([str(tmp_path / 'broken.cu')], {}).load()


def test_runs_with_the_jax_package_blocked(tmp_path):
    wav = str(tmp_path / 'a.wav')
    rng = np.random.RandomState(0)
    t = np.arange(24000) / 16000
    signal = np.sin(2 * np.pi * 140 * t) * (1 + t) + 0.05 * rng.randn(t.size)
    scipy.io.wavfile.write(
        wav, 16000, (signal / np.abs(signal).max() * 15000).astype(np.int16))
    config = str(tmp_path / 'config.yaml')
    script = f'''
import sys


class Blocked:
    # refuse the imports (scipy probes sys.modules for jax, so the
    # blocked packages stay out of it rather than mapped to None)
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {BLOCKED!r}:
            raise ImportError(f'{{name}} is blocked')


sys.meta_path.insert(0, Blocked())
import numpy as np
from shennong_tpu_torch import Utterances, pipeline
from shennong_tpu_torch.cli import main
config = pipeline.get_default_config(
    'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
out = pipeline.extract_features(
    config, Utterances([('a', {wav!r}, 's')]), device='cpu')
assert out['a'].shape == (148, 42), out['a'].shape
assert np.isfinite(out['a'].data).all()
from shennong_tpu_torch import kaldiio, weights
from shennong_tpu_torch.processor.vtln import VtlnProcessor
assert VtlnProcessor().get_params()['ubm']['num_gauss'] == 64
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.models import bottleneck, crepe  # noqa: F401
from shennong_tpu_torch.ops import viterbi  # noqa: F401
from shennong_tpu_torch.processor import (
    BottleneckProcessor, CrepePitchPostProcessor, CrepePitchProcessor)
audio = Audio.load({wav!r})
for decode in ('host', 'device'):
    pitch = CrepePitchProcessor(
        model_capacity='tiny', decode=decode).process_all(
            Utterances([('a', {wav!r})]), device='cpu')['a']
    assert pitch.shape == (148, 2), pitch.shape
post = CrepePitchPostProcessor().process(pitch, device='cpu')
assert post.shape == (148, 3) and np.isfinite(post.data).all()
import torch
frames = bottleneck.frame_signal(torch.as_tensor(
    audio.resample(8000).data, dtype=torch.float32), 200, 80)
fbank = bottleneck.fbank_htk(
    frames, torch.ones(200), torch.as_tensor(bottleneck.mel_filterbank_htk(
        200, 8000, 24, 64.0, 3800.0)), 256)
assert fbank.shape == (148, 24) and BottleneckProcessor().ndims == 80
from shennong_tpu_torch.alignment import Alignment
from shennong_tpu_torch.eval import abx, abx_bench  # noqa: F401
from shennong_tpu_torch.processor import FramedOneHotProcessor
alignment = Alignment.from_list([(0.0, 0.7, 'a'), (0.7, 1.48, 'b')])
assert FramedOneHotProcessor().process(alignment).shape == (146, 2)
segments = [data for _, data in abx.segments_from_alignment(
    out['a'], alignment)]
distances = abx.pairwise_distances(segments, device='cpu')
assert distances.shape == (2, 2) and distances[0, 1] > 0
sys.argv = ['speech-features-torch', 'config', 'bottleneck', '--cmvn']
main()
sys.argv = ['speech-features-torch', 'config', 'mfcc', '--pitch', 'kaldi',
            '--cmvn', '--delta', '--vtln', 'simple', '-o', {config!r}]
main()
loaded = [name for name, module in sys.modules.items()
          if module is not None and name.split('.')[0] in {BLOCKED!r}]
assert not loaded, loaded
print('ok')
'''
    proc = subprocess.run(
        [sys.executable, '-c', script], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith('ok')
    assert 'bottleneck:' in proc.stdout
    with open(config) as stream:
        text = stream.read()
    assert 'mfcc:' in text and 'pitch:' in text and 'delta:' in text
    assert 'vtln:' in text and 'ubm:' in text


#: refuses the blocked packages' imports in a child process (scipy
#: probes sys.modules for jax, so they stay out of it rather than
#: mapped to None)
BLOCKER = f'''
import sys


class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {BLOCKED!r}:
            raise ImportError(f'{{name}} is blocked')


sys.meta_path.insert(0, Blocked())
'''


def test_examples_and_docs_run_with_the_jax_package_blocked(tmp_path):
    wav = str(tmp_path / 'a.wav')
    t = np.arange(24000) / 16000
    scipy.io.wavfile.write(
        wav, 16000, (np.sin(2 * np.pi * 140 * t) * 9000).astype(np.int16))
    script = BLOCKER + f'''
import glob, importlib.util, os
import numpy as np
modules = {{}}
for path in sorted(glob.glob(os.path.join('examples', 'torch', '*.py'))):
    name = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location('example_' + name, path)
    modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(modules[name])
assert len(modules) == 14, sorted(modules)  # 13 scripts and their helpers
report = modules['serve_throughput'].serve(
    batch=1, seconds=0.5, windows=1, iterations=1, device='cpu')
assert report['features'].shape == (1, 48, 42)
from shennong_tpu_torch import Utterances
out = modules['extract_corpus'].extract(
    Utterances([('a', {wav!r}, 's')]), {str(tmp_path / 'out.npz')!r},
    pitch=True, cmvn=True, delta=True, device='cpu')
assert out['features']['a'].shape == (148, 42)
spec = importlib.util.spec_from_file_location(
    'site', os.path.join('doc', 'torch', 'gen_docs.py'))
site = importlib.util.module_from_spec(spec)
spec.loader.exec_module(site)
assert site.build({str(tmp_path / 'html')!r}) > 60
loaded = [name for name, module in sys.modules.items()
          if module is not None and name.split('.')[0] in {BLOCKED!r}]
assert not loaded, loaded
print('ok')
'''
    proc = subprocess.run(
        [sys.executable, '-c', script], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith('ok')


def _collection(features_cls, collection_cls):
    rng = np.random.RandomState(42)
    collection = collection_cls()
    collection['utt_a'] = features_cls(
        rng.rand(12, 4), np.arange(12, dtype=float),
        properties={'mfcc': {'num_ceps': 13, 'dither': 0.0},
                    'pipeline': [{'name': 'mfcc', 'columns': [0, 3]}]})
    collection['utt_b'] = features_cls(
        rng.rand(7, 4).astype(np.float32),
        np.stack([np.arange(7.0), np.arange(7.0) + 0.02], axis=1),
        properties={'pitch': {'min_f0': 50.0},
                    'pipeline': [{'name': 'pitch', 'columns': [0, 3]}]})
    return collection


#: the formats that keep dtypes and properties exactly (``.mat`` keeps
#: values, not dtypes or the layout of properties)
EXACT = ('.npz', '.pkl', '.h5f', '.ark', '')


@pytest.mark.parametrize('ext', ['.npz', '.pkl', '.mat', '.ark', '.h5f', ''])
@pytest.mark.parametrize('direction', ['port to jax', 'jax to port'])
def test_serializers_interchange(tmp_path, ext, direction):
    if ext == '.h5f':
        pytest.importorskip('h5py')
    if direction == 'port to jax':
        written = _collection(Features, FeaturesCollection)
        reader, same_reader = JFeaturesCollection, FeaturesCollection
    else:
        written = _collection(JFeatures, JFeaturesCollection)
        reader, same_reader = FeaturesCollection, JFeaturesCollection
    path = str(tmp_path / ('feats' + ext))
    written.save(path)
    loaded = reader.load(path)
    assert sorted(loaded.keys()) == sorted(written.keys())
    for name, features in written.items():
        theirs = loaded[name]
        if ext in EXACT:
            assert theirs.dtype == features.dtype, name
            assert np.array_equal(theirs.data, features.data), name
            assert np.array_equal(theirs.times, features.times), name
            assert dict_equal(theirs.properties, features.properties), name
        else:
            assert np.allclose(theirs.data, features.data, atol=1e-6)
            assert np.allclose(theirs.times, features.times)
    if ext not in EXACT:
        # the writer's own package reads its properties back the same way
        mine = same_reader.load(path)
        for name in written:
            assert dict_equal(copy.deepcopy(loaded[name].properties),
                              copy.deepcopy(mine[name].properties)), name
