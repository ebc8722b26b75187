"""The port's public API against the JAX package's.

1. An ``ast`` walk of every module of ``shennong_tpu/``: each public
   module-level function and class, each public method or property of
   those classes, and what a package's ``__init__`` exports (its
   imports and its lazy ``_REGISTRY``) must exist at the same place in
   ``shennong_tpu_torch/``, unless :data:`EXEMPT` lists it with its
   reason and the ROADMAP item that removes it. An exemption that no
   longer hides a missing name fails too.
   Every public function or method of ``shennong_tpu/`` that takes
   ``njobs`` has a counterpart that takes it with the same default.
2. The names ported with the walk behave as the JAX package's on the
   same inputs: the root's version helpers, ``Audio.channel``,
   ``precision`` and ``save``, ``Features.is_close``,
   ``FeaturesCollection.is_close`` and ``partition``,
   ``Utterances.fit_to_duration``, ``BaseProcessor.set_logger``, the
   HTK serializers, ``utils.list2array``, the ``PipelineManager``
   getters, ``ops.framing.first_sample_of_frame``,
   ``ops.postops.pad_frame_axis``,
   ``parallel.fused.mfcc_pitch_pipeline`` (1e-3, the pipelines'
   tolerance) and the native WAV scan and PCM16 loader the port calls
   (equal).
"""

import ast
import glob
import importlib
import logging
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

import shennong_tpu
import shennong_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MESH = (
    "device meshes: one JAX process drives N devices over a mesh, while "
    "the port runs one process per device and its data axis is the "
    "torch.distributed process group (parallel.distributed); the mesh "
    "paths of the executor, CREPE and bottleneck have no counterpart for "
    "the same reason; no item")

#: names of shennong_tpu without a counterpart in the port: 'module' or
#: 'module:Name[.member]' -> why, and the ROADMAP item that ports it
EXEMPT = {
    'ops.pallas_viterbi': (
        'the Pallas kernels are CUDA kernels: ops/cuda_viterbi.py '
        '(viterbi_forward, viterbi_backtrace, viterbi_lags); no item'),
    'processor.ubm:DiagGmm.as_jax': (
        'DiagGmm.as_tensors(device) hands the model to the device; no '
        'item'),
    'models.crepe:forward': (
        'the CNN is the nn.Module models.crepe.Crepe, whose forward is '
        'this function; no item'),
    'parallel.mesh': _MESH,
    'parallel:data_mesh': _MESH,
    'parallel:get_default_mesh': _MESH,
    'parallel:set_default_mesh': _MESH,
    'parallel.fused:make_gmm_training_step': (
        'a sharded MFCC-and-EM step that nothing in the JAX package calls '
        'and no test holds; no item'),
    'utils:enable_compilation_cache': (
        "JAX's persistent compile cache; eager PyTorch compiles nothing "
        'per shape; no item'),
    'ops.spectral:power_spectrum_matmul': (
        "the power spectrum as DFT matmuls, the TPU's MXU branch of "
        'power_spectrum; the port takes torch.fft.rfft, the reference\'s '
        'branch off the TPU; no item'),
    'native:wav_scan': (
        'the port scans WAV headers with native.wav_scan2, which adds '
        'the format and bit depth; no item'),
    'native:load_wav_batch': (
        'the float32 WAV loader: the port loads PCM16 rows with '
        'native.load_wav_batch_i16 and reads other WAVs with scipy; no '
        'item'),
}


def jax_modules():
    """(path, dotted name relative to the package) of every module of
    shennong_tpu."""
    root = os.path.join(REPO, 'shennong_tpu')
    for path in sorted(glob.glob(os.path.join(root, '**', '*.py'),
                                 recursive=True)):
        rel = os.path.relpath(path, root)[:-3].replace(os.sep, '.')
        if rel == '__init__':
            rel = ''
        elif rel.endswith('.__init__'):
            rel = rel[:-len('.__init__')]
        yield path, rel


def public_names(path):
    """Public module-level functions and classes, the public methods
    and properties of those classes, and a package's exports."""
    with open(path) as stream:
        tree = ast.parse(stream.read(), path)
    names = []
    package = os.path.basename(path) == '__init__.py'
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name.startswith('_'):
                continue
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f'{node.name}.{sub.name}' for sub in node.body
                          if isinstance(sub, ast.FunctionDef)
                          and not sub.name.startswith('_')]
        elif package and isinstance(node, ast.ImportFrom):
            names += [alias.asname or alias.name for alias in node.names
                      if not (alias.asname or alias.name).startswith('_')]
        elif (package and isinstance(node, ast.Assign)
              and any(getattr(t, 'id', None) == '_REGISTRY'
                      for t in node.targets)):
            names += [key.value for key in node.value.keys]
    return names


def missing_names():
    """'module' or 'module:name' of every JAX name the port lacks."""
    missing = []
    for path, rel in jax_modules():
        try:
            module = importlib.import_module(
                'shennong_tpu_torch' + (f'.{rel}' if rel else ''))
        except ModuleNotFoundError:
            missing.append(rel)
            continue
        for name in public_names(path):
            target = module
            for part in name.split('.'):
                target = getattr(target, part, None)
                if target is None:
                    missing.append(f'{rel}:{name}')
                    break
    return missing


def test_every_public_name_has_a_counterpart():
    missing = missing_names()
    unexplained = sorted(set(missing) - set(EXEMPT))
    assert not unexplained, (
        'the port lacks these public names of shennong_tpu:\n'
        + '\n'.join(unexplained))
    stale = sorted(set(EXEMPT) - set(missing))
    assert not stale, f'exempted but present in the port: {stale}'


def njobs_functions():
    """(dotted module, 'name' or 'Class.method', njobs default source)
    of every public function or method of shennong_tpu whose signature
    has ``njobs``."""
    found = []
    for path, rel in jax_modules():
        with open(path) as stream:
            tree = ast.parse(stream.read(), path)
        scopes = [('', node) for node in tree.body]
        scopes += [(f'{node.name}.', sub) for node in tree.body
                   if isinstance(node, ast.ClassDef)
                   and not node.name.startswith('_')
                   for sub in node.body]
        for prefix, node in scopes:
            if (not isinstance(node, ast.FunctionDef)
                    or node.name.startswith('_')):
                continue
            args = node.args
            positional = args.posonlyargs + args.args
            defaults = dict(zip(
                [a.arg for a in positional[len(positional)
                                           - len(args.defaults):]],
                args.defaults))
            defaults.update(
                (a.arg, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
                if d is not None)
            names = [a.arg for a in positional + args.kwonlyargs]
            if 'njobs' in names:
                found.append((rel, prefix + node.name,
                              ast.literal_eval(defaults['njobs'])))
    return found


def test_njobs_parameters_have_counterparts():
    """``njobs`` bounds host decode concurrency in both packages: every
    public callable of the JAX package that takes it has a counterpart
    that takes it, with the same default."""
    import inspect

    found = njobs_functions()
    assert len(found) >= 30
    wrong = []
    for rel, name, default in found:
        target = importlib.import_module(
            'shennong_tpu_torch' + (f'.{rel}' if rel else ''))
        for part in name.split('.'):
            target = getattr(target, part)
        parameter = inspect.signature(target).parameters.get('njobs')
        if parameter is None or parameter.default != default:
            wrong.append(f'{rel}:{name} (JAX default {default!r}, port '
                         f'{None if parameter is None else parameter})')
    assert not wrong, '\n'.join(wrong)


def test_walk_sees_the_api():
    """The walk reads classes, methods, properties and lazy registries
    (a walk that found nothing would pass the test above)."""
    names = dict(jax_modules())
    by_module = {rel: public_names(path) for path, rel in jax_modules()}
    assert len(names) > 50
    assert 'Audio.save' in by_module['audio']
    assert 'Features.is_close' in by_module['features']
    assert 'OneHotProcessor' in by_module['processor']
    assert 'abx_error' in by_module['eval']
    assert 'PipelineManager.utterances' in by_module['pipeline_manager']


def test_pallas_viterbi_counterparts():
    from shennong_tpu_torch.ops import cuda_viterbi

    for name in ('viterbi_forward', 'viterbi_backtrace', 'viterbi_lags'):
        assert callable(getattr(cuda_viterbi, name))


# ------------------------------------------------------------ host layer

def test_root_helpers():
    assert shennong_tpu_torch.url() == shennong_tpu.url()
    assert shennong_tpu_torch.version() == shennong_tpu_torch.__version__
    assert shennong_tpu_torch.version(tuple) == tuple(
        shennong_tpu_torch.__version__.split('.'))
    assert shennong_tpu_torch.version('tuple', full=True) == \
        shennong_tpu_torch.version(tuple)
    assert shennong_tpu_torch.version() in shennong_tpu_torch.version_long()
    with pytest.raises(ValueError) as ours:
        shennong_tpu_torch.version(type=int)
    with pytest.raises(ValueError) as theirs:
        shennong_tpu.version(type=int)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize('dtype', [np.int16, np.int32, np.float32])
def test_audio_channel_precision_save(tmp_path, dtype):
    from shennong_tpu.audio import Audio as JAudio
    from shennong_tpu_torch.audio import Audio

    scale = 0.1 if dtype == np.float32 else 1000
    data = (np.random.RandomState(0).randn(800, 2) * scale).astype(dtype)
    ours, theirs = Audio(data, 8000), JAudio(data, 8000)
    assert ours.precision == theirs.precision == 8 * data.itemsize
    for index in (0, 1):
        np.testing.assert_array_equal(
            ours.channel(index).data, theirs.channel(index).data)
    mono = ours.channel(0)
    assert mono.channel(0) is mono
    for audio in (ours, theirs):
        with pytest.raises(ValueError, match='not enough channels'):
            audio.channel(2)

    ours.save(str(tmp_path / 'ours.wav'))
    theirs.save(str(tmp_path / 'theirs.wav'))
    assert (tmp_path / 'ours.wav').read_bytes() == (
        tmp_path / 'theirs.wav').read_bytes()
    assert Audio.load(str(tmp_path / 'ours.wav')) == ours
    with pytest.raises(ValueError, match='already exists'):
        ours.save(str(tmp_path / 'ours.wav'))
    with pytest.raises(ValueError, match='without extension'):
        ours.save(str(tmp_path / 'noextension'))


def features_pair(seed, nframes=20, ndims=3):
    from shennong_tpu.features import Features as JFeatures
    from shennong_tpu_torch.features import Features

    rng = np.random.RandomState(seed)
    data = rng.randn(nframes, ndims)
    times = np.arange(nframes) * 0.01
    props = {'mfcc': {'num_ceps': ndims}}
    return (Features(data, times, props), JFeatures(data, times, props))


def test_features_is_close_and_partition():
    from shennong_tpu.features_collection import (
        FeaturesCollection as JCollection)
    from shennong_tpu_torch.features_collection import FeaturesCollection

    (a, ja), (b, jb) = features_pair(0), features_pair(1)
    near = a.copy()
    near._data = a.data + 1e-9
    jnear = ja.copy()
    jnear._data = ja.data + 1e-9
    for x, y, jx, jy in ((a, a, ja, ja), (a, near, ja, jnear),
                         (a, b, ja, jb)):
        assert x.is_close(y) == jx.is_close(jy)
        assert x.is_close(y, atol=10) == jx.is_close(jy, atol=10)
    assert a.is_close(near) and not a.is_close(b)

    ours = FeaturesCollection(u1=a, u2=b, u3=near)
    theirs = JCollection(u1=ja, u2=jb, u3=jnear)
    assert ours.is_close(FeaturesCollection(u1=a, u2=b, u3=a))
    assert not ours.is_close(FeaturesCollection(u1=a, u2=b))
    index = {'u1': 's1', 'u2': 's2', 'u3': 's1', 'extra': 's3'}
    parts, jparts = ours.partition(index), theirs.partition(index)
    assert {k: sorted(v) for k, v in parts.items()} == {
        k: sorted(v) for k, v in jparts.items()}
    assert all(isinstance(v, FeaturesCollection) for v in parts.values())
    with pytest.raises(ValueError) as error:
        ours.partition({'u1': 's1'})
    with pytest.raises(ValueError) as jerror:
        theirs.partition({'u1': 's1'})
    assert str(error.value) == str(jerror.value)


@pytest.mark.parametrize('duration,truncate', [
    (0.5, False), (1.2, False), (2.0, True), (0.05, False)])
def test_fit_to_duration(tmp_path, duration, truncate):
    from shennong_tpu.utterances import Utterances as JUtterances
    from shennong_tpu_torch.utterances import Utterances

    entries = []
    for index, seconds in enumerate((0.4, 0.7, 0.3, 0.9)):
        wav = str(tmp_path / f'u{index}.wav')
        scipy.io.wavfile.write(
            wav, 16000, np.zeros(int(seconds * 16000), np.int16))
        entries.append((f'u{index}', wav, f's{index % 2}'))

    def fitted(cls):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            try:
                out = cls(entries).fit_to_duration(duration, truncate)
            except ValueError as error:
                return str(error), []
        return ([(u.name, u.speaker, u.tstart, u.tstop) for u in out],
                [str(w.message) for w in caught])

    assert fitted(Utterances) == fitted(JUtterances)
    with pytest.raises(ValueError, match='positive'):
        Utterances(entries).fit_to_duration(0)


def test_set_logger():
    from shennong_tpu_torch.processor import MfccProcessor

    proc = MfccProcessor()
    proc.set_logger('error')
    assert proc.log.getEffectiveLevel() == logging.ERROR
    proc.set_logger('debug', formatter='%(message)s')
    assert proc.log.getEffectiveLevel() == logging.DEBUG


def test_htk_files_interchange(tmp_path):
    from shennong_tpu import serializers as jserializers
    from shennong_tpu_torch import serializers

    data = np.random.RandomState(0).randn(37, 5).astype(np.float32)
    serializers.write_htk(str(tmp_path / 'ours.fea'), data, 0.02)
    jserializers.write_htk(str(tmp_path / 'theirs.fea'), data, 0.02)
    assert (tmp_path / 'ours.fea').read_bytes() == (
        tmp_path / 'theirs.fea').read_bytes()
    back, period = serializers.read_htk(str(tmp_path / 'theirs.fea'))
    jback, jperiod = jserializers.read_htk(str(tmp_path / 'ours.fea'))
    np.testing.assert_array_equal(back, data)
    np.testing.assert_array_equal(back, jback)
    assert back.dtype == np.float32 and period == jperiod
    assert abs(period - 0.02) < 1e-12


def test_list2array():
    from shennong_tpu import utils as jutils
    from shennong_tpu_torch import utils

    value = {'a': [1, 2], 'b': {'c': [[0.5]], 'd': 'x'}, 'e': 3}
    ours, theirs = utils.list2array(value), jutils.list2array(value)
    assert utils.dict_equal(ours, theirs)
    assert isinstance(ours['b']['c'], np.ndarray)
    assert utils.list2array([1, 2]).tolist() == [1, 2]


def test_manager_getters(tmp_path):
    from shennong_tpu import pipeline as jpipeline
    from shennong_tpu.pipeline_manager import PipelineManager as JManager
    from shennong_tpu.utterances import Utterances as JUtterances
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.pipeline_manager import PipelineManager
    from shennong_tpu_torch.utils import dict_equal
    from shennong_tpu_torch.utterances import Utterances

    entries = []
    for index in range(2):
        wav = str(tmp_path / f'u{index}.wav')
        scipy.io.wavfile.write(wav, 16000, (np.random.RandomState(
            index).randn(8000) * 1000).astype(np.int16))
        entries.append((f'u{index}', wav, f's{index}'))
    kwargs = dict(with_pitch='kaldi', with_cmvn=True, with_delta=True,
                  with_vtln='simple')
    ours = PipelineManager(pipeline.get_default_config('mfcc', **kwargs),
                           Utterances(entries))
    theirs = JManager(jpipeline.get_default_config('mfcc', **kwargs),
                      JUtterances(entries))
    assert ours.utterances == Utterances(entries)
    utterance = ours.utterances['u0']
    jutterance = theirs.utterances['u0']
    for stage in ('features', 'energy', 'vad', 'cmvn', 'pitch',
                  'pitch_post', 'delta', 'vtln'):
        proc = getattr(ours, f'get_{stage}_processor')(utterance)
        jproc = getattr(theirs, f'get_{stage}_processor')(jutterance)
        assert type(proc).__name__ == type(jproc).__name__, stage
        assert dict_equal(proc.get_params(), jproc.get_params()), stage
        assert type(proc).__module__.startswith('shennong_tpu_torch.')


# ------------------------------------------------------------------- ops

@pytest.mark.parametrize('snip_edges', [True, False])
def test_first_sample_of_frame(snip_edges):
    from shennong_tpu.ops import framing as jframing
    from shennong_tpu_torch.ops import framing

    opts = framing.FrameOptions(snip_edges=snip_edges)
    jopts = jframing.FrameOptions(snip_edges=snip_edges)
    for frame in (0, 1, 7, 1000):
        assert framing.first_sample_of_frame(frame, opts) == \
            jframing.first_sample_of_frame(frame, jopts)


@pytest.mark.parametrize('nframes,minimum', [(1, 128), (129, 128), (7, 4)])
def test_pad_frame_axis(nframes, minimum):
    from shennong_tpu.ops import postops as jpostops
    from shennong_tpu_torch.ops import postops

    data = np.random.RandomState(nframes).randn(nframes, 3)
    for ours, theirs in zip(postops.pad_frame_axis(data, minimum),
                            jpostops.pad_frame_axis(data, minimum)):
        np.testing.assert_array_equal(ours, theirs)
        assert ours.dtype == theirs.dtype


def test_mfcc_pitch_pipeline():
    from shennong_tpu.ops import framing as jframing
    from shennong_tpu.ops import pitch as jpitch
    from shennong_tpu.ops import spectral as jspectral
    from shennong_tpu.parallel import fused as jfused
    from shennong_tpu_torch.ops import framing, mel, pitch, spectral
    from shennong_tpu_torch.parallel import fused

    # voiced, with a syllable-rate envelope: a signal of constant
    # energy leaves the energy column's variance at float32 rounding,
    # where the per-utterance variance normalization of either package
    # divides by noise
    rng = np.random.RandomState(0)
    lengths = np.array([16000, 11000], np.int32)
    signals = np.zeros((2, 16000), np.float32)
    t = np.arange(16000) / 16000
    for row, length in enumerate(lengths):
        envelope = (0.5 * (1 + np.sin(2 * np.pi * 2.7 * t[:length]))) ** 2
        signals[row, :length] = envelope * 8000 * np.sin(
            2 * np.pi * (120 + 40 * row) * t[:length]) + 300 * rng.randn(
                length)
    weights, _ = mel.mel_banks(23, 512, 16000.0, 20.0, 0.0, 100.0, -500.0,
                               1.0)
    opts = spectral.MfccOpts(frame=framing.FrameOptions(dither=0.0))
    jopts = jspectral.MfccOpts(frame=jframing.FrameOptions(dither=0.0))
    nframes_max = framing.num_frames(16000, opts.frame)
    pitch_frames = pitch.num_pitch_frames(16000, pitch.PitchOpts())
    ours, counts = fused.mfcc_pitch_pipeline(
        torch.from_numpy(signals), torch.from_numpy(lengths), weights, opts,
        pitch.PitchOpts(), pitch.ProcessPitchOpts(), nframes_max,
        pitch_frames, device='cpu')
    theirs, jcounts = jfused.mfcc_pitch_pipeline(
        jnp.asarray(signals), jnp.asarray(lengths), weights, jopts,
        jpitch.PitchOpts(), jpitch.ProcessPitchOpts(), nframes_max,
        pitch_frames)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert ours.shape == theirs.shape == (2, nframes_max, 42)
    for row, count in enumerate(np.asarray(jcounts)):
        gap = np.abs(ours[row, :count].numpy()
                     - np.asarray(theirs)[row, :count]).max()
        assert gap < 1e-3, (row, gap)


# ---------------------------------------------------------------- native

def test_native_wav_entry_points(tmp_path):
    from shennong_tpu import native as jnative
    from shennong_tpu_torch import native

    paths = []
    for index, nsamples in enumerate((1000, 2500)):
        path = str(tmp_path / f'u{index}.wav')
        scipy.io.wavfile.write(path, 16000, (np.random.RandomState(
            index).randn(nsamples) * 3000).astype(np.int16))
        paths.append(path)
    assert native.codec_available() == jnative.codec_available()
    if not native.available():
        assert native.wav_scan2(paths[0]) is None
        return
    for path in paths:
        assert native.wav_scan2(path) == jnative.wav_scan2(path)
    args = (paths, [0, 100], [3000, 2000], 2600)
    ours = native.load_wav_batch_i16(*args)
    theirs = jnative.load_wav_batch_i16(*args)
    for mine, ref in zip(ours, theirs):
        np.testing.assert_array_equal(mine, ref)
        assert mine.dtype == ref.dtype
    assert native.wav_scan2(str(tmp_path / 'missing.wav')) is None
