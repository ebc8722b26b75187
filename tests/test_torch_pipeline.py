"""The port's processors and pipeline against the JAX package.

Same configurations and inputs through ``shennong_tpu`` and
``shennong_tpu_torch`` on the CPU. With every random source at 0 (the
MFCC dither, the pitch-post noise and the energy VAD's dither) the
whole slice agrees at max-abs 1e-3, the contract of
tests/test_real_audio.py.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from shennong_tpu import pipeline as jpipeline
from shennong_tpu.processor import energy as jenergy
from shennong_tpu.utterances import Utterances as JUtterances
from shennong_tpu_torch import pipeline
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.parallel import executor as executor_module
from shennong_tpu_torch.pipeline_manager import PipelineManager
from shennong_tpu_torch.processor import energy
from shennong_tpu_torch.processor.energy import EnergyProcessor
from shennong_tpu_torch.processor.mfcc import MfccProcessor
from shennong_tpu_torch.processor.pitch_kaldi import (
    KaldiPitchPostProcessor, KaldiPitchProcessor)
from shennong_tpu_torch.utils import dict_equal
from shennong_tpu_torch.utterances import Utterances

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_WAV = os.path.join(REPO, 'tests', 'data', 'test.wav')


def speech_like(nsamples, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(nsamples) / 16000
    f0 = 100 + 60 * rng.rand() + 25 * np.sin(2 * np.pi * 0.6 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    voiced = sum((0.6 ** k) * np.sin((k + 1) * phase) for k in range(6))
    envelope = (0.5 * (1 + np.sin(2 * np.pi * 2.7 * t))) ** 2
    envelope[:800] = 0
    signal = voiced * envelope + rng.randn(nsamples) * 0.02
    return (signal / np.abs(signal).max() * 20000).astype(np.int16)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """4 utterances of 2 speakers, the real test.wav among them."""
    path = tmp_path_factory.mktemp('corpus')
    entries = [('real', REAL_WAV, 'spk1')]
    for index, nsamples in enumerate([30000, 41000, 25500]):
        wav = str(path / f'u{index}.wav')
        scipy.io.wavfile.write(wav, 16000, speech_like(nsamples, index))
        entries.append((f'u{index}', wav, f'spk{1 + index % 2}'))
    return entries


@pytest.fixture
def no_energy_dither(monkeypatch):
    """The energy VAD's default dither of 1.0 set to 0 in both
    packages (the pipeline config has no knob for it)."""
    for cls in (jenergy.EnergyProcessor, energy.EnergyProcessor):
        defaults = list(cls.__init__.__defaults__)
        defaults[3] = 0.0  # sample_rate, frame_shift, frame_length, dither
        monkeypatch.setattr(cls.__init__, '__defaults__', tuple(defaults))
    assert energy.EnergyProcessor().dither == 0


def deterministic_config():
    config = pipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
    config['mfcc']['dither'] = 0
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    return config


# ---------------------------------------------------------------- config

@pytest.mark.parametrize('pitch,cmvn,delta', [
    ('kaldi', True, True), (False, False, False), ('kaldi', False, True),
    (False, True, False)])
def test_default_config_parity(pitch, cmvn, delta):
    kwargs = dict(with_pitch=pitch, with_cmvn=cmvn, with_delta=delta)
    assert dict_equal(
        pipeline.get_default_config('mfcc', **kwargs),
        jpipeline.get_default_config('mfcc', **kwargs))
    assert (pipeline.get_default_config('mfcc', to_yaml=True, **kwargs)
            == jpipeline.get_default_config('mfcc', to_yaml=True, **kwargs))


def test_config_roundtrip_yaml():
    text = pipeline.get_default_config(
        'mfcc', to_yaml=True, with_pitch='kaldi', with_cmvn=True,
        with_delta=True)
    assert dict_equal(
        pipeline.init_config(text),
        pipeline.get_default_config(
            'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True))


@pytest.mark.parametrize('features,pitch', [
    ('bottleneck', False), ('plp', 'crepe'), ('mfcc', 'crepe')])
def test_not_ported_raises(features, pitch):
    """The configurations that raised NotImplementedError before CREPE
    and bottleneck were ported: they build now, equal to the JAX
    package's, and nothing raises."""
    assert pipeline.get_default_config(features, with_pitch=pitch) == \
        jpipeline.get_default_config(features, with_pitch=pitch)


def test_manager_resolves_port_classes():
    for name in ('spectrogram', 'filterbank', 'mfcc', 'plp', 'energy',
                 'kaldi_pitch', 'kaldi_pitch_post', 'cmvn',
                 'sliding_window_cmvn', 'delta', 'vad', 'bottleneck',
                 'crepe_pitch', 'crepe_pitch_post', 'ubm', 'vtln'):
        cls = PipelineManager.get_processor_class(name)
        assert cls.__module__.startswith('shennong_tpu_torch.'), name
    with pytest.raises(ValueError):
        PipelineManager.get_processor_class('nope')


# ------------------------------------------------------------ processors

def test_processors_golden():
    """The golden regression lock of tests/test_real_audio.py, on the
    port (CPU)."""
    audio = Audio.load(REAL_WAV)
    golden = np.load(os.path.join(REPO, 'tests', 'data', 'golden_real.npz'))
    pitch = KaldiPitchProcessor().process(audio, device='cpu')
    outputs = {
        'mfcc': MfccProcessor(dither=0).process(audio, device='cpu'),
        'energy': EnergyProcessor(dither=0).process(audio, device='cpu'),
        'pitch': pitch,
        'pitch_post': KaldiPitchPostProcessor(
            delta_pitch_noise_stddev=0).process(pitch, device='cpu'),
    }
    for name, features in outputs.items():
        assert features.shape == golden[name].shape, name
        assert np.abs(features.data - golden[name]).max() < 1e-3, name


def test_processor_dither_is_seeded():
    audio = Audio.load(REAL_WAV)
    proc = MfccProcessor()
    first, again, other = (
        proc.process(audio, device='cpu',
                     generator=torch.Generator().manual_seed(seed)).data
        for seed in (3, 3, 4))
    assert np.array_equal(first, again)
    assert not np.array_equal(first, other)


# ----------------------------------------------------------------- slice

def test_slice_matches_reference(corpus, no_energy_dither):
    config = deterministic_config()
    ref = jpipeline.extract_features(
        copy.deepcopy(config), JUtterances(corpus))
    ours = pipeline.extract_features(
        copy.deepcopy(config), Utterances(corpus), device='cpu')
    assert list(ours.keys()) == list(ref.keys())
    for name in ref:
        assert ours[name].shape == ref[name].shape, name
        assert ours[name].shape[1] == 42
        assert np.abs(ours[name].data - ref[name].data).max() < 1e-3, name
        assert np.array_equal(ours[name].times, ref[name].times)
        props, ref_props = (copy.deepcopy(f.properties)
                            for f in (ours[name], ref[name]))
        assert np.allclose(props['cmvn'].pop('stats'),
                           ref_props['cmvn'].pop('stats'), rtol=1e-5)
        assert dict_equal(props, ref_props), name


def test_slice_seeded_generator(corpus):
    config = pipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
    utterances = Utterances(corpus[:2])
    first, again, other = (
        pipeline.extract_features(
            copy.deepcopy(config), utterances, device='cpu',
            generator=torch.Generator().manual_seed(seed))
        for seed in (11, 11, 12))
    for name in first:
        assert np.array_equal(first[name].data, again[name].data)
        assert not np.array_equal(first[name].data, other[name].data)


def test_executor_collects(corpus, no_energy_dither):
    config = deterministic_config()
    manager = PipelineManager(config, Utterances(corpus))
    first = Utterances(corpus)[corpus[0][0]]
    executor = executor_module.FusedPipelineExecutor(
        manager.make('features', first),
        energy_proc=manager.make('energy', first),
        vad_proc=manager.make('vad'),
        pitch_proc=manager.make('pitch', first),
        pitch_post=manager.make('pitch_post'),
        device='cpu', batch_size=3)
    features, vads, pitches = executor.run(Utterances(corpus))
    assert sorted(features) == sorted(name for name, _, _ in corpus)
    for name in features:
        assert features[name].shape[1] == 13
        assert vads[name].dtype == np.uint8
        assert vads[name].shape == (features[name].nframes,)
        assert pitches[name].shape[1] == 3
        assert abs(pitches[name].nframes - features[name].nframes) <= 2


def test_pass_two_failure_stops_pass_one(corpus, monkeypatch):
    """A failure in the per-utterance hook stops the stream at once,
    instead of surfacing after every batch has run."""
    calls = []
    real = executor_module.pass_one_program

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(executor_module, 'pass_one_program', counting)
    proc = MfccProcessor(dither=0)
    executor = executor_module.FusedPipelineExecutor(
        proc, device='cpu', batch_size=1, depth=1)

    def fail(*_):
        raise RuntimeError('pass 2 failed')

    with pytest.raises(RuntimeError, match='pass 2 failed'):
        executor.run(Utterances(corpus), on_utterance=fail)
    assert len(calls) == 2  # batch 1 drained and failed after batch 2

    monkeypatch.setattr(
        pipeline, '_pass_two',
        lambda *_: (_ for _ in ()).throw(RuntimeError('pass 2 failed')))
    with pytest.raises(RuntimeError, match='pass 2 failed'):
        pipeline.extract_features(
            deterministic_config(), Utterances(corpus), device='cpu')


def test_port_imports_no_jax(tmp_path):
    """The port runs without ever importing jax."""
    wav = str(tmp_path / 'a.wav')
    scipy.io.wavfile.write(wav, 16000, speech_like(20000, 0))
    script = f'''
import sys
from shennong_tpu_torch import Utterances, pipeline
config = pipeline.get_default_config(
    'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
out = pipeline.extract_features(
    config, Utterances([('a', {wav!r}, 's')]), device='cpu')
assert out['a'].shape == (123, 42), out['a'].shape
assert 'jax' not in sys.modules, 'jax was imported'
print('ok')
'''
    proc = subprocess.run(
        [sys.executable, '-c', script], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


# ------------------------------------------------------ overlapped pass 2

def one_batch_each(monkeypatch):
    """The fused executor at one utterance a batch, one in flight."""
    defaults = dict(executor_module.FusedPipelineExecutor.__init__
                    .__kwdefaults__)
    defaults.update(batch_size=1, depth=1)
    monkeypatch.setattr(executor_module.FusedPipelineExecutor.__init__,
                        '__kwdefaults__', defaults)


def by_utterance_config():
    config = deterministic_config()
    config['cmvn']['by_speaker'] = False  # each utterance a CMVN group
    return config


def test_pass_two_overlaps_pass_one(corpus, monkeypatch, no_energy_dither):
    """Pass 2 of the first CMVN group runs on the thread ``pass-two``
    before pass 1 dispatches its last program. The last dispatch waits
    (30 s at most) for that pass 2 to start: a pass 2 that ran after
    pass 1, or on pass 1's thread, fails the test."""
    import threading

    one_batch_each(monkeypatch)
    events, started = [], threading.Event()
    real_program = executor_module.pass_one_program
    real_pass_two = pipeline._pass_two

    def program(*args, **kwargs):
        if len([e for e in events if e[0] == 'dispatch']) == len(corpus) - 1:
            started.wait(timeout=30)
        events.append(('dispatch', threading.current_thread().name))
        return real_program(*args, **kwargs)

    def pass_two(manager, triplets, log):
        events.append(('pass2', threading.current_thread().name))
        started.set()
        return real_pass_two(manager, triplets, log)

    monkeypatch.setattr(executor_module, 'pass_one_program', program)
    monkeypatch.setattr(pipeline, '_pass_two', pass_two)
    out = pipeline.extract_features(
        by_utterance_config(), Utterances(corpus), device='cpu')
    assert sorted(out) == sorted(name for name, _, _ in corpus)
    dispatches = [i for i, e in enumerate(events) if e[0] == 'dispatch']
    passes = [i for i, e in enumerate(events) if e[0] == 'pass2']
    assert len(dispatches) == len(passes) == len(corpus)
    assert passes[0] < dispatches[-1], events
    assert {events[i][1] for i in passes} == {'pass-two'}
    assert 'pass-two' not in {events[i][1] for i in dispatches}


def test_pass_two_failure_on_the_worker_stops_pass_one(corpus, monkeypatch):
    """A pass-2 failure on the worker stops pass 1 at the next drained
    utterance, before the last batch; the worker is joined."""
    import threading

    one_batch_each(monkeypatch)
    calls, failed = [], threading.Event()
    real_program = executor_module.pass_one_program

    def program(*args, **kwargs):
        if len(calls) >= 2:
            failed.wait(timeout=30)  # the failure has happened by now
        calls.append(1)
        return real_program(*args, **kwargs)

    def fail(*_):
        failed.set()
        raise RuntimeError('pass 2 failed on the worker')

    monkeypatch.setattr(executor_module, 'pass_one_program', program)
    monkeypatch.setattr(pipeline, '_pass_two', fail)
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match='failed on the worker'):
        pipeline.extract_features(
            by_utterance_config(), Utterances(corpus), device='cpu')
    assert len(calls) < len(corpus)
    assert 'pass-two' not in {t.name for t in threading.enumerate()} - before


def test_overlapped_pass_two_equals_sequential(corpus, no_energy_dither):
    """The overlapped flow gives the bits of pass 1 over every
    utterance followed by one pass 2 over all of them."""
    config = deterministic_config()
    utterances = Utterances(corpus)
    out = pipeline.extract_features(
        copy.deepcopy(config), utterances, device='cpu')
    manager = PipelineManager(
        pipeline.init_config(copy.deepcopy(config)), utterances,
        device='cpu')
    triplets = []
    pipeline._pass_one(manager, list(utterances), 'cpu',
                       torch.Generator().manual_seed(0),
                       pipeline.get_logger('pipeline', 'warning'), None,
                       triplets.extend, 1)
    sequential = pipeline._pass_two(
        manager, triplets, pipeline.get_logger('pipeline', 'warning'))
    assert sorted(sequential) == sorted(out)
    for name in out:
        np.testing.assert_array_equal(out[name].data, sequential[name].data)
        assert dict_equal(out[name].properties, sequential[name].properties)


@pytest.mark.parametrize('njobs', [1, 4])
def test_python_decode_njobs(corpus, monkeypatch, no_energy_dither, njobs):
    """Audio the native loader does not read decodes on ``njobs``
    threads, to the bits of the native route."""
    from shennong_tpu_torch import native

    config = deterministic_config()
    utterances = Utterances(corpus)
    native_out = pipeline.extract_features(
        copy.deepcopy(config), utterances, device='cpu')
    monkeypatch.setattr(native, 'available', lambda: False)
    out = pipeline.extract_features(
        copy.deepcopy(config), utterances, njobs=njobs, device='cpu')
    for name in native_out:
        np.testing.assert_array_equal(out[name].data, native_out[name].data)
    with pytest.raises(ValueError, match='strictly positive'):
        pipeline.extract_features(
            copy.deepcopy(config), utterances, njobs=0, device='cpu')


# ----------------------------------------------------------- fetch dtype

#: port against JAX package after a reduced-precision fetch, relative to
#: max(|value|, 1) as tests/test_pipeline.py:108-111 scales it: float16
#: at that test's 2e-3; bfloat16 at 2e-3 times the ratio of the two
#: formats' unit roundoffs (2**-8 / 2**-11 = 8), since one bfloat16 ulp
#: is already 3.9e-3 of a value in [1, 2) and float32 values 1e-3 apart
#: can round to neighbouring bfloat16 values
FETCH_TOL = {'float16': 2e-3, 'bfloat16': 8 * 2e-3}


@pytest.mark.parametrize('fetch_dtype', ['float16', 'bfloat16'])
def test_fetch_dtype_matches_reference(corpus, no_energy_dither, fetch_dtype):
    """A half-precision fetch gives the JAX package's values on the same
    utterances, scaled as tests/test_pipeline.py scales them: the cast
    happens at the same point (before pass 2) in both packages."""
    config = deterministic_config()
    ref = jpipeline.extract_features(
        copy.deepcopy(config), JUtterances(corpus), fetch_dtype=fetch_dtype)
    ours = pipeline.extract_features(
        copy.deepcopy(config), Utterances(corpus), device='cpu',
        fetch_dtype=fetch_dtype)
    exact = pipeline.extract_features(
        copy.deepcopy(config), Utterances(corpus), device='cpu')
    assert list(ours.keys()) == list(ref.keys())
    for name in ref:
        assert ours[name].dtype == ref[name].dtype == np.float32
        assert ours[name].shape == ref[name].shape, name
        scale = np.maximum(np.abs(ref[name].data), 1.0)
        err = np.abs(ours[name].data - ref[name].data) / scale
        assert err.max() < FETCH_TOL[fetch_dtype], (name, err.max())
        # the reduced precision is there: not the float32 bits
        assert not np.array_equal(ours[name].data, exact[name].data)


def test_fetch_dtype_float32_is_the_programs_bits(corpus, monkeypatch,
                                                  no_energy_dither):
    """The default payload hands over the very bits of the pass-1
    program's outputs (the earlier fetch copied each output alone), and
    None means 'float32'."""
    programs = []
    real = executor_module.pass_one_program

    def recording(*args, **kwargs):
        programs.append(real(*args, **kwargs))
        return programs[-1]

    monkeypatch.setattr(executor_module, 'pass_one_program', recording)
    config = deterministic_config()
    manager = PipelineManager(config, Utterances(corpus))
    first = Utterances(corpus)[corpus[0][0]]
    results = []
    for fetch_dtype in (None, 'float32'):
        programs.clear()
        executor = executor_module.FusedPipelineExecutor(
            manager.make('features', first),
            energy_proc=manager.make('energy', first),
            vad_proc=manager.make('vad'),
            pitch_proc=manager.make('pitch', first),
            pitch_post=manager.make('pitch_post'),
            device='cpu', batch_size=4, fetch_dtype=fetch_dtype)
        assert executor.fetch_dtype == 'float32'
        results.append(executor.run(Utterances(corpus)))
    (out,) = programs
    features, vads, pitches = results[0]
    # one batch, rows in the stream's length order
    order = sorted(corpus, key=lambda e: Audio.scan(e[1]).nsamples)
    for row, (name, _, _) in enumerate(order):
        nframes = features[name].nframes
        np.testing.assert_array_equal(
            features[name].data, out['feats'][row, :nframes].numpy())
        np.testing.assert_array_equal(
            vads[name], out['vad'][row, :nframes].numpy())
        np.testing.assert_array_equal(
            pitches[name].data,
            out['pitch'][row, :pitches[name].nframes].numpy())
        for collection, other in zip(results[0], results[1]):
            np.testing.assert_array_equal(
                getattr(collection[name], 'data', collection[name]),
                getattr(other[name], 'data', other[name]))


@pytest.mark.parametrize('fetch_dtype', ['int8', 'float64', 'half'])
def test_fetch_dtype_unknown_raises(corpus, fetch_dtype):
    with pytest.raises(ValueError, match='fetch_dtype'):
        pipeline.extract_features(
            deterministic_config(), Utterances(corpus), device='cpu',
            fetch_dtype=fetch_dtype)
    with pytest.raises(ValueError, match='fetch_dtype'):
        executor_module.FusedPipelineExecutor(
            MfccProcessor(), device='cpu', fetch_dtype=fetch_dtype)


def test_fetch_dtype_halves_bytes_down(corpus, no_energy_dither):
    """``bytes_down`` counts the payload: the float parts at half their
    bytes, the uint8 VAD unchanged."""
    from shennong_tpu_torch.parallel.profiler import counters

    down = {}
    for fetch_dtype in ('float32', 'float16', 'bfloat16'):
        counters.reset()
        pipeline.extract_features(
            deterministic_config(), Utterances(corpus), device='cpu',
            fetch_dtype=fetch_dtype)
        down[fetch_dtype] = counters.snapshot()['bytes_down']
    # one batch of 4 rows: feats [4, F, 13] and pitch [4, F, 3] floats
    # (the same frame grid), the VAD [4, F] uint8
    rows = len(corpus)
    vad = down['float32'] - 2 * (down['float32'] - down['float16'])
    assert down['float16'] == down['bfloat16']
    assert vad > 0 and vad % rows == 0
    floats = down['float32'] - vad
    assert down['float16'] == vad + floats // 2
    assert floats == 4 * vad * (13 + 3)


def test_pack_payload_round_trips():
    """Every part comes back from the payload in the layout's order:
    the floats at the fetch precision, the VAD's bytes untouched, an
    odd VAD putting the pitch off its alignment."""
    from shennong_tpu_torch.parallel.fused import pack_payload

    rng = np.random.RandomState(0)
    out = {
        'feats': torch.from_numpy(rng.randn(3, 5, 13).astype(np.float32)),
        'vad': torch.from_numpy(rng.randint(0, 2, (3, 5)).astype(np.uint8)),
        'pitch': torch.from_numpy(rng.randn(3, 5, 3).astype(np.float32))}
    for fetch_dtype, dtype in (('float32', torch.float32),
                               ('float16', torch.float16),
                               ('bfloat16', torch.bfloat16)):
        layout = executor_module._payload_layout(out, fetch_dtype)
        assert [name for name, _, _ in layout] == ['feats', 'vad', 'pitch']
        payload = pack_payload(
            [out[name] for name, _, _ in layout], dtype=fetch_dtype)
        assert payload.dtype == torch.uint8 and payload.dim() == 1
        assert payload.numel() == (
            (3 * 5 * 13 + 3 * 5 * 3) * dtype.itemsize + 3 * 5)
        back = executor_module._unpack_payload(payload, layout)
        assert list(back) == ['feats', 'vad', 'pitch']
        np.testing.assert_array_equal(back['vad'], out['vad'].numpy())
        for name in ('feats', 'pitch'):
            assert back[name].dtype == np.float32
            np.testing.assert_array_equal(
                back[name], out[name].to(dtype).float().numpy())
    # without VAD or pitch the layout has the features alone
    layout = executor_module._payload_layout(
        {'feats': out['feats']}, 'float32')
    assert [name for name, _, _ in layout] == ['feats']
