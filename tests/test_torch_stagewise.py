"""The port's stage-wise extraction path against the JAX package.

``BatchExecutor`` and the processors' ``process_all``, the
``SignalCache``, the collection post-processors, and
``extract_features`` on its three pass-1 paths (fused, stage-wise for
hour-scale utterances, per utterance for corpora that mix sample
rates) with precomputed warps. The same corpora, made with numpy from
a seed, go through ``shennong_tpu`` and ``shennong_tpu_torch`` on the
CPU with every random source at 0. Hour-scale utterances are stood in
for by a lowered ``AUTO_CHUNK_FRAMES`` on the features processor class
of both packages (pitch stays unchunked: its plain Viterbi is a Python
loop here). Tolerances (max-abs):

- ``BatchExecutor.process_all``: 1e-4, relative to the output's largest
  magnitude when it is over 1 (pitch: lags exact or proven ties, NCCF
  1e-4);
- VAD exact, deltas and pitch post-processing 1e-5;
- ``extract_features``: 1e-3 (the contract of tests/test_real_audio.py),
  the pitch columns as the lags allow;
- ``SignalCache``: a replay equals a plain sweep bit for bit.
"""

import copy
import os
import warnings

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from shennong_tpu import pipeline as jpipeline
from shennong_tpu.audio import Audio as JAudio
from shennong_tpu.features import Features as JFeatures
from shennong_tpu.features_collection import (
    FeaturesCollection as JFeaturesCollection)
from shennong_tpu.parallel.executor import BatchExecutor as JBatchExecutor
from shennong_tpu.postprocessor import delta as jdelta
from shennong_tpu.postprocessor import vad as jvad
from shennong_tpu.processor import energy as jenergy
from shennong_tpu.processor import filterbank as jfilterbank
from shennong_tpu.processor import mfcc as jmfcc
from shennong_tpu.processor import pitch_kaldi as jpitch
from shennong_tpu.processor import plp as jplp
from shennong_tpu.processor import spectrogram as jspectrogram
from shennong_tpu.utterances import Utterances as JUtterances
from shennong_tpu_torch import pipeline
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.parallel import executor as executor_module
from shennong_tpu_torch.parallel import stream
from shennong_tpu_torch.parallel.executor import BatchExecutor
from shennong_tpu_torch.postprocessor.delta import DeltaPostProcessor
from shennong_tpu_torch.postprocessor.vad import VadPostProcessor
from shennong_tpu_torch.processor import energy
from shennong_tpu_torch.processor.energy import EnergyProcessor
from shennong_tpu_torch.processor.filterbank import FilterbankProcessor
from shennong_tpu_torch.processor.mfcc import MfccProcessor
from shennong_tpu_torch.processor.pitch_kaldi import (
    KaldiPitchPostProcessor, KaldiPitchProcessor)
from shennong_tpu_torch.processor.plp import PlpProcessor
from shennong_tpu_torch.processor.spectrogram import SpectrogramProcessor
from shennong_tpu_torch.utterances import Utterances

from tests.conftest import make_speech_like_signal
from tests.pitch_oracle import assert_lag_decisions

torch.set_num_threads(2)

REAL_DATA = os.path.join(os.path.dirname(__file__), 'data')


def jax_utterances(utterances):
    """The JAX package's Utterances of the same entries."""
    return JUtterances([
        tuple(field for field in (
            utt.name, utt.audio_file, utt.speaker, utt.tstart, utt.tstop)
            if field is not None)
        for utt in utterances])


def jax_audio(audio):
    """The JAX package's Audio of the same samples."""
    return JAudio(audio.data, audio.sample_rate, validate=False)


def jax_collection(collection):
    """The JAX package's FeaturesCollection of the same arrays."""
    return JFeaturesCollection({
        name: JFeatures(features.data, features.times,
                        copy.deepcopy(features.properties), validate=False)
        for name, features in collection.items()})

#: the six frame processors, as (port class, JAX class, kwargs)
PROCESSORS = {
    'mfcc': (MfccProcessor, jmfcc.MfccProcessor, {'dither': 0}),
    'filterbank': (FilterbankProcessor, jfilterbank.FilterbankProcessor,
                   {'dither': 0}),
    'plp': (PlpProcessor, jplp.PlpProcessor, {'dither': 0, 'rasta': True}),
    'energy': (EnergyProcessor, jenergy.EnergyProcessor, {'dither': 0}),
    'spectrogram': (SpectrogramProcessor, jspectrogram.SpectrogramProcessor,
                    {'dither': 0}),
    'pitch': (KaldiPitchProcessor, jpitch.KaldiPitchProcessor, {}),
}


def against_jax(ours, ref):
    """Max-abs error, relative to the reference's largest magnitude
    when it is over 1."""
    return np.abs(ours - ref).max() / max(1.0, np.abs(ref).max())


@pytest.fixture(scope='module')
def long_wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('long') / 'long.wav')
    scipy.io.wavfile.write(path, 16000, make_speech_like_signal(67000, 16000))
    return path


@pytest.fixture(scope='module')
def segments(long_wav):
    """One 'hour-scale' utterance (past a lowered limit) and two short
    segments of the same file."""
    return Utterances([
        ('big', long_wav, 's1', 0.0, 4.1),
        ('small1', long_wav, 's2', 0.0, 0.9),
        ('small2', long_wav, 's1', 1.0, 2.2)])


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """5 utterances of 2 speakers: a 6 s one and four short ones."""
    path = tmp_path_factory.mktemp('corpus')
    entries = []
    for index, nsamples in enumerate([96000, 30000, 41000, 25500, 12000]):
        wav = str(path / f'u{index}.wav')
        scipy.io.wavfile.write(
            wav, 16000, make_speech_like_signal(nsamples, 16000, seed=index))
        entries.append((f'u{index}', wav, f'spk{index % 2}'))
    return entries


@pytest.fixture
def lowered_limit(monkeypatch):
    """MFCC's AUTO_CHUNK_FRAMES at 300 in both packages: utterances past
    3 s take the chunked route, and the pipeline the stage-wise path."""
    for cls in (MfccProcessor, jmfcc.MfccProcessor):
        monkeypatch.setattr(cls, 'AUTO_CHUNK_FRAMES', 300)


@pytest.fixture
def no_energy_dither(monkeypatch):
    """The energy VAD's default dither of 1.0 set to 0 in both
    packages (the pipeline config has no knob for it)."""
    for cls in (jenergy.EnergyProcessor, energy.EnergyProcessor):
        defaults = list(cls.__init__.__defaults__)
        defaults[3] = 0.0  # sample_rate, frame_shift, frame_length, dither
        monkeypatch.setattr(cls.__init__, '__defaults__', tuple(defaults))


def deterministic_config(features='mfcc'):
    config = pipeline.get_default_config(
        features, with_pitch='kaldi', with_cmvn=True, with_delta=True)
    config[features]['dither'] = 0
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    return config


def check_slice(ours, ref, utterances, pitch_columns=3):
    """Every utterance within 1e-3 of JAX, the pitch columns as far as
    the lags agree (a lag that differs must be a proven tie)."""
    assert list(ours.keys()) == list(ref.keys())
    for utt in utterances:
        mine, theirs = ours[utt.name].data, ref[utt.name].data
        assert mine.shape == theirs.shape, utt.name
        assert mine.dtype == np.float32
        features = mine.shape[1] - pitch_columns
        assert np.abs(mine[:, :features] - theirs[:, :features]).max() < 1e-3
        audio = utt.load_audio()
        raw = KaldiPitchProcessor(
            sample_rate=audio.sample_rate).process(audio, device='cpu')
        ref_raw = jpitch.KaldiPitchProcessor(
            sample_rate=audio.sample_rate).process(jax_audio(audio))
        if np.array_equal(raw.data[:, 1], ref_raw.data[:, 1]):
            assert np.abs(mine - theirs).max() < 1e-3, utt.name
        else:
            assert_lag_decisions(
                audio.astype(np.int16).data.astype(np.float64),
                raw.data, ref_raw.data, rate=audio.sample_rate)
        assert ours[utt.name].properties.keys() == \
            ref[utt.name].properties.keys()


# ------------------------------------------------------------- executor

def test_batch_executor_oversize_and_warps(segments, lowered_limit):
    """Oversize utterances take the chunked route, the rest is batched;
    per-utterance warps reach both, as in the JAX executor."""
    proc = MfccProcessor(dither=0)
    ref_proc = jmfcc.MfccProcessor(dither=0)
    for warps in (None, {'big': 1.1, 'small1': 0.9, 'small2': 1.0}):
        ours = BatchExecutor(proc, device='cpu').process_all(
            segments, vtln_warp=warps)
        ref = JBatchExecutor(ref_proc).process_all(
            jax_utterances(segments), vtln_warp=warps)
        assert list(ours.keys()) == list(ref.keys())
        for utt in segments:
            assert ours[utt.name].shape == ref[utt.name].shape
            assert against_jax(ours[utt.name].data, ref[utt.name].data) < 1e-4
            assert ours[utt.name].properties == ref[utt.name].properties
            single = proc.process_chunked(
                utt.load_audio(), chunk_frames=10 ** 9, device='cpu',
                vtln_warp=1.0 if warps is None else warps[utt.name])
            assert np.abs(ours[utt.name].data - single.data).max() < 1e-4


def test_batch_executor_chunks_oversize(segments, lowered_limit,
                                        monkeypatch):
    calls = []
    real = MfccProcessor.process_chunked

    def counting(self, audio, *args, **kwargs):
        calls.append(audio.nsamples)
        return real(self, audio, *args, **kwargs)

    monkeypatch.setattr(MfccProcessor, 'process_chunked', counting)
    BatchExecutor(MfccProcessor(dither=0), device='cpu').process_all(
        segments)
    assert calls == [int(4.1 * 16000)]


@pytest.mark.parametrize('name', sorted(PROCESSORS))
def test_process_all(segments, name):
    """Each processor's process_all (through BatchExecutor) against the
    JAX package's."""
    ours_cls, ref_cls, kwargs = PROCESSORS[name]
    ours = ours_cls(**kwargs).process_all(segments, device='cpu')
    ref = ref_cls(**kwargs).process_all(jax_utterances(segments))
    assert sorted(ours.keys()) == sorted(ref.keys())
    for utt in segments:
        mine, theirs = ours[utt.name], ref[utt.name]
        assert mine.shape == theirs.shape
        assert mine.dtype == theirs.dtype
        assert np.array_equal(mine.times, theirs.times)
        assert mine.properties == theirs.properties
        if name == 'pitch':
            same = assert_lag_decisions(
                utt.load_audio().data.astype(np.float64), mine.data,
                theirs.data)
            assert np.abs(mine.data[same, 0] - theirs.data[same, 0]).max() \
                < 1e-4
        elif name == 'spectrogram':
            # the log power of near-floor bins is not held against the
            # reference's float32 FFT: the energy column, and the power
            # relative to each frame's largest bin
            assert against_jax(mine.data[:, 0], theirs.data[:, 0]) < 1e-4
            power, ref_power = np.exp(mine.data[:, 1:]), np.exp(
                theirs.data[:, 1:])
            assert (np.abs(power - ref_power)
                    / ref_power.max(axis=1, keepdims=True)).max() < 1e-4
        else:
            assert against_jax(mine.data, theirs.data) < 1e-4


def test_process_all_arguments(segments):
    proc = MfccProcessor(dither=0)
    with pytest.raises(ValueError, match='is not a dict'):
        proc.process_all(segments, device='cpu', vtln_warp=1.1)
    with pytest.raises(ValueError, match='different names'):
        proc.process_all(segments, device='cpu', vtln_warp={'big': 1.1})
    with pytest.raises(ValueError, match='does not accept VTLN warps'):
        BatchExecutor(EnergyProcessor(), device='cpu').process_all(
            segments, vtln_warp={u.name: 1.0 for u in segments})
    with pytest.raises(ValueError, match='sample rates'):
        BatchExecutor(MfccProcessor(sample_rate=8000), device='cpu') \
            .process_all(segments)


def test_process_all_dither_is_seeded(segments, lowered_limit):
    """Batches and chunks draw the dither from the caller's generator."""
    proc = MfccProcessor()
    first, again, other = (
        proc.process_all(segments, device='cpu',
                         generator=torch.Generator().manual_seed(seed))
        for seed in (7, 7, 8))
    for name in first:
        assert np.array_equal(first[name].data, again[name].data)
        assert not np.array_equal(first[name].data, other[name].data)


# --------------------------------------------------------- signal cache

def collect(source):
    """name -> (valid int16 row, nsamples) for a stream."""
    rows = {}
    for names, signals, nsamples, nvalid in source:
        assert signals.dtype == torch.int16
        assert nvalid == len(names)
        host = signals.cpu().numpy()
        for row, name in enumerate(names):
            rows[name] = host[row, :int(nsamples[row])].copy()
    return rows


def test_signal_cache_replays_a_sweep(corpus, monkeypatch):
    utterances = Utterances(corpus)
    fresh = collect(stream.stream_batches(utterances, 2, pin_memory=False))
    cache = stream.SignalCache(device='cpu')
    first = collect(cache.stream(utterances, 2))
    # another batch size is another entry
    single = collect(cache.stream(utterances, 1))

    def no_decode(*_):
        raise AssertionError('a replay decoded audio')

    monkeypatch.setattr(stream, 'decode_batch', no_decode)
    replay = collect(cache.stream(utterances, 2))
    replay_single = collect(cache.stream(utterances, 1))
    sweeps = (first, single, replay, replay_single)
    for other in sweeps:
        assert list(other) == list(fresh)
    for name in fresh:
        for other in sweeps:
            np.testing.assert_array_equal(fresh[name], other[name])


def test_signal_cache_cap_streams_normally(corpus, monkeypatch):
    utterances = Utterances(corpus)
    fresh = collect(stream.stream_batches(utterances, 2, pin_memory=False))
    decoded = []
    real = stream.decode_batch

    def counting(chunk, *args):
        decoded.append(len(chunk))
        return real(chunk, *args)

    monkeypatch.setattr(stream, 'decode_batch', counting)
    cache = stream.SignalCache(max_bytes=100000, device='cpu')
    for _ in range(2):
        swept = collect(cache.stream(utterances, 2))
        for name in fresh:
            np.testing.assert_array_equal(fresh[name], swept[name])
    # both sweeps decoded the whole corpus: nothing was retained
    assert sum(decoded) == 2 * len(corpus)
    assert cache._bytes == 0


def test_signal_cache_keys_segments(long_wav, segments):
    """Segments of one file with other bounds are other entries."""
    cache = stream.SignalCache(device='cpu')
    first = collect(cache.stream(segments, 4))
    moved = Utterances([('big', long_wav, 's1', 0.5, 4.1)])
    assert collect(cache.stream(moved, 4))['big'].shape[0] != \
        first['big'].shape[0]


def test_plan_batches_by_length(corpus):
    """Batches are planned from the headers, shortest first, and decode
    to one row per utterance."""
    utterances = Utterances(corpus)
    plans = stream.plan_batches(utterances, 2)
    assert [[utt.name for utt in chunk] for chunk in plans] == [
        ['u4', 'u3'], ['u1', 'u2'], ['u0']]
    names, signals, nsamples, nvalid = stream.decode_batch(
        plans[0], pin_memory=False)
    assert names == ['u4', 'u3'] and nvalid == 2
    assert signals.dtype == torch.int16 and signals.shape[0] == 2
    assert list(nsamples) == [12000, 25500]
    assert (signals[0, 12000:] == 0).all()


# ------------------------------------------------------ post-processors

@pytest.fixture(scope='module')
def energies(segments):
    ours = EnergyProcessor(dither=0).process_all(segments, device='cpu')
    return FeaturesCollection({name: ours[name] for name in sorted(ours)})


def test_vad_process_all(energies):
    for kwargs in ({}, {'frames_context': 2, 'energy_mean_scale': 0.3}):
        ours = VadPostProcessor(**kwargs).process_all(energies, device='cpu')
        ref = jvad.VadPostProcessor(**kwargs).process_all(
            jax_collection(energies))
        assert list(ours.keys()) == list(ref.keys())
        for name in ref:
            assert ours[name].dtype == np.uint8
            assert np.array_equal(ours[name].data, ref[name].data)
            assert ours[name].properties == ref[name].properties
            single = VadPostProcessor(**kwargs).process(
                energies[name], device='cpu')
            assert np.array_equal(ours[name].data, single.data)


def test_delta_process_all(segments):
    feats = MfccProcessor(dither=0).process_all(segments, device='cpu')
    for kwargs in ({}, {'order': 1, 'window': 3}):
        ours = DeltaPostProcessor(**kwargs).process_all(feats, device='cpu')
        ref = jdelta.DeltaPostProcessor(**kwargs).process_all(
            jax_collection(feats))
        for name in ref:
            assert ours[name].shape == ref[name].shape
            assert np.abs(ours[name].data - ref[name].data).max() < 1e-5
            assert ours[name].properties == ref[name].properties


def test_pitch_post_process_collection(segments):
    raw = KaldiPitchProcessor().process_all(segments, device='cpu')
    post = dict(delta_pitch_noise_stddev=0, add_raw_log_pitch=True)
    ours = KaldiPitchPostProcessor(**post).process_collection(
        raw, batch_rows=2, device='cpu')
    ref = jpitch.KaldiPitchPostProcessor(**post).process_collection(
        jax_collection(raw), batch_rows=2)
    assert list(ours.keys()) == list(raw.keys())
    for name in raw:
        assert ours[name].shape == ref[name].shape == (raw[name].nframes, 4)
        assert np.abs(ours[name].data - ref[name].data).max() < 1e-5
        assert ours[name].properties == ref[name].properties
        single = KaldiPitchPostProcessor(**post).process(
            raw[name], device='cpu')
        assert np.abs(ours[name].data - single.data).max() < 1e-5

    noisy = KaldiPitchPostProcessor()
    first, again = (
        noisy.process_collection(
            raw, device='cpu', generator=torch.Generator().manual_seed(3))
        for _ in range(2))
    for name in raw:
        assert np.array_equal(first[name].data, again[name].data)

    with pytest.raises(ValueError, match='at least one'):
        KaldiPitchPostProcessor(
            add_pov_feature=False, add_normalized_log_pitch=False,
            add_delta_pitch=False).process_collection(raw, device='cpu')
    with pytest.raises(ValueError, match='shape must be'):
        KaldiPitchPostProcessor().process_collection(
            MfccProcessor(dither=0).process_all(segments, device='cpu'),
            device='cpu')


# ------------------------------------------------------------- pipeline

def test_stagewise_pipeline(corpus, lowered_limit, no_energy_dither,
                            monkeypatch):
    """An utterance past the features' limit sends the collection down
    the stage-wise path, which sweeps three times over one upload."""

    def no_fused(*_, **__):
        raise AssertionError('the fused pass 1 ran')

    monkeypatch.setattr(executor_module.FusedPipelineExecutor, 'run',
                        no_fused)
    decoded = []
    real = stream.decode_batch

    def counting(chunk, *args):
        decoded.extend(utt.name for utt in chunk)
        return real(chunk, *args)

    monkeypatch.setattr(stream, 'decode_batch', counting)

    config = deterministic_config()
    utterances = Utterances(corpus)
    ours = pipeline.extract_features(
        copy.deepcopy(config), utterances, device='cpu')
    ref = jpipeline.extract_features(
        copy.deepcopy(config), jax_utterances(utterances))
    check_slice(ours, ref, utterances)
    for name in ours:
        assert ours[name].shape[1] == 42
    # the features sweep skips u0 (chunked); the energy and pitch
    # sweeps take every utterance: one decode, then a replay
    assert sorted(decoded) == sorted(
        ['u1', 'u2', 'u3', 'u4'] + [f'u{i}' for i in range(5)])


def test_stagewise_pipeline_plp(corpus, lowered_limit, no_energy_dither,
                                monkeypatch):
    """RASTA-PLP through the stage-wise path: its chunked halo."""
    for cls in (PlpProcessor, jplp.PlpProcessor):
        monkeypatch.setattr(cls, 'AUTO_CHUNK_FRAMES', 300)
    config = deterministic_config('plp')
    config['plp']['rasta'] = True
    utterances = Utterances(corpus[:3])
    ours = pipeline.extract_features(
        copy.deepcopy(config), utterances, device='cpu')
    ref = jpipeline.extract_features(
        copy.deepcopy(config), jax_utterances(utterances))
    check_slice(ours, ref, utterances)


@pytest.mark.parametrize('path', ['fused', 'stagewise'])
@pytest.mark.parametrize('by', ['speaker', 'utterance'])
def test_warps(corpus, no_energy_dither, monkeypatch, path, by):
    if path == 'stagewise':
        for cls in (MfccProcessor, jmfcc.MfccProcessor):
            monkeypatch.setattr(cls, 'AUTO_CHUNK_FRAMES', 300)
    utterances = Utterances(corpus[:4])
    if by == 'speaker':
        warps = {'spk0': 1.1, 'spk1': 0.9}
    else:
        warps = {'u0': 1.05, 'u1': 0.92, 'u2': 1.0, 'u3': 1.15}
    config = deterministic_config()
    ours = pipeline.extract_features(
        copy.deepcopy(config), utterances, warps=warps, device='cpu')
    ref = jpipeline.extract_features(
        copy.deepcopy(config), jax_utterances(utterances), warps=warps)
    check_slice(ours, ref, utterances)
    for utt in utterances:
        warp = warps[utt.speaker if by == 'speaker' else utt.name]
        assert ours[utt.name].properties['mfcc']['vtln_warp'] == warp
        assert ref[utt.name].properties['mfcc']['vtln_warp'] == warp


def test_warps_errors(corpus):
    utterances = Utterances(corpus[:2])
    config = pipeline.get_default_config('mfcc')
    with pytest.raises(ValueError, match='do not match utterances'):
        pipeline.extract_features(
            config, utterances, warps={'who': 1.0}, device='cpu')
    with_vtln = jpipeline.get_default_config('mfcc', with_vtln='simple')
    with pytest.raises(ValueError, match='already defined'):
        pipeline.extract_features(
            with_vtln, utterances, warps={'spk0': 1.0, 'spk1': 1.0},
            device='cpu')
    with pytest.raises(ValueError, match='do not support VTLN'):
        pipeline.extract_features(
            pipeline.get_default_config('spectrogram'), utterances,
            warps={'spk0': 1.0, 'spk1': 1.0}, device='cpu')
    # a vtln section trains the warps: by speaker, it needs speakers
    no_speakers = Utterances([(utt.name, utt.audio_file) for utt in utterances])
    with pytest.raises(ValueError, match='speaker information is missing'):
        pipeline.extract_features(with_vtln, no_speakers, device='cpu')


@pytest.fixture(scope='module')
def mixed_rates():
    """The real recordings at 16 kHz (int16 and float32) and 8 kHz;
    u3 asks for more audio than its file holds (warns, then clamps)."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return Utterances([
            ('u1', os.path.join(REAL_DATA, 'test.wav'), 's1', 0, 1),
            ('u2', os.path.join(REAL_DATA, 'test.float32.wav'), 's2', 1,
             1.2),
            ('u3', os.path.join(REAL_DATA, 'test.8k.wav'), 's1', 1, 3)])


def test_mixed_rates(mixed_rates, no_energy_dither):
    """The full-pipeline contract of tests/test_real_audio.py (shapes,
    dtype, per-speaker CMVN, properties), and the JAX package's
    output."""
    config = deterministic_config()
    config['cmvn']['with_vad'] = False
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        feats = pipeline.extract_features(
            copy.deepcopy(config), mixed_rates, device='cpu')
        ref = jpipeline.extract_features(
            copy.deepcopy(config), jax_utterances(mixed_rates))

    # mfcc * delta + pitch = 13 * 3 + 3 = 42 columns
    assert feats['u1'].shape == (98, 42)
    assert feats['u2'].shape == (18, 42)
    assert feats['u3'].shape == (40, 42)
    for utt in ('u1', 'u2', 'u3'):
        assert feats[utt].dtype == np.float32

    # per-speaker CMVN: normalized within each speaker's pooled frames
    assert feats['u2'].data[:, :13].mean() == pytest.approx(0, abs=1e-5)
    assert feats['u2'].data[:, :13].std() == pytest.approx(1, abs=1e-5)
    pooled = np.vstack(
        (feats['u1'].data[:, :13], feats['u3'].data[:, :13]))
    assert pooled.mean() == pytest.approx(0, abs=1e-5)
    assert pooled.std() == pytest.approx(1, abs=1e-5)

    assert feats['u1'].properties.keys() == {
        'audio', 'mfcc', 'cmvn', 'pitch', 'delta', 'speaker', 'pipeline'}
    assert feats['u3'].properties['audio']['sample_rate'] == 8000
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        check_slice(feats, ref, mixed_rates)


def test_mixed_rates_with_warps(mixed_rates, no_energy_dither):
    """Warps by speaker on the per-utterance path, with the VAD."""
    config = deterministic_config('filterbank')
    warps = {'s1': 0.95, 's2': 1.08}
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        ours = pipeline.extract_features(
            copy.deepcopy(config), mixed_rates, warps=warps, device='cpu')
        ref = jpipeline.extract_features(
            copy.deepcopy(config), jax_utterances(mixed_rates), warps=warps)
        check_slice(ours, ref, mixed_rates)
    assert ours['u3'].properties['filterbank']['vtln_warp'] == 0.95
