"""The port's extraction examples against the JAX package, on the CPU.

``examples/torch/`` holds a counterpart of each JAX example. This file
runs four of them in process with ``device='cpu'`` at a small size,
every random source at 0, and holds what they return against the JAX
package on the same inputs: ``extract_corpus`` and ``long_audio``
against the library calls they wrap (1e-3, the pipelines' tolerance),
``serve_throughput`` against the JAX package's ``mfcc_pitch_pipeline``
(1e-3, frame counts equal), ``sustained_scale``'s corpus against the JAX
example's (the same bytes) and its audio-plane bound against
``chip_smoke.pool_bound``. Every script but the host-only
``serializer_bench`` raises when its default ``--device cuda`` is
missing.
"""

import copy
import os

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from shennong_tpu import pipeline as jpipeline
from shennong_tpu.processor import energy as jenergy
from shennong_tpu.utterances import Utterances as JUtterances
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.processor import energy
from tests.test_torch_examples_scripts import SCRIPTS, load

torch.set_num_threads(2)

TOL = 1e-3


@pytest.fixture
def no_energy_dither(monkeypatch):
    """The energy VAD's dither at 0 in both packages."""
    for cls in (jenergy.EnergyProcessor, energy.EnergyProcessor):
        defaults = list(cls.__init__.__defaults__)
        defaults[3] = 0.0  # sample_rate, frame_shift, frame_length, dither
        monkeypatch.setattr(cls.__init__, '__defaults__', tuple(defaults))


def speech_like(nsamples, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(nsamples) / 16000
    f0 = 110 + 50 * rng.rand() + 20 * np.sin(2 * np.pi * 0.6 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    voiced = sum((0.6 ** k) * np.sin((k + 1) * phase) for k in range(6))
    envelope = (0.5 * (1 + np.sin(2 * np.pi * 2.7 * t))) ** 2
    signal = voiced * envelope + rng.randn(nsamples) * 0.02
    return (signal / np.abs(signal).max() * 20000).astype(np.int16)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """3 utterances of 2 speakers, and their index file."""
    path = tmp_path_factory.mktemp('corpus')
    entries = []
    for index, nsamples in enumerate([24000, 30500, 19000]):
        wav = str(path / f'u{index}.wav')
        scipy.io.wavfile.write(wav, 16000, speech_like(nsamples, index))
        entries.append((f'u{index}', wav, f'spk{index % 2}'))
    index = str(path / 'utterances.txt')
    with open(index, 'w') as stream:
        stream.writelines(' '.join(entry) + '\n' for entry in entries)
    return entries, index


# the arguments each script needs before its --device is read
ARGS = {'extract_corpus': ['utts.txt', 'out.h5f'],
        'vtln_warps': ['utts.txt', 'warps.yaml'],
        'features_abx': ['outdir', '--synthetic', '4']}


@pytest.mark.skipif(torch.cuda.is_available(), reason='a CUDA device is here')
@pytest.mark.parametrize(
    'name', [name for name in SCRIPTS if name != 'serializer_bench'])
def test_default_device_without_cuda_raises(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        load(name).main(ARGS.get(name, []))
    assert not os.listdir(tmp_path)  # nothing ran


def test_serializer_bench_is_host_only():
    with pytest.raises(SystemExit):
        load('serializer_bench').main(['--device', 'cpu'])


@pytest.mark.parametrize('ext', ['.h5f', '.npz'])
def test_extract_corpus(corpus, tmp_path, monkeypatch, no_energy_dither, ext):
    """``--pitch --cmvn --delta`` from an index file, against the JAX
    package's ``extract_features`` of the same configuration."""
    if ext == '.h5f':
        pytest.importorskip('h5py')
    entries, index = corpus
    module = load('extract_corpus')
    real = module.get_default_config

    def no_dither(*args, **kwargs):
        config = real(*args, **kwargs)
        config['mfcc']['dither'] = 0
        config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
        return config

    monkeypatch.setattr(module, 'get_default_config', no_dither)
    output = str(tmp_path / ('features' + ext))
    report = module.extract(index, output, pitch=True, cmvn=True, delta=True,
                            device='cpu')
    config = no_dither('mfcc', with_pitch='kaldi', with_cmvn=True,
                       with_delta=True)
    ref = jpipeline.extract_features(copy.deepcopy(config),
                                     JUtterances(entries))
    saved = FeaturesCollection.load(output)
    assert report['output'] == output
    assert report['xrt'] > 0 and report['seconds'] > 0
    assert np.isclose(report['hours'] * 3600, (24000 + 30500 + 19000) / 16000)
    assert sorted(report['features']) == sorted(ref) == sorted(saved)
    for name in ref:
        ours = report['features'][name]
        assert ours.shape == ref[name].shape
        assert np.abs(ours.data - ref[name].data).max() < TOL, name
        np.testing.assert_array_equal(saved[name].data, ours.data)


def test_serve_throughput():
    """The served batches' features against the JAX package's
    ``mfcc_pitch_pipeline`` on the same signals, no dither.

    The script's utterances are a steady 130 Hz tone, so their energy
    coefficient barely moves (mean 23.3, deviation 0.041). Both packages'
    per-utterance CMVN takes the variance as E[x^2] - mean^2 in float32,
    which loses the digits of E[x^2] / var = 3.2e5 (the column's
    condition number), and the two sum in different orders. A column is
    held at 1e-3 plus what that cancellation allows: each package's
    variance off by up to 2 float32 roundings of E[x^2], so a normalised
    value x by |x| * eps * E[x^2] / var each. Its deltas take the
    largest |x| of the utterance."""
    import dataclasses

    import jax.numpy as jnp

    from shennong_tpu.ops.spectral import mfcc_batch

    from shennong_tpu.ops import mel as jmel
    from shennong_tpu.ops.framing import num_frames
    from shennong_tpu.ops.pitch import (
        PitchOpts, ProcessPitchOpts, num_pitch_frames)
    from shennong_tpu.ops.spectral import MfccOpts
    from shennong_tpu.parallel.fused import mfcc_pitch_pipeline

    report = load('serve_throughput').serve(
        batch=2, seconds=1.0, windows=2, iterations=2, dither=0.0,
        device='cpu')
    assert len(report['xrt']) == len(report['ms_per_batch']) == 2
    assert min(report['xrt']) > 0 and report['first_s'] > 0
    opts = MfccOpts()
    opts = dataclasses.replace(
        opts, frame=dataclasses.replace(opts.frame, dither=0.0))
    pitch = PitchOpts()
    signals = jnp.asarray(report['signals'].numpy())
    nsamples = jnp.asarray(report['nsamples'].numpy())
    mel = jnp.asarray(jmel.mel_banks(
        23, opts.frame.padded_window_size, 16000.0, 20.0, 0.0, 100.0,
        -500.0, 1.0)[0])
    nframes = num_frames(16000, opts.frame)
    theirs, frames = mfcc_pitch_pipeline(
        signals, nsamples, mel, opts, pitch, ProcessPitchOpts(), nframes,
        num_pitch_frames(16000, pitch))
    theirs, frames = np.asarray(theirs), np.asarray(frames)
    ours = report['features'].numpy()
    np.testing.assert_array_equal(report['frames'].numpy(), frames)
    assert ours.shape == theirs.shape == (2, 98, 42)
    raw = np.asarray(mfcc_batch(signals, nsamples, mel, opts, nframes),
                     dtype=np.float64)
    condition = (raw ** 2).mean(axis=1) / raw.var(axis=1)  # [B, 13]
    scale = np.abs(theirs[..., :13]).max(axis=1)           # [B, 13]
    cancel = 2 * np.finfo(np.float32).eps * condition * scale
    tol = TOL + np.concatenate(
        [np.tile(cancel, 3), np.zeros((2, 3))], axis=1)[:, None, :]
    assert (np.abs(ours - theirs) <= tol).all()
    # the cepstra past the energy (condition numbers of 1 to 300) keep
    # to 1e-3
    assert np.abs(ours - theirs)[..., 1:13].max() < TOL


@pytest.mark.parametrize('chunked', [False, True])
def test_long_audio(monkeypatch, chunked):
    """Each extractor of the script against the JAX package's processor
    on the same signal, whole or (with ``AUTO_CHUNK_FRAMES`` lowered on
    the frame processors of both packages) chunked."""
    from shennong_tpu.audio import Audio as JAudio
    from shennong_tpu.processor import (
        KaldiPitchProcessor, MfccProcessor, PlpProcessor)
    from shennong_tpu.processor.base import FramesProcessor as JFrames
    from shennong_tpu_torch.processor.base import FramesProcessor

    if chunked:
        for cls in (JFrames, FramesProcessor):
            monkeypatch.setattr(cls, 'AUTO_CHUNK_FRAMES', 120)
    report = load('long_audio').run(0.05, dither=0.0, device='cpu')
    assert report['seconds'] == 3.0
    audio = JAudio(report['audio'].data, 16000)
    refs = {'mfcc': MfccProcessor(dither=0),
            'plp+rasta': PlpProcessor(rasta=True, dither=0),
            'kaldi pitch': KaldiPitchProcessor()}
    assert list(report['stages']) == list(refs)
    for name, proc in refs.items():
        stage = report['stages'][name]
        ref = proc.process(audio).data
        assert stage['xrt'] > 0 and stage['cold'] > 0
        assert stage['features'].shape == ref.shape == (298, ref.shape[1])
        assert np.abs(stage['features'].data - ref).max() < TOL, name


def test_sustained_scale(tmp_path):
    """A 70 s corpus: the JAX example's files, extracted in one call,
    the audio plane within the port's bound of the plan's shapes."""
    from chip_smoke import pool_bound
    from shennong_tpu_torch.ops.framing import bucket_size
    from shennong_tpu_torch.parallel import stream

    module = load('sustained_scale')
    (tmp_path / 'ours').mkdir()
    ours, seconds = module.build_corpus(str(tmp_path / 'ours'), 0.015)
    (tmp_path / 'theirs').mkdir()
    theirs, jseconds = load('sustained_scale', jax=True).build_corpus(
        str(tmp_path / 'theirs'), 0.015)
    assert seconds == jseconds == 70.0
    for mine, ref in zip(ours, theirs):
        with open(mine.audio_file, 'rb') as a, open(ref.audio_file, 'rb') as b:
            assert a.read() == b.read()

    shapes = [(len(chunk), bucket_size(max(stream._scan_count(u)
                                           for u in chunk)))
              for chunk in stream.plan_batches(list(ours), 64)]
    assert module.pool_bound(ours) == pool_bound(shapes) > 0

    report = module.run(0.015, str(tmp_path / 'run'), njobs=2, device='cpu')
    assert report['utterances'] == 3
    assert report['audio_hours'] == 70.0 / 3600
    assert report['sustained_xrt'] > 0
    assert report['pool_bound_bytes'] == module.pool_bound(ours)
    assert (report['pool_peak_bytes'] <= report['pool_held_bytes']
            + report['pool_bound_bytes'])
