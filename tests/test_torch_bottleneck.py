"""The port's bottleneck features against the JAX package, on the CPU.

Both packages load the same synthetic weights in the BUT npz layout
(the layer layout of ``tests/processor/test_bottleneck.py``, hidden
width 90), injected into each package's weights directory for the
module. The HTK filterbank matrix and the VAD are exact; the
filterbank outputs, the context compression and the network 1e-5
(float32 FFTs and products summing in different orders); the
processor (``process``, ``process_all``, too-short audio, silence) and
``extract_features`` with bottleneck features and CMVN 1e-3, with the
dither at 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import shennong_tpu.processor.bottleneck as jbn_module
import shennong_tpu_torch.processor.bottleneck as bn_module
from shennong_tpu import Utterances as JUtterances
from shennong_tpu import pipeline as jpipeline
from shennong_tpu.audio import Audio as JAudio
from shennong_tpu.logger import null_logger
from shennong_tpu.models import bottleneck as jbn
from shennong_tpu_torch import Utterances, pipeline
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.models import bottleneck as bn
from shennong_tpu_torch.processor.bottleneck import BottleneckProcessor
from shennong_tpu_torch.weights import bottleneck_from_numpy

torch.set_num_threads(2)

HIDDEN = 90


def synthetic_params(hidden=HIDDEN, seed=0):
    """Shape-correct random weights in the BUT npz layout (stage 1:
    144 -> hidden -> hidden -> 80, stagger stack to 400, stage 2:
    400 -> hidden -> hidden -> hidden -> 80)."""
    rng = np.random.RandomState(seed)

    def dense(nin, nout):
        return (rng.randn(nin, nout) * (1 / np.sqrt(nin)),
                rng.randn(nout) * 0.1)

    params = {
        'context': np.int64(5),
        'input_mean': rng.randn(144) * 0.1,
        'input_std': np.abs(rng.randn(144)) * 0.5 + 0.5,
        'bn_mean': rng.randn(400) * 0.1,
        'bn_std': np.abs(rng.randn(400)) * 0.5 + 0.5,
    }
    for name, (nin, nout) in {
            'W1': (144, hidden), 'W2': (hidden, hidden),
            'W3': (hidden, 80), 'W5': (400, hidden),
            'W6': (hidden, hidden), 'W7': (hidden, hidden),
            'W8': (hidden, 80)}.items():
        weight, bias = dense(nin, nout)
        params[name] = weight.astype(np.float32)
        params['b' + name[1:]] = bias.astype(np.float32)
    return params


@pytest.fixture(scope='module', autouse=True)
def synthetic_weights(tmp_path_factory):
    """The synthetic weights as FisherMono and BabelMulti, in both
    packages."""
    directory = tmp_path_factory.mktemp('bottleneck_weights')
    for filename in ('FisherEnglish_FBANK_HL500_SBN80_PhnStates120',
                     'Babel-ML17_FBANK_HL1500_SBN80_PhnStates3096'):
        np.savez(str(directory / (filename + '.npz')), **synthetic_params())
    modules = (bn_module, jbn_module)
    old = [module._SHARE_DIR for module in modules]
    for module in modules:
        module._SHARE_DIR = str(directory)
        module.BottleneckProcessor._loaded_weights.clear()
    yield
    for module, directory in zip(modules, old):
        module._SHARE_DIR = directory
        module.BottleneckProcessor._loaded_weights.clear()


# ------------------------------------------------------------ front end

@pytest.mark.parametrize('args', [
    (200, 8000, 24, 64.0, 3800.0), (400, 16000, 23, 20.0, None),
    (256, 8000, 20, 0.0, None)])
def test_mel_filterbank_exact(args):
    ours = bn.mel_filterbank_htk(*args)
    assert ours.tobytes() == jbn.mel_filterbank_htk(*args).tobytes()


@pytest.mark.parametrize('bugfix', [False, True])
def test_vad_exact(bugfix):
    rng = np.random.RandomState(1)
    signal = np.concatenate([
        (rng.randn(8000) * 10), (rng.randn(8000) * 3000),
        (rng.randn(4000) * 300)]).astype(np.int16)
    ours = bn.compute_vad(signal, null_logger(), bugfix=bugfix)
    ref = jbn.compute_vad(signal, null_logger(), bugfix=bugfix)
    assert ours.dtype == ref.dtype == bool
    assert np.array_equal(ours, ref)
    assert 0 < ours.sum() < len(ours)
    silent = np.zeros(4000, np.int16)
    assert np.array_equal(bn.compute_vad(silent, null_logger()),
                          jbn.compute_vad(silent, null_logger()))


def test_fbank_matches_jax():
    rng = np.random.RandomState(2)
    signal = (rng.randn(8000) * 2000).astype(np.float32)
    frames = bn.frame_signal(signal, 200, 80)
    assert np.array_equal(frames, jbn.frame_signal(signal, 200, 80))
    assert np.array_equal(
        bn.frame_signal(torch.from_numpy(signal), 200, 80).numpy(), frames)
    window = np.hamming(200).astype(np.float32)
    bank = bn.mel_filterbank_htk(200, 8000, 24, 64.0, 3800.0)
    ours = bn.fbank_htk(*(torch.from_numpy(a) for a in (
        frames, window, bank)), 256).numpy()
    ref = np.asarray(jbn.fbank_htk(
        jnp.asarray(frames), jnp.asarray(window), jnp.asarray(bank), 256))
    assert ours.shape == ref.shape == (frames.shape[0], 24)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize('context', [5, 15])
def test_context_compression_matches_jax(context):
    assert bn.context_compression_matrix(context).tobytes() == \
        jbn.context_compression_matrix(context).tobytes()
    fea = np.random.RandomState(context).randn(60, 24).astype(np.float32)
    np.testing.assert_allclose(
        bn.preprocess_nn_input(fea, context),
        jbn.preprocess_nn_input(fea, context), atol=1e-5, rtol=0)


def test_network_matches_jax():
    tensors, context = bottleneck_from_numpy(synthetic_params())
    assert context == 5
    x = np.random.RandomState(3).randn(2, 64, 144).astype(np.float32)
    ours = bn.stacked_bn_forward(tensors, torch.from_numpy(x)).numpy()
    params = {k: jnp.asarray(v) for k, v in synthetic_params().items()
              if k != 'context'}
    for row in range(2):
        ref = np.asarray(jbn.stacked_bn_forward(params, jnp.asarray(x[row])))
        assert ours[row].shape == ref.shape == (44, 80)
        np.testing.assert_allclose(ours[row], ref, atol=1e-5, rtol=0)
        # a batch row equals the row alone
        alone = bn.stacked_bn_forward(
            tensors, torch.from_numpy(x[row])).numpy()
        np.testing.assert_allclose(ours[row], alone, atol=1e-6, rtol=0)


# ------------------------------------------------------------ processor

def test_weights_validation_and_availability(monkeypatch):
    with pytest.raises(ValueError, match='invalid weights'):
        BottleneckProcessor(weights='NoSuchNet')
    assert set(BottleneckProcessor.available_weights()) == {
        'FisherMono', 'BabelMulti'}
    assert BottleneckProcessor().get_params() == \
        jbn_module.BottleneckProcessor().get_params()
    proc = BottleneckProcessor(weights='FisherTri')
    with pytest.raises(RuntimeError, match='not installed'):
        proc._get_weights()
    monkeypatch.setattr(bn_module, '_SHARE_DIR', '/nonexistent')
    with pytest.raises(RuntimeError, match='no weights file found'):
        BottleneckProcessor.available_weights()


@pytest.mark.parametrize('name', ['wav_file', 'wav_file_8k',
                                  'real_wav_file_8k'])
def test_process_matches_jax(request, name):
    path = request.getfixturevalue(name)
    ours = BottleneckProcessor(weights='FisherMono', dither=0).process(
        Audio.load(path), device='cpu')
    ref = jbn_module.BottleneckProcessor(
        weights='FisherMono', dither=0).process(JAudio.load(path))
    assert ours.shape == ref.shape
    assert ours.shape[1] == 80 and ours.shape[0] > 100
    assert np.array_equal(ours.times, ref.times)
    np.testing.assert_allclose(ours.data, ref.data, atol=1e-3, rtol=0)
    assert ours.properties == ref.properties


def test_dither_draws_from_the_generator(wav_file):
    audio = Audio.load(wav_file)
    proc = BottleneckProcessor(weights='FisherMono', dither=0.1)

    def run(seed):
        generator = torch.Generator().manual_seed(seed)
        return proc.process(audio, device='cpu', generator=generator).data

    assert np.array_equal(run(1), run(1))
    assert not np.array_equal(run(1), run(2))
    still = BottleneckProcessor(weights='FisherMono', dither=0)
    np.testing.assert_allclose(
        run(1), still.process(audio, device='cpu').data, atol=0.1)


def test_silence_raises():
    silent = Audio(np.zeros(16000, dtype=np.int16), 16000)
    with pytest.raises(RuntimeError, match='no voice detected'):
        BottleneckProcessor(weights='FisherMono').process(
            silent, device='cpu')


def test_too_short_audio_yields_empty(monkeypatch):
    proc = BottleneckProcessor(weights='FisherMono')
    monkeypatch.setattr(
        proc, '_prepare', lambda *args: np.zeros((15, 144), np.float32))
    feats = proc.process(
        Audio(np.zeros(16000, np.float32), 16000), device='cpu')
    assert feats.shape == (0, 80)
    assert feats.times.shape == (0, 2)


def test_process_all_matches_jax(wav_file):
    items = [('u1', wav_file, 0.0, 0.8), ('u2', wav_file, 0.3, 1.4),
             ('u3', wav_file, 0.0, 1.4), ('u4', wav_file, 0.0, 0.1)]
    proc = BottleneckProcessor(weights='FisherMono', dither=0)
    ours = proc.process_all(Utterances(items), device='cpu')
    ref = jbn_module.BottleneckProcessor(
        weights='FisherMono', dither=0).process_all(JUtterances(items))
    assert list(ours.keys()) == ['u1', 'u2', 'u3', 'u4']
    for name in ours.keys():
        assert ours[name].shape == ref[name].shape, name
        np.testing.assert_allclose(
            ours[name].data, ref[name].data, atol=1e-3, rtol=0)
        single = proc.process(
            Utterances(items).by_name()[name].load_audio(), device='cpu')
        np.testing.assert_allclose(
            ours[name].data, single.data, atol=1e-5, rtol=0)


# ------------------------------------------------------------ pipeline

def whitened_params(audio):
    """The synthetic weights with their input and bottleneck whitening
    fitted to ``audio``, as a trained BUT network's ``input_mean`` /
    ``input_std`` and ``bn_mean`` / ``bn_std`` are. Without it the
    sigmoids saturate on this audio and one output column keeps a
    standard deviation of 2e-4, which CMVN scales by 5000: a float32
    rounding of 1e-6 in the network output then moves the normalized
    features by 5e-3 on either package."""
    params = synthetic_params()
    nn_input = BottleneckProcessor(
        weights='FisherMono', dither=0)._prepare(audio, 'cpu', None)
    params['input_mean'] = -nn_input.mean(axis=0)
    params['input_std'] = 1 / nn_input.std(axis=0)
    tensors, _ = bottleneck_from_numpy(params)
    hidden = torch.from_numpy(nn_input)
    hidden = (hidden + tensors['input_mean']) * tensors['input_std']
    for index in (1, 2, 3):
        hidden = hidden @ tensors[f'W{index}'] + tensors[f'b{index}']
        if index < 3:
            hidden = torch.sigmoid(hidden)
    steps = hidden.shape[0]
    stacked = torch.cat([hidden[offset:steps - 20 + offset]
                         for offset in range(0, 21, 5)], dim=1).numpy()
    params['bn_mean'] = -stacked.mean(axis=0)
    params['bn_std'] = 1 / stacked.std(axis=0)
    return params


def test_pipeline_matches_jax(wav_file, tmp_path, monkeypatch):
    """Bottleneck features with CMVN (and its energy VAD at 8 kHz):
    the per-utterance pass 1, against the JAX pipeline with every
    random source at 0."""
    from shennong_tpu.processor import energy as jenergy
    from shennong_tpu_torch.processor import energy

    np.savez(str(tmp_path / 'Babel-ML17_FBANK_HL1500_SBN80_PhnStates3096'),
             **whitened_params(Audio.load(wav_file)))
    for module in (bn_module, jbn_module):
        monkeypatch.setattr(module, '_SHARE_DIR', str(tmp_path))
        monkeypatch.setattr(module.BottleneckProcessor, '_loaded_weights', {})
    items = [('utt1', wav_file, 'spk1', 0.0, 0.7),
             ('utt2', wav_file, 'spk2', 0.7, 1.4),
             ('utt3', wav_file, 'spk1', 0.2, 1.4)]
    config = pipeline.get_default_config('bottleneck', with_cmvn=True)
    assert config == jpipeline.get_default_config(
        'bottleneck', with_cmvn=True)
    config['bottleneck']['dither'] = 0
    for module in (energy, jenergy):
        defaults = list(module.EnergyProcessor.__init__.__defaults__)
        defaults[3] = 0.0
        monkeypatch.setattr(module.EnergyProcessor.__init__, '__defaults__',
                            tuple(defaults))
    ours = pipeline.extract_features(config, Utterances(items), device='cpu')
    ref = jpipeline.extract_features(config, JUtterances(items))
    for name, _, _, _, _ in items:
        assert ours[name].shape == ref[name].shape
        assert ours[name].shape[1] == 80
        np.testing.assert_allclose(
            ours[name].data, ref[name].data, atol=1e-3, rtol=0)
        assert ours[name].properties['audio']['sample_rate'] == 8000
