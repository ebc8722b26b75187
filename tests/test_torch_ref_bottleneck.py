"""Counterpart of ``tests/processor/test_bottleneck.py``, case for case:
the port's bottleneck processor and network on the CPU, with the JAX
cases' synthetic weights (the pre-trained BUT networks are distributed
separately), inputs, checks and bounds (forward 1e-4 against the numpy
oracle, batched 1e-5 against single, the DCT 1e-6).
``tests/test_torch_bottleneck.py`` holds the same functions against the
JAX package on other weights.
"""

import os

import numpy as np
import pytest
import torch

import shennong_tpu_torch.processor.bottleneck as bn_module
from shennong_tpu_torch.models import bottleneck as bn
from shennong_tpu_torch.processor.bottleneck import BottleneckProcessor

from tests.torch_ref import audio, audio_8k, real_audio_8k  # noqa: F401


@pytest.fixture(scope='module', autouse=True)
def synthetic_weights(tmp_path_factory):
    """Generate shape-correct random weights mimicking the BUT npz
    layout (stage 1: 144 -> 90 -> 90 -> 80, stagger stack to 400,
    stage 2: 400 -> 90 -> 90 -> 90 -> 80)."""
    rng = np.random.RandomState(0)
    hidden = 90

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

    directory = tmp_path_factory.mktemp('bottleneck_weights')
    path = str(directory / (
        'FisherEnglish_FBANK_HL500_SBN80_PhnStates120.npz'))
    np.savez(path, **params)

    old_dir = bn_module._SHARE_DIR
    bn_module._SHARE_DIR = str(directory)
    BottleneckProcessor._loaded_weights.clear()
    yield
    bn_module._SHARE_DIR = old_dir
    BottleneckProcessor._loaded_weights.clear()


def test_weights_validation():
    with pytest.raises(ValueError, match='invalid weights'):
        BottleneckProcessor(weights='NoSuchNet')


def test_available_weights():
    files = BottleneckProcessor.available_weights()
    assert 'FisherMono' in files


def test_shape_anchor(audio):
    feats = BottleneckProcessor(weights='FisherMono').process(
        audio, device='cpu')
    assert feats.shape == (140, 80)
    assert feats.times.shape == (140, 2)
    assert np.all(np.isfinite(feats.data))


def test_8k_passthrough(audio_8k):
    feats = BottleneckProcessor(weights='FisherMono').process(
        audio_8k, device='cpu')
    assert feats.ndims == 80


def test_silence_raises():
    from shennong_tpu_torch.audio import Audio
    silent = Audio(np.zeros(16000, dtype=np.int16), 16000)
    with pytest.raises(RuntimeError, match='no voice detected'):
        BottleneckProcessor(weights='FisherMono').process(silent, device='cpu')


def test_dither_property(audio):
    proc = BottleneckProcessor(weights='FisherMono', dither=0)
    out1 = proc.process(audio, device='cpu')
    out2 = proc.process(audio, device='cpu')
    assert np.array_equal(out1.data, out2.data)


def test_htk_fbank_matches_reference_algorithm():
    """The HTK filterbank construction matches the published BUT
    algorithm evaluated independently."""
    bank = bn.mel_filterbank_htk(200, 8000, 24, 64.0, 3800.0)
    assert bank.shape == (129, 24)
    # triangles are non-negative, each channel sums to something
    # positive and channels are ordered in frequency
    assert np.all(bank >= 0)
    assert np.all(bank.sum(axis=0) > 0)
    peaks = bank.argmax(axis=0)
    assert np.all(np.diff(peaks) > 0)


def test_vad_detects_speech_pattern():
    rng = np.random.RandomState(1)
    silence = (rng.randn(8000) * 10).astype(np.int16)
    speech = (rng.randn(8000) * 3000).astype(np.int16)
    signal = np.concatenate([silence, speech])
    from shennong_tpu_torch.logger import null_logger
    # the fixed energy path must segment cleanly (amplitude 3000
    # squares past int16, so only bugfix=True is meaningful here)
    vad = bn.compute_vad(signal, null_logger(), bugfix=True)
    nsil = (8000 - 200) // 80 + 1
    assert vad[:nsil - 2].mean() < 0.1
    assert vad[nsil + 2:].mean() > 0.9


def test_vad_default_wraps_like_reference():
    """The default VAD reproduces the reference's int16-overflow
    energies (``bottleneck.py:403-411``, bugfix=False) that the
    published networks and the BUT golden were produced with."""
    rng = np.random.RandomState(2)
    signal = (rng.randn(4000) * 3000).astype(np.int16)

    # independent wrapped-energy computation
    wrapped = signal.astype(np.int64) ** 2
    wrapped = ((wrapped + 2 ** 15) % 2 ** 16) - 2 ** 15
    nframes = (len(signal) - 200) // 80 + 1
    energies = np.array([
        wrapped[i * 80:i * 80 + 200].sum() for i in range(nframes)],
        dtype=np.float64)

    frames = bn.frame_signal(signal ** 2, 200, 80)
    assert np.array_equal(frames.sum(axis=1).astype(np.float64),
                          energies)


def test_real_audio_shape_and_vad(real_audio_8k):
    """On the real 8 kHz recording the default (reference-semantics)
    VAD must find speech and the output must match the golden's row
    count: 140 fbank frames -> +30 edge pad -> -10 context -> -20
    stagger -> 140 rows of 80."""
    from shennong_tpu_torch.logger import null_logger
    vad = bn.compute_vad(real_audio_8k.data, null_logger())
    assert len(vad) == 140
    assert 0 < vad.sum() < 140

    feat = BottleneckProcessor(
        weights='FisherMono', dither=0).process(real_audio_8k, device='cpu')
    assert feat.shape == (140, 80)
    assert np.all(np.isfinite(feat.data))

    # times as in the reference: 80-sample shift, 200-sample frames
    assert feat.times[0] == pytest.approx([0.0, 0.025])
    assert feat.times[1] == pytest.approx([0.01, 0.035])


def test_context_dct_matches_reference_algorithm():
    """The context compression matrix equals an independently built
    hamming-weighted matlab-style DCT (bottleneck.py:455-474)."""
    import scipy.fftpack
    for context in (5, 15):
        window = 2 * context + 1
        basis = scipy.fftpack.idct(np.eye(6, window), norm='ortho')
        basis[0] = np.sqrt(2.0 / window)
        expected = (basis * np.hamming(window)).T
        ours = bn.context_compression_matrix(context)
        assert np.max(np.abs(ours - expected)) < 1e-6

        # and the windowed application equals a literal per-frame loop
        rng = np.random.RandomState(context)
        fea = rng.randn(50, 3)
        out = bn.preprocess_nn_input(fea, context)
        assert out.shape == (50 - 2 * context, 18)
        for t in range(out.shape[0]):
            block = fea[t:t + window]  # [win, C]
            manual = (block.T @ expected).reshape(-1)
            assert np.allclose(out[t], manual, atol=1e-5)


def test_forward_matches_numpy_oracle():
    """The two-stage MLP equals a literal numpy forward
    implementing the published BUT recipe (sigmoid hiddens, linear
    bottlenecks, 5-offset stagger stacking, W4 unused)."""
    proc = BottleneckProcessor(weights='FisherMono')
    params = {k: np.asarray(v) for k, v in proc._get_weights().items()
              if k != 'context'}
    rng = np.random.RandomState(3)
    x = rng.randn(64, 144).astype(np.float32)

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    y = (x + params['input_mean']) * params['input_std']
    y = sigmoid(y @ params['W1'] + params['b1'])
    y = sigmoid(y @ params['W2'] + params['b2'])
    y = y @ params['W3'] + params['b3']
    stacked = np.hstack(
        [y[0:-20], y[5:-15], y[10:-10], y[15:-5], y[20:]])
    z = (stacked + params['bn_mean']) * params['bn_std']
    z = sigmoid(z @ params['W5'] + params['b5'])
    z = sigmoid(z @ params['W6'] + params['b6'])
    z = sigmoid(z @ params['W7'] + params['b7'])
    z = z @ params['W8'] + params['b8']

    ours = bn.stacked_bn_forward(
        {k: torch.as_tensor(v, dtype=torch.float32)
         for k, v in params.items()},
        torch.from_numpy(x)).numpy()
    assert ours.shape == z.shape == (44, 80)
    assert np.max(np.abs(ours - z)) < 1e-4


def test_process_all_batched(wav_file, synthetic_weights):
    """Batched process_all (the network over bucket groups) matches
    per-utterance process()."""
    from shennong_tpu_torch import Utterances
    utterances = Utterances([
        ('u1', wav_file, 0.0, 0.8), ('u2', wav_file, 0.3, 1.4),
        ('u3', wav_file, 0.0, 1.4)])
    proc = BottleneckProcessor(weights='FisherMono', dither=0)
    batched = proc.process_all(utterances, device='cpu')
    assert sorted(batched.keys()) == ['u1', 'u2', 'u3']
    for utt in utterances:
        single = proc.process(utt.load_audio(), device='cpu')
        assert batched[utt.name].shape == single.shape
        assert np.allclose(
            batched[utt.name].data, single.data, atol=1e-5), utt.name


def test_too_short_audio_yields_empty():
    # fewer network-input rows than the 20-row stagger context (real
    # BUT nets have context 15, where a <0.4 s signal lands here)
    # produce zero output frames, never padding-derived garbage (the
    # reference's unpadded stagger slices come out empty)
    from shennong_tpu_torch.audio import Audio
    proc = BottleneckProcessor(weights='FisherMono')
    proc._prepare = lambda signal, device, generator: np.zeros(
        (15, 144), np.float32)
    audio = Audio(np.zeros(16000, np.float32), 16000)
    feats = proc.process(audio, device='cpu')
    assert feats.shape == (0, 80)
    assert feats.times.shape == (0, 2)


def test_missing_selected_weights_raises_runtime_error(monkeypatch):
    """Selecting weights whose file is absent while OTHER weights are
    installed must raise the documented RuntimeError, not a bare
    KeyError from the availability dict."""
    proc = BottleneckProcessor(weights='BabelMulti')
    monkeypatch.setattr(
        BottleneckProcessor, 'available_weights',
        classmethod(lambda cls: {'FisherMono': '/nope/FisherMono.npz'}))
    with pytest.raises(RuntimeError, match='not installed'):
        proc._get_weights()
