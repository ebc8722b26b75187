"""The port's CUDA path on the card (marker ``gpu``; skipped without a
CUDA device).

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

The Viterbi kernels are held against their plain PyTorch versions on
the card (forward history bit-equal over valid frames, lags equal),
the processors against golden_real.npz (max-abs 1e-3) and against
their CPU runs (1e-3), the RASTA filter and sliding-window CMVN
against their CPU runs (1e-5), and the MFCC and RASTA-PLP slices on
the card against the same slices on the CPU (max-abs 1e-3, every
random source at 0). The Viterbi kernels are also held at the chunk
shape of hour-scale pitch, [8, 8400, 417]; chunked extraction against
whole-signal extraction on the card (1e-4, RASTA-PLP 1e-3, pitch lags
equal or proven ties); and the stage-wise path on the card against
the CPU (1e-3).
"""

import copy
import math
import os

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from shennong_tpu.audio import Audio
from shennong_tpu.utterances import Utterances
from shennong_tpu_torch import pipeline
from shennong_tpu_torch.ops import cuda_viterbi, plp, postops
from shennong_tpu_torch.processor import energy
from shennong_tpu_torch.processor.energy import EnergyProcessor
from shennong_tpu_torch.processor.filterbank import FilterbankProcessor
from shennong_tpu_torch.processor.mfcc import MfccProcessor
from shennong_tpu_torch.processor.pitch_kaldi import (
    KaldiPitchPostProcessor, KaldiPitchProcessor)
from shennong_tpu_torch.processor.plp import PlpProcessor
from shennong_tpu_torch.processor.spectrogram import SpectrogramProcessor

from tests.lag_ties import assert_ties

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_WAV = os.path.join(REPO, 'tests', 'data', 'test.wav')
FACTOR = 0.1 * math.log(1.005) ** 2  # the default inter-frame factor

# small and edge shapes (rows of 0 and 1 frames, one frame), and the
# main path's: 64 utterances of 6 s, 598 pitch frames, 417 lags
CASES = [
    ((5, 37, 50), [37, 30, 37, 5, 1]),
    ((1, 10, 417), [10]),
    ((8, 64, 130), [64] * 8),
    ((3, 100, 7), [100, 99, 50]),
    ((4, 20, 33), [20, 0, 1, 7]),
    ((2, 1, 417), [1, 0]),
    ((64, 598, 417), [598] * 32 + [int(n) for n in np.random.RandomState(
        1).randint(0, 599, 32)]),
    # a group of hour-scale pitch chunks (compute_pitch_long)
    ((8, 8400, 417), [8400, 8400, 8400, 5000, 8400, 1, 0, 3000]),
]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('shape,bounds', CASES)
def test_kernels_match_plain(cuda_device, shape, bounds):
    rng = np.random.RandomState(0)
    cost = torch.from_numpy(
        rng.rand(*shape).astype(np.float32)).to(cuda_device)
    counts = torch.tensor(bounds, dtype=torch.int32, device=cuda_device)

    cuda_viterbi.reset_launches()
    hist = cuda_viterbi.viterbi_forward(cost, counts, FACTOR)
    best = cuda_viterbi.viterbi_backtrace(hist, counts, FACTOR)
    assert cuda_viterbi.LAUNCHES == {
        'viterbi_forward': 1, 'viterbi_backtrace': 1}
    plain = cuda_viterbi.viterbi_forward_plain(cost, counts, FACTOR)
    best_plain = cuda_viterbi.viterbi_backtrace_plain(plain, counts, FACTOR)
    torch.cuda.synchronize()
    for row, bound in enumerate(bounds):
        valid = max(bound, 1)  # frame 0 is computed for empty rows too
        assert torch.equal(hist[:valid, row], plain[:valid, row]), row
        assert torch.equal(best[:bound, row], best_plain[:bound, row]), row


def test_processors_golden(cuda_device):
    audio = Audio.load(REAL_WAV)
    golden = np.load(os.path.join(REPO, 'tests', 'data', 'golden_real.npz'))
    pitch = KaldiPitchProcessor().process(audio, device=cuda_device)
    outputs = {
        'mfcc': MfccProcessor(dither=0).process(audio, device=cuda_device),
        'energy': EnergyProcessor(dither=0).process(
            audio, device=cuda_device),
        'pitch': pitch,
        'pitch_post': KaldiPitchPostProcessor(
            delta_pitch_noise_stddev=0).process(pitch, device=cuda_device),
    }
    for name, features in outputs.items():
        assert features.shape == golden[name].shape, name
        assert np.abs(features.data - golden[name]).max() < 1e-3, name


@pytest.mark.parametrize('name', ['fbank', 'spectrogram', 'plp',
                                  'rastaplp'])
def test_frontends_golden(cuda_device, name):
    audio = Audio.load(REAL_WAV)
    golden = np.load(os.path.join(REPO, 'tests', 'data', 'golden_real.npz'))
    proc = {'fbank': FilterbankProcessor(dither=0),
            'spectrogram': SpectrogramProcessor(dither=0),
            'plp': PlpProcessor(dither=0),
            'rastaplp': PlpProcessor(dither=0, rasta=True)}[name]
    ours = proc.process(audio, device=cuda_device).data
    assert ours.shape == golden[name].shape
    assert np.abs(ours - golden[name]).max() < 1e-3
    assert np.abs(ours - proc.process(audio, device='cpu').data).max() < 1e-3


def test_rasta_and_sliding_cmvn_match_cpu(cuda_device):
    rng = np.random.RandomState(0)
    log_mel = (rng.uniform(8, 20, (3, 1, 23))
               + rng.randn(3, 700, 23)).astype(np.float32)
    nframes = torch.tensor([700, 300, 3], dtype=torch.int32)
    on_cpu = plp.rasta_filter(torch.from_numpy(log_mel), nframes)
    on_cuda = plp.rasta_filter(
        torch.from_numpy(log_mel).to(cuda_device), nframes.to(cuda_device))
    assert np.abs(on_cuda.cpu().numpy() - on_cpu.numpy()).max() < 1e-5
    on_cpu = postops.sliding_window_cmvn(
        torch.from_numpy(log_mel), nframes, normalize_variance=True)
    on_cuda = postops.sliding_window_cmvn(
        torch.from_numpy(log_mel).to(cuda_device), nframes.to(cuda_device),
        normalize_variance=True)
    for row, valid in enumerate(nframes.tolist()):
        assert np.abs(on_cuda[row, :valid].cpu().numpy()
                      - on_cpu[row, :valid].numpy()).max() < 1e-5


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    """4 utterances of 2 speakers, the energy VAD's dither at 0."""
    defaults = list(energy.EnergyProcessor.__init__.__defaults__)
    defaults[3] = 0.0  # the energy VAD's dither
    monkeypatch.setattr(
        energy.EnergyProcessor.__init__, '__defaults__', tuple(defaults))
    entries = [('real', REAL_WAV, 'spk1')]
    rng = np.random.RandomState(0)
    for index, nsamples in enumerate([30000, 41000, 25500]):
        wav = str(tmp_path / f'u{index}.wav')
        t = np.arange(nsamples) / 16000
        signal = (np.sin(2 * np.pi * (120 + 20 * index) * t)
                  * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
                  + 0.05 * rng.randn(nsamples))
        scipy.io.wavfile.write(
            wav, 16000, (signal / np.abs(signal).max() * 20000).astype(
                np.int16))
        entries.append((f'u{index}', wav, f'spk{1 + index % 2}'))
    return Utterances(entries)


@pytest.mark.parametrize('features', ['mfcc', 'plp'])
def test_slice_matches_cpu(cuda_device, corpus, features):
    """The MFCC slice, and the RASTA-PLP slice of the same shape."""
    config = pipeline.get_default_config(
        features, with_pitch='kaldi', with_cmvn=True, with_delta=True)
    config[features]['dither'] = 0
    if features == 'plp':
        config['plp']['rasta'] = True
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0

    cuda_viterbi.reset_launches()
    on_cuda = pipeline.extract_features(
        copy.deepcopy(config), corpus, device=cuda_device)
    assert min(cuda_viterbi.LAUNCHES.values()) > 0
    on_cpu = pipeline.extract_features(
        copy.deepcopy(config), corpus, device='cpu')
    for name in on_cpu:
        assert on_cuda[name].shape == on_cpu[name].shape
        assert on_cuda[name].shape[1] == 42
        assert np.isfinite(on_cuda[name].data).all()
        assert np.abs(on_cuda[name].data - on_cpu[name].data).max() < 1e-3


@pytest.fixture(scope='module')
def two_minutes():
    """Two minutes of voiced harmonics with a wandering F0 under a
    syllabic envelope, and a little noise."""
    rng = np.random.RandomState(2)
    t = np.arange(120 * 16000) / 16000
    phase = 2 * np.pi * np.cumsum(120 + 30 * np.sin(2 * np.pi * 0.7 * t))
    voiced = sum((0.6 ** k) * np.sin((k + 1) * phase / 16000)
                 for k in range(6))
    signal = (voiced * (0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * t)) ** 2
              + 0.02 * rng.randn(t.size))
    return Audio((signal / np.abs(signal).max() * 20000).astype(np.int16),
                 16000)


@pytest.mark.parametrize('name', [
    'mfcc', 'filterbank', 'energy', 'spectrogram', 'plp', 'rastaplp'])
def test_chunked_matches_whole(cuda_device, two_minutes, name):
    proc = {'mfcc': MfccProcessor(dither=0),
            'filterbank': FilterbankProcessor(dither=0),
            'energy': EnergyProcessor(dither=0),
            'spectrogram': SpectrogramProcessor(dither=0),
            'plp': PlpProcessor(dither=0),
            'rastaplp': PlpProcessor(dither=0, rasta=True)}[name]
    chunked = proc.process_chunked(
        two_minutes, chunk_frames=3000, device=cuda_device)
    whole = proc.process_chunked(
        two_minutes, chunk_frames=10 ** 9, device=cuda_device)
    assert chunked.shape == whole.shape == (11998, proc.ndims)
    bound = 1e-3 if name == 'rastaplp' else 1e-4
    assert np.abs(chunked.data - whole.data).max() < bound


def test_pitch_chunked_matches_whole(cuda_device, two_minutes):
    proc = KaldiPitchProcessor()
    cuda_viterbi.reset_launches()
    chunked = proc.process_chunked(
        two_minutes, chunk_frames=2000, halo_frames=200,
        device=cuda_device).data
    # 6 chunks of 2400 frames: one group of 8 rows
    assert cuda_viterbi.LAUNCHES == {
        'viterbi_forward': 1, 'viterbi_backtrace': 1}
    whole = proc.process(two_minutes, device=cuda_device).data
    assert_ties(two_minutes.data, proc.options(), chunked, whole,
                cuda_device)


def test_stagewise_slice_matches_cpu(cuda_device, corpus, monkeypatch):
    """An utterance past a lowered features limit: the stage-wise path
    and its chunked route, on the card against the CPU."""
    monkeypatch.setattr(MfccProcessor, 'AUTO_CHUNK_FRAMES', 200)
    config = pipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
    config['mfcc']['dither'] = 0
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    warps = {'spk1': 0.93, 'spk2': 1.06}
    on_cuda = pipeline.extract_features(
        copy.deepcopy(config), corpus, warps=warps, device=cuda_device)
    on_cpu = pipeline.extract_features(
        copy.deepcopy(config), corpus, warps=warps, device='cpu')
    for name in on_cpu:
        assert on_cuda[name].shape == on_cpu[name].shape
        assert np.abs(on_cuda[name].data - on_cpu[name].data).max() < 1e-3
