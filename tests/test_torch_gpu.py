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
the CPU (1e-3). The GMM and fMLLR device operations of the VTLN
training are held against their CPU runs (1e-5 relative, 1e-4
absolute; the iterated EM and LVTLN rounds 1e-4 relative, 1e-3
absolute), a gaussian selection that differs being a near-tie
(log-likelihoods within 1e-5 relative), the warp classes equal; and the
config-4 slice (a ``vtln`` section) on the card against the CPU (warps
equal, features 1e-3). The banded Viterbi kernel of the CREPE device
decode is held against its plain version on the card (paths equal,
over repeated launches too), the CREPE CNN and the bottleneck network
and filterbank on the card against the CPU (1e-4, float32 convolutions
and products summing in other orders), the CREPE CNN over each row's
real frames against the same call over every frame (1e-5, and no
synchronization inside the call), and the CREPE processor's host
and device decodes on the card against the CPU. The CREPE conv
kernel is held block by block, for every capacity, against the plain
chain on the card and against float64 (8 sqrt(K) ulps of the largest
value, K the products an output sums), the 'full' network through it
against the plain chain (1e-4, argmax bins equal but at near-ties),
and its wrapper refuses what the kernel does not take. The DTW kernel of the
ABX evaluator is held against its plain version on the card (1e-5 on
real-valued costs or a near-tie proven in float64 by
``chip_smoke.dtw_against_plain``, at most one pair in 1000; equal on
integer-valued ones, over repeated launches), and the 'ci' ABX
benchmark on the card against the CPU (warps equal, errors within
0.005). Two processes on the card over gloo run the main path and the
VTLN training (``tests/test_torch_distributed.py``'s worker): their
transforms and warps the same bits, their features 1e-5 from the
single-process card run. The upload pool lends page-locked buffers
that come back after their copy, and a card extraction fills the
counters of the extraction plane (one dispatch a batch, the int16
bytes up, the fetched bytes down). The pinned payload buffers of the
packed download peak within ``chip_smoke.pool_bound`` of the plan's
payload shapes, for ``fetch_dtype`` float32 and float16.
"""

import copy
import math
import os

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from chip_smoke import VITERBI, launch_counts, reset_counters
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.utterances import Utterances
from shennong_tpu_torch import pipeline
from shennong_tpu_torch.ops import cuda_viterbi, fmllr, gmm, plp, postops
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
    # lags not divisible by the forward's cluster size, with rows of 0
    # and 1 frames
    ((8, 64, 417), [64, 0, 1, 64, 63, 2, 64, 30]),
    ((20, 50, 7), [50 - n for n in range(19)] + [0]),
    # one long row: the largest cluster
    ((1, 20000, 417), [20000]),
    # past 512 lags the backtrace streams each lane's scores
    ((2, 30, 600), [30, 12]),
    # the other lag counts of the pitch options grid (min_f0, max_f0,
    # delta_pitch of tests/test_fuzz_parity.py), rows of 0 and 1 frames
] + [((4, 48, lags), [48, 0, 1, 31]) for lags in (
    133, 162, 181, 209, 266, 323, 360)]

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

    reset_counters()
    hist = cuda_viterbi.viterbi_forward(cost, counts, FACTOR)
    best = cuda_viterbi.viterbi_backtrace(hist, counts, FACTOR)
    assert launch_counts(*VITERBI) == {
        'viterbi_forward': 1, 'viterbi_backtrace': 1}
    plain = cuda_viterbi.viterbi_forward_plain(cost, counts, FACTOR)
    best_plain = cuda_viterbi.viterbi_backtrace_plain(plain, counts, FACTOR)
    torch.cuda.synchronize()
    for row, bound in enumerate(bounds):
        valid = max(bound, 1)  # frame 0 is computed for empty rows too
        assert torch.equal(hist[:valid, row], plain[:valid, row]), row
        assert torch.equal(best[:bound, row], best_plain[:bound, row]), row


def test_cluster_sizes(cuda_device):
    """The forward spreads a row over a cluster of blocks: at least 2 at
    the corpus batch (B = 64), at least 8 at a group of hour-scale
    chunks (B = 8), never more than the lags, 1 past the SMs."""
    assert cuda_viterbi.forward_plan(64, 417, cuda_device)['clusters'] >= 2
    assert cuda_viterbi.forward_plan(8, 417, cuda_device)['clusters'] >= 8
    assert cuda_viterbi.forward_plan(3, 7, cuda_device)['clusters'] <= 7
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert cuda_viterbi.forward_plan(sms, 417, cuda_device)['clusters'] == 1


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

    reset_counters()
    on_cuda = pipeline.extract_features(
        copy.deepcopy(config), corpus, device=cuda_device)
    assert min(launch_counts(*VITERBI).values()) > 0
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
    reset_counters()
    chunked = proc.process_chunked(
        two_minutes, chunk_frames=2000, halo_frames=200,
        device=cuda_device).data
    # 6 chunks of 2400 frames: one group of 8 rows
    assert launch_counts(*VITERBI) == {
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


def gmm_inputs(n=3000, dim=39, num_gauss=64, padding=4, seed=0):
    """Frames [n, dim] and a random diagonal GMM (float32 numpy) whose
    last ``padding`` components have weight 0 (the init loop's shape
    padding)."""
    rng = np.random.RandomState(seed)
    weights = rng.rand(num_gauss) + 0.1
    weights[-padding:] = 0
    weights /= weights.sum()
    means = rng.randn(num_gauss, dim)
    inv_vars = 1.0 / (0.3 + rng.rand(num_gauss, dim))
    feats = rng.randn(n, dim) * 1.3
    return tuple(a.astype(np.float32)
                 for a in (feats, weights, means, inv_vars))


def on(device, arrays, dtype=torch.float32):
    """numpy arrays as tensors on ``device``, the float ones in
    ``dtype``."""
    return [torch.from_numpy(a).to(device, dtype if a.dtype.kind == 'f'
                                   else None) for a in arrays]


def assert_selection_near_tie(ours, ref, loglikes):
    """Equal selections, or, where a frame's differ, near-ties: the
    log-likelihoods of the two picks at each rank within 1e-5
    relative."""
    differ = np.flatnonzero((ours != ref).any(axis=1))
    for row in differ:
        a = loglikes[row, ours[row]]
        b = loglikes[row, ref[row]]
        assert np.all(np.abs(a - b) <= 1e-5 * np.abs(b)), row
    print(f'{differ.size} of {len(ours)} frames select differently '
          '(near-ties)')


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_gmm_ops_match_cpu(cuda_device, dtype):
    """In float32 as the JAX package, and in float64 (GMM_DTYPE) as the
    port's trainers call them."""
    feats, weights, means, inv_vars = gmm_inputs()
    model = (weights, means, inv_vars)
    fweights = (np.arange(len(feats)) % 3 != 0).astype(np.float32)

    def both(function, arrays, *extra):
        return tuple(function(*on(device, arrays, dtype), *extra)
                     for device in (cuda_device, 'cpu'))

    def close(ours, ref, name, rtol=1e-5, atol=1e-4):
        for a, b in zip(*[o if isinstance(o, tuple) else (o,)
                          for o in (ours, ref)]):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=rtol, atol=atol, err_msg=name)

    cpu_loglikes = gmm.log_likelihoods(
        *on('cpu', (feats,) + model, dtype)).numpy()
    for name, args in (
            ('gconsts', model),
            ('log_likelihoods', (feats,) + model),
            ('accumulate_stats', (feats, fweights) + model),
            ('em_step', (feats, fweights) + model)):
        close(*both(getattr(gmm, name), args), name)

    ours, ref = both(gmm.gaussian_selection, (feats,) + model, 15)
    close(ours[0], ref[0], 'gaussian_selection')
    assert_selection_near_tie(ours[1].cpu().numpy(), ref[1].numpy(),
                              cpu_loglikes)
    preselect = ref[1].numpy()
    ours, ref = both(gmm.gaussian_selection_preselect,
                     (feats, preselect) + model, 5)
    close(ours[0], ref[0], 'gaussian_selection_preselect')
    assert_selection_near_tie(ours[1].cpu().numpy(), ref[1].numpy(),
                              cpu_loglikes)
    close(*both(gmm.posteriors_preselect, (feats, preselect) + model),
          'posteriors_preselect')

    # four EM iterations: padding components stay dead on both devices
    ours, ref = both(gmm.em_steps, (feats, fweights) + model, 4)
    assert (ours[1][-4:] == 0).all() and (ref[1][-4:] == 0).all()
    close(ours, ref, 'em_steps', rtol=1e-4, atol=1e-3)


def lvtln_inputs(n=6000, dim=39, num_gauss=64, k=15, groups=16,
                 classes=41, seed=3):
    """The arguments of ``lvtln_rounds``, float32/int32 numpy: frames
    with padding rows of weight 0, a gaussian selection, base
    transforms near the identity (the middle class the identity) and
    the warp grid."""
    feats, weights, means, inv_vars = gmm_inputs(n, dim, num_gauss, 1, seed)
    weights = np.full(num_gauss, 1.0 / num_gauss, np.float32)
    rng = np.random.RandomState(seed)
    feats[-100:] = 0.0
    fweights = np.ones(n, np.float32)
    fweights[-100:] = 0.0
    gid = rng.randint(0, groups, n).astype(np.int32)
    gsel = gmm.top_k(gmm.log_likelihoods(*[torch.from_numpy(a) for a in (
        feats, weights, means, inv_vars)]), k).numpy().astype(np.int32)
    base = np.eye(dim)[None] + rng.randn(classes, dim, dim) * 0.02
    base[classes // 2] = np.eye(dim)
    warps = np.linspace(0.85, 1.25, classes)
    return (feats, fweights, gid, gsel, base.astype(np.float32),
            warps.astype(np.float32), weights, means, inv_vars)


def test_fmllr_ops_match_cpu(cuda_device):
    args = lvtln_inputs()
    feats, _, gid, gsel = args[:4]
    post = np.random.RandomState(4).rand(*gsel.shape).astype(np.float32)
    post /= post.sum(axis=1, keepdims=True)
    stats_args = (feats, gsel, post, gid, args[7], args[8])
    ours = fmllr.fmllr_stats_groups(*on(cuda_device, stats_args), 16)
    ref = fmllr.fmllr_stats_groups(*on('cpu', stats_args), 16)
    for a, b in zip(ours, ref):
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.cpu().numpy() / scale,
                                   b.numpy() / scale, rtol=1e-5, atol=1e-4)

    base, warps = args[4], args[5]
    sign, logdet = np.linalg.slogdet(base.astype(np.float64))
    solve_args = tuple(b.numpy() for b in ref) + (
        base, warps, sign > 0, logdet.astype(np.float32))
    for norm_type in ('offset', 'diag'):
        ours = fmllr.solve_warp_classes(
            *on(cuda_device, solve_args), norm_type=norm_type,
            default_class=20)
        theirs = fmllr.solve_warp_classes(
            *on('cpu', solve_args), norm_type=norm_type, default_class=20)
        assert torch.equal(ours[2].cpu(), theirs[2]), norm_type
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=1e-5, atol=1e-4, err_msg=norm_type)

    signals = np.zeros((3, 16000), dtype=np.int16)
    nsamples = np.array([16000, 11200, 7000], dtype=np.int32)
    audio = Audio.load(REAL_WAV)
    for row, count in enumerate(nsamples):
        signals[row, :count] = audio.data[3000 * row:3000 * row + count]
    proc = MfccProcessor(dither=0)
    mel = np.stack([proc.mel_weights(w) for w in (0.9, 1.0, 1.1, 1.0)])
    nframes_max = proc.output_frames(signals.shape[1])
    nframes = np.array([proc.output_frames(int(n)) for n in nsamples],
                       dtype=np.int32)
    select = ((np.random.RandomState(5).rand(3, nframes_max) > 0.4)
              & (np.arange(nframes_max) < nframes[:, None])).astype(
                  np.float32)
    moments = {
        device: fmllr.warp_class_mapping_moments(
            *on(device, (signals.astype(np.float32), nsamples, nframes,
                         mel.astype(np.float32), select)),
            proc.options(), nframes_max, 2, 3)
        for device in (cuda_device, 'cpu')}
    for a, b in zip(moments[cuda_device], moments['cpu']):
        scale = max(1.0, float(b.abs().max()))
        np.testing.assert_allclose(a.cpu().numpy() / scale,
                                   b.numpy() / scale, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_lvtln_rounds_match_cpu(cuda_device, dtype):
    args = lvtln_inputs()
    kwargs = dict(num_groups=16, num_iters=3, default_class=20)
    ours = fmllr.lvtln_rounds(*on(cuda_device, args, dtype), **kwargs)
    ref = fmllr.lvtln_rounds(*on('cpu', args, dtype), **kwargs)
    names = ('weights', 'means', 'inv_vars', 'transforms', 'warps', 'best',
             'impr', 'beta')
    assert torch.equal(ours[5].cpu(), ref[5])
    for name, a, b in zip(names, ours, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-3, err_msg=name)


def test_vtln_slice_matches_cpu(cuda_device, corpus):
    """extract_features with a small vtln section (BASELINE config 4 at
    test size): the same warps on both devices, features 1e-3."""
    config = pipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True,
        with_vtln='full')
    config['mfcc']['dither'] = 0
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    vtln = config['vtln']
    vtln['features']['mfcc']['dither'] = 0
    vtln['ubm']['features']['mfcc']['dither'] = 0
    vtln['num_iters'] = 3
    vtln['ubm'].update(num_gauss=8, num_iters=2, num_iters_init=4,
                       num_frames=2000)

    reset_counters()
    on_cuda = pipeline.extract_features(
        copy.deepcopy(config), corpus, device=cuda_device)
    assert min(launch_counts(*VITERBI).values()) > 0
    on_cpu = pipeline.extract_features(
        copy.deepcopy(config), corpus, device='cpu')
    for name in on_cpu:
        warp = on_cpu[name].properties['mfcc']['vtln_warp']
        assert on_cuda[name].properties['mfcc']['vtln_warp'] == warp
        assert on_cuda[name].shape == on_cpu[name].shape
        assert np.isfinite(on_cuda[name].data).all()
        assert np.abs(on_cuda[name].data - on_cpu[name].data).max() < 1e-3


# ------------------------------------------------ CREPE and bottleneck

BANDED_CASES = [
    # the corpus slice of the device decode and one chunk-long row
    ((16, 1024, 360, 11), [1024] * 8 + [1, 0, 2, 1023, 700, 64, 5, 1000]),
    ((1, 8192, 360, 11), [8192]),
    # few states (one warp), a wide band and many states
    ((3, 200, 30, 11), [200, 1, 150]),
    ((2, 300, 1000, 3), [300, 299]),
    ((4, 50, 360, 63), [50, 0, 49, 25]),
    # across the kernel's tiling: 383 and 385 states sit one below and one
    # above 3 states a thread on four warps (3 x 128), 129 one above 1;
    # one state; a halfwidth wider than a thread's states (8 a thread at
    # 1024 states); rows longer than two back-pointer tiles in shared
    # memory (385 states: tiles of 284 frames; 1024: 108)
    ((3, 300, 383, 11), [300, 1, 299]),
    ((2, 700, 385, 11), [700, 650]),
    ((2, 100, 129, 11), [100, 50]),
    ((3, 40, 1, 11), [40, 1, 0]),
    ((2, 3000, 1024, 63), [3000, 2999]),
]


def banded_inputs(shape, seed=0):
    """Observations along wandering tracks with jumps and plateaus,
    and the CREPE-like banded prior of ``nstates`` and ``halfwidth``."""
    from shennong_tpu_torch.ops.viterbi import _band_matrix

    rows, frames, nstates, halfwidth = shape
    rng = np.random.RandomState(seed)
    obs = np.cumsum(rng.randint(-3, 4, (rows, frames)), axis=1) + nstates // 2
    obs[0, frames // 3:frames // 2] = obs[0, frames // 3]
    obs[-1] = rng.randint(0, nstates, frames)
    obs = np.clip(obs, 0, nstates - 1).astype(np.int32)
    grid = np.arange(nstates)
    trans = np.maximum(halfwidth + 1 - np.abs(grid[:, None] - grid), 0)
    with np.errstate(divide='ignore'):
        log_trans = np.log(trans / trans.sum(axis=1, keepdims=True))
    uniform, self_w = np.log(0.9 / nstates), np.log(0.1 + 0.9 / nstates)
    return (obs, np.full(nstates, -np.log(nstates)),
            _band_matrix(log_trans, halfwidth), uniform, self_w)


@pytest.mark.parametrize('shape,bounds', BANDED_CASES)
def test_banded_viterbi_matches_plain(cuda_device, shape, bounds):
    from shennong_tpu_torch.ops import viterbi

    obs, log_start, band, uniform, self_w = banded_inputs(shape)
    halfwidth = shape[3]
    obs_t = torch.from_numpy(obs).to(cuda_device)
    counts = torch.tensor(bounds, dtype=torch.int32, device=cuda_device)
    reset_counters()
    paths = viterbi.viterbi_banded_obs_batch(
        log_start, band, uniform, self_w, obs_t, counts, halfwidth)
    assert launch_counts('banded_viterbi') == {'banded_viterbi': 1}
    plain = viterbi.viterbi_banded_obs_batch_plain(
        torch.as_tensor(log_start, dtype=torch.float32, device=cuda_device),
        torch.as_tensor(band, dtype=torch.float32, device=cuda_device),
        uniform, self_w, obs_t, counts, halfwidth)
    torch.cuda.synchronize()
    assert torch.equal(paths, plain)
    for _ in range(2):
        assert torch.equal(viterbi.viterbi_banded_obs_batch(
            log_start, band, uniform, self_w, obs_t, counts, halfwidth),
            paths)
    # on the CPU, the plain version gives the same paths
    cpu = viterbi.viterbi_banded_obs_batch(
        log_start, band, uniform, self_w, torch.from_numpy(obs),
        torch.tensor(bounds, dtype=torch.int32), halfwidth)
    assert torch.equal(paths.cpu(), cpu)


def test_crepe_network_matches_cpu(cuda_device):
    from shennong_tpu_torch.models import crepe

    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    frames = torch.from_numpy(
        np.random.RandomState(0).randn(64, 1024).astype(np.float32))
    with torch.no_grad():
        cpu = crepe.load_model('tiny', 'cpu')(frames)
        gpu = crepe.load_model('tiny', cuda_device)(frames.to(cuda_device))
    assert float((gpu.cpu() - cpu).abs().max()) < 1e-4


@pytest.mark.parametrize('capacity', ['tiny', 'full'])
def test_crepe_packed_chunk_matches_every_frame(cuda_device, capacity):
    """forward_audio_chunk with each row's real frame counts on the card:
    the real frames within 1e-5 of the call over every frame (at the
    'full' widths both run in two pieces), zeros on the others, and the
    call never synchronizes (torch.cuda.set_sync_debug_mode('error'))."""
    from chip_smoke import crepe_params
    from shennong_tpu_torch.models import crepe
    from shennong_tpu_torch.weights import crepe_from_numpy

    hop, chunk = 160, 256
    halo = crepe.required_halo(hop)
    seg_len, left = crepe.segment_geometry(hop, chunk, halo)
    counts = np.array([256, 201, 3, 0, 256, 140, 256, 256, 97, 256, 0, 256,
                       256, 256])
    rng = np.random.RandomState(22)
    t = np.arange(seg_len) / 16000
    segments = np.zeros((counts.shape[0], seg_len), np.int16)
    for row, count in enumerate(counts):
        end = min(seg_len, left + (count - 1) * hop + 1024) if count else 0
        segments[row, :end] = np.round(
            8000 * np.sin(2 * np.pi * (100 + 15 * row) * t[:end])
            + 300 * rng.randn(end))
    owners = np.where(counts > 0, counts - 1 + halo, 0).astype(np.int32)
    model = crepe.load_model('tiny', cuda_device) if capacity == 'tiny' \
        else crepe_from_numpy(crepe_params('full', 22)).to(cuda_device)
    args = (model, torch.as_tensor(segments, device=cuda_device),
            torch.as_tensor(owners, device=cuda_device), hop, chunk, halo)

    with torch.no_grad():
        sal, stats = crepe.forward_audio_chunk(*args)
        crepe.forward_audio_chunk(*args, counts=counts)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            packed, packed_stats = crepe.forward_audio_chunk(
                *args, counts=counts)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    real = torch.arange(chunk)[None, :] < torch.from_numpy(counts)[:, None]
    sal, stats, packed, packed_stats = (
        x.cpu() for x in (sal, stats, packed, packed_stats))
    assert float((packed[real] - sal[real]).abs().max()) < 1e-5
    assert float((packed_stats[real][:, 1]
                  - stats[real][:, 1]).abs().max()) < 1e-5
    assert not packed[~real].any()


def test_crepe_processor_matches_cpu(cuda_device):
    """process_all on the card against the CPU: host decode 1e-3 (the
    salience within 1e-4 gives the same bins here), device decode
    through the kernel with the same bins as the plain version."""
    from shennong_tpu_torch.ops import viterbi
    from shennong_tpu_torch.processor.pitch_crepe import CrepePitchProcessor

    utterances = Utterances([
        ('u1', REAL_WAV, 0.0, 0.7), ('u2', REAL_WAV, 0.3, 1.4),
        ('u3', REAL_WAV, 0.0, 1.41)])
    for decode in ('host', 'device'):
        proc = CrepePitchProcessor(model_capacity='tiny', decode=decode)
        reset_counters()
        gpu = proc.process_all(utterances, device=cuda_device)
        # one launch per slice with the device decode, none with the host's
        assert (launch_counts('banded_viterbi')['banded_viterbi'] > 0) == (
            decode == 'device')
        cpu = proc.process_all(utterances, device='cpu')
        for name in cpu.keys():
            assert gpu[name].shape == cpu[name].shape
            assert np.abs(gpu[name].data - cpu[name].data).max() < 1e-3


CREPE_CAPACITIES = ['tiny', 'small', 'medium', 'large', 'full']


def crepe_block_inputs(model, nframes, seed):
    """Random float32 inputs of each conv block of ``model`` at the shapes
    the network gives it, with the first and last samples of every row
    large, so that both 'SAME' edges meet real samples."""
    rng = np.random.RandomState(seed)
    shapes = [(1, 1024)] + [(cin, 128 >> i)
                            for i, cin in enumerate(model.channels[:-1])]
    inputs = []
    for cin, size in shapes:
        x = rng.randn(nframes, cin, size).astype(np.float32)
        x[..., :2] = 3 * np.sign(x[..., :2])
        x[..., -2:] = -3 * np.sign(x[..., -2:])
        inputs.append(torch.from_numpy(x))
    return inputs


def float64_block(block):
    from shennong_tpu_torch.ops.crepe_conv import Block

    return Block(copy.deepcopy(block.conv).double(),
                 *(t.double() for t in block[1:]))


def crepe_plain_network(model, frames):
    """The CNN through the plain chain of every block, on any device."""
    from shennong_tpu_torch.ops.crepe_conv import conv_block_plain

    x = frames[:, None, :]
    for layer in range(6):
        block = model.block(layer)
        if frames.dtype == torch.float64:
            block = float64_block(block)
        x = conv_block_plain(x, block)
    x = x.transpose(1, 2).reshape(frames.shape[0], -1)
    classifier = model.classifier
    if frames.dtype == torch.float64:
        classifier = copy.deepcopy(classifier).double()
    return torch.sigmoid(classifier(x))


@pytest.mark.parametrize('nframes', [1, 7, 2049])
@pytest.mark.parametrize('capacity', CREPE_CAPACITIES)
def test_crepe_conv_kernel_matches_plain(cuda_device, capacity, nframes):
    """Each conv block through the kernel against the plain chain on the
    card (cuDNN), both against the chain in float64. Tolerance: the two
    sum the K = Cin x width products of an output in float32 in other
    orders, and rounding errors of a sum of K terms grow as sqrt(K) ulps
    of its size; 8 sqrt(K) ulps of the largest value covers the tail
    over millions of outputs, and the batch norm's scale (at most 1.42
    here) stays inside it."""
    from chip_smoke import crepe_params
    from shennong_tpu_torch.ops.crepe_conv import conv_block, conv_block_plain
    from shennong_tpu_torch.parallel.profiler import counters
    from shennong_tpu_torch.weights import crepe_from_numpy

    model = crepe_from_numpy(crepe_params(capacity, 7)).to(cuda_device)
    reset_counters()
    with torch.no_grad():
        for layer, x in enumerate(crepe_block_inputs(model, nframes, 8)):
            block = model.block(layer)
            x = x.to(cuda_device)
            out = conv_block(x, block)
            plain = conv_block_plain(x, block)
            exact = conv_block_plain(x.double(), float64_block(block))
            assert out.shape == plain.shape
            conv = block.conv
            size = math.sqrt(conv.in_channels * conv.kernel_size[0])
            bound = 8 * size * 2.0 ** -24 * float(exact.abs().max())
            assert float((out.double() - exact).abs().max()) <= bound, layer
            assert float((plain.double() - exact).abs().max()) <= bound, layer
            assert float((out - plain).abs().max()) <= 2 * bound, layer
    assert launch_counts('crepe_conv')['crepe_conv'] == 6
    # counted at the first block's launch
    assert counters.snapshot()['crepe_conv_kernel_frames'] == nframes


def test_crepe_full_network_matches_plain(cuda_device):
    """The 'full' network through the kernels against the plain chain on
    the card: saliences within 1e-4 (float32 sums in other orders, as the
    card against the CPU), argmax bins equal but where the float64
    chain's two largest saliences lie within 1e-5 (a near-tie)."""
    from chip_smoke import crepe_params
    from shennong_tpu_torch.weights import crepe_from_numpy

    model = crepe_from_numpy(crepe_params('full', 22)).to(cuda_device)
    frames = torch.from_numpy(np.random.RandomState(9).randn(
        300, 1024).astype(np.float32)).to(cuda_device)
    with torch.no_grad():
        salience = model(frames)
        plain = crepe_plain_network(model, frames)
        exact = crepe_plain_network(model, frames.double())
    assert float((salience - plain).abs().max()) < 1e-4
    top2 = exact.topk(2, dim=-1).values
    near_tie = (top2[:, 0] - top2[:, 1]) < 1e-5
    for ours in (salience, plain):
        differ = ours.argmax(-1) != exact.argmax(-1)
        assert not (differ & ~near_tie).any()


def test_crepe_conv_rejects_what_the_kernel_does_not_take(cuda_device):
    """The wrapper raises ValueError on another dtype, device, shape or a
    non-contiguous input, and launches on what it takes."""
    from shennong_tpu_torch.models import crepe
    from shennong_tpu_torch.ops.crepe_conv import conv_block

    model = crepe.load_model('tiny', cuda_device)
    block = model.block(1)
    x = torch.randn(4, 128, 128, device=cuda_device)
    reset_counters()
    assert conv_block(x, block).shape == (4, 16, 64)
    assert launch_counts('crepe_conv')['crepe_conv'] == 1
    for bad in (x.double(), x[:, :64].contiguous(), x[..., :96].contiguous(),
                torch.randn(4, 128, 128, device=cuda_device).transpose(1, 2),
                x.to('meta')):
        with pytest.raises(ValueError):
            conv_block(bad, block)
    with pytest.raises(ValueError):
        conv_block(torch.randn(2, 1, 1000, device=cuda_device),
                   model.block(0))
    assert launch_counts('crepe_conv')['crepe_conv'] == 1


def test_bottleneck_network_matches_cpu(cuda_device):
    from shennong_tpu_torch.models import bottleneck
    from shennong_tpu_torch.weights import bottleneck_from_numpy

    rng = np.random.RandomState(0)
    params = {'context': np.int64(15), 'input_mean': rng.randn(144) * 0.1,
              'input_std': rng.rand(144) + 0.5,
              'bn_mean': rng.randn(400) * 0.1, 'bn_std': rng.rand(400) + 0.5}
    for name, (nin, nout) in {
            'W1': (144, 1500), 'W2': (1500, 1500), 'W3': (1500, 80),
            'W5': (400, 1500), 'W6': (1500, 1500), 'W7': (1500, 1500),
            'W8': (1500, 80)}.items():
        params[name] = rng.randn(nin, nout) / np.sqrt(nin)
        params['b' + name[1:]] = rng.randn(nout) * 0.1
    tensors, _ = bottleneck_from_numpy(params)
    x = torch.from_numpy(rng.randn(4, 600, 144).astype(np.float32))
    cpu = bottleneck.stacked_bn_forward(tensors, x)
    gpu = bottleneck.stacked_bn_forward(
        {k: v.to(cuda_device) for k, v in tensors.items()},
        x.to(cuda_device))
    assert float((gpu.cpu() - cpu).abs().max()) < 1e-4

    signal = torch.from_numpy(
        (rng.randn(80000) * 3000).astype(np.float32))
    frames = bottleneck.frame_signal(signal, 200, 80)
    bank = torch.from_numpy(bottleneck.mel_filterbank_htk(
        200, 8000, 24, 64.0, 3800.0))
    window = torch.from_numpy(np.hamming(200).astype(np.float32))
    cpu = bottleneck.fbank_htk(frames, window, bank, 256)
    gpu = bottleneck.fbank_htk(
        frames.to(cuda_device), window.to(cuda_device), bank.to(cuda_device),
        256)
    assert float((gpu.cpu() - cpu).abs().max()) < 1e-4


# the ABX evaluator's DTW kernel: the benchmark's segments (full and
# ragged counts from 1), one strip and several, one row, one column
DTW_CASES = [
    ((4096, 24, 24), False), ((4096, 24, 24), True), ((7, 1, 1), True),
    ((5, 1, 40), True), ((5, 40, 1), True), ((512, 64, 64), True),
    ((3, 33, 70), True), ((1, 300, 280), False),
    # pairs packed into a warp: two at 24 rows (ragged from 1), four at
    # 16, eight at 5; the transposed walk (fewer columns than rows); one
    # staged pair a block; a pair too large to stage (strips)
    ((100, 16, 16), True), ((64, 5, 7), True), ((33, 24, 9), True),
    ((4, 100, 100), True), ((3, 128, 128), True)]


@pytest.mark.parametrize('shape,ragged', DTW_CASES)
def test_dtw_kernel_matches_plain(cuda_device, shape, ragged):
    from chip_smoke import dtw_against_plain
    from shennong_tpu_torch.eval import abx
    from shennong_tpu_torch.ops import dtw

    bsz, rows, cols = shape
    rng = np.random.RandomState(bsz + rows)

    def counts(limit):
        values = (rng.randint(1, limit + 1, bsz) if ragged
                  else np.full(bsz, limit))
        return torch.tensor(values, dtype=torch.int32, device=cuda_device)

    nx, ny = counts(rows), counts(cols)
    x = torch.from_numpy(rng.randn(bsz, rows, 13).astype(np.float32))
    y = torch.from_numpy(rng.randn(bsz, cols, 13).astype(np.float32))
    for metric in ('cosine', 'euclidean'):
        costs = abx._frame_costs(
            x.to(cuda_device), y.to(cuda_device), metric)
        reset_counters()
        div = dtw.dtw_divergences(costs, nx, ny)
        assert launch_counts('dtw') == {'dtw': 1}
        plain = dtw.dtw_divergences_plain(costs, nx, ny)
        # past 1e-5, the two must be a proven near-tie of two lengths,
        # and at most one pair in 1000 may be
        _, _, _, failed = dtw_against_plain(costs, nx, ny, div, plain)
        assert not failed, (metric, failed)
        assert torch.equal(dtw.dtw_divergences(costs, nx, ny), div)
    # integer-valued costs: every sum exact, ties in cost to the
    # shortest path in both, and on the CPU too
    costs = torch.from_numpy(
        rng.randint(0, 3, shape).astype(np.float32)).to(cuda_device)
    div = dtw.dtw_divergences(costs, nx, ny)
    assert torch.equal(div, dtw.dtw_divergences_plain(costs, nx, ny))
    assert torch.equal(
        div.cpu(), dtw.dtw_divergences(costs.cpu(), nx.cpu(), ny.cpu()))


@pytest.mark.parametrize('rows_per_lane', [1, 2, 3, 4])
def test_dtw_kernel_variants_match(cuda_device, rows_per_lane):
    """Every rows-a-lane variant of the staged DTW kernel gives the
    default launch's bits on ragged real costs, and the plain version's
    on integer costs."""
    from shennong_tpu_torch.eval import abx
    from shennong_tpu_torch.ops import dtw

    rng = np.random.RandomState(rows_per_lane)
    bsz, rows, cols = 300, 24, 24
    nx = torch.tensor(rng.randint(1, rows + 1, bsz), dtype=torch.int32,
                      device=cuda_device)
    ny = torch.tensor(rng.randint(1, cols + 1, bsz), dtype=torch.int32,
                      device=cuda_device)
    costs = abx._frame_costs(
        torch.from_numpy(rng.randn(bsz, rows, 13).astype(np.float32)).to(
            cuda_device),
        torch.from_numpy(rng.randn(bsz, cols, 13).astype(np.float32)).to(
            cuda_device), 'cosine').contiguous()
    integer = torch.from_numpy(rng.randint(0, 3, (bsz, rows, cols)).astype(
        np.float32)).to(cuda_device)
    for values, want in ((costs, dtw.dtw_divergences(costs, nx, ny)),
                         (integer, dtw.dtw_divergences_plain(integer, nx, ny))):
        div = torch.empty(bsz, dtype=torch.float32, device=cuda_device)
        dtw.launch_dtw(values, nx, ny, div, rows_per_lane)
        assert torch.equal(div, want)


def test_pairwise_distances_never_waits_in_its_batch_loop(cuda_device):
    """On the card, pairwise_distances synchronizes only at its ends: of
    the calls that torch.cuda.set_sync_debug_mode('warn') reports, none
    comes from a line of its batch loop or from the DTW wrapper, and they
    are as many for 39 batches as for one (the uploads before the loop,
    the one fetch after it)."""
    import inspect
    import warnings

    from shennong_tpu_torch.eval import abx

    lines, first = inspect.getsourcelines(abx.pairwise_distances)
    loop = [first + n for n, line in enumerate(lines)
            if 'for start in range' in line
            or 'distances = np.zeros' in line]
    rng = np.random.RandomState(11)
    segments = [rng.randn(rng.randint(1, 25), 13) for _ in range(40)]
    pairs = 40 * 39 // 2
    abx.pairwise_distances(segments, batch=pairs, device=cuda_device)
    places = {}
    for batch in (pairs, 20):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            torch.cuda.set_sync_debug_mode('warn')
            try:
                got = abx.pairwise_distances(segments, batch=batch,
                                             device=cuda_device)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        places[batch] = [(os.path.basename(w.filename), w.lineno)
                         for w in caught
                         if 'called a synchronizing' in str(w.message)]
        assert got.shape == (40, 40) and np.isfinite(got).all()
    assert len(loop) == 2 and -(-pairs // 20) == 39
    for found in places.values():
        assert found, 'the fetch at the end synchronizes'
        assert all(name == 'abx.py' and not loop[0] <= line < loop[1]
                   for name, line in found), (loop, found)
    assert places[20] == places[pairs]


def test_abx_ci_matches_cpu(cuda_device):
    from shennong_tpu_torch.eval import abx_bench
    from shennong_tpu_torch.ops import dtw

    reset_counters()
    gpu = abx_bench.benchmark('ci', features=('mfcc', 'rastaplp'),
                              device=cuda_device)
    assert launch_counts('dtw')['dtw'] >= 10
    cpu = abx_bench.benchmark('ci', features=('mfcc', 'rastaplp'),
                              device='cpu')
    assert gpu['warps'] == cpu['warps']
    for task in ('across', 'within'):
        for feature in ('mfcc', 'rastaplp'):
            for label, value in gpu['errors'][task][feature].items():
                assert abs(value - cpu['errors'][task][feature][label]) \
                    < 0.005, (task, feature, label)


def test_two_processes_on_one_card(cuda_device, tmp_path, monkeypatch):
    """Two processes on the card over gloo (parallel/distributed.py):
    the main path (both Viterbi kernels launched in each) and the VTLN
    training; the transforms and warps the same bits in both, the merged
    features equal to the single-process card run (1e-5)."""
    from tests import test_torch_distributed as dist

    results = dist.outputs('cuda', 2, str(tmp_path))
    dist.assert_same_bits(results, ('vtln.',))
    for result in results:
        for name in ('viterbi_forward', 'viterbi_backtrace'):
            assert result[f'launches.{name}'] > 0, name
    defaults = list(energy.EnergyProcessor.__init__.__defaults__)
    defaults[3] = 0.0  # the energy VAD's dither, as in the processes
    monkeypatch.setattr(
        energy.EnergyProcessor.__init__, '__defaults__', tuple(defaults))
    single = pipeline.extract_features(
        dist.main_config(), dist.utterances('spanning', str(tmp_path)),
        device=cuda_device)
    merged = dist.merged(results, 'extract')
    assert sorted(merged) == sorted(single.keys())
    for name in single:
        dist.close(merged[name], single[name].data, dist.FEATURES_TOL)


def test_pool_pins_and_recycles_on_the_card(cuda_device, corpus):
    """The stream's buffers are page-locked for a CUDA consumer, come
    back to the pool after the event that follows their copy, and the
    next batch of that shape reuses them: the card sees the same
    samples each time."""
    from shennong_tpu_torch.parallel import stream

    batches = list(stream.stream_batches(corpus, 2, pin_memory=True))
    uploads = stream.PendingUploads(cuda_device)
    copies = []
    for _, signals, _, _ in batches:
        assert signals.is_pinned()
        copies.append(signals.to(cuda_device, non_blocking=True))
        uploads.add(signals)
    uploads.drain()
    again = list(stream.stream_batches(corpus, 2, pin_memory=True))
    reused = {id(b[1]) for b in batches} & {id(b[1]) for b in again}
    assert reused
    for (_, signals, _, _), copy_ in zip(again, copies):
        assert torch.equal(copy_.cpu(), signals)
    for _, signals, _, _ in again:
        stream.recycle(signals)


def test_counters_of_a_card_extraction(cuda_device, corpus, monkeypatch):
    from shennong_tpu_torch.ops.framing import bucket_size
    from shennong_tpu_torch.parallel import stream
    from shennong_tpu_torch.parallel.profiler import counters

    config = pipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
    counters.reset()
    monkeypatch.setattr(stream, '_pool', stream._BufferPool())
    out = pipeline.extract_features(config, corpus, njobs=4,
                                    device=cuda_device)
    snap = counters.snapshot()
    counts = [stream._scan_count(utt) for utt in corpus]
    assert snap['dispatches'] == 1  # 4 utterances, one batch
    assert snap['bytes_up'] == len(counts) * (2 * bucket_size(max(counts))
                                              + 4)
    assert snap['bytes_down'] > 0
    for key in ('decode_s', 'dispatch_s', 'fetch_s', 'pass2_s'):
        assert snap[key] > 0, key
    assert 0 < stream.pool_peak_bytes() <= 7 * len(counts) * 2 * (
        bucket_size(max(counts)))
    assert len(out) == len(counts)


@pytest.mark.parametrize('fetch_dtype', ['float32', 'float16'])
def test_payload_pool_is_bounded(cuda_device, tmp_path, monkeypatch,
                                 fetch_dtype):
    """The download payloads of a fused MFCC slice run over 8 batches in
    two shapes (6 of one) peak within ``chip_smoke.pool_bound`` of the
    plan's payload shapes, from a new pool."""
    from chip_smoke import payload_shapes, pool_bound
    from shennong_tpu_torch.parallel import stream

    rng = np.random.RandomState(0)
    entries = []
    for index in range(8 * 64):
        nsamples = 4800 if index % 4 else 9600  # 6 batches, then 2
        wav = str(tmp_path / f'u{index:03d}.wav')
        scipy.io.wavfile.write(wav, 16000, (rng.randn(nsamples) * 3000)
                               .astype(np.int16))
        entries.append((f'u{index:03d}', wav, f'spk{index % 8}'))
    corpus = Utterances(entries)
    shapes = payload_shapes(corpus, fetch_dtype)
    assert len(shapes) == 8 and len(set(shapes)) == 2
    monkeypatch.setattr(stream, 'payloads',
                        stream._BufferPool(dtype=torch.uint8))
    out = pipeline.extract_features(
        pipeline.get_default_config(
            'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True),
        corpus, fetch_dtype=fetch_dtype, device=cuda_device)
    assert len(out) == len(entries)
    assert 0 < stream.payloads.peak_bytes <= pool_bound(shapes, itemsize=1)
