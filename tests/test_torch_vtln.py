"""The port's LVTLN trainer and the config-4 pipeline against the JAX
package, on the CPU.

The warp-class MFCCs (``mfcc_multi_warp_batch``), the fMLLR operations
(:mod:`shennong_tpu_torch.ops.fmllr`), ``VtlnProcessor`` on its device
and staged bodies (the latter with device and host rounds), its model
files, the parameter carriers on JAX-trained models and
``extract_features`` with a ``vtln`` section. The inputs are made with
numpy from a seed or read from ``tests/data/test.wav`` (two 0.7 s
utterances), every random source at 0. Tolerances:

- device operations on the same inputs: 1e-5 relative, 1e-4 absolute,
  the selected classes equal; features 1e-4;
- ``VtlnProcessor.process``: the warps equal, the transforms within
  2e-3 absolute and 1e-3 relative (the JAX package's own bound between
  its fused and host rounds);
- ``extract_features`` with a ``vtln`` section: the warps equal, the
  features 1e-3.
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shennong_tpu import kaldiio as jkaldiio
from shennong_tpu import pipeline as jpipeline
from shennong_tpu.ops import fmllr as jfmllr
from shennong_tpu.ops import gmm as jgmm
from shennong_tpu.ops import spectral as jspectral
from shennong_tpu.processor import energy as jenergy
from shennong_tpu.processor import mfcc as jmfcc
from shennong_tpu.processor import ubm as jubm
from shennong_tpu.processor import vtln as jvtln
from shennong_tpu.utterances import Utterances as JUtterances
from shennong_tpu_torch import pipeline
from shennong_tpu_torch.logger import null_logger
from shennong_tpu_torch.ops import fmllr, gmm, spectral
from shennong_tpu_torch.processor import energy
from shennong_tpu_torch.processor import ubm as ubm_module
from shennong_tpu_torch.processor.mfcc import MfccProcessor
from shennong_tpu_torch.processor.vtln import VtlnProcessor
from shennong_tpu_torch.utterances import Utterances
from shennong_tpu_torch.weights import gmm_from_numpy, lvtln_from_numpy

torch.set_num_threads(2)

REAL_WAV = os.path.join(os.path.dirname(__file__), 'data', 'test.wav')
RTOL, ATOL = 1e-5, 1e-4
ENTRIES = [('u1', REAL_WAV, 's1', 0.0, 0.7), ('u2', REAL_WAV, 's2', 0.7, 1.4)]


def close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64),
        rtol=rtol, atol=atol)


def signal_batch():
    """Three rows of test.wav, of 16000, 11200 and 7000 samples."""
    from shennong_tpu_torch.audio import Audio

    audio = Audio.load(REAL_WAV)
    signals = np.zeros((3, 16000), dtype=np.int16)
    nsamples = np.array([16000, 11200, 7000], dtype=np.int32)
    for row, count in enumerate(nsamples):
        signals[row, :count] = audio.data[3000 * row:3000 * row + count]
    return signals, nsamples


def warp_banks(warps):
    ours, theirs = MfccProcessor(dither=0), jmfcc.MfccProcessor(dither=0)
    return (ours, theirs,
            np.stack([ours.mel_weights(w) for w in warps]).astype(np.float32))


# ------------------------------------------------------------- device ops

@pytest.mark.parametrize('classes', [3, 41])
def test_mfcc_multi_warp_batch(classes):
    signals, nsamples = signal_batch()
    warps = np.linspace(0.85, 1.25, classes)
    ours_proc, theirs_proc, mel = warp_banks(warps)
    nframes_max = ours_proc.output_frames(signals.shape[1])
    ours = spectral.mfcc_multi_warp_batch(
        torch.from_numpy(signals).float(), torch.from_numpy(nsamples),
        torch.from_numpy(mel), ours_proc.options(), nframes_max).numpy()
    theirs = np.asarray(jspectral.mfcc_multi_warp_batch(
        jnp.asarray(signals, jnp.float32), jnp.asarray(nsamples),
        jnp.asarray(mel), theirs_proc.options(), nframes_max))
    assert ours.shape == theirs.shape == (classes, 3, nframes_max, 13)
    for row, count in enumerate(nsamples):
        valid = ours_proc.output_frames(int(count))
        assert np.abs(ours[:, row, :valid] - theirs[:, row, :valid]).max() \
            < 1e-4 * max(1.0, np.abs(theirs).max())


def test_warp_class_mapping_moments():
    signals, nsamples = signal_batch()
    ours_proc, theirs_proc, mel = warp_banks([0.9, 1.0, 1.1, 1.0])
    nframes_max = ours_proc.output_frames(signals.shape[1])
    nframes = np.array([ours_proc.output_frames(int(n)) for n in nsamples],
                       dtype=np.int32)
    rng = np.random.RandomState(0)
    weights = ((rng.rand(3, nframes_max) > 0.4)
               & (np.arange(nframes_max) < nframes[:, None])).astype(
                   np.float32)
    ours = fmllr.warp_class_mapping_moments(
        torch.from_numpy(signals).float(), torch.from_numpy(nsamples),
        torch.from_numpy(nframes), torch.from_numpy(mel),
        torch.from_numpy(weights), ours_proc.options(), nframes_max, 2, 3)
    theirs = jfmllr.warp_class_mapping_moments(
        jnp.asarray(signals, jnp.float32), jnp.asarray(nsamples),
        jnp.asarray(nframes), jnp.asarray(mel), jnp.asarray(weights),
        theirs_proc.options(), nframes_max, 2, 3)
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        # the moments of features near 20: relative to the largest
        close(a.numpy() / max(1.0, np.abs(b).max()),
              b / max(1.0, np.abs(b).max()))
    close(fmllr.solve_mapping_from_moments([tuple(o.numpy() for o in ours)]),
          jfmllr.solve_mapping_from_moments(
              [tuple(np.asarray(t) for t in theirs)]), rtol=1e-3, atol=2e-3)


def stats_inputs(n=400, dim=5, num_gauss=8, k=3, groups=3, seed=0):
    rng = np.random.RandomState(seed)
    means = rng.randn(num_gauss, dim).astype(np.float32)
    inv_vars = (1.0 / (0.5 + rng.rand(num_gauss, dim))).astype(np.float32)
    feats = rng.randn(n, dim).astype(np.float32)
    idx = np.stack([rng.choice(num_gauss, k, replace=False)
                    for _ in range(n)]).astype(np.int32)
    val = rng.rand(n, k).astype(np.float32)
    val /= val.sum(axis=1, keepdims=True)
    gid = rng.randint(0, groups, n).astype(np.int32)
    return feats, idx, val, gid, means, inv_vars


def test_fmllr_stats_groups():
    args = stats_inputs()
    ours = fmllr.fmllr_stats_groups(
        *[torch.from_numpy(a) for a in args], 3)
    theirs = jfmllr.fmllr_stats_groups(
        *[jnp.asarray(a) for a in args], 3)
    for a, b in zip(ours, theirs):
        close(a.numpy(), np.asarray(b))


def base_transforms(dim, num_classes, seed=1):
    rng = np.random.RandomState(seed)
    base = np.eye(dim)[None] + rng.randn(num_classes, dim, dim) * 0.05
    base[num_classes // 2] = np.eye(dim)
    return base.astype(np.float32)


@pytest.mark.parametrize('norm_type', ['offset', 'none', 'diag'])
def test_solve_warp_classes(norm_type):
    feats, idx, val, gid, means, inv_vars = stats_inputs()
    beta, K, G = (np.array(a) for a in jfmllr.fmllr_stats_groups(
        jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(val),
        jnp.asarray(gid), jnp.asarray(means), jnp.asarray(inv_vars), 3))
    base = base_transforms(5, 7)
    base[1, 0] *= -1.0  # a negative determinant: excluded
    warps = np.linspace(0.9, 1.1, 7).astype(np.float32)
    sign, logdet = np.linalg.slogdet(base.astype(np.float64))
    valid = sign > 0
    logdet = np.where(valid, logdet, 0.0).astype(np.float32)
    args = (beta, K, G, base, warps, valid, logdet)
    kwargs = dict(norm_type=norm_type, logdet_scale=0.5, default_class=3)
    ours = fmllr.solve_warp_classes(
        *[torch.from_numpy(a) for a in args], **kwargs)
    theirs = jfmllr.solve_warp_classes(
        *[jnp.asarray(a) for a in args], **kwargs)
    assert np.array_equal(ours[2].numpy(), np.asarray(theirs[2]))
    assert 1 not in ours[2].numpy()
    for a, b in zip(ours, theirs):
        close(a.numpy(), np.asarray(b))


def test_lvtln_rounds():
    feats, _, _, gid, means, inv_vars = stats_inputs(n=600, k=3, groups=4)
    feats[-50:] = 0.0
    fweights = np.ones(len(feats), np.float32)
    fweights[-50:] = 0.0
    weights = np.full(8, 1.0 / 8, np.float32)
    gsel = np.array(jnp.argsort(-jfmllr_loglikes(
        feats, weights, means, inv_vars), axis=1)[:, :3]).astype(np.int32)
    base = base_transforms(5, 9)
    warps = np.linspace(0.9, 1.1, 9).astype(np.float32)
    args = (feats, fweights, gid, gsel, base, warps, weights, means,
            inv_vars)
    kwargs = dict(num_groups=4, num_iters=3, default_class=4)
    ours = fmllr.lvtln_rounds(*[torch.from_numpy(a) for a in args], **kwargs)
    theirs = jfmllr.lvtln_rounds(*[jnp.asarray(a) for a in args], **kwargs)
    names = ('weights', 'means', 'inv_vars', 'transforms', 'warps', 'best',
             'impr', 'beta')
    for name, a, b in zip(names, ours, theirs):
        if name == 'best':
            assert np.array_equal(a.numpy(), np.asarray(b))
        else:
            close(a.numpy(), np.asarray(b))


def jfmllr_loglikes(feats, weights, means, inv_vars):
    return jgmm.log_likelihoods(
        jnp.asarray(feats), jnp.asarray(weights), jnp.asarray(means),
        jnp.asarray(inv_vars))


def test_host_solves():
    """FmllrStats, the per-group class choice and the LS fit: the same
    float64 numpy in both packages."""
    feats, idx, val, gid, means, inv_vars = stats_inputs(groups=1)
    from shennong_tpu.processor.ubm import DiagGmm as JDiagGmm
    from shennong_tpu_torch.processor.ubm import DiagGmm

    model = DiagGmm(np.full(8, 1 / 8), means, inv_vars)
    jgmm_model = JDiagGmm(np.full(8, 1 / 8), means, inv_vars)
    ours, theirs = fmllr.FmllrStats(5), jfmllr.FmllrStats(5)
    ours.accumulate(feats, idx, val, model)
    theirs.accumulate(feats, idx, val, jgmm_model)
    assert np.array_equal(ours.G, theirs.G)
    base = base_transforms(5, 5).astype(np.float64)
    carried = lvtln_from_numpy(base, np.linspace(0.9, 1.1, 5), 2)
    ref = jfmllr.LinearVtln(5, 5, 2)
    ref.transforms, ref.warps = base, np.linspace(0.9, 1.1, 5)
    for norm_type in ('offset', 'none', 'diag'):
        a = carried.compute_transform(ours, norm_type)
        b = ref.compute_transform(theirs, norm_type)
        assert a[0] == b[0]
        assert np.array_equal(a[2], b[2])
    x = feats.astype(np.float64)
    pairs = [(x, x @ base[1].T, None)]
    assert np.array_equal(fmllr.compute_mapping_transform(pairs, 5),
                          jfmllr.compute_mapping_transform(pairs, 5))


# --------------------------------------------------------------- trainer

def make_pair(**kwargs):
    """The same small VTLN configuration in both packages: a 4-gaussian
    UBM, the features' dither at 0."""
    params = dict(
        num_iters=3, subsample=2,
        ubm={'num_gauss': 4, 'num_iters': 1, 'num_iters_init': 2,
             'num_frames': 1000})
    params.update(kwargs)
    pair = []
    for cls in (VtlnProcessor, jvtln.VtlnProcessor):
        proc = cls(**copy.deepcopy(params))
        proc.features['mfcc']['dither'] = 0
        ubm = dict(proc.ubm)
        ubm['features'] = copy.deepcopy(proc.features)
        proc.ubm = ubm
        pair.append(proc)
    return pair


def assert_same_training(ours, theirs, warps, jwarps):
    assert warps == jwarps
    assert ours.transforms.keys() == theirs.transforms.keys()
    for key in ours.transforms:
        close(ours.transforms[key], theirs.transforms[key],
              rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize('body', ['device', 'staged', 'host rounds'])
def test_process(body, monkeypatch):
    kwargs = {}
    if body == 'host rounds':
        kwargs = {'num_iters': 2, 'min_warp': 0.95, 'max_warp': 1.05,
                  'warp_step': 0.05}
    ours, theirs = make_pair(**kwargs)
    if body == 'staged':
        monkeypatch.setattr(
            ubm_module, 'fused_frontend_supported', lambda *a: False)
        monkeypatch.setattr(
            jvtln.VtlnProcessor, '_device_body', lambda *a, **k: False)
    if body == 'host rounds':
        for proc in (ours, theirs):
            proc.ubm = dict(proc.ubm, remove_low_count_gaussians=True)
    warps = ours.process(Utterances(ENTRIES), device='cpu')
    jwarps = theirs.process(JUtterances(ENTRIES))
    assert_same_training(ours, theirs, warps, jwarps)
    assert set(warps) == {'u1', 'u2'}
    close(ours.lvtln.transforms, theirs.lvtln.transforms,
          rtol=1e-3, atol=2e-3)


def test_process_by_speaker():
    entries = [(n, p, 'spk', a, b) for n, p, _, a, b in ENTRIES]
    ours, theirs = make_pair(num_iters=1)
    warps = ours.process(Utterances(entries), group_by='speaker',
                         device='cpu')
    jwarps = theirs.process(JUtterances(entries), group_by='speaker')
    assert list(warps) == ['spk']
    assert_same_training(ours, theirs, warps, jwarps)


def test_validation(tmp_path):
    with pytest.raises(ValueError, match='Invalid norm type'):
        VtlnProcessor(norm_type='bad')
    with pytest.raises(TypeError, match='must be a dict'):
        VtlnProcessor(ubm=3)
    with pytest.raises(ValueError, match='Unknown parameters'):
        VtlnProcessor(ubm={'bad_key': 1})
    with pytest.raises(ValueError, match='mfcc'):
        VtlnProcessor(features={'plp': {}})
    assert VtlnProcessor().get_params() == jvtln.VtlnProcessor().get_params()
    utterances = Utterances(ENTRIES)
    with pytest.raises(ValueError, match='group_by'):
        VtlnProcessor().process(utterances, group_by='nope', device='cpu')
    with pytest.raises(ValueError, match='by_speaker'):
        VtlnProcessor(by_speaker=False).process(
            utterances, group_by='speaker', device='cpu')
    with pytest.raises(ValueError, match='Min warp'):
        VtlnProcessor(min_warp=1.2, max_warp=1.0).process(
            utterances, device='cpu')
    no_speakers = Utterances([(u.name, u.audio_file) for u in utterances])
    with pytest.raises(ValueError, match='speaker information'):
        VtlnProcessor().process(no_speakers, device='cpu')
    vtln = VtlnProcessor()
    with pytest.raises(TypeError, match='not initialized'):
        vtln.save(str(tmp_path / 'lvtln.npz'))
    with pytest.raises(TypeError, match='Warps not computed'):
        vtln.save_warps(str(tmp_path / 'warps.yaml'))
    vtln.warps = {'u1': 1.0, 'u2': 0.95}
    vtln.save_warps(str(tmp_path / 'warps.yaml'))
    assert jvtln.VtlnProcessor.load_warps(
        str(tmp_path / 'warps.yaml')) == vtln.warps


@pytest.mark.parametrize('kind', ['npz', 'kaldi'])
@pytest.mark.parametrize('direction', ['jax to port', 'port to jax'])
def test_lvtln_files_interchange(tmp_path, kind, direction):
    base = base_transforms(6, 5).astype(np.float64)
    warps = np.array([0.9, 0.95, 1.0, 1.05, 1.1])
    path = str(tmp_path / f'lvtln.{kind}')
    if direction == 'jax to port':
        writer = jvtln.VtlnProcessor()
        writer.lvtln = jfmllr.LinearVtln(6, 5, 2)
        reader = VtlnProcessor
    else:
        writer = VtlnProcessor()
        writer.lvtln = lvtln_from_numpy(base, warps, 2)
        reader = jvtln.VtlnProcessor
    writer.lvtln.transforms, writer.lvtln.warps = base.copy(), warps.copy()
    (writer.save if kind == 'npz' else writer.save_kaldi)(path)
    assert jkaldiio.is_kaldi_binary(path) == (kind == 'kaldi')
    loaded = reader.load(path).lvtln
    assert loaded.default_class == 2
    tol = 1e-6 if kind == 'kaldi' else 0  # the Kaldi stream is float32
    close(loaded.transforms, base, rtol=tol, atol=tol)
    close(loaded.warps, warps, rtol=tol, atol=tol)


def test_carriers_on_jax_trained_models():
    """A UBM and an LVTLN trained by the JAX package, carried into the
    port by gmm_from_numpy and lvtln_from_numpy: both packages give the
    same log-likelihoods and selections, and pick the same warp class
    and transform from the same statistics."""
    _, theirs = make_pair(num_iters=1)
    jubm_proc = jubm.DiagUbmProcessor(**theirs.ubm)
    jubm_proc.process(JUtterances(ENTRIES))
    theirs.process(JUtterances(ENTRIES), ubm=jubm_proc)
    model = jubm_proc.gmm
    carried_gmm = gmm_from_numpy(model.weights, model.means, model.inv_vars)
    carried = lvtln_from_numpy(theirs.lvtln.transforms, theirs.lvtln.warps,
                               theirs.lvtln.default_class)

    rng = np.random.RandomState(3)
    pick = rng.randint(0, len(model.weights), 300)
    feats = model.means[pick] + rng.randn(300, model.means.shape[1]) \
        / np.sqrt(model.inv_vars[pick])
    like, idx = gmm.gaussian_selection(
        torch.as_tensor(feats), *carried_gmm.as_tensors('cpu'), 3)
    jlike, jidx = jgmm.gaussian_selection(
        jnp.asarray(feats, jnp.float32), *model.as_jax(), 3)
    close(like.numpy(), np.asarray(jlike))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    _, post = gmm.posteriors_preselect(
        torch.as_tensor(feats), idx, *carried_gmm.as_tensors('cpu'))

    ours, ref = fmllr.FmllrStats(feats.shape[1]), jfmllr.FmllrStats(
        feats.shape[1])
    ours.accumulate(feats, idx.numpy(), post.numpy(), carried_gmm)
    ref.accumulate(feats, idx.numpy(), post.numpy(), model)
    a = carried.compute_transform(ours, theirs.norm_type)
    b = theirs.lvtln.compute_transform(ref, theirs.norm_type)
    assert a[0] == b[0]
    assert np.array_equal(a[2], b[2])


def test_lvtln_from_numpy_errors():
    with pytest.raises(ValueError, match='inconsistent'):
        lvtln_from_numpy(np.zeros((3, 4, 4)), np.ones(2), 0)
    with pytest.raises(ValueError, match='default class'):
        lvtln_from_numpy(np.zeros((3, 4, 4)), np.ones(3), 3)


def test_warp_classes_collections():
    """extract_features_warp_classes (the staged body's fallback) and
    the per-warp extraction against the JAX package's."""
    config = pipeline.get_default_config('mfcc', with_delta=True)
    config['mfcc']['dither'] = 0
    warps = [0.9, 1.1]
    ours = pipeline.extract_features_warp_classes(
        copy.deepcopy(config), Utterances(ENTRIES), warps, null_logger(),
        device='cpu')
    theirs = jpipeline.extract_features_warp_classes(
        copy.deepcopy(config), JUtterances(ENTRIES), warps, null_logger())
    single = pipeline.extract_features_warp(
        copy.deepcopy(config), Utterances(ENTRIES), warps[1], null_logger(),
        device='cpu')
    for c in range(len(warps)):
        for name in ('u1', 'u2'):
            ref = theirs[c][name].data
            assert ours[c][name].shape == ref.shape == (68, 39)
            assert np.abs(ours[c][name].data - ref).max() < 1e-4 * max(
                1.0, np.abs(ref).max())
            assert ours[c][name].properties['mfcc']['vtln_warp'] == warps[c]
    for name in ('u1', 'u2'):
        assert np.abs(single[name].data - ours[1][name].data).max() < 1e-5


# ------------------------------------------------------------- pipeline

@pytest.fixture
def no_energy_dither(monkeypatch):
    """The energy VAD's dither at 0 in both packages."""
    for cls in (jenergy.EnergyProcessor, energy.EnergyProcessor):
        defaults = list(cls.__init__.__defaults__)
        defaults[3] = 0.0
        monkeypatch.setattr(cls.__init__, '__defaults__', tuple(defaults))


def tiny_vtln_config():
    """Config 4 (MFCC + Kaldi pitch + CMVN + deltas + vtln) with a
    4-gaussian UBM, 2 rounds and no random source."""
    config = pipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True,
        with_vtln='simple')
    config['mfcc']['dither'] = 0
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    vtln = config['vtln']
    vtln['num_iters'] = 2
    vtln['subsample'] = 2
    vtln['features'] = copy.deepcopy(VtlnProcessor().features)
    vtln['features']['mfcc']['dither'] = 0
    vtln['ubm'].update(num_gauss=4, num_iters=1, num_iters_init=2,
                       num_frames=1000, features=vtln['features'])
    return config


def test_extract_features_vtln(no_energy_dither):
    config = tiny_vtln_config()
    assert jpipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True,
        with_vtln='simple') == pipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True,
        with_vtln='simple')
    ours = pipeline.extract_features(
        copy.deepcopy(config), Utterances(ENTRIES), device='cpu')
    theirs = jpipeline.extract_features(
        copy.deepcopy(config), JUtterances(ENTRIES))
    for name in ('u1', 'u2'):
        assert ours[name].properties['mfcc']['vtln_warp'] == \
            theirs[name].properties['mfcc']['vtln_warp']
        assert ours[name].shape == theirs[name].shape
        assert ours[name].shape[1] == 42
        assert np.abs(ours[name].data - theirs[name].data).max() < 1e-3
