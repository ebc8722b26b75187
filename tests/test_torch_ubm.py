"""The port's UBM-GMM trainer against the JAX package, on the CPU.

The GMM operations (:mod:`shennong_tpu_torch.ops.gmm`), the fused
training front-end (``ubm_frontend_program``), ``DiagUbmProcessor`` and
its model files, and the parameter carrier ``gmm_from_numpy``. The same
inputs, made with numpy from a seed (features, models) or read from
``tests/data/test.wav`` (two 0.7 s utterances, every dither at 0), go
through ``shennong_tpu`` and ``shennong_tpu_torch``. Tolerances:

- device operations: 1e-5 relative, 1e-4 absolute, gaussian selection
  indices equal (ties lowest index first, as ``jax.lax.top_k``);
- ``mle_update`` and ``split_gmm``, the same numpy on the same
  ``RandomState``: equal;
- the front-end: features 1e-4, selection weights equal;
- ``DiagUbmProcessor.process`` on both front-ends: 1e-3 (weights,
  means, inverse variances relative to their largest magnitude).
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shennong_tpu import kaldiio as jkaldiio
from shennong_tpu.features import Features as JFeatures
from shennong_tpu.features_collection import (
    FeaturesCollection as JFeaturesCollection)
from shennong_tpu.ops import gmm as jgmm
from shennong_tpu.parallel import fused as jfused
from shennong_tpu.processor import mfcc as jmfcc
from shennong_tpu.processor import ubm as jubm
from shennong_tpu.utterances import Utterances as JUtterances
from shennong_tpu_torch import kaldiio
from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.ops import gmm
from shennong_tpu_torch.parallel import fused
from shennong_tpu_torch.processor import ubm
from shennong_tpu_torch.processor.mfcc import MfccProcessor
from shennong_tpu_torch.processor.ubm import DiagGmm, DiagUbmProcessor
from shennong_tpu_torch.utterances import Utterances
from shennong_tpu_torch.weights import gmm_from_numpy

torch.set_num_threads(2)

REAL_WAV = os.path.join(os.path.dirname(__file__), 'data', 'test.wav')
RTOL, ATOL = 1e-5, 1e-4
ENTRIES = [('u1', REAL_WAV, 's1', 0.0, 0.7), ('u2', REAL_WAV, 's2', 0.7, 1.4)]


def close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64),
        rtol=rtol, atol=atol)


def model(num_gauss=6, dim=5, seed=0, padding=0):
    """A random diagonal GMM (float32 numpy), ``padding`` trailing
    components of weight 0 (the init loop's shape padding)."""
    rng = np.random.RandomState(seed)
    weights = rng.rand(num_gauss) + 0.1
    weights /= weights.sum()
    means = rng.randn(num_gauss, dim)
    inv_vars = 1.0 / (0.3 + rng.rand(num_gauss, dim))
    if padding:
        weights = np.concatenate([weights, np.zeros(padding)])
        means = np.concatenate([means, np.zeros((padding, dim))])
        inv_vars = np.concatenate([inv_vars, np.ones((padding, dim))])
    return tuple(a.astype(np.float32) for a in (weights, means, inv_vars))


def frames(n=300, dim=5, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, dim) * 1.3).astype(np.float32)


def both(function, args):
    """``function`` of both packages on the same numpy ``args``: numpy
    outputs (ours, theirs)."""
    ours = getattr(gmm, function)(*[
        torch.as_tensor(a) if isinstance(a, np.ndarray) else a
        for a in args])
    theirs = getattr(jgmm, function)(*[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    if not isinstance(ours, tuple):
        ours, theirs = (ours,), (theirs,)
    return ([o.numpy() for o in ours], [np.asarray(t) for t in theirs])


def preselection(n, num_gauss, k, seed=2):
    rng = np.random.RandomState(seed)
    return np.stack([rng.choice(num_gauss, k, replace=False)
                     for _ in range(n)]).astype(np.int32)


# ------------------------------------------------------------- device ops

@pytest.mark.parametrize('padding', [0, 2])
@pytest.mark.parametrize('function', [
    'gconsts', 'log_likelihoods', 'gaussian_selection',
    'gaussian_selection_preselect', 'posteriors_preselect',
    'accumulate_stats', 'em_step', 'em_steps'])
def test_device_op(function, padding):
    params = model(padding=padding)
    feats = frames()
    fw = (np.random.RandomState(3).rand(len(feats)) > 0.2).astype(np.float32)
    args = {
        'gconsts': params,
        'log_likelihoods': (feats,) + params,
        'gaussian_selection': (feats,) + params + (3,),
        'gaussian_selection_preselect': (
            feats, preselection(len(feats), 6, 4)) + params + (2,),
        'posteriors_preselect': (
            feats, preselection(len(feats), 6, 3)) + params,
        'accumulate_stats': (feats, fw) + params,
        'em_step': (feats, fw) + params,
        'em_steps': (feats, fw) + params + (3,),
    }[function]
    ours, theirs = both(function, args)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        if a.dtype.kind == 'i':
            assert np.array_equal(a, b)
        else:
            close(a, b)


def test_selection_ties_lowest_index_first():
    """Duplicated components tie exactly: both packages keep the lower
    index first."""
    weights, means, inv_vars = model(num_gauss=4)
    means[2], inv_vars[2], weights[2] = means[0], inv_vars[0], weights[0]
    means[3], inv_vars[3], weights[3] = means[1], inv_vars[1], weights[1]
    feats = frames(n=50)
    for k in (1, 2, 4):
        ours, theirs = both(
            'gaussian_selection', (feats, weights, means, inv_vars, k))
        assert np.array_equal(ours[1], theirs[1]), k


def test_mle_update_and_split():
    rng = np.random.RandomState(4)
    occ = np.array([500.0, 2.0, 0.0, 80.0])
    mean_acc = rng.randn(4, 3) * occ[:, None]
    var_acc = (rng.rand(4, 3) + 1.0) * occ[:, None]
    weights = np.array([0.5, 0.2, 0.0, 0.3])
    means, inv_vars = rng.randn(4, 3), np.ones((4, 3))
    for remove in (False, True):
        ours = gmm.mle_update(occ, mean_acc, var_acc, weights, means,
                              inv_vars, remove_low_count_gaussians=remove)
        theirs = jgmm.mle_update(occ, mean_acc, var_acc, weights, means,
                                 inv_vars, remove_low_count_gaussians=remove)
        for a, b in zip(ours, theirs):
            assert np.array_equal(a, b)
    ours = gmm.split_gmm(weights[:2], means[:2], inv_vars[:2], 5, 0.1,
                         np.random.RandomState(9))
    theirs = jgmm.split_gmm(weights[:2], means[:2], inv_vars[:2], 5, 0.1,
                            np.random.RandomState(9))
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)


def test_prune_min_post():
    post = np.random.RandomState(0).rand(40, 6)
    post /= post.sum(axis=1, keepdims=True)
    assert np.array_equal(ubm._prune_min_post(post, 0.15),
                          jubm._prune_min_post(post, 0.15))


# ------------------------------------------------------------- front-end

@pytest.mark.parametrize('cmvn', [True, False])
def test_frontend_program(cmvn):
    from shennong_tpu_torch.audio import Audio

    audio = Audio.load(REAL_WAV)
    signals = np.zeros((3, 16000), dtype=np.int16)
    nsamples = np.array([16000, 11200, 7000], dtype=np.int32)
    for row, count in enumerate(nsamples):
        start = 3000 * row
        signals[row, :count] = audio.data[start:start + count]
    ours_proc = MfccProcessor(dither=0)
    theirs_proc = jmfcc.MfccProcessor(dither=0)
    nframes_max = ours_proc.output_frames(signals.shape[1])
    vad_opts = (5.5, 0.5, 0, 0.6)
    cmvn_opts = (True, 300, 100, False) if cmvn else None
    ours = fused.ubm_frontend_program(
        torch.from_numpy(signals), torch.from_numpy(nsamples),
        torch.as_tensor(ours_proc.mel_weights(1.0), dtype=torch.float32),
        ours_proc.options(), nframes_max, 2, 3, vad_opts, cmvn_opts, 5)
    theirs = jfused.ubm_frontend_program(
        jnp.asarray(signals), jnp.asarray(nsamples),
        jnp.asarray(theirs_proc.mel_weights(1.0)), theirs_proc.options(),
        nframes_max, 2, 3, vad_opts, cmvn_opts, 5)
    feats, w_init, w_em, count = (o.numpy() for o in ours)
    jfeats, jw_init, jw_em, jcount = (np.asarray(o) for o in theirs)
    assert feats.shape == jfeats.shape == (3, nframes_max, 39)
    valid = jw_init > 0
    assert np.abs(feats[valid] - jfeats[valid]).max() < 1e-4
    assert np.array_equal(w_init, jw_init)
    assert np.array_equal(w_em, jw_em)
    assert count == jcount > 0


# --------------------------------------------------------------- trainer

def deterministic(proc):
    proc.features['mfcc']['dither'] = 0
    return proc


def assert_same_gmm(ours, theirs, tol=1e-3):
    assert ours.num_gauss() == theirs.num_gauss()
    for name in ('weights', 'means', 'inv_vars'):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < tol, name


def test_training_is_reproducible_across_summation_orders(monkeypatch):
    """ROADMAP C5: the EM of a model whose variances reach the floor
    amplifies rounding, so the port trains in float64 (GMM_DTYPE): the
    log-likelihood products summed in another order, as another
    device's BLAS sums them, give the same model to 1e-9 (in float32
    they differ by float32 rounding at least)."""
    def train():
        proc = deterministic(DiagUbmProcessor(
            4, num_iters=2, num_iters_init=4, num_frames=1000))
        proc.process(Utterances(ENTRIES), device='cpu')
        return proc.gmm

    def reordered(feats, weights, means, inv_vars):
        consts = gmm.gconsts(weights, means, inv_vars)
        linear = feats.flip(1) @ (means * inv_vars).flip(1).T
        quadratic = (feats * feats).flip(1) @ inv_vars.flip(1).T
        return consts[None, :] + linear - 0.5 * quadratic

    ref = train()
    monkeypatch.setattr(gmm, 'log_likelihoods', reordered)
    assert_same_gmm(train(), ref, tol=1e-9)


@pytest.mark.parametrize('frontend', ['fused', 'staged'])
def test_process(frontend, monkeypatch):
    """Training on both front-ends: the same frames and the same
    RandomState draws in both packages."""
    if frontend == 'staged':
        monkeypatch.setattr(ubm, 'stream_frontend', lambda *a, **k: None)
        monkeypatch.setattr(jubm, 'stream_frontend', lambda *a, **k: None)
    kwargs = dict(num_iters=2, num_iters_init=4, num_frames=100, seed=3)
    ours = deterministic(DiagUbmProcessor(4, **kwargs))
    theirs = deterministic(jubm.DiagUbmProcessor(4, **kwargs))
    ours.process(Utterances(ENTRIES), device='cpu')
    theirs.process(JUtterances(ENTRIES))
    assert ours.gmm.dim() == 39
    assert ours.gmm.weights.sum() == pytest.approx(1.0)
    assert_same_gmm(ours.gmm, theirs.gmm)


def test_process_removes_low_count_gaussians():
    kwargs = dict(num_iters=2, num_iters_init=2, num_frames=1000,
                  min_gaussian_weight=0.15, remove_low_count_gaussians=True)
    ours = deterministic(DiagUbmProcessor(6, **kwargs))
    theirs = deterministic(jubm.DiagUbmProcessor(6, **kwargs))
    ours.process(Utterances(ENTRIES), device='cpu')
    theirs.process(JUtterances(ENTRIES))
    assert_same_gmm(ours.gmm, theirs.gmm)


def collections(n=120, dim=5, seed=5):
    rng = np.random.RandomState(seed)
    ours, theirs = FeaturesCollection(), JFeaturesCollection()
    for index, count in enumerate((n, n // 2)):
        data = rng.randn(count, dim).astype(np.float32)
        times = np.arange(count) * 0.01
        ours[f'u{index}'] = Features(data, times)
        theirs[f'u{index}'] = JFeatures(data, times)
    return ours, theirs


def test_host_initialization_and_stats():
    """initialize_gmm (reservoir sampling past num_frames), gaussian
    selection and its refinement, posteriors with pruning, accumulate
    and estimate with mixup, on a host collection."""
    ours_fc, theirs_fc = collections()
    ours = DiagUbmProcessor(4, num_iters_init=4, num_frames=150, seed=2)
    theirs = jubm.DiagUbmProcessor(4, num_iters_init=4, num_frames=150,
                                   seed=2)
    ours.initialize_gmm(ours_fc, device='cpu')
    theirs.initialize_gmm(theirs_fc)
    assert_same_gmm(ours.gmm, theirs.gmm, tol=1e-4)

    ours.num_gselect = theirs.num_gselect = 3
    ours.gaussian_selection(ours_fc, device='cpu')
    theirs.gaussian_selection(theirs_fc)
    ours.num_gselect = theirs.num_gselect = 2
    ours.gaussian_selection(ours_fc, device='cpu')
    theirs.gaussian_selection(theirs_fc)
    for name in ours_fc:
        assert np.array_equal(ours.selection[name], theirs.selection[name])

    posts = ours.gaussian_selection_to_post(ours_fc, 0.3, device='cpu')
    jposts = theirs.gaussian_selection_to_post(theirs_fc, 0.3)
    for name in ours_fc:
        close(posts[name][1], jposts[name][1])

    accs = ours.accumulate(ours_fc, device='cpu')
    for a, b in zip(accs, theirs.accumulate(theirs_fc)):
        close(a, b)
    ours.estimate(accs, mixup=6)
    theirs.estimate(accs, mixup=6)
    assert_same_gmm(ours.gmm, theirs.gmm, tol=1e-4)


# ---------------------------------------------------- files and carriers

def trained_jax_gmm():
    weights, means, inv_vars = model(num_gauss=5, dim=4, seed=7)
    return jubm.DiagGmm(weights, means, inv_vars)


@pytest.mark.parametrize('kind', ['npz', 'kaldi'])
@pytest.mark.parametrize('direction', ['jax to port', 'port to jax'])
def test_model_files_interchange(tmp_path, kind, direction):
    jgmm_model = trained_jax_gmm()
    path = str(tmp_path / f'ubm.{kind}')
    if direction == 'jax to port':
        writer = jubm.DiagUbmProcessor(5)
        writer.gmm = jgmm_model
        reader = DiagUbmProcessor
    else:
        writer = DiagUbmProcessor(5)
        writer.gmm = DiagGmm(jgmm_model.weights, jgmm_model.means,
                             jgmm_model.inv_vars)
        reader = jubm.DiagUbmProcessor
    (writer.save if kind == 'npz' else writer.save_kaldi)(path)
    assert kaldiio.is_kaldi_binary(path) == (kind == 'kaldi')
    loaded = reader.load(path)
    # the Kaldi stream stores float32
    tol = 1e-6 if kind == 'kaldi' else 0
    for name in ('weights', 'means', 'inv_vars'):
        close(getattr(loaded.gmm, name), getattr(jgmm_model, name),
              rtol=tol, atol=tol)
    with pytest.raises(OSError, match='already exists'):
        (writer.save if kind == 'npz' else writer.save_kaldi)(path)


def test_kaldi_codec_matches(tmp_path):
    """The port's copy of the codec writes the JAX package's bytes."""
    jgmm_model = trained_jax_gmm()
    written = []
    for name, module in (('ours', kaldiio), ('theirs', jkaldiio)):
        path = str(tmp_path / name)
        module.write_diag_gmm(path, jgmm_model.weights, jgmm_model.means,
                              jgmm_model.inv_vars)
        with open(path, 'rb') as stream:
            written.append(stream.read())
    assert written[0] == written[1]


def test_gmm_from_numpy():
    """JAX-trained parameters carried into the port give the JAX
    package's log-likelihoods and gaussian selections."""
    theirs = jubm.DiagUbmProcessor(
        4, num_iters=1, num_iters_init=2, num_frames=1000)
    deterministic(theirs).process(JUtterances(ENTRIES))
    carried = gmm_from_numpy(
        theirs.gmm.weights, theirs.gmm.means, theirs.gmm.inv_vars)
    feats = frames(dim=39, seed=8)
    # the port scores in float64 (GMM_DTYPE), the JAX package in float32
    ours = gmm.gaussian_selection(
        torch.as_tensor(feats, dtype=torch.float64),
        *carried.as_tensors('cpu'), 3)
    ref = jgmm.gaussian_selection(jnp.asarray(feats), *theirs.gmm.as_jax(), 3)
    close(ours[0].numpy(), np.asarray(ref[0]))
    assert np.array_equal(ours[1].numpy(), np.asarray(ref[1]))
    close(gmm.log_likelihoods(
        torch.as_tensor(feats, dtype=torch.float64),
        *carried.as_tensors('cpu')).numpy(),
        np.asarray(jgmm.log_likelihoods(
            jnp.asarray(feats), *theirs.gmm.as_jax())))
    with pytest.raises(ValueError, match='inconsistent'):
        gmm_from_numpy(np.ones(3), np.ones((2, 4)), np.ones((2, 4)))


def test_validation(tmp_path):
    with pytest.raises(ValueError, match='at least 2'):
        DiagUbmProcessor(1)
    with pytest.raises(TypeError, match='must be a dict'):
        DiagUbmProcessor(2, vad='nope')
    with pytest.raises(ValueError, match='Unknown parameters'):
        DiagUbmProcessor(2, vad={'bad': 1})
    with pytest.raises(ValueError, match='mfcc'):
        DiagUbmProcessor(2, features={'plp': {}})
    assert DiagUbmProcessor(8).get_params() == jubm.DiagUbmProcessor(
        8).get_params()
    with pytest.raises(TypeError, match='not initialized'):
        DiagUbmProcessor(2).accumulate(collections()[0], device='cpu')
    with pytest.raises(OSError, match='not found'):
        DiagUbmProcessor.load(str(tmp_path / 'nope.npz'))
    zero = DiagUbmProcessor(2)
    zero.gmm = DiagGmm([1.0, 0.0], np.zeros((2, 3)), np.ones((2, 3)))
    zero.save(str(tmp_path / 'zero.npz'))
    with pytest.raises(ValueError, match='zero-weight'):
        DiagUbmProcessor.load(str(tmp_path / 'zero.npz'))


def test_frontend_gate(tmp_path):
    """The fused front-end serves MFCC (+ deltas, sliding CMVN) corpora
    of one sample rate; other configurations take the staged one."""
    config = copy.deepcopy(DiagUbmProcessor(2).features)
    assert ubm.fused_frontend_supported(config, Utterances(ENTRIES))
    config['pitch'] = {'processor': 'kaldi'}
    assert not ubm.fused_frontend_supported(config, Utterances(ENTRIES))
    assert ubm.stream_frontend(
        config, DiagUbmProcessor(2).vad, 5, Utterances(ENTRIES),
        device='cpu') is None
