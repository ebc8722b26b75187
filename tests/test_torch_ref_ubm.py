"""Counterpart of ``tests/processor/test_ubm.py``, case for case: the
port's UBM-GMM trainer and GMM operations on the CPU, on the conftest's
signal and the JAX cases' synthetic clusters, with their checks and
bounds. ``tests/test_torch_ubm.py`` holds the same operations against
the JAX package on other inputs.

The port trains and scores the GMM in float64
(``processor/ubm.py:GMM_DTYPE``, ROADMAP C5): the cases that hand the
JAX operations float32 models hand the port's its float64 ones
(``DiagGmm.as_tensors``); the bounds are the JAX cases'.
"""

import numpy as np
import pytest
import torch

from shennong_tpu_torch import Features, FeaturesCollection, Utterances
from shennong_tpu_torch.ops import gmm as gmm_ops
from shennong_tpu_torch.processor.ubm import (
    GMM_DTYPE, DiagGmm, DiagUbmProcessor)


@pytest.fixture(scope='module')
def utterances(wav_file):
    return Utterances([
        ('u1', wav_file, 's1', 0.0, 0.7),
        ('u2', wav_file, 's1', 0.7, 1.4)])


@pytest.fixture
def gmm_data():
    """Synthetic 2-cluster data with a known structure."""
    rng = np.random.RandomState(0)
    a = rng.randn(500, 4) * 0.5 + np.array([2, 0, 0, 0])
    b = rng.randn(500, 4) * 0.5 - np.array([2, 0, 0, 0])
    return np.vstack([a, b]).astype(np.float32)


def test_params_validation():
    with pytest.raises(ValueError, match='at least 2'):
        DiagUbmProcessor(1)
    with pytest.raises(TypeError, match='must be a dict'):
        DiagUbmProcessor(2, vad='nope')
    with pytest.raises(ValueError, match='Unknown parameters'):
        DiagUbmProcessor(2, vad={'bad': 1})
    with pytest.raises(ValueError, match='mfcc'):
        DiagUbmProcessor(2, features={'plp': {}})
    proc = DiagUbmProcessor(8)
    assert 'mfcc' in proc.features
    assert 'sliding_window_cmvn' in proc.features


def test_gmm_ops_loglike(gmm_data):
    """GMM log-likelihoods match a direct computation."""
    weights = np.array([0.4, 0.6])
    means = np.array([[2.0, 0, 0, 0], [-2.0, 0, 0, 0]])
    inv_vars = np.full((2, 4), 4.0)

    ll = gmm_ops.log_likelihoods(
        torch.from_numpy(gmm_data),
        *(torch.as_tensor(a, dtype=torch.float32)
          for a in (weights, means, inv_vars))).numpy()

    # direct per-frame computation
    x = gmm_data[7]
    for g in range(2):
        direct = (
            np.log(weights[g])
            + np.sum(-0.5 * np.log(2 * np.pi / inv_vars[g])
                     - 0.5 * (x - means[g]) ** 2 * inv_vars[g]))
        assert ll[7, g] == pytest.approx(direct, abs=1e-3)


def test_em_recovers_clusters(gmm_data):
    """A 2-gaussian EM separates the two synthetic clusters."""
    rng = np.random.RandomState(1)
    gmm = DiagGmm(
        np.array([0.5, 0.5]),
        gmm_data[rng.choice(1000, 2)],
        np.ones((2, 4)))

    for _ in range(10):
        _, occ, mean_acc, var_acc = gmm_ops.accumulate_stats(
            torch.as_tensor(gmm_data, dtype=GMM_DTYPE),
            torch.ones(1000, dtype=GMM_DTYPE), *gmm.as_tensors('cpu'))
        gmm = DiagGmm(*gmm_ops.mle_update(
            occ, mean_acc, var_acc, gmm.weights, gmm.means,
            gmm.inv_vars))

    centers = sorted(gmm.means[:, 0])
    assert centers[0] == pytest.approx(-2, abs=0.2)
    assert centers[1] == pytest.approx(2, abs=0.2)
    assert np.allclose(gmm.weights, 0.5, atol=0.05)


def test_split():
    rng = np.random.RandomState(0)
    weights, means, inv_vars = gmm_ops.split_gmm(
        np.array([0.6, 0.4]), np.zeros((2, 3)), np.ones((2, 3)),
        4, 0.1, rng)
    assert weights.shape == (4,)
    assert weights.sum() == pytest.approx(1.0)
    assert means.shape == (4, 3)


def test_process(utterances):
    ubm = DiagUbmProcessor(
        4, num_iters=2, num_iters_init=4, num_frames=1000)
    ubm.process(utterances, device='cpu')
    assert isinstance(ubm.gmm, DiagGmm)
    assert ubm.gmm.num_gauss() == 4
    assert ubm.gmm.dim() == 39  # mfcc 13 * delta order 2
    assert np.all(np.isfinite(ubm.gmm.means))
    assert np.all(ubm.gmm.inv_vars > 0)
    assert ubm.gmm.weights.sum() == pytest.approx(1.0)


def test_save_load(tmpdir, utterances):
    ubm = DiagUbmProcessor(
        4, num_iters=1, num_iters_init=2, num_frames=1000)
    ubm.process(utterances, device='cpu')
    path = str(tmpdir.join('ubm.npz'))
    ubm.save(path)
    loaded = DiagUbmProcessor.load(path)
    assert np.array_equal(loaded.gmm.means, ubm.gmm.means)
    assert np.array_equal(loaded.gmm.weights, ubm.gmm.weights)
    with pytest.raises(OSError, match='already exists'):
        ubm.save(path)
    with pytest.raises(OSError, match='not found'):
        DiagUbmProcessor.load(str(tmpdir.join('nope.npz')))


def test_selection_and_posteriors(utterances):
    ubm = DiagUbmProcessor(
        4, num_iters=1, num_iters_init=2, num_frames=1000,
        num_gselect=2)
    ubm.process(utterances, device='cpu')

    rng = np.random.RandomState(3)
    fc = FeaturesCollection(
        u1=Features(
            rng.randn(50, 39).astype(np.float32), np.arange(50.0)))

    ubm.selection = None
    ubm.gaussian_selection(fc, device='cpu')
    assert ubm.selection['u1'].shape == (50, 2)

    posteriors = ubm.gaussian_selection_to_post(fc, device='cpu')
    indices, post = posteriors['u1']
    assert post.shape == (50, 2)
    assert np.allclose(post.sum(axis=1), 1.0, atol=1e-5)

    # pruning keeps normalization
    posteriors = ubm.gaussian_selection_to_post(
        fc, min_post=0.4, device='cpu')
    _, post = posteriors['u1']
    assert np.allclose(post.sum(axis=1), 1.0, atol=1e-5)
    assert np.all((post == 0) | (post >= 0.4) | (post == 1.0))


def test_accumulate_validation(utterances):
    ubm = DiagUbmProcessor(2)
    fc = FeaturesCollection(
        u1=Features(np.zeros((5, 3)), np.arange(5.0)))
    with pytest.raises(TypeError, match='not initialized'):
        ubm.accumulate(fc, device='cpu')


def test_em_steps_matches_repeated_em_step(gmm_data):
    """The multi-iteration call equals iterated em_step."""
    feats = torch.from_numpy(gmm_data)
    rng = np.random.RandomState(1)
    weights = np.full(4, 0.25)
    means = rng.randn(4, feats.shape[1])
    inv_vars = np.ones((4, feats.shape[1]))
    fw = torch.ones(feats.shape[0], dtype=torch.float32)
    params = [torch.as_tensor(a, dtype=torch.float32)
              for a in (weights, means, inv_vars)]

    params_loop = params
    like_loop = None
    for _ in range(3):
        like_loop, *params_loop = gmm_ops.em_step(feats, fw, *params_loop)

    like_fused, *params_fused = gmm_ops.em_steps(
        feats, fw, *params, num_iters=3)

    assert np.allclose(float(like_loop), float(like_fused), rtol=1e-6)
    for a, b in zip(params_loop, params_fused):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_gaussian_selection_refines_within_previous(utterances):
    # a second selection pass restricts to the first pass's subset
    # (Kaldi gmm-gselect --gselect, reference ubm.py:472-480)
    ubm = DiagUbmProcessor(
        4, num_iters=1, num_iters_init=2, num_frames=1000,
        num_gselect=3)
    ubm.process(utterances, device='cpu')

    rng = np.random.RandomState(7)
    fc = FeaturesCollection(
        u1=Features(
            rng.randn(40, 39).astype(np.float32), np.arange(40.0)))

    ubm.selection = None
    ubm.gaussian_selection(fc, device='cpu')
    first = np.array(ubm.selection['u1'])

    # refine with a smaller k: every refined index must come from the
    # first pass's per-frame subset
    ubm.num_gselect = 2
    ubm.gaussian_selection(fc, device='cpu')
    second = np.array(ubm.selection['u1'])
    assert second.shape == (40, 2)
    for row in range(40):
        assert set(second[row]).issubset(set(first[row]))

    # wrong-size preselect raises (reference error message)
    ubm.selection = {'u1': first[:10]}
    with pytest.raises(ValueError, match='wrong size'):
        ubm.gaussian_selection(fc, device='cpu')


def test_num_iters_init_zero(utterances):
    # skipping the init EM entirely must not divide by zero
    ubm = DiagUbmProcessor(
        4, num_iters=1, num_iters_init=0, num_frames=1000)
    ubm.process(utterances, device='cpu')
    assert ubm.gmm is not None


def test_frontend_falls_back_on_extra_config(utterances, wav_file):
    """Configs with stages beyond mfcc/delta/sliding CMVN must take
    the staged path (the fused front-end would silently drop them)."""
    from shennong_tpu_torch.pipeline import get_default_config
    from shennong_tpu_torch.processor.ubm import stream_frontend

    config = get_default_config('mfcc', with_delta=True)
    config['pitch'] = get_default_config(
        'mfcc', with_pitch='kaldi')['pitch']
    ubm = DiagUbmProcessor(2, features=config)
    assert stream_frontend(
        ubm.features, ubm.vad, ubm.subsample, utterances,
        device='cpu') is None
    # the staged path still trains (pitch columns included)
    ubm.num_iters, ubm.num_iters_init = 1, 2
    ubm.num_frames = 1000
    ubm.process(utterances, device='cpu')
    assert ubm.gmm is not None
    assert ubm.gmm.dim() == 42  # 13 mfcc x3 + 3 pitch


def test_frontend_falls_back_on_mixed_rates(tmp_path, wav_file):
    """A mixed-sample-rate corpus must not crash the fused gate."""
    import scipy.io.wavfile

    from shennong_tpu_torch.processor.ubm import stream_frontend

    rng = np.random.RandomState(0)
    low = tmp_path / 'low.wav'
    scipy.io.wavfile.write(
        str(low), 8000, (rng.randn(8000) * 3000).astype(np.int16))
    utts = Utterances([
        ('a', wav_file, 's1', 0.0, 1.0),
        ('b', str(low), 's2', 0.0, 1.0)])
    ubm = DiagUbmProcessor(2)
    assert stream_frontend(
        ubm.features, ubm.vad, ubm.subsample, utts,
        device='cpu') is None


def test_device_frontend_matches_staged_training(utterances):
    """Training through the fused device front-end must agree with
    the staged path (same frames, same selection semantics; only
    float32-vs-float64 reduction order differs)."""
    def train(force_staged):
        ubm = DiagUbmProcessor(
            4, num_iters=2, num_iters_init=4, num_frames=10000, seed=7)
        # dither off so both paths see identical signals
        ubm.features['mfcc']['dither'] = 0.0
        if force_staged:
            import shennong_tpu_torch.processor.ubm as U
            orig = U.stream_frontend
            U.stream_frontend = lambda *a, **k: None
            try:
                ubm.process(utterances, device='cpu')
            finally:
                U.stream_frontend = orig
        else:
            ubm.process(utterances, device='cpu')
        return ubm.gmm

    device = train(force_staged=False)
    staged = train(force_staged=True)
    assert device.num_gauss() == staged.num_gauss()
    # identical frame set and RNG draws; float reduction order is the
    # only difference between the two paths
    np.testing.assert_allclose(
        np.sort(device.weights), np.sort(staged.weights),
        rtol=1e-3, atol=1e-4)
    order_d = np.argsort(device.means[:, 0])
    order_s = np.argsort(staged.means[:, 0])
    np.testing.assert_allclose(
        device.means[order_d], staged.means[order_s],
        rtol=5e-3, atol=5e-3)


def test_mle_update_floored_component_kaldi_weights():
    """Kaldi MleDiagGmmUpdate semantics for a starved component: its
    mean/variance stay untouched, its weight becomes
    max(occupancy share, min_gaussian_weight), and the vector is NOT
    renormalized (Kaldi only renormalizes on component removal)."""
    from shennong_tpu_torch.ops import gmm as gmm_ops

    occupancy = np.array([500.0, 2.0])  # second under min_occupancy
    dim = 3
    mean_acc = np.stack([
        np.full(dim, 1000.0), np.full(dim, 4.0)])
    var_acc = np.stack([
        np.full(dim, 4000.0), np.full(dim, 9.0)])
    weights = np.array([0.7, 0.3])
    means = np.stack([np.zeros(dim), np.full(dim, 7.0)])
    inv_vars = np.ones((2, dim))

    new_w, new_m, new_iv = gmm_ops.mle_update(
        occupancy, mean_acc, var_acc, weights, means, inv_vars,
        min_gaussian_weight=1e-4, min_gaussian_occupancy=10.0)

    # updated component: weight = occupancy share
    np.testing.assert_allclose(new_w[0], 500.0 / 502.0)
    # floored component: weight follows occupancy too (not the old
    # 0.3, and no renormalization of the vector)
    np.testing.assert_allclose(new_w[1], max(2.0 / 502.0, 1e-4))
    # floored component keeps mean/variance
    np.testing.assert_array_equal(new_m[1], means[1])
    np.testing.assert_array_equal(new_iv[1], inv_vars[1])

    # the device em_step applies the identical weight rule
    rng = np.random.RandomState(0)
    feats = np.concatenate([
        rng.randn(500, dim) + 5.0, rng.randn(2, dim) - 5.0]
        ).astype(np.float32)
    fw = np.ones(len(feats), np.float32)
    w0 = np.array([0.6, 0.4], np.float32)
    m0 = np.stack([np.full(dim, 5.0), np.full(dim, -5.0)]
                  ).astype(np.float32)
    iv0 = np.ones((2, dim), np.float32)
    tensors = [torch.from_numpy(a) for a in (feats, fw, w0, m0, iv0)]
    _, occ, macc, vacc = gmm_ops.accumulate_stats(*tensors)
    ref_w, _, _ = gmm_ops.mle_update(
        occ.numpy(), macc.numpy(), vacc.numpy(), w0, m0, iv0)
    _, dev_w, _, _ = gmm_ops.em_step(*tensors)
    np.testing.assert_allclose(
        np.asarray(dev_w), ref_w, rtol=1e-5, atol=1e-7)


def test_min_post_prunes_sequentially_like_reference():
    """min_post pruning renormalizes after EVERY component like the
    reference's loop (shennong/processor/ubm.py:559-568): zeroing an
    early component can lift later ones over the threshold, so
    [0.35, 0.35, 0.30] at min_post 0.4 keeps two components — a
    single global prune would empty the frame and fall back to its
    argmax."""
    from shennong_tpu_torch.processor.ubm import _prune_min_post

    post = np.array([
        [0.35, 0.35, 0.30],   # incremental: [0, 0.538, 0.462]
        [0.80, 0.15, 0.05],   # prune tail, keep leader
        [0.20, 0.20, 0.60],   # leader alone survives
    ])
    out = _prune_min_post(post, 0.4)
    np.testing.assert_allclose(
        out[0], [0.0, 0.35 / 0.65, 0.30 / 0.65], atol=1e-12)
    np.testing.assert_allclose(out[1], [1.0, 0.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(out[2], [0.0, 0.0, 1.0], atol=1e-12)

    # the literal reference loop as oracle on random frames
    rng = np.random.RandomState(0)
    raw = rng.rand(50, 7)
    raw /= raw.sum(axis=1, keepdims=True)
    ours = _prune_min_post(raw, 0.15)
    for i in range(raw.shape[0]):
        vec = raw[i].copy()
        max_index = int(np.argmax(vec))
        for j in range(len(vec)):
            if vec[j] < 0.15:
                vec[j] = 0.0
            total = vec.sum()
            if total == 0:
                vec[max_index] = 1.0
            else:
                vec = vec / total
        np.testing.assert_allclose(ours[i], vec, atol=1e-12, err_msg=i)


def test_init_loop_removes_low_count_gaussians(monkeypatch):
    """remove_low_count_gaussians applies during the init
    EM-with-splitting loop like the reference (whose init loop
    passes the user options to every MLE update,
    shennong/processor/ubm.py:361-365), not only at the final
    main-loop update — the trailing split restores the count, so the
    evidence is the removal events and the diverged trajectory."""
    from shennong_tpu_torch import Features, FeaturesCollection
    from shennong_tpu_torch.ops import gmm as gmm_ops

    rng = np.random.RandomState(0)
    # two tight clusters: 8 requested gaussians at a high weight
    # floor guarantee starved components after splitting
    data = np.concatenate([
        rng.randn(300, 4) * 0.1 + 5.0,
        rng.randn(300, 4) * 0.1 - 5.0]).astype(np.float32)
    times = np.arange(len(data), dtype=float)[:, None] * [1, 1] * 0.01
    fc = FeaturesCollection({'u1': Features(data, times)})

    removals = []
    real_update = gmm_ops.mle_update

    def spy(occ, *args, **kwargs):
        out = real_update(occ, *args, **kwargs)
        if (kwargs.get('remove_low_count_gaussians')
                and out[0].shape[0] < np.asarray(occ).shape[0]):
            removals.append(
                (np.asarray(occ).shape[0], out[0].shape[0]))
        return out

    monkeypatch.setattr(gmm_ops, 'mle_update', spy)

    def make(remove):
        return DiagUbmProcessor(
            num_gauss=8, num_iters_init=4, num_iters=1, seed=0,
            num_frames=1000, min_gaussian_weight=0.2,
            remove_low_count_gaussians=remove)

    removing = make(True)
    removing.initialize_gmm(fc, device='cpu')
    assert removals, 'no init-loop removal happened'

    keeping = make(False)
    keeping.initialize_gmm(fc, device='cpu')
    assert keeping.gmm.num_gauss() == 8
    # the removals changed the training trajectory
    assert (removing.gmm.num_gauss() != 8
            or not np.allclose(removing.gmm.means, keeping.gmm.means))


def test_em_step_keeps_padding_components_dead():
    """A component with exactly zero weight AND zero occupancy is the
    init loop's shape padding: the MLE update must not revive it at
    min_gaussian_weight (real starved components, which always carry
    a non-zero weight, do get the Kaldi floored weight)."""
    rng = np.random.RandomState(1)
    dim = 3
    feats = (rng.randn(200, dim) + 4.0).astype(np.float32)
    fw = np.ones(200, np.float32)
    # one live component + one zero-weight pad
    w0 = np.array([1.0, 0.0], np.float32)
    m0 = np.stack([np.full(dim, 4.0), np.zeros(dim)]).astype(np.float32)
    iv0 = np.ones((2, dim), np.float32)

    _, w1, m1, iv1 = gmm_ops.em_step(
        *[torch.from_numpy(a) for a in (feats, fw, w0, m0, iv0)])
    assert float(np.asarray(w1)[1]) == 0.0
    np.testing.assert_allclose(float(np.asarray(w1)[0]), 1.0)
    np.testing.assert_array_equal(np.asarray(m1)[1], m0[1])


def test_save_load_without_npz_extension(tmpdir):
    """save(path) must honor the exact filename: np.savez with a bare
    path silently appends '.npz', breaking both the round trip and
    the already-exists guard for any other extension."""
    import os

    ubm = DiagUbmProcessor(2)
    ubm.gmm = DiagGmm(
        np.array([0.5, 0.5]), np.zeros((2, 3)), np.ones((2, 3)))
    path = str(tmpdir.join('model.ubm'))
    ubm.save(path)
    assert os.path.isfile(path)
    loaded = DiagUbmProcessor.load(path)
    assert np.array_equal(loaded.gmm.means, ubm.gmm.means)
    with pytest.raises(OSError, match='already exists'):
        ubm.save(path)


def test_mle_update_all_starved_keeps_last_component():
    """When EVERY component is starved and removal is on, Kaldi's
    index-order removal loop (guarded by to_remove.size() <
    num_gauss-1) keeps the FINAL component — not the one with the
    highest occupancy."""
    from shennong_tpu_torch.ops import gmm as gmm_ops

    dim = 2
    occ = np.array([5.0, 2.0, 3.0])          # argmax is component 0
    weights = np.array([0.5, 0.2, 0.3])
    means = np.arange(3 * dim, dtype=np.float64).reshape(3, dim)
    inv_vars = np.ones((3, dim))
    mean_acc = means * occ[:, None]
    var_acc = (means ** 2 + 1.0) * occ[:, None]

    new_w, new_m, new_iv = gmm_ops.mle_update(
        occ, mean_acc, var_acc, weights, means, inv_vars,
        min_gaussian_occupancy=10.0,       # starves all three
        remove_low_count_gaussians=True)
    assert new_w.shape == (1,)
    # the survivor is component 2 (last index): its mean/variance are
    # kept untouched since it was not updatable
    np.testing.assert_array_equal(new_m[0], means[2])
    np.testing.assert_array_equal(new_iv[0], inv_vars[2])
