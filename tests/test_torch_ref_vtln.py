"""Counterpart of ``tests/processor/test_vtln.py``, case for case: the
port's LVTLN statistics, solves and ``VtlnProcessor`` on the CPU, on
the conftest's signal and the JAX cases' synthetic models, with their
checks and bounds (``tests/test_torch_vtln.py`` holds the same
operations against the JAX package on other inputs).

``test_fused_mapping_stats_match_fallback`` missed the JAX bound
(2.44e-3 against 2e-3) while the device-reduced moments were float32;
they are float64 now (ROADMAP C10).
``test_fused_mapping_stats_against_float64_solve`` holds both routes
against a float64 least-squares solve on the same features.
"""

import numpy as np
import pytest
import torch

from shennong_tpu_torch import Utterances
from shennong_tpu_torch.ops.fmllr import (
    FmllrStats, LinearVtln, apply_transform_to_stats, auxf,
    compute_mapping_transform, solve_diagonal, solve_offset)
from shennong_tpu_torch.processor.ubm import DiagGmm, DiagUbmProcessor
from shennong_tpu_torch.processor.vtln import VtlnProcessor


@pytest.fixture(scope='module')
def utterances(wav_file):
    return Utterances([
        ('u1', wav_file, 's1', 0.0, 0.7),
        ('u2', wav_file, 's2', 0.7, 1.4)])


def test_params_validation():
    proc = VtlnProcessor()
    assert proc.num_iters == 15
    assert proc.min_warp == 0.85
    assert proc.max_warp == 1.25
    with pytest.raises(ValueError, match='Invalid norm type'):
        VtlnProcessor(norm_type='bad')
    with pytest.raises(TypeError, match='must be a dict'):
        VtlnProcessor(ubm=3)
    with pytest.raises(ValueError, match='Unknown parameters'):
        VtlnProcessor(ubm={'bad_key': 1})
    with pytest.raises(ValueError, match='mfcc'):
        VtlnProcessor(features={'plp': {}})


def test_process_validation(utterances):
    with pytest.raises(ValueError, match='group_by'):
        VtlnProcessor().process(utterances, group_by='nope', device='cpu')
    with pytest.raises(ValueError, match='by_speaker'):
        VtlnProcessor(by_speaker=False).process(
            utterances, group_by='speaker', device='cpu')
    with pytest.raises(ValueError, match='Min warp'):
        VtlnProcessor(min_warp=1.2, max_warp=1.0).process(
            utterances, device='cpu')
    no_spk = Utterances([(u.name, u.audio_file) for u in utterances])
    with pytest.raises(ValueError, match='speaker information'):
        VtlnProcessor(by_speaker=True).process(no_spk, device='cpu')


def _toy_gmm(dim=3):
    rng = np.random.RandomState(0)
    return DiagGmm(
        np.array([0.5, 0.5]), rng.randn(2, dim),
        np.abs(rng.randn(2, dim)) + 0.5)


def test_fmllr_stats_identity_optimum():
    """With untransformed data the offset solution is near zero and
    the identity transform is near-optimal."""
    rng = np.random.RandomState(1)
    gmm = _toy_gmm()
    feats = np.repeat(gmm.means, 100, axis=0) + rng.randn(200, 3) * 0.1
    indices = np.repeat(
        np.array([[0], [1]]), 100, axis=0).astype(np.int32)
    values = np.ones((200, 1))

    stats = FmllrStats(3)
    stats.accumulate(feats, indices, values, gmm)
    assert stats.beta == pytest.approx(200)

    offset = solve_offset(stats)
    # data is drawn from the model: offsets should be small
    assert np.abs(offset[:, 3]).max() < 0.2

    # the optimal offset cannot be worse than identity
    identity = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    assert auxf(offset, stats) >= auxf(identity, stats) - 1e-6

    # the diagonal solution is a local maximum of the auxiliary
    # function: any perturbation of its parameters lowers it
    diag = solve_diagonal(stats)
    best = auxf(diag, stats)
    rng2 = np.random.RandomState(0)
    for _ in range(20):
        perturbed = diag.copy()
        d = rng2.randint(3)
        perturbed[d, d] += rng2.randn() * 0.05
        perturbed[d, 3] += rng2.randn() * 0.05
        assert auxf(perturbed, stats) <= best + 1e-9


def test_apply_transform_to_stats():
    """auxf(W, transformed stats) == auxf(W o A, original stats) minus
    the beta log|det A| term."""
    rng = np.random.RandomState(2)
    gmm = _toy_gmm()
    feats = rng.randn(100, 3)
    indices = rng.randint(0, 2, (100, 1)).astype(np.int32)
    values = np.ones((100, 1))
    stats = FmllrStats(3)
    stats.accumulate(feats, indices, values, gmm)

    A = np.eye(3) + rng.randn(3, 3) * 0.1
    transformed = apply_transform_to_stats(A, stats)

    W = np.concatenate([np.eye(3), rng.randn(3, 1) * 0.1], axis=1)
    combined = np.concatenate([W[:, :3] @ A, W[:, 3:]], axis=1)

    # quadratic parts must agree; the logdet parts differ by log|A|
    sign, logdet_a = np.linalg.slogdet(A)
    assert auxf(W, transformed) + stats.beta * logdet_a == \
        pytest.approx(auxf(combined, stats), rel=1e-10)


def test_compute_mapping_transform_recovers_linear_map():
    """The LS fit recovers a known linear map."""
    rng = np.random.RandomState(3)
    x = rng.randn(500, 3)
    true_map = np.eye(3) + rng.randn(3, 3) * 0.2
    y = x @ true_map.T

    fitted = compute_mapping_transform([(x, y, None)], 3)
    # rows are recovered up to the per-dimension variance
    # normalization: directions match the true map
    for d in range(3):
        cos = (fitted[d] @ true_map[d]) / (
            np.linalg.norm(fitted[d]) * np.linalg.norm(true_map[d]))
        assert cos == pytest.approx(1.0, abs=1e-6)
    # and the mapped features have the same per-dim variance as x
    mapped = x @ fitted.T
    assert np.allclose(mapped.var(axis=0), x.var(axis=0), rtol=1e-6)


def test_linear_vtln_picks_matching_class():
    """compute_transform selects the class whose transform matches
    how the data was generated."""
    rng = np.random.RandomState(4)
    gmm = _toy_gmm()
    lv = LinearVtln(3, 3, 1)
    # volume-preserving class maps (like Kaldi's variance-normalized
    # base transforms, class selection carries no logdet term)
    scale_maps = [
        np.diag([s, 1.0 / s, 1.0]) for s in (0.8, 1.0, 1.25)]
    for c, mat in enumerate(scale_maps):
        lv.set_transform(c, mat)
        lv.set_warp(c, [0.9, 1.0, 1.1][c])

    # draw data exactly from the GMM, then 'unwarp' it with the
    # inverse of class 2: the best class to re-warp it is class 2
    comps = rng.randint(0, 2, 400)
    stds = 1.0 / np.sqrt(gmm.inv_vars)
    clean = gmm.means[comps] + rng.randn(400, 3) * stds[comps]
    feats = clean @ np.linalg.inv(scale_maps[2]).T

    indices = comps[:, None].astype(np.int32)
    values = np.ones((400, 1))
    stats = FmllrStats(3)
    stats.accumulate(feats, indices, values, gmm)

    class_idx, _, transform, impr, count = lv.compute_transform(
        stats, 'offset', 0.0)
    assert class_idx == 2
    assert impr > 0
    assert count == pytest.approx(400)
    assert transform.shape == (3, 4)


def test_process_end_to_end(utterances):
    """Full VTLN training on a small warp range returns plausible
    warps for both speakers."""
    vtln = VtlnProcessor(
        num_iters=2, min_warp=0.95, max_warp=1.05, warp_step=0.05,
        subsample=2,
        ubm={'num_gauss': 4, 'num_iters': 1, 'num_iters_init': 2,
             'num_frames': 1000})
    warps = vtln.process(utterances, device='cpu')
    assert sorted(warps.keys()) == ['u1', 'u2']
    for warp in warps.values():
        assert 0.95 <= warp <= 1.05

    # warps can be saved/loaded as yaml
    assert isinstance(vtln.warps, dict)


def test_save_load_warps(tmpdir):
    vtln = VtlnProcessor()
    vtln.warps = {'u1': 1.0, 'u2': 0.95}
    path = str(tmpdir.join('warps.yaml'))
    vtln.save_warps(path)
    assert VtlnProcessor.load_warps(path) == vtln.warps
    with pytest.raises(OSError, match='already exists'):
        vtln.save_warps(path)
    with pytest.raises(OSError, match='not found'):
        VtlnProcessor.load_warps(str(tmpdir.join('nope.yaml')))


def test_save_load_lvtln(tmpdir):
    vtln = VtlnProcessor()
    with pytest.raises(TypeError, match='not initialized'):
        vtln.save(str(tmpdir.join('lvtln.npz')))
    vtln.lvtln = LinearVtln(5, 3, 1)
    path = str(tmpdir.join('lvtln.npz'))
    vtln.save(path)
    loaded = VtlnProcessor.load(path)
    assert loaded.lvtln.dim == 5
    assert loaded.lvtln.num_classes == 3


def test_process_full_warp_grid(utterances):
    """The default 41-class warp grid end to end (tiny UBM)."""
    vtln = VtlnProcessor(
        num_iters=1, subsample=5,
        ubm={'num_gauss': 4, 'num_iters': 1, 'num_iters_init': 2,
             'num_frames': 1000})
    assert int(1.5 + (vtln.max_warp - vtln.min_warp)
               / vtln.warp_step) == 41
    warps = vtln.process(utterances, device='cpu')
    assert sorted(warps.keys()) == ['u1', 'u2']
    for warp in warps.values():
        assert 0.85 <= warp <= 1.25
    assert vtln.lvtln.num_classes == 41


@pytest.fixture(scope='module')
def mapping_routes(utterances):
    """The two routes to the LVTLN base transforms on the JAX case's
    input (dither 0, delta window 3, VAD then every second frame, warps
    0.9 / 1.0 / 1.1): the device-reduced moments and their transforms,
    and the materialized unwarped and warped collections."""
    from shennong_tpu_torch import pipeline, FeaturesCollection
    from shennong_tpu_torch.logger import null_logger
    from shennong_tpu_torch.ops.fmllr import solve_mapping_from_moments
    from shennong_tpu_torch.postprocessor.vad import VadPostProcessor

    config = pipeline.get_default_config('mfcc', with_delta=True)
    config['mfcc']['dither'] = 0
    config['delta']['window'] = 3
    subsample = 2
    class_warps = [0.9, 1.0, 1.1]

    raw = pipeline.extract_features(
        config, utterances, log=null_logger(), device='cpu')
    vad = {
        utt: d.data.reshape(-1).astype(bool)
        for utt, d in VadPostProcessor(energy_threshold=5.5).process_all(
            raw, device='cpu').items()}

    keep = {}
    for utt, mask in vad.items():
        rank = np.cumsum(mask) - 1
        keep[utt] = (mask & (rank % subsample == 0)).astype(np.float32)

    moments = pipeline.accumulate_warp_mapping_stats(
        config, utterances, class_warps, keep, null_logger(),
        device='cpu')

    # fallback: materialize the warped collections, trim + subsample
    unwarped = FeaturesCollection({
        u: f.copy(subsample=subsample)
        for u, f in raw.trim(vad).items()})
    collections = pipeline.extract_features_warp_classes(
        config, utterances, class_warps, null_logger(), device='cpu')
    warped = [
        FeaturesCollection({
            u: f.copy(subsample=subsample)
            for u, f in collection.trim(vad).items()})
        for collection in collections]
    return {'moments': moments,
            'fused': solve_mapping_from_moments(moments),
            'unwarped': unwarped, 'warped': warped}


def test_fused_mapping_stats_match_fallback(mapping_routes):
    """The device-fused LS statistics path produces the same base
    transforms as materializing the warped collections and solving
    with compute_mapping_transform (dither=0)."""
    fused = mapping_routes['fused']
    unwarped = mapping_routes['unwarped']
    dim = fused.shape[1]
    for c, warped in enumerate(mapping_routes['warped']):
        pairs = [
            (unwarped[u].data, warped[u].data, None) for u in unwarped]
        expected = compute_mapping_transform(iter(pairs), dim)
        diff = np.abs(fused[c] - expected)
        assert diff.max() < 2e-3, c
        assert np.median(diff) < 1e-5, c

    # the total selected weight equals the trimmed+subsampled rows
    beta = sum(float(m[0]) for m in mapping_routes['moments'])
    assert beta == sum(unwarped[u].nframes for u in unwarped)


def test_fused_mapping_stats_against_float64_solve(mapping_routes):
    """Both routes against a float64 least-squares solve (QR, then the
    per-dimension variance normalization of compute_mapping_transform)
    on the same materialized features, under the JAX case's bounds; the
    distances are printed (``pytest -s``). With float32
    moments the fused route was 2.4e-3 from this solve at warp 1.1 and
    the materialized one 1e-10 (ROADMAP C10)."""
    fused = mapping_routes['fused']
    unwarped = mapping_routes['unwarped']
    dim = fused.shape[1]
    x = np.concatenate([unwarped[u].data for u in unwarped]).astype(
        np.float64)
    xplus = np.concatenate([x, np.ones((len(x), 1))], axis=1)
    for c, warped in enumerate(mapping_routes['warped']):
        y = np.concatenate([warped[u].data for u in unwarped]).astype(
            np.float64)
        solution = np.linalg.lstsq(xplus, y, rcond=None)[0]
        reference = solution[:dim].T * np.sqrt(
            x.var(axis=0) / (xplus @ solution).var(axis=0))[:, None]
        materialized = compute_mapping_transform(
            [(unwarped[u].data, warped[u].data, None) for u in unwarped],
            dim)
        for route, transform in (('fused', fused[c]),
                                 ('materialized', materialized)):
            diff = np.abs(transform - reference)
            print(f'{route} class {c}: max {diff.max():.4g}, median '
                  f'{np.median(diff):.4g} from the float64 solve')
            assert diff.max() < 2e-3, (route, c, diff.max())
            assert np.median(diff) < 1e-5, (route, c, np.median(diff))


def test_fmllr_stats_groups_match_host():
    """The one-program grouped fMLLR accumulation equals per-group
    float64 host accumulation (Kaldi AffineXformStats semantics)."""
    from shennong_tpu_torch.ops.fmllr import fmllr_stats_groups

    rng = np.random.RandomState(0)
    dim, ngauss, k, n, nspk = 5, 8, 3, 300, 3
    gmm = DiagGmm(
        np.full(ngauss, 1.0 / ngauss),
        rng.randn(ngauss, dim),
        1.0 / (0.5 + rng.rand(ngauss, dim)))
    feats = rng.randn(n, dim).astype(np.float32)
    idx = rng.randint(0, ngauss, size=(n, k)).astype(np.int32)
    val = rng.rand(n, k).astype(np.float32)
    val /= val.sum(axis=1, keepdims=True)
    gid = rng.randint(0, nspk, size=n).astype(np.int32)

    beta, K, G = fmllr_stats_groups(
        *[torch.from_numpy(a) for a in (feats, idx, val, gid)],
        torch.as_tensor(gmm.means, dtype=torch.float32),
        torch.as_tensor(gmm.inv_vars, dtype=torch.float32), nspk)

    for s in range(nspk):
        rows = gid == s
        expected = FmllrStats(dim)
        expected.accumulate(feats[rows], idx[rows], val[rows], gmm)
        assert float(beta[s]) == pytest.approx(expected.beta, rel=1e-5)
        assert np.abs(np.asarray(K[s]) - expected.K).max() < 1e-3
        assert np.abs(np.asarray(G[s]) - expected.G).max() < 1e-3


def test_fused_rounds_match_host(utterances, monkeypatch):
    """The single-program LVTLN loop (ops.fmllr.lvtln_rounds)
    reproduces the host-orchestrated rounds: same class decisions,
    same warps, transforms equal to float32 accumulation error."""
    from shennong_tpu_torch import pipeline

    def make_vtln():
        feat_config = pipeline.get_default_config(
            'mfcc', with_delta=True)
        feat_config['mfcc']['dither'] = 0
        feat_config['delta']['window'] = 3
        from shennong_tpu_torch.postprocessor.cmvn import \
            SlidingWindowCmvnPostProcessor
        feat_config['sliding_window_cmvn'] = (
            SlidingWindowCmvnPostProcessor().get_params())
        feat_config['sliding_window_cmvn']['cmn_window'] = 300

        ubm_feats = pipeline.get_default_config(
            'mfcc', with_delta=True)
        ubm_feats['mfcc']['dither'] = 0
        ubm_feats['delta']['window'] = 3
        ubm_feats['sliding_window_cmvn'] = (
            SlidingWindowCmvnPostProcessor().get_params())
        ubm_feats['sliding_window_cmvn']['cmn_window'] = 300
        return VtlnProcessor(
            num_iters=3, min_warp=0.9, max_warp=1.1, warp_step=0.05,
            subsample=2, features=feat_config,
            ubm={'num_gauss': 4, 'num_iters': 1, 'num_iters_init': 2,
                 'num_frames': 1000, 'seed': 0, 'features': ubm_feats})

    fused = make_vtln()
    warps_fused = fused.process(utterances, device='cpu')

    host = make_vtln()
    monkeypatch.setattr(
        VtlnProcessor, '_train_rounds_fused',
        VtlnProcessor._train_rounds_host)
    warps_host = host.process(utterances, device='cpu')

    assert warps_fused == warps_host
    assert fused.transforms.keys() == host.transforms.keys()
    for key in fused.transforms:
        np.testing.assert_allclose(
            fused.transforms[key], host.transforms[key],
            atol=2e-3, rtol=1e-3)


def test_accumulate_group_stats_all_empty_groups():
    """A caller owning no utterances (a distributed process whose
    shard is empty or entirely unvoiced) gets zero statistics for
    every group instead of a np.concatenate crash — its peers hold
    the data, and the zero stats merge through the collective."""
    from shennong_tpu_torch.ops.fmllr import LinearVtln

    dim = 5
    vtln = VtlnProcessor()
    vtln.lvtln = LinearVtln(dim, num_classes=3, default_class=1)
    gmm = DiagGmm(
        np.full(2, 0.5), np.zeros((2, dim)), np.ones((2, dim)))
    ubm = DiagUbmProcessor(num_gauss=2)
    ubm.gmm = gmm

    stats = vtln._accumulate_group_stats(
        ubm, {}, {}, {'spk0': [], 'spk1': []}, device='cpu')
    assert sorted(stats) == ['spk0', 'spk1']
    for group in stats:
        assert stats[group].beta == 0
        np.testing.assert_array_equal(
            stats[group].K, np.zeros((dim, dim + 1)))


def test_save_load_lvtln_without_npz_extension(tmpdir):
    """LinearVtln.save must honor the exact filename (np.savez with a
    bare path appends '.npz' for other extensions)."""
    import os

    vtln = VtlnProcessor()
    vtln.lvtln = LinearVtln(5, 3, 1)
    path = str(tmpdir.join('model.lvtln'))
    vtln.save(path)
    assert os.path.isfile(path)
    loaded = VtlnProcessor.load(path)
    assert loaded.lvtln.dim == 5


def test_estimate_rejects_unmapped_utterances():
    """estimate() must raise on utterances missing from utt2speak
    (the reference's partition raises 'not defined in the partition
    index') instead of silently dropping them from every group."""
    from shennong_tpu_torch import Features, FeaturesCollection
    from shennong_tpu_torch.ops.fmllr import LinearVtln

    dim = 4
    vtln = VtlnProcessor()
    vtln.lvtln = LinearVtln(dim, num_classes=3, default_class=1)
    gmm = DiagGmm(
        np.full(2, 0.5), np.zeros((2, dim)), np.ones((2, dim)))
    ubm = DiagUbmProcessor(num_gauss=2)
    ubm.gmm = gmm

    data = np.zeros((5, dim))
    times = np.arange(5, dtype=float)[:, None] * [1, 1] * 0.01
    fc = FeaturesCollection(
        {'u1': Features(data, times), 'u2': Features(data, times)})
    posteriors = {
        name: (np.zeros((5, 2), np.int32), np.full((5, 2), 0.5))
        for name in fc}
    with pytest.raises(ValueError, match='not defined in the partition'):
        vtln.estimate(
            ubm, fc, posteriors, {'u1': 'spkA'}, device='cpu')
