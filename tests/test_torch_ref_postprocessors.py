"""Counterpart of ``tests/postprocessor/test_postprocessors.py``, case
for case: the port's delta, CMVN, sliding-window CMVN and VAD
post-processors on the CPU, on the conftest's MFCC, against
``tests/kaldi_oracle.py`` with the JAX cases' bounds (deltas and
sliding-window CMVN max-abs 1e-3, VAD equal, CMVN's moments 1e-5 and
1e-4).
"""

import numpy as np
import pytest

from shennong_tpu_torch import Features, FeaturesCollection
from shennong_tpu_torch.postprocessor import (
    CmvnPostProcessor, DeltaPostProcessor,
    SlidingWindowCmvnPostProcessor, VadPostProcessor, apply_cmvn)

from tests import kaldi_oracle
from tests.torch_ref import audio, mfcc  # noqa: F401 (fixtures)


# -------------------------------------------------------------------- delta

def test_delta_shape_and_identity(mfcc):
    delta = DeltaPostProcessor(order=2).process(mfcc, device='cpu')
    assert delta.shape == (mfcc.nframes, mfcc.ndims * 3)
    assert np.array_equal(delta.data[:, :mfcc.ndims], mfcc.data)
    assert delta.properties['delta'] == {'order': 2, 'window': 2}
    assert delta.properties['pipeline'][-1]['columns'] == [0, 38]


@pytest.mark.parametrize('order,window', [(1, 2), (2, 2), (2, 3), (3, 1)])
def test_delta_oracle(mfcc, order, window):
    ours = DeltaPostProcessor(order=order, window=window).process(
        mfcc, device='cpu')
    ref = kaldi_oracle.compute_deltas(
        mfcc.data.astype(np.float64), order=order, window=window)
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours.data - ref)) < 1e-3


def test_delta_bad_window():
    with pytest.raises(ValueError, match='window'):
        DeltaPostProcessor(window=0)
    with pytest.raises(ValueError, match='window'):
        DeltaPostProcessor(window=1000)


# --------------------------------------------------------------------- cmvn

def test_cmvn_normalizes(mfcc):
    proc = CmvnPostProcessor(mfcc.ndims)
    proc.accumulate(mfcc)
    assert proc.count == mfcc.nframes
    cmvn = proc.process(mfcc)
    assert np.allclose(cmvn.data.mean(axis=0), 0, atol=1e-5)
    assert np.allclose(cmvn.data.var(axis=0), 1, atol=1e-4)
    # properties carry the stats
    assert np.array_equal(cmvn.properties['cmvn']['stats'], proc.stats)


def test_cmvn_no_norm_vars(mfcc):
    proc = CmvnPostProcessor(mfcc.ndims)
    proc.accumulate(mfcc)
    out = proc.process(mfcc, norm_vars=False)
    assert np.allclose(out.data.mean(axis=0), 0, atol=1e-5)
    assert np.allclose(out.data.var(axis=0), mfcc.data.var(axis=0),
                       rtol=1e-5)


def test_cmvn_reverse(mfcc):
    proc = CmvnPostProcessor(mfcc.ndims)
    proc.accumulate(mfcc)
    forward = proc.process(mfcc)
    back = proc.process(forward, reverse=True)
    assert np.allclose(back.data, mfcc.data, atol=1e-4)


def test_cmvn_skip_dims(mfcc):
    proc = CmvnPostProcessor(mfcc.ndims)
    proc.accumulate(mfcc)
    out = proc.process(mfcc, skip_dims=[0, 1])
    assert np.array_equal(out.data[:, :2], mfcc.data[:, :2])
    assert np.allclose(out.data[:, 2:].mean(axis=0), 0, atol=1e-5)
    with pytest.raises(ValueError, match='skipped dimensions'):
        proc.process(mfcc, skip_dims=[100])


def test_cmvn_weights(mfcc):
    proc = CmvnPostProcessor(mfcc.ndims)
    weights = np.zeros(mfcc.nframes)
    weights[:50] = 1.0
    proc.accumulate(mfcc, weights=weights)
    assert proc.count == 50
    out = proc.process(mfcc)
    assert np.allclose(out.data[:50].mean(axis=0), 0, atol=1e-5)

    with pytest.raises(ValueError, match='single dimension'):
        proc.accumulate(mfcc, weights=weights[:, None])
    with pytest.raises(ValueError, match='must be equal'):
        proc.accumulate(mfcc, weights=weights[:10])


def test_cmvn_accumulate_across(mfcc):
    """Stats accumulated over two features equal pooled stats."""
    proc1 = CmvnPostProcessor(mfcc.ndims)
    proc1.accumulate(mfcc)
    proc1.accumulate(mfcc)
    pooled = np.vstack([mfcc.data, mfcc.data])
    expected_mean = pooled.astype(np.float64).mean(axis=0)
    assert np.allclose(
        proc1.stats[0, :-1] / proc1.count, expected_mean, atol=1e-4)


def test_cmvn_errors(mfcc):
    with pytest.raises(ValueError, match='strictly positive'):
        CmvnPostProcessor(0)
    with pytest.raises(ValueError, match='shaped'):
        CmvnPostProcessor(13, stats=np.zeros((2, 3)))
    proc = CmvnPostProcessor(mfcc.ndims)
    with pytest.raises(ValueError, match='insufficient accumulation'):
        proc.process(mfcc)


def test_cmvn_preaccumulated_stats(mfcc):
    proc = CmvnPostProcessor(mfcc.ndims)
    proc.accumulate(mfcc)
    proc2 = CmvnPostProcessor(mfcc.ndims, stats=proc.stats)
    assert proc.process(mfcc) == proc2.process(mfcc)


def test_apply_cmvn_collection(mfcc):
    fc = FeaturesCollection(u1=mfcc, u2=mfcc.copy())
    out = apply_cmvn(fc)
    pooled = np.vstack([f.data for f in out.values()])
    assert np.allclose(pooled.mean(axis=0), 0, atol=1e-5)

    by_utt = apply_cmvn(fc, by_collection=False)
    assert np.allclose(by_utt['u1'].data.mean(axis=0), 0, atol=1e-5)

    with pytest.raises(ValueError, match='keys differ'):
        apply_cmvn(fc, weights={'u1': None})
    with pytest.raises(ValueError, match='out of bounds'):
        apply_cmvn(fc, skip_dims=[99])

    bad = FeaturesCollection(
        u1=mfcc,
        u2=Features(np.zeros((5, 2)), np.arange(5.0)))
    with pytest.raises(ValueError, match='consistent dimensions'):
        apply_cmvn(bad)


# ------------------------------------------------------------- sliding cmvn

@pytest.mark.parametrize('kwargs', [
    dict(),
    dict(normalize_variance=True),
    dict(center=False),
    dict(center=False, min_window=50),
    dict(cmn_window=40, min_window=40, normalize_variance=True),
    dict(cmn_window=1000),
])
def test_sliding_cmvn_oracle(mfcc, kwargs):
    ours = SlidingWindowCmvnPostProcessor(**kwargs).process(
        mfcc, device='cpu')
    ref = kaldi_oracle.sliding_window_cmn(
        mfcc.data.astype(np.float64),
        center=kwargs.get('center', True),
        cmn_window=kwargs.get('cmn_window', 600),
        min_window=kwargs.get('min_window', 100),
        normalize_variance=kwargs.get('normalize_variance', False))
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours.data - ref)) < 1e-3


def test_sliding_cmvn_window_normalization(mfcc):
    """Mid-utterance frames are normalized by their local window."""
    size = 40
    proc = SlidingWindowCmvnPostProcessor(
        cmn_window=size, min_window=size, normalize_variance=True)
    out = proc.process(mfcc, device='cpu')
    frame = 70
    window = mfcc.data[frame - size // 2: frame + size // 2]
    expected = (
        (mfcc.data[frame] - window.mean(axis=0)) / window.std(axis=0))
    assert np.allclose(out.data[frame], expected, atol=1e-4)


# ---------------------------------------------------------------------- vad

def test_vad_basic(mfcc):
    vad = VadPostProcessor().process(mfcc, device='cpu')
    assert vad.shape == (mfcc.nframes, 1)
    assert vad.dtype == np.uint8
    voiced = int(vad.data.sum())
    assert 0 < voiced < mfcc.nframes


@pytest.mark.parametrize('kwargs', [
    dict(),
    dict(frames_context=2),
    dict(frames_context=5, proportion_threshold=0.3),
    dict(energy_mean_scale=0.0),
    dict(energy_threshold=9.0),
])
def test_vad_oracle(mfcc, kwargs):
    ours = VadPostProcessor(**kwargs).process(mfcc, device='cpu')
    ref = kaldi_oracle.vad_energy(
        mfcc.data.astype(np.float64), **kwargs)
    assert np.array_equal(ours.data[:, 0], ref)


def test_vad_param_validation():
    with pytest.raises(ValueError, match='mean scale'):
        VadPostProcessor(energy_mean_scale=-1)
    with pytest.raises(ValueError, match='frames_context'):
        VadPostProcessor(frames_context=-1)
    with pytest.raises(ValueError, match='proportion_threshold'):
        VadPostProcessor(proportion_threshold=1.5)


def test_cmvn_dim_mismatch_raises(mfcc):
    proc = CmvnPostProcessor(1)
    proc.accumulate(Features(np.ones((5, 1)), np.arange(5.0)))
    with pytest.raises(ValueError, match='dimensions'):
        proc.process(mfcc)


def test_cmvn_properties_stats_snapshot(mfcc):
    # properties carry a snapshot of the statistics, not the live
    # accumulator
    proc = CmvnPostProcessor(mfcc.ndims)
    proc.accumulate(mfcc)
    out = proc.process(mfcc)
    before = np.array(out.properties['cmvn']['stats'])
    proc.accumulate(mfcc)
    np.testing.assert_array_equal(
        out.properties['cmvn']['stats'], before)


def test_delta_window_validation_coerces():
    with pytest.raises(ValueError, match='window must be'):
        DeltaPostProcessor(window=0.5)


def test_delta_process_all_collection(mfcc):
    fc = FeaturesCollection(a=mfcc, b=mfcc.copy(subsample=2))
    out = DeltaPostProcessor().process_all(fc, device='cpu')
    assert out.keys() == fc.keys()
    single = DeltaPostProcessor().process(mfcc, device='cpu')
    np.testing.assert_allclose(out['a'].data, single.data, atol=1e-5)
