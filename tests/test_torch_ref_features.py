"""Counterpart of ``tests/test_features.py``, case for case: the port's
``Features`` and ``FeaturesCollection``, with the JAX cases' checks."""

import numpy as np
import pytest

from shennong_tpu_torch import Features, FeaturesCollection


@pytest.fixture
def feats():
    return Features(
        np.random.RandomState(0).rand(10, 3),
        np.arange(10, dtype=float),
        properties={'key': 'value'})


def test_basic(feats):
    assert feats.shape == (10, 3)
    assert feats.nframes == 10
    assert feats.ndims == 3
    assert feats.dtype == np.float64
    assert feats.properties == {'key': 'value'}
    assert feats.is_valid()


def test_equality(feats):
    same = Features(feats.data, feats.times, properties=feats.properties)
    assert feats == same
    assert feats.is_close(same)
    other = Features(feats.data + 1e-8, feats.times,
                     properties=feats.properties)
    assert feats != other
    assert feats.is_close(other, atol=1e-6)
    assert not feats.is_close(other, rtol=0, atol=1e-10)


def test_copy_subsample(feats):
    copied = feats.copy()
    assert copied == feats
    assert copied.data is not feats.data

    sub = feats.copy(subsample=3)
    assert sub.nframes == 4
    assert np.array_equal(sub.data, feats.data[::3])

    as32 = feats.copy(dtype=np.float32)
    assert as32.dtype == np.float32

    with pytest.raises(ValueError, match='subsample'):
        feats.copy(subsample=0)
    with pytest.raises(ValueError, match='subsample'):
        feats.copy(subsample=1.5)


def test_validate():
    with pytest.raises(ValueError, match='data must be a numpy array'):
        Features([1, 2], np.arange(2))
    with pytest.raises(ValueError, match='dimension must be 2'):
        Features(np.zeros(5), np.arange(5))
    with pytest.raises(ValueError, match='mismatch in number of frames'):
        Features(np.zeros((5, 2)), np.arange(4))
    with pytest.raises(ValueError, match='not sorted'):
        Features(np.zeros((3, 2)), np.array([0.0, 2.0, 1.0]))
    with pytest.raises(ValueError, match='non-finite'):
        Features(np.full((3, 2), np.nan), np.arange(3.0))


def test_2d_times():
    times = np.stack([np.arange(5.0), np.arange(5.0) + 0.5], axis=1)
    feats = Features(np.zeros((5, 2)), times)
    assert feats.is_valid()
    with pytest.raises(ValueError, match='shape\\[1\\] must be 2'):
        Features(np.zeros((5, 2)), np.zeros((5, 3)))


def test_concatenate(feats):
    other = Features(np.ones((10, 2)), feats.times)
    both = feats.concatenate(other)
    assert both.shape == (10, 5)
    assert np.array_equal(both.data[:, 3:], other.data)


def test_concatenate_tolerance(feats):
    shorter = Features(np.ones((8, 2)), feats.times[:8])
    with pytest.raises(ValueError, match='different number of frames'):
        feats.concatenate(shorter)
    with pytest.raises(ValueError, match='greater than tolerance'):
        feats.concatenate(shorter, tolerance=1)
    both = feats.concatenate(shorter, tolerance=2)
    assert both.shape == (8, 5)


def test_concatenate_pipeline_columns():
    f1 = Features(
        np.zeros((5, 3)), np.arange(5.0),
        properties={'pipeline': [{'name': 'a', 'columns': [0, 2]}]})
    f2 = Features(
        np.zeros((5, 2)), np.arange(5.0),
        properties={'pipeline': [{'name': 'b', 'columns': [0, 1]}]})
    both = f1.concatenate(f2)
    assert both.properties['pipeline'] == [
        {'name': 'a', 'columns': [0, 2]},
        {'name': 'b', 'columns': [3, 4]}]


def test_collection_partition(feats):
    fc = FeaturesCollection(u1=feats, u2=feats.copy(), u3=feats.copy())
    with pytest.raises(ValueError, match='not defined in the partition'):
        fc.partition({'u1': 's1'})
    parts = fc.partition({'u1': 's1', 'u2': 's1', 'u3': 's2'})
    assert sorted(parts.keys()) == ['s1', 's2']
    assert sorted(parts['s1'].keys()) == ['u1', 'u2']
    assert parts['s2'].keys() == {'u3'}
    assert all(isinstance(p, FeaturesCollection) for p in parts.values())


def test_collection_trim(feats):
    fc = FeaturesCollection(u1=feats)
    mask = np.zeros(10, dtype=bool)
    mask[2:7] = True
    trimmed = fc.trim({'u1': mask})
    assert trimmed['u1'].nframes == 5

    with pytest.raises(ValueError, match='keys'):
        fc.trim({'other': mask})
    with pytest.raises(ValueError, match='bool'):
        fc.trim({'u1': mask.astype(int)})
    with pytest.raises(ValueError, match='length'):
        fc.trim({'u1': mask[:5]})


def test_collection_is_close(feats):
    fc1 = FeaturesCollection(u1=feats)
    fc2 = FeaturesCollection(
        u1=Features(feats.data + 1e-9, feats.times,
                    properties=feats.properties))
    assert fc1.is_close(fc2, atol=1e-6)
    assert not fc1.is_close(FeaturesCollection(other=feats))
