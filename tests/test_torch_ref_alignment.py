"""Counterpart of ``tests/test_alignment.py``, case for case: the
port's ``Alignment`` and ``AlignmentCollection``, with the JAX cases'
checks."""

import numpy as np
import pytest

from shennong_tpu_torch.alignment import Alignment, AlignmentCollection


@pytest.fixture
def alignment():
    return Alignment(
        np.array([[0.0, 1.0], [1.0, 2.0], [2.0, 3.5]]),
        np.array(['a', 'b', 'a']))


def test_basic(alignment):
    assert alignment.is_valid()
    assert alignment.duration() == pytest.approx(3.5)
    assert alignment.get_tokens_inventory() == {'a', 'b'}
    assert np.array_equal(alignment.onsets, [0.0, 1.0, 2.0])
    assert np.array_equal(alignment.offsets, [1.0, 2.0, 3.5])


def test_validation():
    with pytest.raises(ValueError, match='same length'):
        Alignment(np.array([[0.0, 1.0]]), np.array(['a', 'b']))
    with pytest.raises(ValueError, match='onset must be lesser'):
        Alignment(np.array([[1.0, 0.5]]), np.array(['a']))
    with pytest.raises(ValueError, match='mismatch'):
        Alignment(
            np.array([[0.0, 1.0], [1.5, 2.0]]), np.array(['a', 'b']))


def test_from_to_list(alignment):
    triplets = alignment.to_list()
    rebuilt = Alignment.from_list(triplets)
    assert rebuilt == alignment
    with pytest.raises(ValueError, match='3 fields'):
        Alignment.from_list([(0, 1)])


def test_time_slice(alignment):
    sub = alignment[1.0:2.0]
    assert sub.tokens.tolist() == ['b']

    sub = alignment[0.5:2.5]
    assert sub.tokens.tolist() == ['a', 'b', 'a']
    assert sub.onsets[0] == 0.5
    assert sub.offsets[-1] == 2.5

    # out-of-range slice returns empty alignment
    assert alignment[5.0:6.0].duration() == 0
    # full slice returns self
    assert alignment[:] is alignment
    # partial read within one token
    sub = alignment[0.2:0.8]
    assert sub.tokens.tolist() == ['a']
    assert sub.times.tolist() == [[0.2, 0.8]]

    with pytest.raises(ValueError, match='must be a slice'):
        alignment[1.0]
    with pytest.raises(ValueError, match='step'):
        alignment[0.0:1.0:0.5]


def test_at_sample_rate(alignment):
    sampled = alignment.at_sample_rate(4)
    assert sampled.shape == (14,)
    assert sampled[:4].tolist() == ['a'] * 4
    assert sampled[4:8].tolist() == ['b'] * 4
    assert sampled[8:].tolist() == ['a'] * 6


def test_collection(alignment_file, tmpdir):
    collection = AlignmentCollection.load(alignment_file)
    assert sorted(collection.keys()) == ['item1', 'item2']
    assert all(a.is_valid() for a in collection.values())
    assert collection.get_tokens_inventory() == {'a', 'b', 'c', 'd', 'e'}

    # save / reload roundtrip, plain and gzipped
    for name, compress in (('a.txt', False), ('a.txt.gz', True)):
        path = str(tmpdir.join(name))
        collection.save(path, sort=True, compress=compress)
        loaded = AlignmentCollection.load(path, compress=compress)
        assert loaded.keys() == collection.keys()
        for key in collection:
            assert loaded[key] == collection[key]

    with pytest.raises(ValueError, match='already exist'):
        collection.save(str(tmpdir.join('a.txt')))


def test_collection_errors():
    with pytest.raises(ValueError, match='4 columns'):
        AlignmentCollection([('item', 0, 1)])
    with pytest.raises(ValueError, match='item bad'):
        AlignmentCollection([('bad', 1.0, 0.5, 'a')])
