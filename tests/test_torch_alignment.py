"""The port's alignments against the JAX package's, on the CPU.

``shennong_tpu_torch.alignment`` loads, saves and slices
``tests/data/alignment.txt`` exactly as ``shennong_tpu.alignment``
does, the files either package writes (plain and gzipped) load in the
other with equal alignments, and both raise the same validation errors.
"""

import numpy as np
import pytest

from shennong_tpu import alignment as jalignment
from shennong_tpu_torch import alignment


def assert_same(ours, theirs):
    assert isinstance(ours, alignment.Alignment)
    np.testing.assert_array_equal(ours.times, theirs.times)
    np.testing.assert_array_equal(ours.tokens, theirs.tokens)
    assert ours.times.dtype == theirs.times.dtype
    assert ours.tokens.dtype == theirs.tokens.dtype


@pytest.fixture
def collections(alignment_file):
    return (alignment.AlignmentCollection.load(alignment_file),
            jalignment.AlignmentCollection.load(alignment_file))


def test_load_matches_jax(collections):
    ours, theirs = collections
    assert list(ours) == list(theirs)
    for item in ours:
        assert_same(ours[item], theirs[item])
        assert ours[item].is_valid()
        assert ours[item].duration() == theirs[item].duration()
        assert repr(ours[item]) == repr(theirs[item])
        assert ours[item].to_list() == theirs[item].to_list()
    assert ours.get_tokens_inventory() == theirs.get_tokens_inventory()


@pytest.mark.parametrize('window', [
    (None, None), (0.0, 0.5), (0.3, 0.31), (0.1125, 0.3625), (0.05, 10.0),
    (None, 0.7), (0.9, None), (50.0, 60.0), (0.5, 0.5)])
def test_time_slicing_matches_jax(collections, window):
    ours, theirs = collections
    start, stop = window
    for item in ours:
        got, want = ours[item][start:stop], theirs[item][start:stop]
        assert_same(got, want)
        if (start, stop) == (None, None):
            assert got is ours[item]


def test_at_sample_rate_matches_jax(collections):
    ours, theirs = collections
    for item in ours:
        for rate in (100, 16000):
            np.testing.assert_array_equal(
                ours[item].at_sample_rate(rate),
                theirs[item].at_sample_rate(rate))


@pytest.mark.parametrize('compress', [False, True])
def test_files_interchange(collections, tmp_path, compress):
    ours, theirs = collections
    suffix = '.txt.gz' if compress else '.txt'
    ours.save(str(tmp_path / f'ours{suffix}'), sort=True, compress=compress)
    theirs.save(str(tmp_path / f'theirs{suffix}'), sort=True,
                compress=compress)
    if not compress:  # a gzip header carries its write time
        assert (tmp_path / 'ours.txt').read_bytes() == (
            tmp_path / 'theirs.txt').read_bytes()
    back_in_jax = jalignment.AlignmentCollection.load(
        str(tmp_path / f'ours{suffix}'), compress=compress)
    back_in_port = alignment.AlignmentCollection.load(
        str(tmp_path / f'theirs{suffix}'), compress=compress)
    for item in ours:
        assert_same(ours[item], back_in_jax[item])
        assert_same(back_in_port[item], theirs[item])
    with pytest.raises(ValueError, match='already exist'):
        ours.save(str(tmp_path / f'ours{suffix}'))


@pytest.mark.parametrize('build', [
    lambda m: m.Alignment(np.array([[0.0, 1.0]]), np.array(['a', 'b'])),
    lambda m: m.Alignment(np.array([[1.0, 0.5]]), np.array(['a'])),
    lambda m: m.Alignment(np.array([[0.0, 1.0], [1.5, 2.0]]),
                          np.array(['a', 'b'])),
    lambda m: m.Alignment(np.array([[1.0, 2.0], [0.0, 1.0]]),
                          np.array(['a', 'b'])),
    lambda m: m.Alignment.from_list([(0, 1)]),
    lambda m: m.AlignmentCollection([('item', 0, 1)]),
    lambda m: m.AlignmentCollection([('bad', 1.0, 0.5, 'a')]),
    lambda m: m.AlignmentCollection.load('/nonexistent/alignment.txt'),
    lambda m: m.Alignment(np.array([[0.0, 1.0]]), np.array(['a']))[1.0],
    lambda m: m.Alignment(np.array([[0.0, 1.0]]), np.array(['a']))[
        0.0:1.0:0.5],
])
def test_same_validation_errors(build):
    with pytest.raises(ValueError) as theirs:
        build(jalignment)
    with pytest.raises(ValueError) as ours:
        build(alignment)
    assert str(ours.value) == str(theirs.value)
