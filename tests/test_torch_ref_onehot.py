"""Counterpart of ``tests/processor/test_onehot.py``, case for case:
the port's one-hot processors on the JAX cases' three-token alignment,
with their checks (``tests/test_torch_onehot.py`` holds them against
the JAX package on ``tests/data/alignment.txt``)."""

import numpy as np
import pytest

from shennong_tpu_torch.alignment import Alignment
from shennong_tpu_torch.processor.onehot import (
    FramedOneHotProcessor, OneHotProcessor)


@pytest.fixture
def alignment():
    return Alignment(
        np.array([[0.0, 1.0], [1.0, 2.0], [2.0, 3.0]]),
        np.array(['a', 'b', 'a']))


def test_simple(alignment):
    onehot = OneHotProcessor().process(alignment)
    assert onehot.shape == (3, 2)
    assert onehot.dtype == bool
    assert np.array_equal(
        onehot.data, [[True, False], [False, True], [True, False]])
    assert np.array_equal(onehot.times, alignment.times)
    assert onehot.properties['onehot']['token2index'] == {'a': 0, 'b': 1}


def test_fixed_tokens(alignment):
    proc = OneHotProcessor(tokens=['a', 'b', 'c'])
    onehot = proc.process(alignment)
    assert onehot.shape == (3, 3)
    assert proc.ndims == 3

    proc = OneHotProcessor(tokens=['a'])
    with pytest.raises(ValueError, match='not defined'):
        proc.process(alignment)


def test_ndims_requires_tokens():
    with pytest.raises(ValueError, match='cannot know their dimension'):
        OneHotProcessor().ndims


def test_framed(alignment):
    proc = FramedOneHotProcessor(sample_rate=100)
    onehot = proc.process(alignment)
    expected_frames = proc.frame.nframes(300)
    assert onehot.shape == (expected_frames, 2)
    # every frame selects exactly one token
    assert np.all(onehot.data.sum(axis=1) == 1)
    # frames fully inside token 'b' (1s..2s) pick index 1
    mid = int(1.2 / 0.01)
    assert onehot.data[mid, 1]


def test_framed_window_vote(alignment):
    # at a token boundary the window vote decides
    for window_type in ('povey', 'hamming', 'rectangular'):
        proc = FramedOneHotProcessor(
            sample_rate=100, window_type=window_type)
        out = proc.process(alignment)
        assert np.all(out.data.sum(axis=1) == 1)


def test_framed_params():
    proc = FramedOneHotProcessor(
        sample_rate=8000, frame_shift=0.02, frame_length=0.05)
    assert proc.sample_rate == 8000
    assert proc.frame_shift == 0.02
    assert proc.frame_length == 0.05
    params = proc.get_params()
    assert set(params.keys()) == {
        'tokens', 'sample_rate', 'frame_shift', 'frame_length',
        'window_type', 'blackman_coeff'}
