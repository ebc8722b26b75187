"""Counterpart of ``tests/test_window_frames.py``, case for case: the
port's ``window`` and ``Frames``, with the JAX cases' values."""

import numpy as np
import pytest

from shennong_tpu_torch.frames import Frames
from shennong_tpu_torch.window import types, window


def test_types():
    assert types() == [
        'blackman', 'hamming', 'hanning', 'povey', 'rectangular']


def test_window_reference_values():
    """Exact values documented in the reference docstrings."""
    assert np.allclose(
        window(5, type='hamming'), [0.08, 0.54, 1.0, 0.54, 0.08])
    assert np.allclose(window(5, type='rectangular'), np.ones(5))
    assert np.allclose(
        window(5, type='povey'),
        [0.0, 0.5547847151756287, 1.0, 0.5547847151756287, 0.0])
    assert np.allclose(
        window(5, type='hanning'), [0.0, 0.5, 1.0, 0.5, 0.0])


def test_window_degenerate():
    assert np.array_equal(window(1), np.ones(1))
    assert np.array_equal(window(2, type='povey'), np.ones(2))
    assert np.array_equal(window(2, type='hanning'), np.ones(2))
    with pytest.raises(ValueError, match='strictly positive'):
        window(0)
    with pytest.raises(ValueError, match='type must be'):
        window(5, type='bartlett')


def test_frames_basic():
    frames = Frames(sample_rate=1, frame_shift=1, frame_length=3)
    framed = frames.make_frames(np.arange(10))
    assert framed.shape == (8, 3)
    assert np.array_equal(framed[0], [0, 1, 2])
    assert np.array_equal(framed[-1], [7, 8, 9])


def test_frames_no_snip():
    frames = Frames(
        sample_rate=1, frame_shift=1, frame_length=3, snip_edges=False)
    framed = frames.make_frames(np.arange(10))
    assert framed.shape == (10, 3)


def test_frames_writeable():
    frames = Frames(sample_rate=1, frame_shift=1, frame_length=3)
    view = frames.make_frames(np.arange(10))
    assert not view.flags.writeable
    copy = frames.make_frames(np.arange(10), writeable=True)
    assert copy.flags.writeable
    assert np.array_equal(view, copy)


def test_frames_nframes_anchor():
    # kaldi defaults on the 22713-sample test signal give 140 frames
    frames = Frames()
    assert frames.nframes(22713) == 140
    assert frames.samples_per_frame == 400
    assert frames.samples_per_shift == 160
    assert frames.boundaries(2).tolist() == [[0, 400], [160, 560]]
    times = frames.times(22713)
    assert times.shape == (140, 2)
    assert times[1, 0] == pytest.approx(0.01)

    with pytest.raises(ValueError, match='sample rate too low'):
        Frames(sample_rate=1).nframes(100)


def test_make_frames_short_signal_no_snip():
    # signal shorter than the frame overhang: the reflect padding
    # must cycle instead of reading out of bounds through the view
    frames = Frames(snip_edges=False)
    out = frames.make_frames(np.arange(250.0))
    assert out.shape == (frames.nframes(250), frames.samples_per_frame)
    assert np.all(np.isfinite(out))
    assert np.abs(out).max() < 250
    copied = frames.make_frames(np.arange(250.0), writeable=True)
    np.testing.assert_array_equal(np.asarray(out), copied)


def test_window_returns_fresh_array():
    w1 = window(64)
    w1 *= 0.0
    w2 = window(64)
    assert w2.max() > 0  # the cached window must not be poisoned
