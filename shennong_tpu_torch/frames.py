"""The :class:`Frames` helper splitting raw signals into frames.

Counterpart of :mod:`shennong_tpu.frames` (numpy, on the host): frame
count math, boundaries, times and zero-copy strided frame views. The
batched framing of the processors lives in
:mod:`shennong_tpu_torch.ops.framing`.
"""

import numpy as np

from shennong_tpu_torch.base import BaseProcessor
from shennong_tpu_torch.ops.framing import FrameOptions, num_frames


class Frames(BaseProcessor):
    """Extract frames from raw signals"""

    def __init__(self, sample_rate=16000,
                 frame_shift=0.01, frame_length=0.025,
                 snip_edges=True):
        super().__init__()
        self.sample_rate = sample_rate
        self.frame_shift = frame_shift
        self.frame_length = frame_length
        self.snip_edges = snip_edges

    @property
    def name(self):
        return 'frames'

    @property
    def sample_rate(self):
        """Waveform sample frequency in Hertz

        Must match the sample rate of the signal specified in
        `process`

        """
        return self._sample_rate

    @sample_rate.setter
    def sample_rate(self, value):
        self._sample_rate = value

    @property
    def frame_shift(self):
        """Frame shift in seconds"""
        return self._frame_shift

    @frame_shift.setter
    def frame_shift(self, value):
        self._frame_shift = value

    @property
    def frame_length(self):
        """Frame length in seconds"""
        return self._frame_length

    @frame_length.setter
    def frame_length(self, value):
        self._frame_length = value

    @property
    def snip_edges(self):
        """If true, output only frames that completely fit in the file

        When True the number of frames depends on the `frame_length`.
        If False, the number of frames depends only on the
        `frame_shift`, and we reflect the data at the ends.

        """
        return self._snip_edges

    @snip_edges.setter
    def snip_edges(self, value):
        self._snip_edges = bool(value)

    @property
    def samples_per_frame(self):
        """The number of samples in one frame"""
        return int(self.frame_length * self.sample_rate)

    @property
    def samples_per_shift(self):
        """The number of samples between two shifts"""
        return int(self.frame_shift * self.sample_rate)

    def _options(self):
        return FrameOptions(
            sample_rate=float(self.sample_rate),
            frame_shift_ms=float(np.float32(self.frame_shift * 1000.0)),
            frame_length_ms=float(np.float32(self.frame_length * 1000.0)),
            snip_edges=self.snip_edges)

    def nframes(self, nsamples):
        """Number of frames extracted from ``nsamples`` samples.

        Raises ValueError when the frame shift rounds to zero samples
        (sample rate too low).
        """
        if self.samples_per_shift == 0:
            raise ValueError('cannot compute nframes: sample rate too low')
        return num_frames(nsamples, self._options())

    def first_sample_of_frame(self, frame):
        """Index of the first sample of the given frame"""
        return int(frame * self.samples_per_shift)

    def last_sample_of_frame(self, frame):
        """Index+1 of the last sample of the given frame"""
        return int(self.first_sample_of_frame(frame) + self.samples_per_frame)

    def times(self, nsamples):
        """(tstart, tstop) times of each frame of a ``nsamples`` signal"""
        nframes = self.nframes(nsamples)
        return np.vstack((
            np.arange(nframes) * self.frame_shift,
            np.arange(nframes) * self.frame_shift + self.frame_length)).T

    def boundaries(self, nframes):
        """(istart, istop) sample index boundaries of ``nframes`` frames"""
        first = np.arange(nframes) * self.samples_per_shift
        return (first.repeat(2).reshape(nframes, 2)
                + (0, self.samples_per_frame)).astype(np.int64)

    def make_frames(self, array, writeable=False):
        """Divide ``array`` into overlapping frames.

        With ``writeable=False`` (default) zero-copy strided views are
        returned; with True the frames are materialized copies. When
        ``snip_edges`` is False the tail of the signal is mirrored so
        the last frames are complete.
        """
        nframes = self.nframes(array.shape[0])

        if not self.snip_edges:
            # mirror the signal end into the last frames; np.pad
            # 'reflect' equals the reference's array[-n-1:-1][::-1]
            # concatenation but stays correct (repeated reflection)
            # when the signal is shorter than the overhang — the
            # single-mirror form reads out of bounds through the
            # strided view there
            missing = self.last_sample_of_frame(nframes - 1) - array.shape[0]
            if missing > 0:
                array = np.pad(
                    array,
                    ((0, missing),) + ((0, 0),) * (array.ndim - 1),
                    mode='reflect')

        if writeable:
            out = np.empty(
                (nframes, self.samples_per_frame) + array.shape[1:],
                dtype=array.dtype)
            for i, (start, stop) in enumerate(self.boundaries(nframes)):
                out[i] = array[start:stop]
            return out

        shape = (nframes, self.samples_per_frame) + array.shape[1:]
        strides = (array.strides[0] * self.samples_per_shift,
                   array.strides[0]) + array.strides[1:]
        return np.lib.stride_tricks.as_strided(
            array, shape=shape, strides=strides, writeable=False)
