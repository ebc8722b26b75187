"""Base classes for the feature processors.

Counterpart of :mod:`shennong_tpu.processor.base` (FeaturesProcessor,
FramesProcessor, MelFeaturesProcessor), with the same parameters and
properties. ``process`` handles one utterance as a batch of one on an
explicit ``device``; random stages draw from a :class:`torch.Generator`
(a fresh, randomly seeded one when the caller gives none).
"""

import abc

import numpy as np
import torch

from shennong_tpu.features import Features
from shennong_tpu.base import BaseProcessor
from shennong_tpu_torch.ops.framing import (
    FrameOptions, WINDOW_TYPES, num_frames)
from shennong_tpu_torch.ops.spectral import MelOpts


def fresh_generator(device):
    """A torch.Generator on ``device`` seeded from a non-deterministic
    source (the reference's dither is not reproducible either)."""
    generator = torch.Generator(device=device)
    generator.seed()
    return generator


class FeaturesProcessor(BaseProcessor, metaclass=abc.ABCMeta):
    """Base class of all the features extraction processors."""

    @property
    @abc.abstractmethod
    def name(self):  # pragma: nocover
        """Name of the processor"""

    @property
    @abc.abstractmethod
    def ndims(self):  # pragma: nocover
        """Dimension of the output features frames"""

    def get_properties(self, **kwargs):
        """Processor parameters and pipeline metadata as a dict"""
        params = self.get_params()
        params.update(kwargs)
        return {
            'pipeline': [
                {'name': self.name, 'columns': [0, self.ndims - 1]}],
            self.name: params}

    @abc.abstractmethod
    def process(self, signal, *, device):
        """Compute features from an input signal on ``device``."""


class FramesProcessor(FeaturesProcessor, metaclass=abc.ABCMeta):
    """Base class for frame-based processors (Kaldi framing options)."""

    # frame count above which a signal needs chunked extraction, which
    # is not yet ported: :func:`process` refuses such signals
    AUTO_CHUNK_FRAMES = 60000

    def __init__(self, sample_rate=16000, frame_shift=0.01,
                 frame_length=0.025, dither=1.0, preemph_coeff=0.97,
                 remove_dc_offset=True, window_type='povey',
                 round_to_power_of_two=True, blackman_coeff=0.42,
                 snip_edges=True):
        super().__init__()
        self.sample_rate = sample_rate
        self.frame_shift = frame_shift
        self.frame_length = frame_length
        self.dither = dither
        self.preemph_coeff = preemph_coeff
        self.remove_dc_offset = remove_dc_offset
        self.window_type = window_type
        self.round_to_power_of_two = round_to_power_of_two
        self.blackman_coeff = blackman_coeff
        self.snip_edges = snip_edges

    @property
    def sample_rate(self):
        """Expected sampling rate of the input waveform (Hz).

        Signals handed to process must be sampled at this rate.

        """
        return np.float32(self._sample_rate)

    @sample_rate.setter
    def sample_rate(self, value):
        self._sample_rate = float(value)

    @property
    def frame_shift(self):
        """Time step between two consecutive frames, in seconds"""
        return np.float32(self._frame_shift)

    @frame_shift.setter
    def frame_shift(self, value):
        self._frame_shift = float(value)

    @property
    def frame_length(self):
        """Duration of the analysis window, in seconds"""
        return np.float32(self._frame_length)

    @frame_length.setter
    def frame_length(self, value):
        self._frame_length = float(value)

    @property
    def dither(self):
        """Dithering noise amplitude (0 disables dithering)"""
        return np.float32(self._dither)

    @dither.setter
    def dither(self, value):
        self._dither = float(value)

    @property
    def preemph_coeff(self):
        """Pre-emphasis filter coefficient (0 disables it)"""
        return np.float32(self._preemph_coeff)

    @preemph_coeff.setter
    def preemph_coeff(self, value):
        self._preemph_coeff = float(value)

    @property
    def remove_dc_offset(self):
        """Whether each frame gets its mean (DC offset) removed"""
        return self._remove_dc_offset

    @remove_dc_offset.setter
    def remove_dc_offset(self, value):
        self._remove_dc_offset = bool(value)

    @property
    def window_type(self):
        """Analysis window shape

        One of 'hamming', 'hanning', 'povey', 'rectangular' or
        'blackman'.

        """
        return self._window_type

    @window_type.setter
    def window_type(self, value):
        if value not in WINDOW_TYPES:
            raise ValueError(
                'window type must be in {}, it is {}'.format(
                    list(WINDOW_TYPES), value))
        self._window_type = value

    @property
    def round_to_power_of_two(self):
        """Whether frames are zero-padded to a power-of-two FFT size"""
        return self._round_to_power_of_two

    @round_to_power_of_two.setter
    def round_to_power_of_two(self, value):
        self._round_to_power_of_two = bool(value)

    @property
    def blackman_coeff(self):
        """Shape constant of the generalized Blackman window

        Only relevant when window_type is 'blackman'.

        """
        return np.float32(self._blackman_coeff)

    @blackman_coeff.setter
    def blackman_coeff(self, value):
        self._blackman_coeff = float(value)

    @property
    def snip_edges(self):
        """Whether to emit only frames fully contained in the signal

        With snipping, the frame count depends on the frame_length;
        without, it depends on the frame_shift alone and edge frames
        read boundary-reflected samples.

        """
        return self._snip_edges

    @snip_edges.setter
    def snip_edges(self, value):
        self._snip_edges = bool(value)

    def times(self, nframes):
        """(tstart, tstop) label for each output frame"""
        return np.vstack((
            np.arange(nframes) * self.frame_shift,
            np.arange(nframes) * self.frame_shift + self.frame_length)).T

    def output_frames(self, nsamples):
        """Output rows produced for a signal of ``nsamples`` samples"""
        return num_frames(nsamples, self.frame_options())

    def frame_options(self):
        """The current framing parameters as a static FrameOptions"""
        # the ms values snap to float32 like Kaldi's option structs
        return FrameOptions(
            sample_rate=self._sample_rate,
            frame_shift_ms=float(np.float32(self._frame_shift * 1000.0)),
            frame_length_ms=float(np.float32(self._frame_length * 1000.0)),
            dither=self._dither,
            preemph_coeff=self._preemph_coeff,
            remove_dc_offset=self._remove_dc_offset,
            window_type=self._window_type,
            round_to_power_of_two=self._round_to_power_of_two,
            blackman_coeff=self._blackman_coeff,
            snip_edges=self._snip_edges)

    def _check_signal(self, signal):
        """Validate channel count, sample rate and length of a signal."""
        if signal.nchannels != 1:
            raise ValueError(
                'signal must have one dimension, but it has {}'
                .format(signal.nchannels))
        if self.sample_rate != signal.sample_rate:
            raise ValueError(
                'processor and signal mismatch in sample rates: '
                '{} != {}'.format(self.sample_rate, signal.sample_rate))
        frames = self.output_frames(signal.nsamples)
        if self.AUTO_CHUNK_FRAMES and frames > self.AUTO_CHUNK_FRAMES:
            raise NotImplementedError(
                f'the signal gives {frames} frames, more than '
                f'{self.AUTO_CHUNK_FRAMES}: chunked extraction is not '
                'yet ported')

    def _signal_batch(self, signal, device, generator=None):
        """A batch of one on ``device``.

        Returns (signals [1, T] float32 in int16 range, nsamples [1]
        int32, nframes, generator-or-None).
        """
        data = signal.astype(np.int16).data
        signals = torch.as_tensor(
            data[None, :], device=device).to(torch.float32)
        nsamples = torch.tensor(
            [data.shape[0]], dtype=torch.int32, device=device)
        nframes = self.output_frames(data.shape[0])
        if self._dither != 0 and generator is None:
            generator = fresh_generator(device)
        return signals, nsamples, nframes, generator


class MelFeaturesProcessor(FramesProcessor, metaclass=abc.ABCMeta):
    """Base class for mel-based processors."""

    def __init__(self, sample_rate=16000, frame_shift=0.01,
                 frame_length=0.025, dither=1.0, preemph_coeff=0.97,
                 remove_dc_offset=True, window_type='povey',
                 round_to_power_of_two=True, blackman_coeff=0.42,
                 snip_edges=True, num_bins=23, low_freq=20,
                 high_freq=0, vtln_low=100, vtln_high=-500):
        super().__init__(
            sample_rate=sample_rate, frame_shift=frame_shift,
            frame_length=frame_length, dither=dither,
            preemph_coeff=preemph_coeff,
            remove_dc_offset=remove_dc_offset, window_type=window_type,
            round_to_power_of_two=round_to_power_of_two,
            blackman_coeff=blackman_coeff, snip_edges=snip_edges)
        self.num_bins = num_bins
        self.low_freq = low_freq
        self.high_freq = high_freq
        self.vtln_low = vtln_low
        self.vtln_high = vtln_high

    @property
    def num_bins(self):
        """Count of triangular filters in the mel bank (minimum 3)"""
        return self._num_bins

    @num_bins.setter
    def num_bins(self, value):
        self._num_bins = int(value)

    @property
    def low_freq(self):
        """Lowest edge of the mel filterbank (Hz)"""
        return np.float32(self._low_freq)

    @low_freq.setter
    def low_freq(self, value):
        self._low_freq = float(value)

    @property
    def high_freq(self):
        """Highest edge of the mel filterbank (Hz)

        Non-positive values count down from the Nyquist frequency.

        """
        return np.float32(self._high_freq)

    @high_freq.setter
    def high_freq(self, value):
        self._high_freq = float(value)

    @property
    def vtln_low(self):
        """Lower knee (Hz) of the piecewise-linear VTLN warp"""
        return np.float32(self._vtln_low)

    @vtln_low.setter
    def vtln_low(self, value):
        self._vtln_low = float(value)

    @property
    def vtln_high(self):
        """Upper knee (Hz) of the piecewise-linear VTLN warp

        Negative values count down from high_freq.

        """
        return np.float32(self._vtln_high)

    @vtln_high.setter
    def vtln_high(self, value):
        self._vtln_high = float(value)

    def mel_options(self):
        """The current mel parameters as a static MelOpts"""
        return MelOpts(
            num_bins=self._num_bins,
            low_freq=self._low_freq,
            high_freq=self._high_freq,
            vtln_low=self._vtln_low,
            vtln_high=self._vtln_high)

    def mel_weights(self, vtln_warp):
        """Dense mel filterbank matrix (numpy) for the given VTLN warp"""
        from shennong_tpu.ops import mel as melmod
        opts = self.frame_options()
        weights, _ = melmod.mel_banks(
            self._num_bins, opts.padded_window_size, opts.sample_rate,
            self._low_freq, self._high_freq, self._vtln_low,
            self._vtln_high, float(vtln_warp))
        return weights

    @abc.abstractmethod
    def _compute(self, signal, vtln_warp, device, generator):
        """Subclass hook computing the [nframes, ndims] data matrix"""

    def process(self, signal, vtln_warp=1.0, *, device, generator=None):
        """Compute features on ``device``, with optional VTLN warping.

        Parameters
        ----------
        signal : Audio, shape = [nsamples, 1]
            Mono audio at the processor's sample rate.
        vtln_warp : float, optional
            VTLN warp factor, 1.0 (default) means no warping.
        device : str or torch.device
            Where the computation runs.
        generator : torch.Generator, optional
            Source of the dither, on ``device`` (a fresh, randomly
            seeded one when None and ``dither`` is non-zero).

        Returns
        -------
        features : Features, shape = [nframes, ndims]
        """
        self._check_signal(signal)
        data = self._compute(signal, vtln_warp, device, generator)
        return Features(
            data, self.times(data.shape[0]),
            properties=self.get_properties(vtln_warp=vtln_warp))
