"""Base classes for the feature processors.

Counterpart of :mod:`shennong_tpu.processor.base` (FeaturesProcessor,
FramesProcessor, MelFeaturesProcessor), with the same parameters and
properties. ``process`` handles one utterance as a batch of one on an
explicit ``device`` (hour-scale ones in chunks, ``process_chunked``);
``process_all`` runs whole utterance collections. Random stages draw
from a :class:`torch.Generator` (a fresh, randomly seeded one when the
caller gives none).
"""

import abc
import copy

import numpy as np
import torch

from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.base import BaseProcessor
from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.ops.framing import (
    FrameOptions, WINDOW_TYPES, num_frames)
from shennong_tpu_torch.ops.spectral import MelOpts
from shennong_tpu_torch.utils import get_njobs


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

    def process_all(self, utterances, njobs=None, *, device, generator=None,
                    **kwargs):
        """Compute features for a whole utterance collection, one
        utterance at a time, on ``device``.

        ``kwargs`` values must be dicts indexed by utterance name and
        are forwarded per utterance to :func:`process`, with
        ``generator`` when one is given. ``njobs`` is validated by
        :func:`get_njobs` and has no other effect: this loop loads one
        utterance at a time. Returns a :class:`FeaturesCollection`
        keyed like ``utterances``.
        """
        njobs = get_njobs(njobs, log=self.log)
        _check_per_utterance(utterances, kwargs)
        random = {} if generator is None else {'generator': generator}
        collection = FeaturesCollection()
        for utt in utterances:
            collection[utt.name] = self.process(
                utt.load_audio(), device=device, **random,
                **{k: v[utt.name] for k, v in kwargs.items()})
        return collection


def _check_per_utterance(utterances, kwargs):
    """Each per-utterance argument is a dict keyed like ``utterances``."""
    for name, value in kwargs.items():
        if not isinstance(value, dict):
            raise ValueError(f'argument "{name}" is not a dict')
        if value.keys() != utterances.by_name().keys():
            raise ValueError(
                f'utterances and "{name}" have different names')


class FramesProcessor(FeaturesProcessor, metaclass=abc.ABCMeta):
    """Base class for frame-based processors (Kaldi framing options)."""

    # frame count above which :func:`process` transparently switches
    # to chunked extraction; None disables the automatic routing
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

    def process_all(self, utterances, njobs=None, *, device, generator=None,
                    **kwargs):
        """Batched extraction over a whole utterance collection.

        Utterances run in padded length-sorted batches through
        :class:`shennong_tpu_torch.parallel.executor.BatchExecutor` on
        ``device``, the hour-scale ones through :func:`process_chunked`.
        ``kwargs`` may hold a ``vtln_warp`` dict (mel-based processors);
        other per-utterance arguments take the per-utterance loop.
        ``njobs`` bounds the decode of the audio that the native loader
        does not read. ``generator`` is the source of the dither, on
        ``device``.
        """
        njobs = get_njobs(njobs, log=self.log)
        _check_per_utterance(utterances, kwargs)
        if set(kwargs) <= {'vtln_warp'}:
            from shennong_tpu_torch.parallel.executor import BatchExecutor
            return BatchExecutor(
                self, device=device, generator=generator).process_all(
                    utterances, vtln_warp=kwargs.get('vtln_warp'),
                    njobs=njobs)
        return super().process_all(
            utterances, njobs=njobs, device=device, generator=generator,
            **kwargs)

    def process_chunked(self, signal, chunk_frames=20000, halo_frames=256,
                        *, device, generator=None, **kwargs):
        """Extract features from a long signal in frame-aligned chunks.

        Bounds device memory for hour-scale utterances: the signal is
        split into pieces of ``chunk_frames`` frames, each processed by
        :func:`process` as one utterance, and the outputs concatenated.
        Frame-local computers (spectrogram, filterbank, MFCC, energy,
        plain PLP) give the output of :func:`process` on the whole
        signal when ``dither`` is 0. RASTA-PLP (the one stateful
        computer) re-enters each chunk through a left halo of
        ``halo_frames`` dropped frames: the RASTA IIR pole (0.94)
        decays the boundary error below 1e-6 within 256 frames. The
        dither of every chunk draws from ``generator`` in turn (a
        fresh, randomly seeded one when None and ``dither`` is on).

        Frame placement matches Kaldi for both ``snip_edges`` settings:
        without snipping, the signal is symmetric-padded once on the
        host so every chunk is a plain strided slice.
        """
        chunk_frames = int(chunk_frames)
        if chunk_frames < 1:
            raise ValueError(
                f'chunk_frames must be >= 1, it is {chunk_frames}')
        if int(halo_frames) < 0:
            raise ValueError(
                f'halo_frames must be >= 0, it is {halo_frames}')

        self._check_signal(signal)
        opts = self.frame_options()
        total = num_frames(signal.nsamples, opts)
        if total <= chunk_frames:
            # the regular path with automatic routing disabled, so a
            # small AUTO_CHUNK_FRAMES cannot re-enter here
            direct = copy.copy(self)
            direct.AUTO_CHUNK_FRAMES = None
            return direct.process(
                signal, device=device, generator=generator, **kwargs)

        if self._dither != 0 and generator is None:
            generator = fresh_generator(device)
        data = signal.astype(np.int16).data
        shift, length = opts.window_shift, opts.window_size
        if opts.snip_edges:
            padded, offset = data, 0
        else:
            # one symmetric reflection (-1 -> 0, n -> n-1, ...) covers
            # the half-window overhang of the edge frames
            padded = np.pad(data, length, mode='symmetric')
            offset = length + shift // 2 - length // 2

        worker = copy.copy(self)
        worker.snip_edges = True
        worker.AUTO_CHUNK_FRAMES = None
        halo = int(halo_frames) if getattr(self, 'rasta', False) else 0

        pieces = []
        start = 0
        while start < total:
            stop = min(start + chunk_frames, total)
            head = max(start - halo, 0)
            lo = offset + head * shift
            hi = offset + (stop - 1) * shift + length
            piece = worker.process(
                Audio(padded[lo:hi], signal.sample_rate, validate=False),
                device=device, generator=generator, **kwargs).data
            pieces.append(piece[start - head:])
            start = stop

        props_kwargs = dict(kwargs)
        if isinstance(self, MelFeaturesProcessor):
            props_kwargs.setdefault('vtln_warp', 1.0)
        return Features(
            np.concatenate(pieces, axis=0), self.times(total),
            properties=self.get_properties(**props_kwargs))

    def _maybe_chunk(self, signal, *, device, generator, **kwargs):
        """Route very long signals to chunked extraction.

        Returns the chunked Features, or None when the signal is short
        enough for the regular single-batch path.
        """
        limit = self.AUTO_CHUNK_FRAMES
        if limit and self.output_frames(signal.nsamples) > limit:
            return self.process_chunked(
                signal, device=device, generator=generator, **kwargs)
        return None

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
        """Validate channel count and sample rate of an input signal."""
        if signal.nchannels != 1:
            raise ValueError(
                'signal must have one dimension, but it has {}'
                .format(signal.nchannels))
        if self.sample_rate != signal.sample_rate:
            raise ValueError(
                'processor and signal mismatch in sample rates: '
                '{} != {}'.format(self.sample_rate, signal.sample_rate))

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
        from shennong_tpu_torch.ops import mel as melmod
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

        Signals of more than ``AUTO_CHUNK_FRAMES`` frames go through
        :func:`process_chunked`.

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
        chunked = self._maybe_chunk(
            signal, device=device, generator=generator, vtln_warp=vtln_warp)
        if chunked is not None:
            return chunked
        data = self._compute(signal, vtln_warp, device, generator)
        return Features(
            data, self.times(data.shape[0]),
            properties=self.get_properties(vtln_warp=vtln_warp))
