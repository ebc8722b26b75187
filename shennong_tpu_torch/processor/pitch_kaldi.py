"""Kaldi pitch extraction and post-processing.

Counterpart of :mod:`shennong_tpu.processor.pitch_kaldi`: the NCCF +
Viterbi tracker and the pitch post-processing run as batched PyTorch
programs (:mod:`shennong_tpu_torch.ops.pitch`) on a given device.
"""

import copy

import numpy as np
import torch

from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.ops.pitch import (
    PitchOpts, ProcessPitchOpts, compute_pitch, compute_pitch_long,
    num_pitch_frames, process_pitch)
from shennong_tpu_torch.ops.postops import batch_ragged
from shennong_tpu_torch.processor.base import (
    FeaturesProcessor, fresh_generator)
from shennong_tpu_torch.postprocessor.base import FeaturesPostProcessor


class KaldiPitchProcessor(FeaturesProcessor):
    """NCCF-based pitch tracker (Ghahremani & Povey 2014).

    Produces one row per frame with two columns: the Normalized Cross
    Correlation Function value at the selected lag and the pitch
    estimate in Hz.
    """

    # pitch frame count above which :func:`process` transparently
    # switches to chunked extraction; None disables the routing
    AUTO_CHUNK_FRAMES = 60000

    def __init__(self, sample_rate=16000, frame_shift=0.01,
                 frame_length=0.025, min_f0=50, max_f0=400,
                 soft_min_f0=10, penalty_factor=0.1,
                 lowpass_cutoff=1000, resample_freq=4000,
                 delta_pitch=0.005, nccf_ballast=7000,
                 lowpass_filter_width=1, upsample_filter_width=5):
        super().__init__()
        self.sample_rate = sample_rate
        self.frame_shift = frame_shift
        self.frame_length = frame_length
        self.min_f0 = min_f0
        self.max_f0 = max_f0
        self.soft_min_f0 = soft_min_f0
        self.penalty_factor = penalty_factor
        self.lowpass_cutoff = lowpass_cutoff
        self.resample_freq = resample_freq
        self.delta_pitch = delta_pitch
        self.nccf_ballast = nccf_ballast
        self.lowpass_filter_width = lowpass_filter_width
        self.upsample_filter_width = upsample_filter_width

    @property
    def name(self):
        return 'pitch'

    @property
    def sample_rate(self):
        """Expected sampling rate of the input waveform (Hz).

        Signals handed to process must be sampled at this rate.

        """
        return self._sample_rate

    @sample_rate.setter
    def sample_rate(self, value):
        self._sample_rate = float(value)

    @property
    def frame_shift(self):
        """Time step between two consecutive frames, in seconds"""
        return self._frame_shift

    @frame_shift.setter
    def frame_shift(self, value):
        self._frame_shift = float(value)

    @property
    def frame_length(self):
        """Duration of the analysis window, in seconds"""
        return self._frame_length

    @frame_length.setter
    def frame_length(self, value):
        self._frame_length = float(value)

    @property
    def min_f0(self):
        """Lower bound of the F0 search range (Hz)"""
        return self._min_f0

    @min_f0.setter
    def min_f0(self, value):
        self._min_f0 = float(value)

    @property
    def max_f0(self):
        """Upper bound of the F0 search range (Hz)"""
        return self._max_f0

    @max_f0.setter
    def max_f0(self, value):
        self._max_f0 = float(value)

    @property
    def soft_min_f0(self):
        """Soft lower F0 bound (Hz), penalizing rather than
        excluding low candidates

        Keep it below min_f0.

        """
        return self._soft_min_f0

    @soft_min_f0.setter
    def soft_min_f0(self, value):
        self._soft_min_f0 = float(value)

    @property
    def penalty_factor(self):
        """Weight of the inter-frame pitch-change penalty"""
        return np.float32(self._penalty_factor)

    @penalty_factor.setter
    def penalty_factor(self, value):
        self._penalty_factor = float(value)

    @property
    def lowpass_cutoff(self):
        """Low-pass filter cutoff applied before analysis (Hz)"""
        return self._lowpass_cutoff

    @lowpass_cutoff.setter
    def lowpass_cutoff(self, value):
        self._lowpass_cutoff = float(value)

    @property
    def resample_freq(self):
        """Internal analysis sampling rate (Hz)

        Needs to exceed twice the lowpass_cutoff.

        """
        return self._resample_freq

    @resample_freq.setter
    def resample_freq(self, value):
        self._resample_freq = float(value)

    @property
    def delta_pitch(self):
        """Resolution of the geometric lag grid (relative pitch step)"""
        return np.float32(self._delta_pitch)

    @delta_pitch.setter
    def delta_pitch(self, value):
        self._delta_pitch = float(value)

    @property
    def nccf_ballast(self):
        """Ballast term damping the NCCF on low-energy frames

        Larger values promote smooth pitch tracks through unvoiced
        stretches.

        """
        return self._nccf_ballast

    @nccf_ballast.setter
    def nccf_ballast(self, value):
        self._nccf_ballast = float(value)

    @property
    def lowpass_filter_width(self):
        """Number of zero crossings in the low-pass filter kernel

        Higher values sharpen the transition band.

        """
        return self._lowpass_filter_width

    @lowpass_filter_width.setter
    def lowpass_filter_width(self, value):
        self._lowpass_filter_width = int(value)

    @property
    def upsample_filter_width(self):
        """Kernel width used when interpolating the NCCF onto the
        lag grid"""
        return self._upsample_filter_width

    @upsample_filter_width.setter
    def upsample_filter_width(self, value):
        self._upsample_filter_width = int(value)

    @property
    def ndims(self):
        return 2

    def options(self):
        """All parameters bundled as a static PitchOpts"""
        return PitchOpts(
            sample_rate=self._sample_rate,
            frame_shift_ms=float(np.float32(self._frame_shift * 1000.0)),
            frame_length_ms=float(np.float32(self._frame_length * 1000.0)),
            min_f0=self._min_f0, max_f0=self._max_f0,
            soft_min_f0=self._soft_min_f0,
            penalty_factor=self._penalty_factor,
            lowpass_cutoff=self._lowpass_cutoff,
            resample_freq=self._resample_freq,
            delta_pitch=self._delta_pitch,
            nccf_ballast=self._nccf_ballast,
            lowpass_filter_width=self._lowpass_filter_width,
            upsample_filter_width=self._upsample_filter_width)

    def times(self, nframes):
        """Returns the time label for the rows given by the `process` method"""
        return np.vstack((
            np.arange(nframes) * self.frame_shift,
            np.arange(nframes) * self.frame_shift + self.frame_length)).T

    def output_frames(self, nsamples):
        """Output rows produced for a signal of ``nsamples`` samples
        (pitch frames count on the resampled analysis grid)."""
        return num_pitch_frames(nsamples, self.options())

    def process_all(self, utterances, njobs=None, *, device, **kwargs):
        """Batched pitch extraction over an utterance collection, on
        ``device``, through
        :class:`shennong_tpu_torch.parallel.executor.BatchExecutor`
        (per-utterance arguments take the per-utterance loop).
        ``njobs`` has no effect on the batched path, as in the JAX
        package."""
        if not kwargs:
            from shennong_tpu_torch.parallel.executor import BatchExecutor
            return BatchExecutor(self, device=device).process_all(utterances)
        return super().process_all(
            utterances, njobs=njobs, device=device, **kwargs)

    def _check_signal(self, signal):
        if signal.nchannels != 1:
            raise ValueError(
                'audio signal must have one channel, but it has {}'
                .format(signal.nchannels))
        if self.sample_rate != signal.sample_rate:
            raise ValueError(
                'processor and signal mismatch in sample rates: '
                '{} != {}'.format(self.sample_rate, signal.sample_rate))

    def process(self, signal, *, device):
        """Extract the (NCCF, pitch) per frame of ``signal`` on
        ``device``; output is a [nframes, 2] Features.

        The signal's sample rate must match the processor's. Signals of
        more than ``AUTO_CHUNK_FRAMES`` pitch frames go through
        :func:`process_chunked`.
        """
        self._check_signal(signal)
        opts = self.options()
        nsamp = signal.nsamples
        nframes = num_pitch_frames(nsamp, opts)
        limit = self.AUTO_CHUNK_FRAMES
        if limit and nframes > limit:
            return self.process_chunked(signal, device=device)

        if nframes == 0:
            out = np.zeros((0, 2), dtype=np.float32)
        else:
            data = signal.astype(np.int16).data
            feats = compute_pitch(
                torch.as_tensor(data[None, :], device=device),
                torch.tensor([nsamp], dtype=torch.int32, device=device),
                opts, nframes)
            out = feats[0].cpu().numpy()

        return Features(
            out, self.times(out.shape[0]),
            properties=self.get_properties())

    def process_chunked(self, signal, chunk_frames=8000, halo_frames=200,
                        *, device):
        """Pitch of a very long signal in frame chunks, on ``device``.

        Bounds device memory for hour-scale utterances: the signal is
        resampled in exact aligned chunks, the NCCF ballast uses the
        statistic of the whole signal, and the Viterbi lag selection
        runs per chunk of ``chunk_frames`` frames with ``halo_frames``
        context frames on each side (paths coalesce well inside a 2 s
        halo; see :func:`shennong_tpu_torch.ops.pitch.compute_pitch_long`).
        """
        chunk_frames = int(chunk_frames)
        if chunk_frames < 1:
            raise ValueError(
                f'chunk_frames must be >= 1, it is {chunk_frames}')
        if int(halo_frames) < 0:
            raise ValueError(
                f'halo_frames must be >= 0, it is {halo_frames}')
        self._check_signal(signal)

        data = signal.astype(np.int16).data.astype(np.float32)
        out = compute_pitch_long(
            data, self.options(), chunk_frames=chunk_frames,
            halo_frames=int(halo_frames), device=device)
        return Features(
            out, self.times(out.shape[0]),
            properties=self.get_properties())


class KaldiPitchPostProcessor(FeaturesPostProcessor):
    """Turns raw (NCCF, pitch) pairs into trainable pitch features.

    Up to four columns can be produced, selected by the ``add_*``
    flags: a warped-NCCF probability-of-voicing (POV) feature, a
    POV-weighted mean-subtracted log-pitch, a noised log-pitch delta
    and the raw log-pitch. The default emits the first three. Row
    count always matches the input.
    """

    def __init__(self, pitch_scale=2.0, pov_scale=2.0, pov_offset=0.0,
                 delta_pitch_scale=10.0, delta_pitch_noise_stddev=0.005,
                 normalization_left_context=75,
                 normalization_right_context=75,
                 delta_window=2, delay=0,
                 add_pov_feature=True, add_normalized_log_pitch=True,
                 add_delta_pitch=True, add_raw_log_pitch=False):
        super().__init__()
        self.pitch_scale = pitch_scale
        self.pov_scale = pov_scale
        self.pov_offset = pov_offset
        self.delta_pitch_scale = delta_pitch_scale
        self.delta_pitch_noise_stddev = delta_pitch_noise_stddev
        self.normalization_left_context = normalization_left_context
        self.normalization_right_context = normalization_right_context
        self.delta_window = delta_window
        self.delay = delay
        self.add_pov_feature = add_pov_feature
        self.add_normalized_log_pitch = add_normalized_log_pitch
        self.add_delta_pitch = add_delta_pitch
        self.add_raw_log_pitch = add_raw_log_pitch

    @property
    def name(self):
        return 'pitch postprocessing'

    @property
    def pitch_scale(self):
        """Multiplier applied to the normalized log-pitch column"""
        return self._pitch_scale

    @pitch_scale.setter
    def pitch_scale(self, value):
        self._pitch_scale = float(value)

    @property
    def pov_scale(self):
        """Multiplier applied to the POV feature column"""
        return self._pov_scale

    @pov_scale.setter
    def pov_scale(self, value):
        self._pov_scale = float(value)

    @property
    def pov_offset(self):
        """Constant added to the POV feature

        Useful in online decoding setups that cannot apply cepstral
        mean normalization.

        """
        return self._pov_offset

    @pov_offset.setter
    def pov_offset(self, value):
        self._pov_offset = float(value)

    @property
    def delta_pitch_scale(self):
        """Multiplier applied to the delta log-pitch column"""
        return self._delta_pitch_scale

    @delta_pitch_scale.setter
    def delta_pitch_scale(self, value):
        self._delta_pitch_scale = float(value)

    @property
    def delta_pitch_noise_stddev(self):
        """Stddev of the gaussian noise mixed into the delta log-pitch

        Applied before scaling; pick a value close to the tracker's
        delta_pitch so lag-grid discretization spikes wash out.

        """
        return np.float32(self._delta_pitch_noise_stddev)

    @delta_pitch_noise_stddev.setter
    def delta_pitch_noise_stddev(self, value):
        self._delta_pitch_noise_stddev = float(value)

    @property
    def normalization_left_context(self):
        """Frames of left context in the moving-average
        normalization window"""
        return self._normalization_left_context

    @normalization_left_context.setter
    def normalization_left_context(self, value):
        self._normalization_left_context = int(value)

    @property
    def normalization_right_context(self):
        """Frames of right context in the moving-average
        normalization window"""
        return self._normalization_right_context

    @normalization_right_context.setter
    def normalization_right_context(self, value):
        self._normalization_right_context = int(value)

    @property
    def delta_window(self):
        """Half-width (frames) of the delta computation window"""
        return self._delta_window

    @delta_window.setter
    def delta_window(self, value):
        self._delta_window = int(value)

    @property
    def delay(self):
        """Frame delay applied to the pitch stream before output"""
        return self._delay

    @delay.setter
    def delay(self, value):
        self._delay = int(value)

    @property
    def add_pov_feature(self):
        """Emit the warped-NCCF (POV feature) column"""
        return self._add_pov_feature

    @add_pov_feature.setter
    def add_pov_feature(self, value):
        self._add_pov_feature = bool(value)

    @property
    def add_normalized_log_pitch(self):
        """Emit the mean-subtracted log-pitch column

        The subtracted mean is POV-weighted over the normalization
        window (1.5 s by default).

        """
        return self._add_normalized_log_pitch

    @add_normalized_log_pitch.setter
    def add_normalized_log_pitch(self, value):
        self._add_normalized_log_pitch = bool(value)

    @property
    def add_delta_pitch(self):
        """Emit the log-pitch time-derivative column"""
        return self._add_delta_pitch

    @add_delta_pitch.setter
    def add_delta_pitch(self, value):
        self._add_delta_pitch = bool(value)

    @property
    def add_raw_log_pitch(self):
        """Emit the unnormalized log-pitch column"""
        return self._add_raw_log_pitch

    @add_raw_log_pitch.setter
    def add_raw_log_pitch(self, value):
        self._add_raw_log_pitch = bool(value)

    @property
    def ndims(self):
        return (
            self.add_pov_feature
            + self.add_normalized_log_pitch
            + self.add_delta_pitch
            + self.add_raw_log_pitch)

    def options(self):
        """All parameters bundled as a static ProcessPitchOpts"""
        return ProcessPitchOpts(
            pitch_scale=self._pitch_scale, pov_scale=self._pov_scale,
            pov_offset=self._pov_offset,
            delta_pitch_scale=self._delta_pitch_scale,
            delta_pitch_noise_stddev=self._delta_pitch_noise_stddev,
            normalization_left_context=self._normalization_left_context,
            normalization_right_context=(
                self._normalization_right_context),
            delta_window=self._delta_window, delay=self._delay,
            add_pov_feature=self._add_pov_feature,
            add_normalized_log_pitch=self._add_normalized_log_pitch,
            add_delta_pitch=self._add_delta_pitch,
            add_raw_log_pitch=self._add_raw_log_pitch)

    def get_properties(self, features):
        properties = copy.deepcopy(features.properties)
        properties['pitch'][self.name] = self.get_params()
        properties['pipeline'][0]['columns'] = [0, self.ndims - 1]
        return properties

    def process(self, raw_pitch, *, device, generator=None):
        """Turn raw (NCCF, pitch) features into trainable features, on
        ``device``.

        Output columns are (pov_feature, normalized_log_pitch,
        delta_pitch, raw_log_pitch) in that order, filtered by the
        ``add_*`` flags (at least one must be set). ``generator`` is
        the source of the delta-pitch noise, on ``device`` (a fresh,
        randomly seeded one when None and the noise is on).
        """
        self._validate_flags()

        if raw_pitch.shape[1] != 2:
            raise ValueError(
                'data shape must be (_, 2), but it is (_, {})'
                .format(raw_pitch.shape[1]))

        data = torch.as_tensor(
            raw_pitch.data, dtype=torch.float32, device=device)[None]
        nframes = torch.tensor(
            [raw_pitch.nframes], dtype=torch.int32, device=device)
        noise = None
        if self.add_delta_pitch and self._delta_pitch_noise_stddev != 0:
            if generator is None:
                generator = fresh_generator(device)
            noise = torch.randn(
                data.shape[:2], generator=generator, dtype=torch.float32,
                device=device)

        out = process_pitch(data, nframes, self.options(), noise=noise)
        return Features(
            out[0].cpu().numpy(), raw_pitch.times,
            properties=self.get_properties(raw_pitch))

    def process_collection(self, collection, batch_rows=16, *, device,
                           generator=None):
        """Post-process a whole collection of raw (NCCF, pitch) pairs
        on ``device``.

        Matrices are grouped into padded batches of similar lengths
        (:func:`shennong_tpu_torch.ops.postops.batch_ragged`), each
        batch one :func:`process_pitch` call. ``generator`` is the
        source of the delta-pitch noise, on ``device`` (a fresh,
        randomly seeded one when None and the noise is on). Returns a
        FeaturesCollection keyed like the input.
        """
        self._validate_flags()
        names = list(collection.keys())
        arrays = []
        for name in names:
            feats = collection[name]
            if feats.shape[1] != 2:
                raise ValueError(
                    'data shape must be (_, 2), but it is (_, {})'
                    .format(feats.shape[1]))
            arrays.append(feats.data)

        opts = self.options()
        with_noise = (
            self.add_delta_pitch and self._delta_pitch_noise_stddev != 0)
        if with_noise and generator is None:
            generator = fresh_generator(device)
        outputs = [None] * len(arrays)
        for chunk, stacked, nframes in batch_ragged(
                arrays, batch_rows=batch_rows):
            noise = None
            if with_noise:
                noise = torch.randn(
                    stacked.shape[:2], generator=generator,
                    dtype=torch.float32, device=device)
            out = process_pitch(
                torch.as_tensor(stacked, device=device),
                torch.as_tensor(nframes, device=device), opts,
                noise=noise).cpu().numpy()
            for row, index in enumerate(chunk):
                outputs[index] = out[row, :arrays[index].shape[0]]

        return FeaturesCollection({
            name: Features(
                out, collection[name].times,
                properties=self.get_properties(collection[name]))
            for name, out in zip(names, outputs)})

    def _validate_flags(self):
        if not (self.add_pov_feature or self.add_normalized_log_pitch
                or self.add_delta_pitch or self.add_raw_log_pitch):
            raise ValueError(
                'at least one of the following options must be True: '
                'add_pov_feature, add_normalized_log_pitch, '
                'add_delta_pitch, add_raw_log_pitch')
