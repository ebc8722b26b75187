"""CREPE pitch extraction and post-processing.

Counterpart of :mod:`shennong_tpu.processor.pitch_crepe`, with the same
parameters and outputs. The framing, the normalization and the CNN run
on the device (:mod:`shennong_tpu_torch.models.crepe`); the Viterbi
smoothing of the bin track runs on the host in float64
(:mod:`shennong_tpu_torch.ops.viterbi`, the port's native kernel) or,
with ``decode='device'``, on the device through the hand-written CUDA
kernel of the banded Viterbi. The voicing decision and the POV-to-NCCF
inversion of the post-processor run on the host.
"""

import collections
import concurrent.futures
import copy
import functools
import os
import warnings

import numpy as np
import scipy.signal
import torch

from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.models import crepe
from shennong_tpu_torch.ops.framing import bucket_size
from shennong_tpu_torch.ops.viterbi import (
    _band_matrix, viterbi_host_banded, viterbi_host_banded_obs)
from shennong_tpu_torch.parallel.profiler import counters, span
from shennong_tpu_torch.parallel.stream import as_int16_if_lossless
from shennong_tpu_torch.processor.base import FeaturesProcessor
from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchPostProcessor


class _Fetch:
    """A device tensor's copy to the host, started now: on CUDA the
    copy is queued on the current stream into pinned memory and
    :meth:`result` waits for it alone, so the host can work while
    later device work runs."""

    def __init__(self, tensor):
        self._event = None
        if tensor.device.type == 'cuda':
            self._host = torch.empty(
                tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensor.device))
        else:
            self._host = tensor

    def result(self):
        """The host copy as a numpy array."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _to_local_average_cents(salience, centers):
    """Weighted average of cents around the given center bins."""
    mapping = crepe.cents_mapping()
    out = np.zeros(len(centers))
    for i, center in enumerate(centers):
        start = max(0, int(center) - 4)
        end = min(salience.shape[1], int(center) + 5)
        weights = salience[i, start:end]
        out[i] = np.sum(weights * mapping[start:end]) / np.sum(weights)
    return out


def _local_average_from_neighborhoods(neigh, centers):
    """:func:`_to_local_average_cents` from 9-bin neighborhoods
    (``neigh[i, d]`` holds salience[i, centers[i] - 4 + d], zeros
    outside the bin range, see crepe.gather_neighborhood)."""
    mapping = crepe.cents_mapping()
    idx = centers[:, None].astype(np.int64) + np.arange(-4, 5)
    valid = (idx >= 0) & (idx < mapping.shape[0])
    map_n = np.where(
        valid, mapping[np.clip(idx, 0, mapping.shape[0] - 1)], 0.0)
    with np.errstate(invalid='ignore', divide='ignore'):
        return (neigh * map_n).sum(axis=1) / neigh.sum(axis=1)


class _DeviceSalience:
    """CREPE salience chunks kept on the device, with host statistics.

    The decode needs only the per-frame argmax bin, the per-frame
    maximum (confidence) and a 9-bin neighborhood around the decoded
    path, so the [n, 360] matrix never leaves the device.
    """

    def __init__(self, chunks, counts, argmax, amax):
        self.chunks = chunks    # [chunk_frames, 360] device tensors
        self.counts = counts    # kept frames per chunk
        self.argmax = argmax    # [n] per-frame argmax bin (host)
        self.amax = amax        # [n] per-frame max salience (host)

    def neighborhoods(self, centers):
        """[n, 9] salience values around per-frame center bins, zeros
        outside the bin range."""
        pending, lo = [], 0
        for sal, keep in zip(self.chunks, self.counts):
            c = np.zeros(sal.shape[0], np.int32)
            c[:keep] = centers[lo:lo + keep]
            # every gather is queued before the first wait
            pending.append(_Fetch(crepe.gather_neighborhood(
                sal, torch.as_tensor(c, device=sal.device))))
            lo += keep
        if not pending:
            return np.zeros((0, 9), np.float32)
        return np.concatenate([
            fetch.result()[:keep]
            for fetch, keep in zip(pending, self.counts)])


def _crepe_prior(nstates):
    """(start, transition, emission) of the CREPE smoothing HMM."""
    start = np.full(nstates, 1.0 / nstates)

    grid = np.arange(nstates)
    transition = np.maximum(12 - np.abs(grid[:, None] - grid[None, :]), 0)
    transition = transition / transition.sum(axis=1, keepdims=True)

    self_emission = 0.1
    emission = (np.eye(nstates) * self_emission
                + (1 - self_emission) / nstates)
    return start, transition, emission


@functools.lru_cache(maxsize=4)
def _crepe_prior_logs(nstates):
    """(log start, log transition, uniform log weight, self log
    weight, transition band) of the smoothing prior, built once per
    state count."""
    start, transition, emission = _crepe_prior(nstates)
    with np.errstate(divide='ignore'):
        log_trans = np.log(transition)
        return (np.log(start), log_trans,
                float(np.log(emission[1, 0])),
                float(np.log(emission[0, 0])),
                _band_matrix(log_trans, 11))


def _to_viterbi_cents(salience):
    """Viterbi-smoothed cents decode (360-state banded prior)."""
    observations = np.argmax(salience, axis=1)
    path = _viterbi_bin_path(observations, salience.shape[1])
    return _to_local_average_cents(salience, path)


def _viterbi_bin_path(observations, nstates):
    """The smoothed bin path of an argmax bin sequence: the banded
    (halfwidth 11) two-valued host decoder, bit-equal to the dense
    one."""
    (log_start, log_trans, uniform_w, self_w,
     band) = _crepe_prior_logs(nstates)
    return viterbi_host_banded_obs(
        log_start, log_trans, observations, uniform_w, self_w, 11,
        band=band)


def _nccf_to_pov(x):
    """From Normalized Cross Correlation to Probability of Voicing"""
    y = (-5.2 + 5.4 * np.exp(7.5 * (x - 1)) + 4.8 * x
         - 2 * np.exp(-10 * x) + 4.2 * np.exp(20 * (x - 1)))
    return 1 / (1 + np.exp(-y))


def _pov_to_nccf(pov):
    """Inverse of :func:`_nccf_to_pov` on [0, 1], by interpolation on a
    dense grid (the mapping is strictly increasing there)."""
    grid = np.linspace(0.0, 1.0, 4097)
    values = _nccf_to_pov(grid)
    return np.interp(pov, values, grid)


def predict_voicing(confidence):
    """Viterbi-smoothed voiced/unvoiced decision from confidence.

    A 2-state HMM with gaussian emissions (means 0 and 1, variance
    0.25) and sticky transitions; returns 0/1 per frame.
    """
    means = np.array([0.0, 1.0])
    variance = 0.25
    log_obs = (
        -0.5 * ((confidence[:, None] - means[None, :]) ** 2 / variance
                + np.log(2 * np.pi * variance)))
    log_start = np.log(np.array([0.5, 0.5]))
    log_trans = np.log(np.array([[0.99, 0.01], [0.01, 0.99]]))
    # halfwidth 1 covers the whole 2x2 transition matrix, so the
    # banded decoder is exact
    return viterbi_host_banded(log_start, log_trans, log_obs, 1)


class CrepePitchProcessor(FeaturesProcessor):
    """Extracts the (POV, pitch) per frame from a speech signal

    This processor uses the pre-trained CREPE model. The output will have as
    many rows as there are frames, and two columns corresponding to (POV,
    pitch). POV is the Probability of Voicing.

    ``weights`` (an extension, not a reference parameter) is the path of
    the model's weights, an npz in the converted keras layout, for
    weights kept outside the package; None, the default, takes the
    installed ``share/crepe/model-<model_capacity>.npz``.

    """

    # frames per CNN call of one signal; longer signals run in chunks
    # of this many frames (bounds the first conv layer's activation)
    CHUNK_FRAMES = 8192

    def __init__(self, model_capacity='full', viterbi=True, center=True,
                 frame_shift=0.01, frame_length=0.025, decode='host',
                 weights=None):
        super().__init__()
        self.model_capacity = model_capacity
        self.viterbi = viterbi
        self.center = center
        self.frame_shift = frame_shift
        self.frame_length = frame_length
        self.decode = decode
        self.weights = weights

    @property
    def name(self):
        return 'crepe'

    @property
    def model_capacity(self):
        """String specifying the model capacity to use

        Must be 'tiny', 'small', 'medium', 'large' or 'full' (the
        default, as in the reference). Only the 'tiny' weights ship
        with the package; other capacities must be converted once from
        the published CREPE checkpoints with ``speech-features-torch
        convert-crepe`` (processing raises a RuntimeError when the
        requested weights are not installed).

        """
        return self._model_capacity

    @model_capacity.setter
    def model_capacity(self, value):
        if value not in crepe.CAPACITY_MULTIPLIER:
            raise ValueError(
                f'Model capacity {value} is not recognized.')
        self._model_capacity = value

    @property
    def viterbi(self):
        """Whether to apply viterbi smoothing to the estimated pitch curve"""
        return self._viterbi

    @viterbi.setter
    def viterbi(self, value):
        self._viterbi = bool(value)

    @property
    def center(self):
        """Whether to center the window on the current frame.

        When True, the output frame :math:`t` is centered at `audio[t *
        hop_length]`. When False, the frame begins at `audio[t * hop_length]`.

        """
        return self._center

    @center.setter
    def center(self, value):
        self._center = bool(value)

    @property
    def decode(self):
        """Where the bin decode runs: 'host' or 'device'.

        'host' (the default) runs the Viterbi smoothing and the cents
        averaging on the host in float64, with the reference's
        tie-breaking. 'device' (an extension, not a reference
        parameter) runs the whole decode (banded Viterbi, neighborhood
        cents, confidence) on the device, the Viterbi as one CUDA
        kernel per slice, so no host decode sits on the critical path.
        Its float32 scores may resolve near-tie plateaus differently
        from the float64 host decode (a frame's bin then moves by one
        20-cent step; the confidences are the same). Applies to the
        batched whole-utterance ``process_all`` path; utterances past
        ``CHUNK_FRAMES`` frames keep the host decode.
        """
        return self._decode_mode

    @decode.setter
    def decode(self, value):
        if value not in ('host', 'device'):
            raise ValueError(
                f"decode must be 'host' or 'device', got {value}")
        self._decode_mode = value

    @property
    def weights(self):
        """Path of the model's weights, or None for the installed ones

        An npz file in the converted keras layout (what
        ``speech-features-torch convert-crepe`` writes), whose widths
        must be those of ``model_capacity`` (processing raises a
        ValueError otherwise). None takes
        ``share/crepe/model-<model_capacity>.npz``. An extension, not a
        reference parameter: seeded or converted weights kept outside
        the package.

        """
        return self._weights

    @weights.setter
    def weights(self, value):
        self._weights = None if value is None else os.fspath(value)

    def _model(self, device):
        return crepe.load_model(self.model_capacity, device, self.weights)

    @property
    def frame_shift(self):
        """"Frame shift in seconds for running pitch estimation"""
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
    def sample_rate(self):
        """CREPE operates at 16kHz"""
        return 16000

    @property
    def ndims(self):
        return 2

    def times(self, nframes):
        """Returns the time label for the rows given by :func:`process`"""
        return np.vstack((
            np.arange(nframes) * self.frame_shift,
            np.arange(nframes) * self.frame_shift + self.frame_length)).T

    def _model_frames(self, audio):
        """Normalized 1024-sample model input frames of one signal, on
        the host (the reference path the device framing is held to).

        The reference normalizes in place through an overlapping
        strided view of the audio, so sample ``s`` ends up normalized
        with the statistics of the last frame covering it, frame
        ``min(n-1, s // hop)``; this is that closed form.
        """
        audio = audio.astype(np.float32)
        if self.center:
            audio = np.pad(audio, 512, mode='constant')

        hop = int(16000 * self.frame_shift)
        n_frames = crepe.frame_count(len(audio), hop)
        if n_frames == 0:
            return np.zeros((0, 1024), dtype=np.float32)

        def strided(buf):
            return np.lib.stride_tricks.as_strided(
                buf, shape=(n_frames, 1024),
                strides=(hop * buf.itemsize, buf.itemsize)).copy()

        covered = (n_frames - 1) * hop + 1024
        owner = np.minimum(n_frames - 1, np.arange(covered) // hop)

        frames = strided(audio)
        mean = frames.mean(axis=1)
        audio[:covered] -= mean[owner]
        frames = strided(audio)
        std = frames.std(axis=1)
        audio[:covered] /= np.maximum(std[owner], 1e-38)
        return strided(audio)

    def _forward(self, frames, device):
        """CNN forward over [n, 1024] host frames on ``device``; returns
        the [n, 360] activations on the host."""
        model = self._model(device)
        with torch.no_grad():
            return model(torch.as_tensor(frames, device=device)).cpu().numpy()

    def _decode(self, activation, nsamples):
        """Decode one utterance's activations into (POV, pitch)."""
        if activation.shape[0] == 0:
            return self._finish_decode(None, None, nsamples)
        confidence = activation.max(axis=1)
        if self.viterbi:
            cents = _to_viterbi_cents(activation)
        else:
            cents = _to_local_average_cents(
                activation, np.argmax(activation, axis=1))
        return self._finish_decode(confidence, cents, nsamples)

    def _device_salience(self, audio, device):
        """Framing, normalization and CNN of one signal on ``device``,
        in chunks of at most ``CHUNK_FRAMES`` frames.

        Uploads the raw audio (int16 when it is integer-valued) and
        keeps the [n, 360] salience on the device; only the per-frame
        argmax and maximum come to the host. Returns a
        :class:`_DeviceSalience`, or None when the signal is shorter
        than one model window. Every chunk's salience stays on the
        device until the decode has gathered its neighborhoods.
        """
        audio = np.ascontiguousarray(audio, dtype=np.float32)
        if self.center:
            audio = np.pad(audio, 512, mode='constant')
        hop = int(16000 * self.frame_shift)
        nframes = crepe.frame_count(len(audio), hop)
        if nframes == 0:
            return None

        halo = crepe.required_halo(hop)
        cap = self.CHUNK_FRAMES
        chunk = cap if nframes > cap else bucket_size(nframes, minimum=128)
        model = self._model(device)

        seg_len, pad_left = crepe.segment_geometry(hop, chunk, halo)
        last_start = (nframes - 1) // chunk * chunk * hop
        buf = np.zeros(
            max(pad_left + len(audio), last_start + seg_len), np.float32)
        buf[pad_left:pad_left + len(audio)] = audio
        buf = as_int16_if_lossless(buf)

        # every chunk is queued before the first wait
        chunks, counts, pending = [], [], []
        with torch.no_grad():
            for f0 in range(0, nframes, chunk):
                segment = torch.as_tensor(
                    buf[f0 * hop:f0 * hop + seg_len][None], device=device)
                owner = torch.full(
                    (1,), nframes - 1 - f0 + halo, dtype=torch.int32,
                    device=device)
                counts.append(min(chunk, nframes - f0))
                sal, packed = crepe.forward_audio_chunk(
                    model, segment, owner, hop, chunk, halo,
                    counts=counts[-1:])
                chunks.append(sal[0])
                pending.append(_Fetch(packed))
        stats = [fetch.result() for fetch in pending]
        argm = [s[0, :keep, 0].astype(np.int32)
                for s, keep in zip(stats, counts)]
        amax = [np.ascontiguousarray(s[0, :keep, 1])
                for s, keep in zip(stats, counts)]
        return _DeviceSalience(
            chunks, counts, np.concatenate(argm), np.concatenate(amax))

    def _check_audio(self, audio):
        """Mono check + transparent resampling to the model rate."""
        if audio.nchannels != 1:
            raise ValueError(
                f'audio must have one channel but has {audio.nchannels}')
        if audio.sample_rate != self.sample_rate:
            self.log.debug('resampling audio to 16 kHz')
            audio = audio.resample(self.sample_rate)
        return audio

    def process_all(self, utterances, njobs=None, *, device, **kwargs):
        """Batched extraction over an utterance collection on
        ``device``.

        Utterances are grouped into frame-count buckets; each slice of
        a group runs framing, normalization and CNN as one batched
        call over the raw audio, the CNN on the utterances' real frames
        alone (not the padding up to the bucket, nor the slice's empty
        rows), and only per-frame statistics plus the
        decoded path's neighborhoods come to the host. With the host
        decode, a group splits into about four slices so that the CNN
        of later slices runs on the device while the host decodes the
        earlier ones. Utterances past ``CHUNK_FRAMES`` frames take the
        chunked single-utterance path. ``njobs`` has no effect: the
        audio is loaded one utterance at a time.
        """
        if kwargs:
            return super().process_all(
                utterances, njobs=njobs, device=device, **kwargs)

        hop = int(16000 * self.frame_shift)
        halo = crepe.required_halo(hop)
        collection = FeaturesCollection()

        groups = {}  # bucket -> [(name, nsamples, padded, nframes)]
        for utt in utterances:
            with span('crepe.load', 'crepe_load_s'):
                audio = self._check_audio(utt.load_audio())
                data = np.ascontiguousarray(audio.data, dtype=np.float32)
                if self.center:
                    data = np.pad(data, 512, mode='constant')
            nframes = crepe.frame_count(len(data), hop)
            if nframes == 0:
                collection[utt.name] = self._finish_decode(
                    None, None, audio.shape[0])
            elif nframes > self.CHUNK_FRAMES:
                collection[utt.name] = self._decode_salience(
                    self._device_salience(audio.data, device),
                    audio.shape[0])
            else:
                groups.setdefault(
                    bucket_size(nframes, minimum=128), []).append(
                    (utt.name, audio.shape[0], data, nframes))
        if not groups:
            return collection

        model = self._model(device)
        device_decode = self._decode_mode == 'device'
        if device_decode:
            (dec_log_start, _, dec_uniform, dec_self,
             dec_band) = _crepe_prior_logs(360)
            dec_mapping = crepe.cents_mapping()

        # up to `depth` slices in flight: the CNN of the later ones runs
        # while the host decodes the earliest, and each slice's salience
        # stays on the device until its neighborhoods are gathered
        depth = 3
        inflight = collections.deque()  # (part, bucket, sal, stats fetch)
        gathers = collections.deque()   # (part, bucket, mx, centers, fetch)
        pending = []                    # (name, confidence, cents, nsamples)

        # the rows of a slice decode independently and the native
        # kernel releases the GIL, so they decode across host cores
        workers = min(8, os.cpu_count() or 1)
        decode_pool = (
            concurrent.futures.ThreadPoolExecutor(workers)
            if self.viterbi and workers > 1 else None)

        def decode_slice():
            part, bucket, sal, fetch = inflight.popleft()
            stats = fetch.result()
            with span('crepe.decode', 'crepe_decode_s'):
                am = stats[..., 0].astype(np.int32)
                mx = np.ascontiguousarray(stats[..., 1])
                centers = np.zeros((am.shape[0], bucket), np.int32)

                def fill(task):
                    i, nframes = task
                    obs = am[i, :nframes]
                    centers[i, :nframes] = (
                        _viterbi_bin_path(obs, 360) if self.viterbi
                        else obs)

                tasks = [(i, item[3]) for i, item in enumerate(part)]
                if decode_pool is not None and len(tasks) > 1:
                    list(decode_pool.map(fill, tasks))
                else:
                    for task in tasks:
                        fill(task)
            neigh = crepe.gather_neighborhood(
                sal.reshape(-1, sal.shape[-1]),
                torch.as_tensor(centers.reshape(-1), device=sal.device))
            gathers.append((part, bucket, mx, centers, _Fetch(neigh)))

        def assemble_slice():
            part, bucket, mx, centers, fetch = gathers.popleft()
            neigh = fetch.result().reshape(centers.shape[0], bucket, 9)
            for i, (name, nsamples, _, nframes) in enumerate(part):
                cents = _local_average_from_neighborhoods(
                    neigh[i, :nframes], centers[i, :nframes])
                pending.append((name, mx[i, :nframes], cents, nsamples))

        def assemble_device_slice():
            part, _, _, fetch = inflight.popleft()
            dec = fetch.result()  # [rows, bucket, 2]
            for i, (name, nsamples, _, nframes) in enumerate(part):
                pending.append((
                    name,
                    np.ascontiguousarray(dec[i, :nframes, 1]),
                    np.ascontiguousarray(dec[i, :nframes, 0]),
                    nsamples))

        finish = assemble_device_slice if device_decode else decode_slice
        try:
            with torch.no_grad():
                for bucket, items in sorted(groups.items()):
                    seg_len, pad_left = crepe.segment_geometry(
                        hop, bucket, halo)
                    # at most 16384 frames per slice; the host decode
                    # splits a group in about depth + 1 slices to
                    # pipeline against, the device decode has no host
                    # stage and takes the whole group
                    split = 1 if device_decode else depth + 1
                    rows = max(1, min(
                        16384 // bucket,
                        bucket_size(-(-len(items) // split), minimum=4)
                        if len(items) > 1 else 1))
                    for lo in range(0, len(items), rows):
                        part = items[lo:lo + rows]
                        segments = np.zeros((rows, seg_len), np.float32)
                        owners = np.zeros(rows, np.int32)
                        # real frames a row, 0 on the rows past the part:
                        # the CNN runs on those frames alone
                        counts = np.zeros(rows, np.int64)
                        for i, (_, _, data, nframes) in enumerate(part):
                            segments[i, pad_left:pad_left + len(data)] = data
                            owners[i] = nframes - 1 + halo
                            counts[i] = nframes
                        with span('crepe.cnn', 'crepe_cnn_s'):
                            sal, packed = crepe.forward_audio_chunk(
                                model,
                                torch.as_tensor(
                                    as_int16_if_lossless(segments),
                                    device=device),
                                torch.as_tensor(owners, device=device),
                                hop, bucket, halo, counts=counts)
                        counters.add('crepe_slices')
                        counters.add('crepe_cnn_frames', int(counts.sum()))
                        counters.add('crepe_frames',
                                     sum(item[3] for item in part))
                        if device_decode:
                            lengths = np.ones(rows, np.int32)
                            for i, item in enumerate(part):
                                lengths[i] = max(1, item[3])
                            dec = crepe.decode_salience_chunk(
                                sal, torch.as_tensor(lengths, device=device),
                                dec_log_start, dec_band, dec_uniform,
                                dec_self, dec_mapping,
                                viterbi=bool(self.viterbi))
                            inflight.append((part, bucket, None, _Fetch(dec)))
                        else:
                            inflight.append(
                                (part, bucket, sal, _Fetch(packed)))
                        if len(inflight) >= depth:
                            finish()
                        if len(gathers) >= depth:
                            assemble_slice()
                while inflight:
                    finish()
                while gathers:
                    assemble_slice()
        finally:
            if decode_pool is not None:
                decode_pool.shutdown()
        for name, feats in self._finish_decode_batch(pending):
            collection[name] = feats
        return collection

    def _finish_decode_batch(self, items):
        """Grid-resample many decoded tracks, grouped.

        ``items`` is a list of (name, confidence, cents, nsamples).
        Utterances sharing an (input frames, output frames) geometry
        resample as one vectorized call, with the outputs of
        :meth:`_finish_decode`. Yields (name, Features).
        """
        hop = np.round(self.sample_rate * self.frame_shift).astype(int)
        groups = {}
        for name, confidence, cents, nsamples in items:
            out_frames = 1 + int(
                (nsamples - self.frame_length * self.sample_rate) / hop)
            if confidence is None or out_frames <= 0:
                yield name, Features(
                    np.zeros((0, 2)), self.times(0),
                    properties=self.get_properties())
                continue
            frequency = 10 * 2 ** (cents / 1200)
            frequency[np.isnan(frequency)] = 0
            groups.setdefault(
                (confidence.shape[0], out_frames), []).append(
                (name, confidence, frequency))

        for (_, out_frames), members in groups.items():
            stack = np.stack([
                np.stack([confidence, frequency], axis=1)
                for _, confidence, frequency in members])
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                data = scipy.signal.resample(stack, out_frames, axis=1)
            data[..., 0] = np.where(
                data[..., 0] < 1e-2, 0, np.minimum(data[..., 0], 1))
            for row, (name, _, _) in enumerate(members):
                yield name, Features(
                    data[row], self.times(out_frames),
                    properties=self.get_properties())

    def process(self, audio, *, device):
        """Extract (confidence, pitch) using CREPE on ``device``.

        The audio is transparently resampled to 16 kHz; the CNN output
        grid is resampled onto the processor's frame grid.
        """
        audio = self._check_audio(audio)
        return self._decode_salience(
            self._device_salience(audio.data, device), audio.shape[0])

    def _decode_salience(self, salience, nsamples):
        """Decode a :class:`_DeviceSalience` into (POV, pitch), on the
        host."""
        if salience is None:
            return self._finish_decode(None, None, nsamples)
        if self.viterbi:
            centers = _viterbi_bin_path(salience.argmax, 360)
        else:
            centers = salience.argmax
        cents = _local_average_from_neighborhoods(
            salience.neighborhoods(centers), centers)
        return self._finish_decode(salience.amax, cents, nsamples)

    def _finish_decode(self, confidence, cents, nsamples):
        """(confidence, cents) -> (POV, pitch) on the output grid."""
        hop = np.round(self.sample_rate * self.frame_shift).astype(int)
        out_frames = 1 + int(
            (nsamples - self.frame_length * self.sample_rate) / hop)
        if confidence is None or out_frames <= 0:
            # audio shorter than one model window or one output frame
            return Features(
                np.zeros((0, 2)), self.times(0),
                properties=self.get_properties())

        frequency = 10 * 2 ** (cents / 1200)
        frequency[np.isnan(frequency)] = 0

        # resample onto the target frame grid
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            data = scipy.signal.resample(
                np.array([confidence, frequency]).T, out_frames)

        # clamp the interpolated confidences into [0, 1]
        data[data[:, 0] < 1e-2, 0] = 0
        data[data[:, 0] > 1, 0] = 1

        return Features(
            data, self.times(data.shape[0]),
            properties=self.get_properties())


class CrepePitchPostProcessor(KaldiPitchPostProcessor):
    """Processes the raw (POV, pitch) computed by the CrepePitchProcessor

    Turns the raw pitch quantities into usable features. Converts the POV into
    NCCF usable by the Kaldi-style post-processing, then removes the pitch at
    frames judged unvoiced (2-state HMM on the confidence) and replaces them
    with interpolated values, finally runs the standard pitch
    post-processing.

    """

    def __init__(self, pitch_scale=2.0, delta_pitch_scale=10.0,
                 delta_pitch_noise_stddev=0.005,
                 normalization_left_context=75,
                 normalization_right_context=75,
                 delta_window=2, delay=0,
                 add_pov_feature=True, add_normalized_log_pitch=True,
                 add_delta_pitch=True, add_raw_log_pitch=False):
        super().__init__(
            pitch_scale=pitch_scale,
            delta_pitch_scale=delta_pitch_scale,
            delta_pitch_noise_stddev=delta_pitch_noise_stddev,
            normalization_left_context=normalization_left_context,
            normalization_right_context=normalization_right_context,
            delta_window=delta_window,
            delay=delay,
            add_pov_feature=add_pov_feature,
            add_normalized_log_pitch=add_normalized_log_pitch,
            add_delta_pitch=add_delta_pitch,
            add_raw_log_pitch=add_raw_log_pitch)

    @property
    def name(self):
        return 'crepe postprocessing'

    def get_properties(self, features):
        properties = copy.deepcopy(features.properties)
        properties['crepe'][self.name] = self.get_params()
        properties['pipeline'][0]['columns'] = [0, self.ndims - 1]
        return properties

    def process(self, crepe_pitch, *, device, generator=None):
        """Post-process raw (POV, pitch) from CREPE on ``device``.

        Unvoiced frames get interpolated pitch values (on the host);
        the POV column is inverted into an NCCF before the Kaldi-style
        post-processing runs. ``generator`` is the source of the
        delta-pitch noise, on ``device``.
        """
        if not (self.add_pov_feature or self.add_normalized_log_pitch
                or self.add_delta_pitch or self.add_raw_log_pitch):
            raise ValueError(
                'at least one of the following options must be True: '
                'add_pov_feature, add_normalized_log_pitch, '
                'add_delta_pitch, add_raw_log_pitch')

        if crepe_pitch.shape[1] != 2:
            raise ValueError(
                'data shape must be (_, 2), but it is (_, {})'
                .format(crepe_pitch.shape[1]))

        # interpolate pitch through unvoiced gaps
        to_remove = predict_voicing(crepe_pitch.data[:, 0]) == 0
        if np.all(to_remove):
            raise ValueError('No voiced frames')

        data = crepe_pitch.data[:, 1].copy()
        keep = np.where(~to_remove)[0]
        first, last = keep[0], keep[-1]
        first_value, last_value = data[first], data[last]
        data[to_remove] = np.interp(
            np.where(to_remove)[0], keep, data[keep])
        data[:first] = first_value
        data[last:] = last_value

        if not np.all(data > 0):
            raise ValueError(
                'Not all pitch values are positive: issue with '
                'extracted pitch or interpolation')

        nccf = _pov_to_nccf(np.clip(crepe_pitch.data[:, 0], 0, 1))

        return super().process(
            Features(np.vstack((nccf, data)).T, crepe_pitch.times,
                     crepe_pitch.properties),
            device=device, generator=generator)
