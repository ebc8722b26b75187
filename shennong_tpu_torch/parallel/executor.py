"""Batched extraction over whole utterance collections, on one device.

Counterpart of :mod:`shennong_tpu.parallel.executor` (without a mesh).
Utterances are planned into padded length-sorted batches, decoded ahead
on host threads and uploaded as int16 from pinned memory
(:mod:`shennong_tpu_torch.parallel.stream`).

- :class:`FusedPipelineExecutor` runs the pipeline's pass 1 as one
  program per batch
  (:func:`shennong_tpu_torch.parallel.fused.pass_one_program`).
  Up to ``depth`` batches are in flight: a batch's outputs, packed
  into one uint8 payload
  (:func:`shennong_tpu_torch.parallel.fused.pack_payload`, optionally
  in half precision), are copied to a pinned host buffer behind a CUDA
  event, and the host only waits on that event when it drains the
  batch, ``depth`` dispatches later.
- :class:`BatchExecutor` runs one frame processor per sweep (the
  stage-wise pass 1, and ``process_all``), sending hour-scale
  utterances through the processor's chunked extraction; for LVTLN
  training it also extracts MFCCs at every warp class at once
  (``process_all_classes``) or reduces them to the classes' mapping
  moments on the device (``accumulate_lvtln_stats``).

The host spans ``pass1.dispatch``/``pass1.wait`` (fused) and
``batch.dispatch``/``batch.wait`` (stage-wise) mark enqueuing a batch
and blocking on its outputs, ``batch.chunked`` the whole chunked
extraction of one hour-scale utterance, ``vtln.moments`` the warp-class
moments of one batch; they are profiler annotations
(:func:`torch.profiler.record_function`), which cost nothing
measurable when no profiler runs. The fused pass 1 and
``BatchExecutor.process_all`` also add to the counters of
:mod:`shennong_tpu_torch.parallel.profiler` (``dispatch_s``,
``dispatches``, ``bytes_up``, ``fetch_s``, ``bytes_down``). Every
consumer hands a batch's host buffer back to the stream's pool once the
copy that reads it has finished.
"""

import collections
import dataclasses
import math

import numpy as np
import torch

from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.ops import pitch as pitch_ops
from shennong_tpu_torch.ops import plp as plp_ops
from shennong_tpu_torch.ops import spectral
from shennong_tpu_torch.ops.framing import num_frames
from shennong_tpu_torch.parallel import stream
from shennong_tpu_torch.parallel.fused import (
    FETCH_DTYPES, pack_payload, pass_one_program)
from shennong_tpu_torch.parallel.profiler import counters
from shennong_tpu_torch.processor.base import fresh_generator


class FusedPipelineExecutor:
    """Pipeline pass 1 as one fused program per signal batch.

    Parameters
    ----------
    feat_proc : MfccProcessor, FilterbankProcessor, PlpProcessor or
        SpectrogramProcessor
        The features processor.
    warps : dict, optional
        VTLN warp of each utterance by name (mel-based features).
    energy_proc, vad_proc : optional
        An EnergyProcessor and a VadPostProcessor: enable the VAD
        output (used to weight the CMVN statistics).
    pitch_proc, pitch_post : optional
        A KaldiPitchProcessor and a KaldiPitchPostProcessor: enable
        the post-processed pitch output.
    device : str or torch.device
        Where the program runs.
    batch_size : int
        Utterances per batch, default 64.
    depth : int
        Batches in flight (and decoded ahead), default 2.
    generator : torch.Generator, optional
        Source of the dithers and the pitch noise, on ``device``. A
        fresh, randomly seeded one is made when a random stage is on
        and none is given.
    signal_cache : SignalCache, optional
        Replays the signal batches an earlier sweep over the same
        utterances uploaded (VTLN training before the warped
        extraction), instead of decoding and uploading them again.
    fetch_dtype : str, optional
        Precision of the features and pitch on their way to the host:
        'float32' (None, the default, bit-exact), 'float16' or
        'bfloat16' (half the bytes; the host upcasts them to float32,
        which keeps the reduced precision). Any other name raises
        ValueError.
    """

    def __init__(self, feat_proc, warps=None, energy_proc=None,
                 vad_proc=None, pitch_proc=None, pitch_post=None, *,
                 device, batch_size=64, depth=2, generator=None,
                 signal_cache=None, fetch_dtype='float32'):
        self.feat_proc = feat_proc
        self.warps = warps
        self.energy_proc = energy_proc
        self.vad_proc = vad_proc
        self.pitch_proc = pitch_proc
        self.pitch_post = pitch_post
        self.device = torch.device(device)
        self.batch_size = int(batch_size)
        self.depth = max(1, int(depth))
        self.generator = generator
        self.signal_cache = signal_cache
        self.fetch_dtype = check_fetch_dtype(fetch_dtype)

    def _static_opts(self):
        """The per-run static configuration of the fused program."""
        opts = {'kind': self.feat_proc.name,
                'feat_opts': self.feat_proc.options()}
        if self.energy_proc is not None:
            opts['energy_opts'] = self.energy_proc.options()
            opts['compression'] = self.energy_proc.compression
            vproc = self.vad_proc
            opts['vad_opts'] = (
                vproc.energy_threshold, vproc.energy_mean_scale,
                vproc.frames_context, vproc.proportion_threshold)
        if self.pitch_proc is not None:
            opts['pitch_opts'] = self.pitch_proc.options()
            opts['post_opts'] = self.pitch_post.options()
            opts['with_noise'] = bool(
                self.pitch_post.add_delta_pitch
                and self.pitch_post.delta_pitch_noise_stddev != 0)
        return opts

    def _generator(self, static):
        """The generator of the run, or None when nothing is random."""
        energy = static.get('energy_opts')
        random = (static['feat_opts'].frame.dither != 0
                  or (energy is not None and energy.frame.dither != 0)
                  or static.get('with_noise', False))
        if not random:
            return None
        if self.generator is not None:
            return self.generator
        return fresh_generator(self.device)

    def run(self, utterances, njobs=4, on_utterance=None):
        """Extract pass 1 for every utterance, decoding the audio that
        the native loader does not read on ``njobs`` threads.

        Returns ``(features, vads, pitches)``: a FeaturesCollection, a
        dict of per-frame uint8 VAD decisions (or None) and a
        FeaturesCollection of post-processed pitch (or None).

        With ``on_utterance`` given, each utterance is handed to
        ``on_utterance(name, features, vad, pitch)`` as its batch is
        drained, instead of being collected (the returned collections
        stay empty). An exception it raises stops the run at once.
        """
        utterances = list(utterances)
        _check_sample_rates(utterances, self.feat_proc)
        if self.pitch_post is not None:
            self.pitch_post._validate_flags()

        static = self._static_opts()
        generator = self._generator(static)
        frame_opts = static['feat_opts'].frame
        # without warps every batch shares one mel bank, uploaded once
        shared_mel = (None if self.warps is not None
                      else _mel_inputs(self.feat_proc, None, 0, None,
                                       self.device))
        cuda = self.device.type == 'cuda'

        features = FeaturesCollection()
        vads = {} if self.energy_proc is not None else None
        pitches = (
            FeaturesCollection() if self.pitch_proc is not None else None)

        def dispatch(names, signals, nsamples):
            with torch.profiler.record_function('pass1.dispatch'), \
                    counters.timed('dispatch_s'):
                stream.count_upload(signals, nsamples)
                counters.add('dispatches')
                return _dispatch(names, signals, nsamples)

        def _dispatch(names, signals, nsamples):
            kwargs = dict(static)
            kwargs['nframes_max'] = num_frames(signals.shape[1], frame_opts)
            if self.pitch_proc is not None:
                kwargs['pitch_frames_max'] = pitch_ops.num_pitch_frames(
                    signals.shape[1], kwargs['pitch_opts'])
            dev_signals = signals.to(self.device, non_blocking=True)
            dev_nsamples = torch.from_numpy(nsamples).to(
                self.device, non_blocking=True)
            if shared_mel is not None:
                mel_weights, equal_loudness = shared_mel
            else:
                mel_weights, equal_loudness = _mel_inputs(
                    self.feat_proc, names, signals.shape[0], self.warps,
                    self.device)
            out = pass_one_program(
                dev_signals, dev_nsamples, mel_weights, equal_loudness,
                device=self.device, generator=generator, **kwargs)
            layout = _payload_layout(out, self.fetch_dtype)
            payload = pack_payload(
                [out[key] for key, _, _ in layout], dtype=self.fetch_dtype)
            if not cuda:
                return names, nsamples, layout, payload, None, signals
            # one asynchronous copy into a pinned buffer; the event marks
            # it done (and the input upload with it)
            host = stream.payloads.take(payload.shape, pin_memory=True)
            host.copy_(payload, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return names, nsamples, layout, host, done, signals

        def drain(names, nsamples, layout, payload, done, signals):
            with counters.timed('fetch_s'):
                if done is not None:
                    with torch.profiler.record_function('pass1.wait'):
                        done.synchronize()
                host = _unpack_payload(payload, layout)
            counters.add('bytes_down', payload.numel())
            # the event follows the input upload too
            stream.recycle(signals)
            feats = host['feats']
            vad = host.get('vad')
            pitch = host.get('pitch')
            raw_props = (
                _RawProps(self.pitch_proc.get_properties())
                if pitch is not None else None)
            for row, name in enumerate(names):
                count = int(nsamples[row])
                nframes = self.feat_proc.output_frames(count)
                # copies, not views: the payload buffer goes back to its
                # pool after this batch
                utt_features = Features(
                    feats[row, :nframes].copy(),
                    self.feat_proc.times(nframes),
                    properties=_properties(self.feat_proc, self.warps, name))
                utt_vad = (vad[row, :nframes].copy()
                           if vad is not None else None)
                utt_pitch = None
                if pitch is not None:
                    pframes = self.pitch_proc.output_frames(count)
                    utt_pitch = Features(
                        pitch[row, :pframes].copy(),
                        self.pitch_proc.times(pframes),
                        properties=self.pitch_post.get_properties(
                            raw_props))
                if on_utterance is not None:
                    on_utterance(name, utt_features, utt_vad, utt_pitch)
                    continue
                features[name] = utt_features
                if utt_vad is not None:
                    vads[name] = utt_vad
                if utt_pitch is not None:
                    pitches[name] = utt_pitch
            # the event followed the copy into the buffer, and every
            # utterance holds its own copy out of it
            stream.payloads.give(payload)

        inflight = collections.deque()
        for names, signals, nsamples, _ in stream.stream_source(
                self.signal_cache, utterances, self.batch_size,
                pin_memory=cuda, njobs=njobs, depth=self.depth):
            inflight.append(dispatch(names, signals, nsamples))
            if len(inflight) > self.depth:
                drain(*inflight.popleft())
        while inflight:
            drain(*inflight.popleft())
        return features, vads, pitches


def check_fetch_dtype(fetch_dtype):
    """The name of a fetch precision, 'float32' for None; another name
    than 'float32', 'float16' or 'bfloat16' raises ValueError."""
    name = 'float32' if fetch_dtype is None else fetch_dtype
    if name not in FETCH_DTYPES:
        raise ValueError(
            'fetch_dtype must be one of {}, got {}'.format(
                ', '.join(FETCH_DTYPES), fetch_dtype))
    return name


def _payload_layout(out, fetch_dtype):
    """(name, shape, dtype) of each part of a batch's payload, in the
    pack order of the JAX package (feats, vad, pitch): the float parts
    carry ``fetch_dtype``, the uint8 VAD passes through."""
    target = FETCH_DTYPES[fetch_dtype]
    layout = [('feats', tuple(out['feats'].shape), target)]
    if 'vad' in out:
        layout.append(('vad', tuple(out['vad'].shape), torch.uint8))
    if 'pitch' in out:
        layout.append(('pitch', tuple(out['pitch'].shape), target))
    return layout


def _unpack_payload(payload, layout):
    """The named numpy arrays of a host payload: views of its bytes,
    the half-precision parts upcast to float32. A part whose offset is
    not a multiple of its item size (the float pitch after an odd
    number of VAD bytes) is copied out first, to be viewed."""
    out, cursor = {}, 0
    for name, shape, dtype in layout:
        nbytes = math.prod(shape) * dtype.itemsize
        part = payload[cursor:cursor + nbytes]
        if cursor % dtype.itemsize:
            part = part.clone()
        cursor += nbytes
        part = part.view(dtype).reshape(shape)
        if dtype in (torch.float16, torch.bfloat16):
            part = part.float()
        out[name] = part.numpy()
    return out


@dataclasses.dataclass
class _RawProps:
    """Stand-in for the raw pitch Features (the fused path never
    builds them; only their ``properties`` are chained)."""
    properties: dict


def _mel_fanout(proc, names, rows, warps):
    """(mel_weights, equal_loudness-or-None), numpy, with per-row VTLN
    warps.

    ``warps`` is a name -> warp dict or None (no warping). Padding rows
    reuse the last utterance's warp; a batch sharing one warp value
    collapses to a single unbatched matrix.
    """
    want_eql = proc.name == 'plp'
    if warps is None:
        return (proc.mel_weights(1.0),
                proc.equal_loudness(1.0) if want_eql else None)
    per_row = [warps[name] for name in names]
    per_row += [per_row[-1]] * (rows - len(per_row))
    if len(set(per_row)) == 1:
        return (proc.mel_weights(per_row[0]),
                proc.equal_loudness(per_row[0]) if want_eql else None)
    mel = np.stack([proc.mel_weights(w) for w in per_row])
    eql = (np.stack([proc.equal_loudness(w) for w in per_row])
           if want_eql else None)
    return mel, eql


def _mel_inputs(proc, names, rows, warps, device):
    """(mel_weights, equal_loudness) of one batch on ``device``: the mel
    bank of the mel-based processors and the equal-loudness weights of
    PLP (:func:`_mel_fanout`), else None."""
    if not hasattr(proc, 'mel_weights'):  # spectrogram
        return None, None
    mel, eql = _mel_fanout(proc, names, rows, warps)
    return (torch.as_tensor(mel, device=device),
            None if eql is None else torch.as_tensor(eql, device=device))


def _properties(proc, warps, name):
    """The properties of one utterance's features, with its VTLN warp
    when the processor is mel-based and warps are given."""
    if warps is not None and hasattr(proc, 'mel_weights'):
        return proc.get_properties(vtln_warp=warps[name])
    return proc.get_properties()


def _check_sample_rates(utterances, proc):
    """The whole collection must share the processor's sample rate."""
    for utt in utterances:
        rate = Audio.scan(utt.audio_file).sample_rate
        if float(proc.sample_rate) != float(rate):
            raise ValueError(
                'processor and signal mismatch in sample rates: '
                '{} != {}'.format(proc.sample_rate, rate))


class BatchExecutor:
    """Runs a frame processor over utterance collections in padded
    batches, one batch at a time, on one device.

    Counterpart of :class:`shennong_tpu.parallel.executor.BatchExecutor`.

    Parameters
    ----------
    processor :
        A frame processor: MfccProcessor, FilterbankProcessor,
        SpectrogramProcessor, PlpProcessor, EnergyProcessor or
        KaldiPitchProcessor.
    batch_size : int, optional
        Utterances per batch, default 16.
    device : str or torch.device
        Where the batches run.
    generator : torch.Generator, optional
        Source of the dither, on ``device``: every batch, and every
        chunk of an hour-scale utterance, draws from it in turn. A
        fresh, randomly seeded one is made when the dither is on and
        none is given.
    """

    def __init__(self, processor, batch_size=16, *, device, generator=None):
        self.processor = processor
        self.batch_size = int(batch_size)
        self.device = torch.device(device)
        self.generator = generator

    def process_all(self, utterances, vtln_warp=None, njobs=4,
                    signal_cache=None):
        """Extract features for every utterance.

        ``vtln_warp`` optionally maps utterance names to warp factors
        (mel-based processors only). ``njobs`` bounds the decode of the
        audio that the native loader does not read. ``signal_cache``
        optionally replays already-uploaded signal batches
        (:class:`shennong_tpu_torch.parallel.stream.SignalCache`).
        Utterances of more than the processor's ``AUTO_CHUNK_FRAMES``
        frames go through its ``process_chunked``. Returns a
        FeaturesCollection keyed in streaming order.
        """
        proc = self.processor
        name = proc.name
        if vtln_warp is not None and not hasattr(proc, 'mel_weights'):
            raise ValueError(
                f'processor {name} does not accept VTLN warps')

        # a generator would be exhausted by the rate check
        utterances = list(utterances)
        _check_sample_rates(utterances, proc)
        random = {}
        if name != 'pitch':
            generator = self.generator
            if generator is None and proc.dither != 0:
                generator = fresh_generator(self.device)
            random['generator'] = generator

        collection = FeaturesCollection()
        # hour-scale utterances would force one giant padded batch:
        # they take chunked extraction, and only the rest is batched
        limit = proc.AUTO_CHUNK_FRAMES
        if limit:
            regular = []
            for utt in utterances:
                frames = proc.output_frames(
                    int(utt.duration * float(proc.sample_rate)))
                if frames > limit:
                    kwargs = dict(random)
                    if vtln_warp is not None:
                        kwargs['vtln_warp'] = vtln_warp[utt.name]
                    with torch.profiler.record_function('batch.chunked'):
                        collection[utt.name] = proc.process_chunked(
                            utt.load_audio(), device=self.device, **kwargs)
                else:
                    regular.append(utt)
            utterances = regular
        if not utterances:
            return collection

        source = stream.stream_source(
            signal_cache, utterances, self.batch_size,
            pin_memory=self.device.type == 'cuda', njobs=njobs)
        for names, signals, nsamples, _ in source:
            with torch.profiler.record_function('batch.dispatch'), \
                    counters.timed('dispatch_s'):
                stream.count_upload(signals, nsamples)
                counters.add('dispatches')
                out = self._run_batch(
                    names, signals, nsamples, vtln_warp, **random)
            with torch.profiler.record_function('batch.wait'), \
                    counters.timed('fetch_s'):
                feats = out.cpu().numpy()
            counters.add('bytes_down', feats.nbytes)
            # the fetch ordered after the upload on the stream
            stream.recycle(signals)
            for row, utt_name in enumerate(names):
                nframes = proc.output_frames(int(nsamples[row]))
                data = feats[row, :nframes]
                if name == 'energy':
                    data = data.astype(np.float64)[:, None]
                else:
                    # a copy: a view would keep the whole padded batch
                    # alive as long as one of its utterances
                    data = np.ascontiguousarray(data)
                collection[utt_name] = Features(
                    data, proc.times(data.shape[0]),
                    properties=_properties(proc, vtln_warp, utt_name))
        return collection

    def _dither_generator(self):
        """The generator of the processor's dither, or None."""
        if self.processor.dither == 0:
            return None
        if self.generator is not None:
            return self.generator
        return fresh_generator(self.device)

    def process_all_classes(self, utterances, class_warps, njobs=4):
        """MFCCs of every utterance at every VTLN warp class.

        The framing and the FFT run once per batch and only the mel
        bank fans out over the ``class_warps``
        (:func:`shennong_tpu_torch.ops.spectral.mfcc_multi_warp_batch`);
        utterances past ``AUTO_CHUNK_FRAMES`` take chunked extraction,
        once per class. ``njobs`` bounds the decode of the audio that
        the native loader does not read. Returns one FeaturesCollection
        per class.
        """
        proc = self.processor
        if proc.name != 'mfcc':
            raise ValueError(
                'multi-class warping requires an MFCC processor, '
                f'got {proc.name}')
        utterances = list(utterances)
        _check_sample_rates(utterances, proc)
        generator = self._dither_generator()
        collections = [FeaturesCollection() for _ in class_warps]

        limit = proc.AUTO_CHUNK_FRAMES
        if limit:
            regular = []
            for utt in utterances:
                frames = proc.output_frames(
                    int(utt.duration * float(proc.sample_rate)))
                if frames > limit:
                    audio = utt.load_audio()
                    with torch.profiler.record_function('batch.chunked'):
                        for c, warp in enumerate(class_warps):
                            collections[c][utt.name] = proc.process_chunked(
                                audio, vtln_warp=warp, device=self.device,
                                generator=generator)
                else:
                    regular.append(utt)
            utterances = regular
        if not utterances:
            return collections

        mel_weights = torch.as_tensor(
            np.stack([proc.mel_weights(w) for w in class_warps]),
            dtype=torch.float32, device=self.device)
        frame_opts = proc.frame_options()
        for names, signals, nsamples, _ in stream.stream_batches(
                utterances, self.batch_size,
                pin_memory=self.device.type == 'cuda', njobs=njobs):
            with torch.profiler.record_function('batch.dispatch'):
                feats = spectral.mfcc_multi_warp_batch(
                    signals.to(self.device, non_blocking=True).to(
                        torch.float32),
                    torch.from_numpy(nsamples).to(self.device),
                    mel_weights, proc.options(),
                    num_frames(signals.shape[1], frame_opts),
                    generator=generator)
            with torch.profiler.record_function('batch.wait'):
                feats = feats.cpu().numpy()
            stream.recycle(signals)
            for row, utt_name in enumerate(names):
                nframes = num_frames(int(nsamples[row]), frame_opts)
                for c, warp in enumerate(class_warps):
                    collections[c][utt_name] = Features(
                        np.ascontiguousarray(feats[c, row, :nframes]),
                        proc.times(nframes),
                        properties=proc.get_properties(vtln_warp=warp))
        return collections

    def accumulate_lvtln_stats(self, utterances, class_warps, keep,
                               delta_order=None, delta_window=None,
                               njobs=4, signal_cache=None):
        """Least-squares mapping statistics of every VTLN warp class.

        ``keep`` maps utterance names to per-frame float weights (the
        VAD-and-subsample selection). Each signal batch runs
        :func:`shennong_tpu_torch.ops.fmllr.warp_class_mapping_moments`
        on the device, under the profiler span ``vtln.moments``; the
        warped features never reach the host, and the moments of all
        batches are fetched once at the end.

        Returns the list of per-batch moment tuples (numpy float32) for
        :func:`shennong_tpu_torch.ops.fmllr.solve_mapping_from_moments`.
        ``njobs`` bounds the decode of the audio that the native loader
        does not read; each batch's host buffer goes back to the pool
        once an event after its upload has completed (no wait in the
        loop).
        """
        from shennong_tpu_torch.ops import fmllr as fmllr_ops

        proc = self.processor
        if proc.name != 'mfcc':
            raise ValueError(
                'LVTLN statistics require an MFCC processor, '
                f'got {proc.name}')
        utterances = list(utterances)
        _check_sample_rates(utterances, proc)
        generator = self._dither_generator()

        mel_weights = torch.as_tensor(
            np.stack([proc.mel_weights(w) for w in class_warps]
                     + [proc.mel_weights(1.0)]),
            dtype=torch.float32, device=self.device)

        # the moment program holds the (C+1)-way warped features
        # [C+1, rows, T, D(+deltas)] about twice: size the batch rows to
        # a ~2 GB footprint, so long utterances shrink the batch
        frame_opts = proc.frame_options()
        max_frames = max(
            proc.output_frames(int(utt.duration * float(proc.sample_rate)))
            for utt in utterances)
        dim = proc.ndims * (
            delta_order + 1 if delta_order is not None else 1)
        bytes_per_row = (len(class_warps) + 1) * max_frames * dim * 4 * 2
        batch_rows = min(64, max(1, int((2 << 30) // max(bytes_per_row, 1))))

        source = stream.stream_source(
            signal_cache, utterances, batch_rows,
            pin_memory=self.device.type == 'cuda', njobs=njobs)
        parts = []
        uploads = stream.PendingUploads(self.device)
        for names, signals, nsamples, _ in source:
            with torch.profiler.record_function('vtln.moments'):
                nframes_max = num_frames(signals.shape[1], frame_opts)
                nframes = np.ones(signals.shape[0], dtype=np.int32)
                weights = np.zeros(
                    (signals.shape[0], nframes_max), dtype=np.float32)
                for row, name in enumerate(names):
                    count = num_frames(int(nsamples[row]), frame_opts)
                    nframes[row] = count
                    weights[row, :count] = keep[name][:count]
                parts.append(fmllr_ops.warp_class_mapping_moments(
                    signals.to(self.device, non_blocking=True).to(
                        torch.float32),
                    torch.from_numpy(nsamples).to(self.device),
                    torch.from_numpy(nframes).to(self.device),
                    mel_weights, torch.from_numpy(weights).to(self.device),
                    proc.options(), nframes_max, delta_order=delta_order,
                    delta_window=delta_window, generator=generator))
            uploads.add(signals)
            uploads.release()
        # one fetch for every batch's moments
        shapes = [m.shape for m in parts[0]]
        packed = torch.cat(
            [m.reshape(-1) for batch in parts for m in batch]).cpu().numpy()
        uploads.drain()
        moments, cursor = [], 0
        for _ in parts:
            batch = []
            for shape in shapes:
                size = int(np.prod(shape))
                batch.append(packed[cursor:cursor + size].reshape(shape))
                cursor += size
            moments.append(tuple(batch))
        return moments

    def _run_batch(self, names, signals, nsamples, vtln_warp,
                   generator=None):
        """Enqueue one batch; returns its [B, F(, D)] output on the
        device."""
        proc = self.processor
        name = proc.name
        signals = signals.to(self.device, non_blocking=True).to(
            torch.float32)
        nsamples_dev = torch.from_numpy(nsamples).to(
            self.device, non_blocking=True)

        if name == 'pitch':
            opts = proc.options()
            return pitch_ops.compute_pitch(
                signals, nsamples_dev, opts,
                pitch_ops.num_pitch_frames(signals.shape[1], opts))

        nframes_max = num_frames(signals.shape[1], proc.frame_options())
        if name == 'energy':
            return spectral.energy_batch(
                signals, nsamples_dev, proc.options(), nframes_max,
                compression=proc.compression, generator=generator)
        if name == 'spectrogram':
            return spectral.spectrogram_batch(
                signals, nsamples_dev, proc.options(), nframes_max,
                generator=generator)

        # mel-based processors, with optional per-utterance warps
        mel_weights, eql = _mel_inputs(
            proc, names, signals.shape[0], vtln_warp, self.device)
        if name == 'plp':
            return plp_ops.plp_batch(
                signals, nsamples_dev, mel_weights, eql, proc.options(),
                nframes_max, generator=generator)
        if name == 'mfcc':
            return spectral.mfcc_batch(
                signals, nsamples_dev, mel_weights, proc.options(),
                nframes_max, generator=generator)
        if name == 'filterbank':
            return spectral.fbank_batch(
                signals, nsamples_dev, mel_weights, proc.options(),
                nframes_max, generator=generator)
        raise ValueError(
            f'processor {name} does not support batched execution')
