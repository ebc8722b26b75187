"""Batched extraction over whole utterance collections, on one device.

Counterpart of :mod:`shennong_tpu.parallel.executor` (without a mesh).
Utterances are planned into padded length-sorted batches, decoded ahead
on host threads and uploaded as int16 from pinned memory
(:mod:`shennong_tpu_torch.parallel.stream`).

- :class:`FusedPipelineExecutor` runs the pipeline's pass 1 as one
  program per batch
  (:func:`shennong_tpu_torch.parallel.fused.pass_one_program`).
  Up to ``depth`` batches are in flight: a batch's outputs are copied
  to pinned host memory behind a CUDA event, and the host only waits
  on that event when it drains the batch, ``depth`` dispatches later.
- :class:`BatchExecutor` runs one frame processor per sweep (the
  stage-wise pass 1, and ``process_all``), sending hour-scale
  utterances through the processor's chunked extraction.

The host spans ``pass1.dispatch``/``pass1.wait`` (fused) and
``batch.dispatch``/``batch.wait`` (stage-wise) mark enqueuing a batch
and blocking on its outputs, ``batch.chunked`` the whole chunked
extraction of one hour-scale utterance; they are profiler annotations
(:func:`torch.profiler.record_function`), which cost nothing
measurable when no profiler runs.
"""

import collections
import dataclasses

import numpy as np
import torch

from shennong_tpu.features import Features
from shennong_tpu.features_collection import FeaturesCollection
from shennong_tpu.audio import Audio
from shennong_tpu_torch.ops import pitch as pitch_ops
from shennong_tpu_torch.ops import plp as plp_ops
from shennong_tpu_torch.ops import spectral
from shennong_tpu_torch.ops.framing import num_frames
from shennong_tpu_torch.parallel import stream
from shennong_tpu_torch.parallel.fused import pass_one_program
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
    """

    def __init__(self, feat_proc, warps=None, energy_proc=None,
                 vad_proc=None, pitch_proc=None, pitch_post=None, *,
                 device, batch_size=64, depth=2, generator=None):
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

    def run(self, utterances, on_utterance=None):
        """Extract pass 1 for every utterance.

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
            with torch.profiler.record_function('pass1.dispatch'):
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
            if not cuda:
                return names, nsamples, out, None, signals
            # one asynchronous copy per output into pinned memory; the
            # event marks them done (and the input upload with them)
            host = {}
            for key, value in out.items():
                host[key] = torch.empty(
                    value.shape, dtype=value.dtype, pin_memory=True)
                host[key].copy_(value, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return names, nsamples, host, done, signals

        def drain(names, nsamples, out, done, signals):
            if done is not None:
                with torch.profiler.record_function('pass1.wait'):
                    done.synchronize()
            del signals  # its upload finished with the program
            feats = out['feats'].numpy()
            vad = out['vad'].numpy() if 'vad' in out else None
            pitch = out['pitch'].numpy() if 'pitch' in out else None
            raw_props = (
                _RawProps(self.pitch_proc.get_properties())
                if pitch is not None else None)
            for row, name in enumerate(names):
                count = int(nsamples[row])
                nframes = self.feat_proc.output_frames(count)
                # copies, not views: a view would keep the whole padded
                # batch alive as long as one of its utterances
                utt_features = Features(
                    np.ascontiguousarray(feats[row, :nframes]),
                    self.feat_proc.times(nframes),
                    properties=_properties(self.feat_proc, self.warps, name))
                utt_vad = (np.ascontiguousarray(vad[row, :nframes])
                           if vad is not None else None)
                utt_pitch = None
                if pitch is not None:
                    pframes = self.pitch_proc.output_frames(count)
                    utt_pitch = Features(
                        np.ascontiguousarray(pitch[row, :pframes]),
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

        inflight = collections.deque()
        for names, signals, nsamples, _ in stream.stream_batches(
                utterances, self.batch_size, pin_memory=cuda,
                depth=self.depth):
            inflight.append(dispatch(names, signals, nsamples))
            if len(inflight) > self.depth:
                drain(*inflight.popleft())
        while inflight:
            drain(*inflight.popleft())
        return features, vads, pitches


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

    def process_all(self, utterances, vtln_warp=None, signal_cache=None):
        """Extract features for every utterance.

        ``vtln_warp`` optionally maps utterance names to warp factors
        (mel-based processors only). ``signal_cache`` optionally
        replays already-uploaded signal batches
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
            pin_memory=self.device.type == 'cuda')
        for names, signals, nsamples, _ in source:
            with torch.profiler.record_function('batch.dispatch'):
                out = self._run_batch(
                    names, signals, nsamples, vtln_warp, **random)
            with torch.profiler.record_function('batch.wait'):
                feats = out.cpu().numpy()
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
