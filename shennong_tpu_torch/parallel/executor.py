"""Pipeline pass 1 over a whole utterance collection, on one device.

Counterpart of :class:`shennong_tpu.parallel.executor.FusedPipelineExecutor`
(without a mesh): utterances are planned into padded length-sorted
batches, decoded ahead on host threads, uploaded as int16 from pinned
memory, and each batch runs :func:`shennong_tpu_torch.parallel.fused.pass_one_program`.
Up to ``depth`` batches are in flight: a batch's outputs are copied to
pinned host memory behind a CUDA event, and the host only waits on
that event when it drains the batch, ``depth`` dispatches later.

The host spans ``pass1.dispatch`` (enqueuing one batch) and
``pass1.wait`` (blocking on a batch's outputs) are profiler
annotations (:func:`torch.profiler.record_function`), which cost
nothing measurable when no profiler runs.
"""

import collections
import dataclasses

import numpy as np
import torch

from shennong_tpu.features import Features
from shennong_tpu.features_collection import FeaturesCollection
from shennong_tpu.audio import Audio
from shennong_tpu_torch.ops import pitch as pitch_ops
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

    def __init__(self, feat_proc, energy_proc=None, vad_proc=None,
                 pitch_proc=None, pitch_post=None, *, device,
                 batch_size=64, depth=2, generator=None):
        self.feat_proc = feat_proc
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
        for utt in utterances:
            _check_not_chunked(utt, self.feat_proc)
            if self.pitch_proc is not None:
                _check_not_chunked(utt, self.pitch_proc)

        static = self._static_opts()
        generator = self._generator(static)
        frame_opts = static['feat_opts'].frame
        mel_weights, equal_loudness = _mel_inputs(
            self.feat_proc, self.device)
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
                    properties=self.feat_proc.get_properties())
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


def _mel_inputs(proc, device):
    """(mel_weights, equal_loudness) of the features processor on
    ``device``: the mel bank of the mel-based processors, and the
    equal-loudness weights of PLP, else None."""
    if not hasattr(proc, 'mel_weights'):  # spectrogram
        return None, None
    mel = torch.as_tensor(proc.mel_weights(1.0), device=device)
    if proc.name != 'plp':
        return mel, None
    return mel, torch.as_tensor(proc.equal_loudness(1.0), device=device)


def _check_sample_rates(utterances, proc):
    """The whole collection must share the processor's sample rate."""
    for utt in utterances:
        rate = Audio.scan(utt.audio_file).sample_rate
        if float(proc.sample_rate) != float(rate):
            raise ValueError(
                'processor and signal mismatch in sample rates: '
                '{} != {}'.format(proc.sample_rate, rate))


def _check_not_chunked(utt, proc):
    """Hour-scale utterances need chunked extraction, not yet ported."""
    limit = proc.AUTO_CHUNK_FRAMES
    frames = proc.output_frames(int(utt.duration * float(proc.sample_rate)))
    if limit and frames > limit:
        raise NotImplementedError(
            f'utterance {utt.name} gives {frames} frames, more than '
            f'{limit}: chunked extraction is not yet ported')
