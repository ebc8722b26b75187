"""Bottleneck features from the BUT/Phonexia pre-trained networks.

Counterpart of :mod:`shennong_tpu.processor.bottleneck`, with the same
parameters and outputs: the filterbank front end and the
stacked-bottleneck MLP run on the device
(:mod:`shennong_tpu_torch.models.bottleneck`), the VAD and the context
compression on the host.

The pre-trained weight files (FisherMono / FisherTri / BabelMulti,
distributed separately by the reference as well) are looked up under
``shennong_tpu_torch/share/bottleneck/<name>.npz``, in the BUT npz
layout.
"""

import os

import numpy as np
import torch

from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.logger import get_logger
from shennong_tpu_torch.models import bottleneck as bn
from shennong_tpu_torch.ops.framing import bucket_size
from shennong_tpu_torch.processor.base import (
    FeaturesProcessor, fresh_generator)

_WEIGHTS_FILES = {
    'BabelMulti': 'Babel-ML17_FBANK_HL1500_SBN80_PhnStates3096',
    'FisherMono': 'FisherEnglish_FBANK_HL500_SBN80_PhnStates120',
    'FisherTri': 'FisherEnglish_FBANK_HL500_SBN80_triphones2423',
}

_SHARE_DIR = os.path.join(
    os.path.dirname(__file__), '..', 'share', 'bottleneck')


class BottleneckProcessor(FeaturesProcessor):
    """Bottleneck features from a pre-trained neural network

    Parameters
    ----------
    weights : 'BabelMulti', 'FisherMono' or 'FisherTri'
        The pretrained weights to use for features extraction
    dither : float, optional
        Amount of dither added before the filterbank, default 0.1

    Raises
    ------
    ValueError
        If the ``weights`` name is invalid
    RuntimeError
        If the corresponding weights file is not installed
    """

    # weights loaded once per process, shared across instances: the
    # npz arrays by weights name, and their device tensors by (weights
    # name, device)
    _loaded_weights = {}
    _device_weights = {}

    def __init__(self, weights='BabelMulti', dither=0.1):
        super().__init__()
        self.weights = weights
        self.dither = dither

    @property
    def name(self):
        return 'bottleneck'

    @property
    def dither(self):
        """Amount of dithering

        0.0 means no dither

        """
        return self._dither

    @dither.setter
    def dither(self, value):
        self._dither = float(value)

    @property
    def weights(self):
        """The name of the pretrained weights used to extract the features

        Must be 'BabelMulti', 'FisherMono' or 'FisherTri'.

        """
        return self._weights

    @weights.setter
    def weights(self, value):
        if value not in _WEIGHTS_FILES:
            raise ValueError(
                'invalid weights "{}", choose in "{}"'.format(
                    value, ', '.join(sorted(_WEIGHTS_FILES))))
        self._weights = value

    @property
    def ndims(self):
        """The dimension of extracted frames

        Cannot be tuned because the underlying neural networks are
        trained with this parameter.

        """
        return 80

    @property
    def sample_rate(self):
        """Processing sample frequency in Hertz

        Cannot be tuned because the underlying neural networks are
        trained with this parameter.

        """
        return 8000

    @property
    def frame_length(self):
        """The length of extracted frames (in seconds)"""
        return 0.025

    @property
    def frame_shift(self):
        """The time shift between two consecutive frames (in seconds)"""
        return 0.01

    @classmethod
    def available_weights(cls):
        """The installed weights files as a dict name -> path.

        Raises RuntimeError when no weights file at all is found.
        """
        directory = os.path.abspath(_SHARE_DIR)
        expected = {
            name: os.path.join(directory, filename + '.npz')
            for name, filename in _WEIGHTS_FILES.items()}
        files = {
            name: path for name, path in expected.items()
            if os.path.isfile(path)}
        if not files:
            raise RuntimeError(
                'no weights file found in {}, install the BUT/Phonexia '
                'npz files to enable bottleneck features'.format(
                    directory))
        for name in expected:
            if name not in files:
                get_logger('bottleneck', 'warning').warning(
                    'weights file for "%s" is unavailable', name)
        return files

    def _get_weights(self):
        """The npz arrays of the selected weights (loaded once)."""
        if self.weights not in self._loaded_weights:
            available = self.available_weights()
            if self.weights not in available:
                raise RuntimeError(
                    'weights file for "{}" is not installed (found: '
                    '{})'.format(
                        self.weights, ', '.join(sorted(available))))
            weights_file = available[self.weights]
            self.log.info('loading %s', os.path.basename(weights_file))
            with np.load(weights_file) as data:
                self._loaded_weights[self.weights] = {
                    k: v for k, v in data.items()}
        return self._loaded_weights[self.weights]

    def _params(self, device):
        """(network tensors on ``device``, context) of the selected
        weights, uploaded once per device."""
        from shennong_tpu_torch.weights import bottleneck_from_numpy

        arrays = self._get_weights()
        key = (self.weights, str(torch.device(device)))
        cached = self._device_weights.get(key)
        if cached is None or cached[0] is not arrays:
            tensors, context = bottleneck_from_numpy(arrays)
            cached = (arrays, {k: v.to(device) for k, v in tensors.items()},
                      context)
            self._device_weights[key] = cached
        return cached[1], cached[2]

    def _prepare(self, signal, device, generator):
        """The front end: resample to 8 kHz int16, VAD (host), dither and
        HTK filterbank (``device``), voiced mean normalization and the
        context DCT compression (host). Returns the network input
        [rows, D] float32 (numpy)."""
        if (signal.sample_rate != 8000
                or signal.dtype != np.dtype(np.int16)):
            self.log.debug(
                'resampling audio from %dHz@%db to %dHz@%db',
                signal.sample_rate, signal.dtype.itemsize * 8, 8000, 16)
            signal = signal.resample(8000).astype(np.int16)

        data = signal.data
        frame_length, frame_overlap = 200, 120
        frame_shift = frame_length - frame_overlap

        vad = bn.compute_vad(
            data, self.log, win_length=frame_length,
            win_overlap=frame_overlap)
        voiced = int(vad.sum())
        if not voiced:
            raise RuntimeError(
                'no voice detected in signal, failed to extract features')
        self.log.debug(
            '%d frames of speech detected (on %d total frames)',
            voiced, len(vad))

        # dither (float64, as the reference) and mel filterbank
        samples = torch.as_tensor(data, device=device).to(torch.float64)
        if self._dither != 0:
            noise = torch.rand(
                samples.shape, generator=generator, dtype=torch.float64,
                device=device)
            samples = samples + self._dither * (noise * 2 - 1)
        window_vec = torch.as_tensor(
            np.hamming(frame_length).astype(np.float32), device=device)
        bank = torch.as_tensor(bn.mel_filterbank_htk(
            frame_length, 8000, num_chans=24, low_freq=64.0,
            high_freq=3800.0), device=device)
        frames = bn.frame_signal(
            samples.to(torch.float32), frame_length, frame_shift)
        fea = bn.fbank_htk(frames, window_vec, bank, 256).cpu().numpy()

        # mean normalization over voiced frames
        fea = fea - fea[vad].mean(axis=0)

        # global +-15 frame context, then the network's context
        fea = np.concatenate([
            np.repeat(fea[:1], 15, axis=0), fea,
            np.repeat(fea[-1:], 15, axis=0)], axis=0)
        return bn.preprocess_nn_input(fea, int(self._get_weights()['context']))

    def _emit(self, output):
        """Wrap one utterance's network output as Features."""
        frame_length, frame_shift = 200, 80
        times = (1.0 / 8000) * np.vstack((
            np.arange(output.shape[0]) * frame_shift,
            np.arange(output.shape[0]) * frame_shift + frame_length)).T
        return Features(
            output.astype(np.float64), times, self.get_properties())

    def _generator(self, device, generator):
        if self._dither != 0 and generator is None:
            return fresh_generator(device)
        return generator

    def process(self, signal, *, device, generator=None):
        """Compute bottleneck features on an audio ``signal``, on
        ``device``.

        The signal is resampled to 8 kHz int16; output frames have a
        10 ms shift, 25 ms length and 80 dimensions. ``generator`` is
        the source of the dither, on ``device`` (a fresh, randomly
        seeded one when None and ``dither`` is non-zero). Raises
        RuntimeError when the VAD finds no speech.
        """
        nn_input = self._prepare(
            signal, device, self._generator(device, generator))
        # the stagger stacking consumes 20 rows of context: shorter
        # audio has no output frames
        rows = nn_input.shape[0]
        if rows <= 20:
            return self._emit(np.zeros((0, 80), dtype=np.float32))
        params, _ = self._params(device)
        with torch.no_grad():
            output = bn.stacked_bn_forward(
                params, torch.as_tensor(nn_input, device=device))
        return self._emit(output.cpu().numpy())

    def process_all(self, utterances, njobs=None, *, device, generator=None,
                    **kwargs):
        """Batched extraction over an utterance collection on ``device``:
        the front end per utterance, then utterances sharing a row
        bucket run the network as one batched forward (the stagger
        stacking mixes rows within an utterance, so the batch is a
        leading dimension, never a concatenation). ``generator`` is the
        source of the dither, every utterance drawing from it in turn.
        ``njobs`` has no effect: the audio is loaded one utterance at a
        time."""
        if kwargs:
            return super().process_all(
                utterances, njobs=njobs, device=device, generator=generator,
                **kwargs)

        generator = self._generator(device, generator)
        with torch.profiler.record_function('bottleneck.frontend'):
            prepared = {
                utt.name: self._prepare(utt.load_audio(), device, generator)
                for utt in utterances}

        groups = {}
        for name, nn_input in prepared.items():
            groups.setdefault(
                bucket_size(nn_input.shape[0], minimum=128), []).append(name)

        params, _ = self._params(device)
        outputs = {}
        with torch.no_grad(), \
                torch.profiler.record_function('bottleneck.forward'):
            for bucket, names in groups.items():
                stacked = np.zeros(
                    (len(names), bucket, prepared[names[0]].shape[1]),
                    dtype=np.float32)
                for row, name in enumerate(names):
                    inp = prepared[name]
                    stacked[row, :inp.shape[0]] = inp
                batch = bn.stacked_bn_forward(
                    params, torch.as_tensor(stacked, device=device)).cpu()
                for row, name in enumerate(names):
                    # <= 20 rows: no output frames (the stagger stacking
                    # consumes 20 rows of context)
                    count = max(prepared[name].shape[0] - 20, 0)
                    outputs[name] = batch[row, :count].numpy()
        return FeaturesCollection({
            utt.name: self._emit(outputs[utt.name]) for utt in utterances})
