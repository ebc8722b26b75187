"""Energy-based voice activity detection post-processor.

Counterpart of :mod:`shennong_tpu.postprocessor.vad`: the decision is
a windowed vote (:func:`shennong_tpu_torch.ops.postops.compute_vad_energy`)
on a given device. The input's first column is a log-energy (as
produced by EnergyProcessor, or MFCC with ``use_energy``).
"""

import numpy as np
import torch

from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.ops import postops
from shennong_tpu_torch.postprocessor.base import FeaturesPostProcessor


class VadPostProcessor(FeaturesPostProcessor):
    """Computes VAD on speech features"""

    def __init__(self, energy_threshold=5.0, energy_mean_scale=0.5,
                 frames_context=0, proportion_threshold=0.6):
        super().__init__()
        self.energy_threshold = energy_threshold
        self.energy_mean_scale = energy_mean_scale
        self.frames_context = frames_context
        self.proportion_threshold = proportion_threshold

    @property
    def name(self):
        return 'vad'

    @property
    def energy_threshold(self):
        """Base value of the voicing energy cutoff

        The actual cutoff also includes the scaled mean log-energy,
        see energy_mean_scale.

        """
        return np.float32(self._energy_threshold)

    @energy_threshold.setter
    def energy_threshold(self, value):
        self._energy_threshold = float(value)

    @property
    def energy_mean_scale(self):
        """Weight of the utterance mean log-energy in the cutoff

        The decision threshold is energy_threshold + scale * mean;
        must be non-negative.

        """
        return np.float32(self._energy_mean_scale)

    @energy_mean_scale.setter
    def energy_mean_scale(self, value):
        if value < 0:
            raise ValueError(
                'Energy mean scale must be >= 0, it is {}'.format(value))
        self._energy_mean_scale = float(value)

    @property
    def frames_context(self):
        """Half-width of the voting window, in frames

        Each decision looks at 2 * frames_context + 1 frames; must be
        non-negative.

        """
        return self._frames_context

    @frames_context.setter
    def frames_context(self, value):
        if value < 0:
            raise ValueError(
                'frames_context must be >= 0, it is {}'.format(value))
        self._frames_context = int(value)

    @property
    def proportion_threshold(self):
        """Fraction of the voting window that must exceed the cutoff

        Strictly between 0 and 1.

        """
        return np.float32(self._proportion_threshold)

    @proportion_threshold.setter
    def proportion_threshold(self, value):
        if value <= 0 or value >= 1:
            raise ValueError(
                'proportion_threshold must be in ]0, 1[, it is {}'
                .format(value))
        self._proportion_threshold = float(value)

    @property
    def ndims(self):
        return 1

    def process(self, features, *, device):
        """Per-frame voicing decision from the log-energy column,
        computed on ``device``.

        Returns uint8 features with 1 for voiced frames, 0 otherwise.
        """
        log_energy = torch.as_tensor(
            features.data[:, 0], dtype=torch.float32, device=device)[None]
        nframes = torch.tensor(
            [features.nframes], dtype=torch.int32, device=device)
        vad = postops.compute_vad_energy(
            log_energy, nframes,
            energy_threshold=self._energy_threshold,
            energy_mean_scale=self._energy_mean_scale,
            frames_context=self._frames_context,
            proportion_threshold=self._proportion_threshold)
        return Features(
            vad[0].cpu().numpy().astype(np.uint8)[:, None],
            features.times, properties=self.get_properties(features))

    def process_all(self, features_collection, njobs=None, *, device):
        """Voicing decisions for a whole collection, on ``device``.

        Utterances are grouped into padded masked batches
        (:func:`shennong_tpu_torch.ops.postops.batch_ragged`): one
        device program per batch instead of one per utterance. Returns
        a FeaturesCollection keyed like the input. ``njobs`` has no
        effect: it keeps the JAX package's signature, and the features
        are in memory, nothing is decoded.
        """
        names = list(features_collection.keys())
        arrays = [features_collection[n].data[:, :1] for n in names]
        out = FeaturesCollection()
        for chunk, stacked, nframes in postops.batch_ragged(arrays):
            vad = postops.compute_vad_energy(
                torch.as_tensor(stacked[:, :, 0], device=device),
                torch.as_tensor(nframes, device=device),
                energy_threshold=self._energy_threshold,
                energy_mean_scale=self._energy_mean_scale,
                frames_context=self._frames_context,
                proportion_threshold=self._proportion_threshold)
            vad = vad.cpu().numpy()
            for row, index in enumerate(chunk):
                features = features_collection[names[index]]
                out[names[index]] = Features(
                    vad[row, :features.nframes].astype(np.uint8)[:, None],
                    features.times,
                    properties=self.get_properties(features))
        return out
