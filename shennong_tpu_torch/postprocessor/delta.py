"""Delta (time derivative) post-processor.

Counterpart of :mod:`shennong_tpu.postprocessor.delta`: Kaldi's
polynomial-fit coefficients with edge replication, as a shifted
weighted sum (:func:`shennong_tpu_torch.ops.postops.compute_deltas`)
on a given device.
"""

import copy

import torch

from shennong_tpu.features import Features
from shennong_tpu.features_collection import FeaturesCollection
from shennong_tpu_torch.ops import postops
from shennong_tpu_torch.postprocessor.base import FeaturesPostProcessor


class DeltaPostProcessor(FeaturesPostProcessor):
    def __init__(self, order=2, window=2):
        super().__init__()
        self.order = order
        self.window = window

    @property
    def name(self):
        return 'delta'

    @property
    def order(self):
        """Highest derivative order to compute"""
        return self._order

    @order.setter
    def order(self, value):
        self._order = int(value)

    @property
    def window(self):
        """Half-width of the regression window per derivative order

        Each order looks at 2 * window + 1 frames; utterance edges
        replicate the first/last frame.

        """
        return self._window

    @window.setter
    def window(self, value):
        value = int(value)
        if not 0 < value < 1000:
            raise ValueError(
                'window must be in [1, 999], it is {}'.format(value))
        self._window = value

    @property
    def ndims(self):
        raise ValueError(
            'the delta output dimension is input-dependent '
            '((order + 1) times the input dimension)')

    def get_properties(self, features):
        properties = copy.deepcopy(features.properties)
        properties[self.name] = {
            'order': self.order, 'window': self.window}
        properties.setdefault('pipeline', []).append({
            'name': self.name,
            'columns': [0, (self.order + 1) * features.ndims - 1]})
        return properties

    def process(self, features, *, device):
        """Concatenate ``features`` with its time derivatives, computed
        on ``device``.

        Output has ``(order + 1) * ndims`` columns: the input followed
        by the derivative of each order.
        """
        data = torch.as_tensor(
            features.data, dtype=torch.float32, device=device)[None]
        nframes = torch.tensor(
            [features.nframes], dtype=torch.int32, device=device)
        out = postops.compute_deltas(
            data, nframes, order=self._order, window=self._window)
        return Features(
            out[0].cpu().numpy().astype(features.dtype),
            features.times,
            self.get_properties(features))

    def process_all(self, features_collection, *, device):
        """Deltas for a whole collection, on ``device``.

        Utterances are grouped into padded masked batches by (frame
        bucket, dim) (:func:`shennong_tpu_torch.ops.postops.batch_ragged`):
        one device program per batch instead of one per utterance.
        Returns a FeaturesCollection keyed like the input.
        """
        names = list(features_collection.keys())
        arrays = [features_collection[n].data for n in names]
        out = FeaturesCollection()
        for chunk, stacked, nframes in postops.batch_ragged(arrays):
            deltas = postops.compute_deltas(
                torch.as_tensor(stacked, device=device),
                torch.as_tensor(nframes, device=device),
                order=self._order, window=self._window).cpu().numpy()
            for row, index in enumerate(chunk):
                feats = features_collection[names[index]]
                out[names[index]] = Features(
                    deltas[row, :feats.nframes].astype(feats.dtype),
                    feats.times, self.get_properties(feats))
        return out
