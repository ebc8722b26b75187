"""A named collection of :class:`Features`, with file serialization.

The port's own copy of ``shennong_tpu/features_collection.py``: a dict
of utterance name -> Features with save, load, comparison, partition
and VAD trimming.
"""

import collections

import numpy as np

from shennong_tpu_torch.features import Features
from shennong_tpu_torch.logger import get_logger
from shennong_tpu_torch.serializers import get_serializer


class FeaturesCollection(dict):
    """Dictionary of utterance name -> :class:`Features`."""

    @classmethod
    def load(cls, filename, serializer=None,
             log=get_logger('serializer', 'warning')):
        """Load a collection from ``filename``.

        The serializer is guessed from the file extension unless given
        explicitly (see :mod:`shennong_tpu_torch.serializers`).
        """
        return get_serializer(cls, filename, log, serializer).load()

    def save(self, filename, serializer=None, with_properties=True,
             log=get_logger('serializer', 'warning'), **kwargs):
        """Save the collection to ``filename``.

        Extra ``kwargs`` are serializer-specific (``compress`` for
        npz/mat/h5f, ``scp`` for kaldi ark).
        """
        get_serializer(self.__class__, filename, log, serializer).save(
            self, with_properties=with_properties, **kwargs)

    def is_valid(self):
        """True if every features item in the collection is valid"""
        return all(feats.is_valid() for feats in self.values())

    def is_close(self, other, rtol=1e-5, atol=1e-8):
        """Approximate equality of two collections"""
        if self.keys() != other.keys():
            return False
        return all(
            self[k].is_close(other[k], rtol=rtol, atol=atol) for k in self)

    def partition(self, index):
        """Split the collection into sub-collections following ``index``.

        ``index`` maps every utterance name in the collection to a
        group label (e.g. a speaker); the result maps each label to the
        sub-collection of its utterances. ``index`` may hold more names
        than the collection.
        """
        missing = set(self.keys()) - set(index.keys())
        if missing:
            raise ValueError(
                'following items are not defined in the partition index: {}'
                .format(', '.join(sorted(missing))))

        groups = collections.defaultdict(list)
        for key in self.keys():
            groups[index[key]].append(key)

        return {
            label: FeaturesCollection({k: self[k] for k in keys})
            for label, keys in groups.items()}

    def trim(self, vad):
        """Keep only the frames flagged True in per-utterance ``vad``
        masks (bool arrays keyed like the collection)."""
        if vad.keys() != self.keys():
            raise ValueError('Vad keys are different from this keys.')
        for key in vad:
            if vad[key].dtype != np.dtype('bool'):
                raise ValueError('Vad arrays must be arrays of bool.')
            if vad[key].shape[0] != self[key].nframes:
                raise ValueError(
                    'Vad arrays length must be equal to the number of '
                    'frames.')
        return FeaturesCollection({
            k: Features(self[k].data[vad[k]], self[k].times[vad[k]],
                        properties=self[k].properties)
            for k in self.keys()})
