"""One-hot encoding of time-aligned tokens.

The port's own copy of ``shennong_tpu/processor/onehot.py``, host
numpy on the port's :class:`Features`, :class:`Frames` and windows
(no tensors, so ``process`` takes no device): the simple
variant encodes alignment tokens directly, the framed variant samples
the alignment at a given rate, frames it and elects a winner token per
frame by window-weight vote.
"""

import collections
import copy
import operator

import numpy as np

from shennong_tpu_torch import window as windows
from shennong_tpu_torch.features import Features
from shennong_tpu_torch.frames import Frames
from shennong_tpu_torch.processor.base import FeaturesProcessor


class _OneHotBase(FeaturesProcessor):
    def __init__(self, tokens=None):
        super().__init__()
        self.tokens = tokens

    @property
    def name(self):
        return 'onehot'

    @property
    def tokens(self):
        return self._tokens

    @tokens.setter
    def tokens(self, value):
        self._tokens = None if value is None else sorted(set(value))

    @property
    def ndims(self):
        if self.tokens:
            return len(self.tokens)
        raise ValueError(
            'onehot tokens are not defined, cannot know their dimension')

    def _tokens_set(self, alignment):
        if self.tokens is None:
            return alignment.get_tokens_inventory()
        errors = [
            t for t in set(alignment.tokens) if t not in self.tokens]
        if errors:
            raise ValueError(
                'following tokens are in alignment but not defined in the '
                'onehot features processor: {}'.format(errors))
        return self.tokens

    def _token2index(self, alignment):
        return {
            t: i for i, t in enumerate(
                sorted(self._tokens_set(alignment)))}

    def _properties_with_mapping(self, token2index):
        """Properties dict including the token mapping; when the
        tokens were inferred from the alignment, a shallow COPY of
        the processor carries them — mutating ``self.tokens``
        in-place would corrupt a concurrent ``process()`` call on
        another thread (the API runs on threads under
        ``process_all``)."""
        try:
            properties = self.get_properties()
        except ValueError:  # tokens inferred from the alignment
            materialized = copy.copy(self)
            materialized.tokens = token2index.keys()
            properties = materialized.get_properties()
        properties[self.name].update({'token2index': token2index})
        return properties


class OneHotProcessor(_OneHotBase):
    """Direct one-hot encoding: one row per aligned token.

    ``tokens`` optionally fixes the inventory (so different alignments
    share a consistent column order); otherwise it is read off each
    processed alignment.
    """

    def __init__(self, tokens=None):
        super().__init__(tokens=tokens)

    def process(self, alignment):
        token2index = self._token2index(alignment)

        data = np.zeros(
            (alignment.tokens.shape[0], len(token2index)), dtype=bool)
        indices = np.array(
            [token2index[t] for t in alignment.tokens], dtype=int)
        data[np.arange(len(indices)), indices] = True

        return Features(
            data, alignment.times,
            properties=self._properties_with_mapping(token2index))


class FramedOneHotProcessor(_OneHotBase):
    """One-hot encoding on overlapping frames.

    The alignment expands to one token per sample at ``sample_rate``;
    frames then elect the token holding the largest share of the
    window's weight mass.
    """

    def __init__(self, tokens=None, sample_rate=16000,
                 frame_shift=0.01, frame_length=0.025,
                 window_type='povey', blackman_coeff=0.42):
        super().__init__(tokens=tokens)
        self.frame = Frames(
            sample_rate=sample_rate,
            frame_shift=frame_shift,
            frame_length=frame_length)
        self.window_type = window_type
        self.blackman_coeff = blackman_coeff

    @property
    def sample_rate(self):
        """Sampling rate (Hz) at which the alignment is expanded"""
        return self.frame.sample_rate

    @sample_rate.setter
    def sample_rate(self, value):
        self.frame.sample_rate = value

    @property
    def frame_shift(self):
        """Time step between two consecutive frames, in seconds"""
        return self.frame.frame_shift

    @frame_shift.setter
    def frame_shift(self, value):
        self.frame.frame_shift = value

    @property
    def frame_length(self):
        """Duration of the analysis window, in seconds"""
        return self.frame.frame_length

    @frame_length.setter
    def frame_length(self, value):
        self.frame.frame_length = value

    def process(self, alignment):
        token2index = self._token2index(alignment)

        sampled = alignment.at_sample_rate(self.frame.sample_rate)
        nframes = self.frame.nframes(sampled.shape[0])
        boundaries = self.frame.boundaries(nframes)

        data = np.zeros((nframes, len(token2index)), dtype=bool)
        window = windows.window(
            self.frame.samples_per_frame, type=self.window_type,
            blackman_coeff=self.blackman_coeff)

        for i, (onset, offset) in enumerate(boundaries):
            framed = sampled[onset:offset]
            if np.all(framed[0] == framed[1:]):
                winner = framed[0]
            else:
                # several tokens in the frame: weight each token by
                # the window mass it covers
                weights = collections.defaultdict(int)
                for weight, token in zip(window, framed):
                    weights[token] += weight
                winner = sorted(
                    weights.items(), key=operator.itemgetter(1),
                    reverse=True)[0][0]
            data[i, token2index[winner]] = True

        return Features(
            data, boundaries / self.frame.sample_rate,
            properties=self._properties_with_mapping(token2index))
