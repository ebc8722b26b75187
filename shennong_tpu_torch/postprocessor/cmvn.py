"""Cepstral mean/variance normalization post-processors.

Counterpart of :mod:`shennong_tpu.postprocessor.cmvn`. Statistics
accumulation is an associative float64 reduction and the application
a per-dimension affine transform, both on the host. The sliding-window
variant runs on a given device as a batched prefix-sum computation
(:func:`shennong_tpu_torch.ops.postops.sliding_window_cmvn`).
"""

import copy

import numpy as np
import torch

from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.ops import postops
from shennong_tpu_torch.postprocessor.base import FeaturesPostProcessor


class CmvnPostProcessor(FeaturesPostProcessor):
    """Accumulates and applies CMVN statistics over features.

    Parameters
    ----------
    dim : int
        The features dimension, must be strictly positive
    stats : array, shape = [2, dim+1], optional
        Pre-accumulated CMVN statistics (see :func:`stats`)
    """

    def __init__(self, dim, stats=None):
        super().__init__()

        if not isinstance(dim, int) or dim <= 0:
            raise ValueError(
                'dimension must be a strictly positive integer, it is {}'
                .format(dim))
        self._dim = dim

        if stats is not None:
            stats = np.asarray(stats, dtype=np.float64)
            if stats.shape != (2, dim + 1):
                raise ValueError(
                    'stats must be an array of shape {}, but is shaped as {}'
                    .format((2, dim + 1), stats.shape))
            self._stats = stats.copy()
        else:
            self._stats = np.zeros((2, dim + 1))

    @property
    def name(self):
        return 'cmvn'

    @property
    def dim(self):
        """The dimension of features on which to compute CMVN"""
        return self._dim

    @property
    def stats(self):
        """The accumulated CMVN statistics, shape [2, dim+1].

        Row 0 holds the per-dimension weighted sums with the total
        frame weight in the last column; row 1 holds the weighted sums
        of squares.
        """
        return self._stats

    @property
    def count(self):
        """The weighted total count of accumulated features frames"""
        return self._stats[0, -1]

    @property
    def ndims(self):
        return self.dim

    def get_properties(self, features):
        properties = super().get_properties(features)
        # a copy: later accumulate() calls update self._stats in
        # place and must not retroactively rewrite the provenance of
        # already-returned Features
        properties[self.name]['stats'] = np.array(self.stats)
        return properties

    def accumulate(self, features, weights=None):
        """Add the statistics of ``features`` to the accumulator.

        ``weights`` optionally weighs each frame (e.g. a VAD mask to
        exclude silences).
        """
        if weights is not None:
            weights = np.asarray(weights)
            if weights.ndim != 1:
                raise ValueError(
                    'weights must have a single dimension but have {}'
                    .format(weights.ndim))
            if weights.shape[0] != features.nframes:
                raise ValueError(
                    'there is {} weights but {} feature frames, must be equal'
                    .format(weights.shape[0], features.nframes))

        self._stats += postops.accumulate_cmvn_stats(
            features.data, weights=weights)

    def _check(self, features):
        """Raise ValueError where the statistics cannot normalize
        ``features``: a count below 1, another dimension."""
        if self.count < 1.0:
            raise ValueError(
                'insufficient accumulation of stats for CMVN, '
                'must be >= 1.0 but is {}'.format(self.count))

        if features.ndims != self.dim:
            raise ValueError(
                'features have {} dimensions but the accumulated '
                'statistics have {}'.format(features.ndims, self.dim))

    def process(self, features, norm_vars=True, skip_dims=None,
                reverse=False):
        """Normalize ``features`` with the accumulated statistics.

        ``norm_vars`` additionally normalizes the variance,
        ``skip_dims`` lists dimensions to leave untouched, ``reverse``
        applies the inverse transform.
        """
        self._check(features)
        if skip_dims:
            dmin, dmax = min(skip_dims), max(skip_dims)
            if dmin < 0 or dmax >= self.dim:
                raise ValueError(
                    'skipped dimensions must be in [0, {}[ but are in '
                    '[{}, {}['.format(self.dim, dmin, dmax))

        data = postops.apply_cmvn(
            features.data, self._stats, norm_vars=norm_vars,
            skip_dims=skip_dims, reverse=reverse)

        return Features(
            data, features.times,
            properties=self.get_properties(features))


def apply_cmvn(feats_collection, by_collection=True, norm_vars=True,
               weights=None, skip_dims=None):
    """CMVN normalization of a whole features collection.

    With ``by_collection`` the statistics are pooled over the entire
    collection; otherwise each features is normalized independently.
    """
    dims = set(f.ndims for f in feats_collection.values())
    if len(dims) != 1:
        raise ValueError(
            'features in the collection must have consistent dimensions '
            'but dimensions are: {}'.format(sorted(dims)))
    dim = dims.pop()

    if weights is not None and weights.keys() != feats_collection.keys():
        raise ValueError('keys differ for weights and features collection')

    if skip_dims is not None:
        sdmin, sdmax = min(skip_dims), max(skip_dims)
        if sdmin < 0 or sdmax >= dim:
            raise ValueError(
                'out of bounds dimensions in skip_dims, must be in [0, {}] '
                'but are in [{}, {}]'.format(dim - 1, sdmin, sdmax))

    def weight_of(key):
        return weights[key] if weights is not None else None

    if by_collection:
        cmvn = CmvnPostProcessor(dim)
        for key, feats in feats_collection.items():
            cmvn.accumulate(feats, weights=weight_of(key))
        return FeaturesCollection({
            key: cmvn.process(
                feats, norm_vars=norm_vars, skip_dims=skip_dims)
            for key, feats in feats_collection.items()})

    out = FeaturesCollection()
    for key, feats in feats_collection.items():
        cmvn = CmvnPostProcessor(feats.ndims)
        cmvn.accumulate(feats, weights=weight_of(key))
        out[key] = cmvn.process(
            feats, norm_vars=norm_vars, skip_dims=skip_dims)
    return out


#: utterances per padded batch of SlidingWindowCmvnPostProcessor.process_all
BATCH_ROWS = 16


class SlidingWindowCmvnPostProcessor(FeaturesPostProcessor):
    """Sliding-window mean (and variance) normalization.

    Parameters
    ----------
    center : bool, optional
        Whether to center the window on the current frame, default True
    cmn_window : int, optional
        Window size for average CMN computation, default 600
    min_window : int, optional
        Minimum CMN window used at start of decoding, default 100
    max_warnings : int, optional
        Kept for API compatibility (unused), default 5
    normalize_variance : bool, optional
        Whether to normalize variance to one, default False
    """

    def __init__(self, center=True, cmn_window=600, min_window=100,
                 max_warnings=5, normalize_variance=False):
        super().__init__()
        self.center = center
        self.cmn_window = cmn_window
        self.min_window = min_window
        self.max_warnings = max_warnings
        self.normalize_variance = normalize_variance

    @property
    def name(self):
        return 'sliding_window_cmvn'

    @property
    def ndims(self):
        raise ValueError('output dimension for sliding '
                         'window CMVN processor depends on input')

    @property
    def center(self):
        """Whether to center the window on the current frame"""
        return self._center

    @center.setter
    def center(self, value):
        self._center = bool(value)

    @property
    def cmn_window(self):
        """Window size for average CMN computation"""
        return self._cmn_window

    @cmn_window.setter
    def cmn_window(self, value):
        self._cmn_window = int(value)

    @property
    def min_window(self):
        """Minimum CMN window used at start of decoding"""
        return self._min_window

    @min_window.setter
    def min_window(self, value):
        self._min_window = int(value)

    @property
    def max_warnings(self):
        """Maximum warning to report per utterance"""
        return self._max_warnings

    @max_warnings.setter
    def max_warnings(self, value):
        self._max_warnings = int(value)

    @property
    def normalize_variance(self):
        """Whether to normalize variance to one"""
        return self._normalize_variance

    @normalize_variance.setter
    def normalize_variance(self, value):
        self._normalize_variance = bool(value)

    def get_properties(self, features):
        properties = copy.deepcopy(features.properties)
        properties[self.name] = self.get_params()
        properties.setdefault('pipeline', []).append({
            'name': self.name,
            'columns': [0, features.ndims - 1]})
        return properties

    def _normalize(self, stacked, nframes, device):
        """sliding_window_cmvn of a [B, T, D] numpy batch on ``device``"""
        out = postops.sliding_window_cmvn(
            torch.as_tensor(stacked, device=device),
            torch.as_tensor(nframes, device=device),
            center=self._center, cmn_window=self._cmn_window,
            min_window=self._min_window,
            normalize_variance=self._normalize_variance)
        return out.cpu().numpy()

    def process(self, features, *, device):
        """Apply sliding-window normalization to ``features`` on
        ``device``."""
        out = self._normalize(
            features.data.astype(np.float32)[None],
            np.array([features.nframes], dtype=np.int32), device)
        return Features(
            out[0].astype(features.dtype), features.times,
            self.get_properties(features))

    def process_all(self, features_collection, njobs=None, *, device):
        """Sliding-window normalization of a whole collection on
        ``device``, :data:`BATCH_ROWS` utterances of one dimension per
        padded batch. Returns a FeaturesCollection keyed like the
        input. ``njobs`` has no effect: it keeps the JAX package's
        signature, and the features are in memory, nothing is decoded."""
        names = list(features_collection.keys())
        by_dim = {}
        for name in names:
            by_dim.setdefault(
                features_collection[name].ndims, []).append(name)
        normed = {}
        for dim, group in by_dim.items():
            for start in range(0, len(group), BATCH_ROWS):
                chunk = group[start:start + BATCH_ROWS]
                nframes = np.array(
                    [features_collection[name].nframes for name in chunk],
                    dtype=np.int32)
                stacked = np.zeros(
                    (len(chunk), max(nframes.max(), 1), dim),
                    dtype=np.float32)
                for row, name in enumerate(chunk):
                    stacked[row, :nframes[row]] = \
                        features_collection[name].data
                out = self._normalize(stacked, nframes, device)
                for row, name in enumerate(chunk):
                    normed[name] = out[row, :nframes[row]]
        return FeaturesCollection({
            name: Features(
                normed[name].astype(features_collection[name].dtype),
                features_collection[name].times,
                self.get_properties(features_collection[name]))
            for name in names})
