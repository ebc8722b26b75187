"""The :class:`Features` container: per-frame features + timestamps.

The port's own copy of ``shennong_tpu/features.py``. A Features instance stores an immutable triplet (data,
times, properties) for one utterance; collections of them are handled
by :class:`~shennong_tpu_torch.features_collection.FeaturesCollection`.
"""

import numpy as np

from shennong_tpu_torch.logger import get_logger
from shennong_tpu_torch.utils import copy_properties, dict_equal


class Features:
    """Features matrix ``[nframes, ndims]`` with timestamps and metadata."""

    def __init__(self, data, times, properties=None, validate=True):
        self._data = data
        self._times = times
        self._properties = {} if properties is None else properties
        if validate:
            self.validate()

    @property
    def data(self):
        """The features matrix"""
        return self._data

    @property
    def times(self):
        """Per-frame timestamps, shape [nframes] or [nframes, 2]"""
        return self._times

    @property
    def dtype(self):
        """dtype of the features data"""
        return self.data.dtype

    @property
    def shape(self):
        """(nframes, ndims)"""
        return self.data.shape

    @property
    def ndims(self):
        """Feature dimensionality (number of columns)"""
        return self.shape[1]

    @property
    def nframes(self):
        """Number of frames (number of rows)"""
        return self.shape[0]

    @property
    def properties(self):
        """Metadata dict: generating pipeline, parameters, audio info"""
        return self._properties

    def _to_dict(self, with_properties=True):
        out = {'data': self.data, 'times': self.times}
        if with_properties:
            out['properties'] = self.properties
        return out

    @staticmethod
    def _from_dict(features, validate=True):
        missing = {'data', 'times'} - set(features.keys())
        if missing:
            raise ValueError(
                'cannot read features from dict, missing keys: {}'
                .format(', '.join(missing)))
        return Features(
            features['data'], features['times'],
            properties=features.get('properties', {}),
            validate=validate)

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, Features):
            return NotImplemented
        return (
            self.shape == other.shape
            and self.dtype == other.dtype
            and dict_equal(self.properties, other.properties)
            and np.array_equal(self.times, other.times)
            and np.array_equal(self.data, other.data))

    def is_close(self, other, rtol=1e-5, atol=1e-8):
        """Approximate equality: identical times/properties, allclose data."""
        if self is other:
            return True
        return (
            self.shape == other.shape
            and dict_equal(self.properties, other.properties)
            and np.array_equal(self.times, other.times)
            and np.allclose(self.data, other.data, atol=atol, rtol=rtol))

    def copy(self, dtype=None, subsample=None):
        """Deep copy, with optional dtype conversion and frame
        subsampling (every ``subsample``-th frame)."""
        if subsample is None:
            subsample = 1
        elif not isinstance(subsample, int) or subsample <= 0:
            raise ValueError(
                f'subsample must be a strictly positive integer, '
                f'it is: {subsample}')
        data = self.data[::subsample]
        times = self.times[::subsample]
        if dtype:
            data, times = data.astype(dtype), times.astype(dtype)
        else:
            data, times = data.copy(), times.copy()
        return Features(
            data, times, properties=copy_properties(self.properties),
            validate=False)

    def is_valid(self):
        """True if :func:`validate` passes"""
        try:
            self.validate()
        except ValueError:
            return False
        return True

    def validate(self):
        """Raise ValueError if the features are inconsistent."""
        errors = []
        if not isinstance(self.data, np.ndarray):
            errors.append('data must be a numpy array')
        if not isinstance(self.times, np.ndarray):
            errors.append('times must be a numpy array')
        if not isinstance(self.properties, dict):
            errors.append('properties must be a dictionnary')
        if errors:
            raise ValueError(
                'invalid features data types: {}'.format(', '.join(errors)))

        if self.data.ndim != 2:
            errors.append(
                'data dimension must be 2 but is {}'.format(self.data.ndim))
        if self.times.ndim > 2:
            errors.append(
                'times dimension must be 1 or 2 but is {}'.format(
                    self.times.ndim))
        if self.times.ndim == 2 and self.times.shape[1] != 2:
            errors.append(
                'times shape[1] must be 2, it is {}'.format(
                    self.times.shape[1]))
        if self.data.shape[0] != self.times.shape[0]:
            errors.append(
                'mismatch in number of frames: {} for data but {} '
                'for times'.format(
                    self.data.shape[0], self.times.shape[0]))
        if errors:
            raise ValueError(
                'invalid features dimensions: {}'.format(', '.join(errors)))

        # direct sortedness checks (equivalent to stable argsort ==
        # arange, without the per-Features argsort/arange allocations)
        if self.times.ndim == 1:
            is_sorted = bool(np.all(self.times[1:] >= self.times[:-1]))
        else:
            # lexicographic on (..., col1 primary, col0 secondary),
            # matching np.lexsort(self.times.T) stability
            primary = np.diff(self.times[:, 1])
            secondary = np.diff(self.times[:, 0])
            is_sorted = bool(np.all(
                (primary > 0) | ((primary == 0) & (secondary >= 0))))
        if not is_sorted:
            raise ValueError('times is not sorted in increasing order')

        if not np.all(np.isfinite(self.data)):
            raise ValueError(
                'data contains non-finite numbers (nan of infinity)')

    def concatenate(
            self, other, tolerance=0, log=get_logger('features', 'info'),
            validate=True):
        """Horizontal concatenation with frame-count tolerance.

        If the two features differ in frame count by at most
        ``tolerance`` frames the longest one is trimmed (the same
        tolerance Kaldi applies in paste-feats); beyond the tolerance a
        ValueError is raised. Timestamps must agree.

        ``validate=False`` skips re-validating the result (the frame
        agreement and timestamp checks above still run): sortedness
        and finiteness are inherited from the operands, so callers
        concatenating already-validated features — the pipeline's
        pass 2 over a whole corpus — avoid a full re-scan of the
        output matrix per utterance.
        """
        diff = check_frames(self.nframes, other.nframes, tolerance, log)
        data1, times1 = self.data, self.times
        data2, times2 = other.data, other.times
        if diff:
            if self.nframes > other.nframes:
                data1, times1 = data1[:-diff], times1[:-diff]
            else:
                data2, times2 = data2[:-diff], times2[:-diff]

        if not np.allclose(times1, times2):
            raise ValueError('times are not equal')

        # merge properties, shifting the pipeline columns of `other`
        properties = copy_properties(self.properties)
        other_properties = copy_properties(other.properties)
        properties.update(
            {k: v for k, v in other_properties.items() if k != 'pipeline'})
        properties.setdefault('pipeline', [])
        for entry in other_properties.get('pipeline', []):
            properties['pipeline'].append(entry)
            columns = properties['pipeline'][-1]['columns']
            properties['pipeline'][-1]['columns'] = [
                columns[0] + self.ndims, columns[1] + self.ndims]

        return Features(
            np.hstack((data1, data2)), times1, properties=properties,
            validate=validate)


def check_frames(nframes, other, tolerance, log):
    """The difference of two frame counts that
    :meth:`Features.concatenate` trims: raises past ``tolerance``,
    warns on ``log`` within it."""
    diff = abs(nframes - other)
    if diff:
        if not tolerance:
            raise ValueError(
                'features have a different number of frames')
        if diff > tolerance:
            raise ValueError(
                'features differs number of frames, and '
                'greater than tolerance: |{} - {}| > {}'.format(
                    nframes, other, tolerance))
        log.warning(
            'features differs in number of frames, but '
            'within tolerance (|%s - %s| <= %s), trim the longest one',
            nframes, other, tolerance)
    return diff
