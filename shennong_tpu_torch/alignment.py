"""Time alignments of speech: :class:`Alignment`, :class:`AlignmentCollection`.

The port's own copy of ``shennong_tpu/alignment.py`` (host numpy; the
files it reads and writes are the JAX package's). An
alignment is a contiguous sequence of (onset, offset, token) triplets;
collections of per-item alignments load/save the 4-column text format
``<item> <onset> <offset> <token>`` (optionally gzipped).
"""

import gzip
import os

import numpy as np


class Alignment:
    """A sequence of tokens aligned on (onset, offset) timestamps."""

    def __init__(self, times, tokens, validate=True):
        self._times = times
        self._tokens = tokens
        if validate:
            self.validate()

    @property
    def times(self):
        """The [ntokens, 2] array of (onset, offset) in seconds"""
        return self._times

    @property
    def onsets(self):
        """Token onset times in seconds"""
        return self._times[:, 0]

    @property
    def offsets(self):
        """Token offset times in seconds"""
        return self._times[:, 1]

    @property
    def tokens(self):
        """The aligned tokens"""
        return self._tokens

    @staticmethod
    def from_list(data, validate=True):
        """Build an Alignment from (tstart, tstop, token) triplets."""
        for i, entry in enumerate(data):
            if len(entry) != 3:
                raise ValueError(
                    'line {}: entry must have 3 fields but has {}'
                    .format(i, len(entry)))
        times = np.array([d[:2] for d in data], dtype=np.float64)
        tokens = np.array([d[2] for d in data])
        return Alignment(times, tokens, validate=validate)

    def validate(self):
        """Raise ValueError unless the alignment is temporally consistent.

        Each token must have a strictly positive duration, onsets must
        be increasing and each offset must equal the next onset.
        """
        if self._times.shape[0] != self.tokens.shape[0]:
            raise ValueError('timestamps and tokens must have the same length')

        if np.any(self.onsets >= self.offsets):
            bad = int(np.argmax(self.onsets >= self.offsets))
            raise ValueError(
                'token {}: onset must be lesser than offset'.format(bad))

        if self.tokens.shape[0] > 1:
            if np.any(self.onsets[:-1] > self.onsets[1:]):
                raise ValueError(
                    'timestamps must be sorted in increasing order')
            if np.any(self.offsets[:-1] != self.onsets[1:]):
                raise ValueError('mismatch in tstop/tstart timestamps')

    def is_valid(self):
        """True if :func:`validate` passes"""
        try:
            self.validate()
        except ValueError:
            return False
        return True

    def __eq__(self, other):
        if not isinstance(other, Alignment):
            return NotImplemented
        return (np.array_equal(self._times, other._times)
                and np.array_equal(self.tokens, other.tokens))

    def __getitem__(self, time):
        """Slice the alignment on a time interval: ``alignment[t0:t1]``."""
        if not isinstance(time, slice):
            raise ValueError(
                'time must be a slice but is {}'.format(type(time)))
        if time.step is not None:
            raise ValueError('time.step is defined but is useless')

        tmin, tmax = self.onsets[0], self.offsets[-1]
        tstart = tmin if time.start is None else max(time.start, tmin)
        tstop = tmax if time.stop is None else min(time.stop, tmax)

        if tstart >= tstop or tstart >= tmax or tstop <= tmin:
            # [0, 2] times so onsets/offsets/to_list work on the
            # empty result
            return Alignment(
                np.empty((0, 2)), np.array([]), validate=False)
        if tstart == tmin and tstop == tmax:
            return self

        istart = (
            0 if tstart == tmin
            else int(np.where(self.onsets <= tstart)[0][-1]))
        istop = (
            self.tokens.shape[0] - 1 if tstop == tmax
            else int(np.where(self.offsets >= tstop)[0][0]))

        if istart == istop:
            # partial read within a single token
            tokens = np.array(self.tokens[istart:istart + 1])
            times = np.array([tstart, tstop]).reshape(1, 2)
        else:
            tokens = self.tokens[istart:istop + 1]
            times = np.copy(self._times[istart:istop + 1, :])
            times[0, 0] = tstart
            times[-1, 1] = tstop

        return Alignment(times, tokens, validate=False)

    def __repr__(self):
        return '\n'.join(
            '{} {} {}'.format(t0, t1, token)
            for (t0, t1, token) in self.to_list())

    def to_list(self):
        """The alignment as (onset, offset, token) triplets"""
        return [(self.onsets[i], self.offsets[i], self.tokens[i])
                for i in range(self.tokens.shape[0])]

    def at_sample_rate(self, sample_rate):
        """Expand the tokens into one token per sample at ``sample_rate``."""
        nsamples = int(self.duration() * sample_rate)
        times = np.arange(nsamples) / sample_rate + self.onsets[0]
        # index of the token covering each sample
        indices = np.searchsorted(self.offsets, times, side='right')
        indices = np.minimum(indices, self.tokens.shape[0] - 1)
        return self.tokens[indices]

    def duration(self):
        """Alignment duration in seconds"""
        if len(self.tokens) == 0:
            return 0
        return self.offsets[-1] - self.onsets[0]

    def get_tokens_inventory(self):
        """The set of distinct tokens in the alignment"""
        return set(self.tokens)


class AlignmentCollection(dict):
    """A dict of item name -> :class:`Alignment` with text file IO."""

    def __init__(self, data):
        for i, entry in enumerate(data):
            if len(entry) != 4:
                raise ValueError(
                    'alignment must have 4 columns but line {} has {}'
                    .format(i + 1, len(entry)))
            item = entry[0]
            if item not in self.keys():
                self[item] = []
            self[item].append(entry[1:])

        for item, triplets in self.items():
            try:
                self[item] = Alignment.from_list(triplets, validate=True)
            except ValueError as err:
                raise ValueError(
                    'item {}: {}'.format(item, err)) from None

    @staticmethod
    def load(filename, compress=False):
        """Load a collection from a 4-column text file (gzip optional)."""
        if not os.path.isfile(filename):
            raise ValueError('{}: file not found'.format(filename))

        open_fun = gzip.open if compress else open
        with open_fun(filename, 'rt', encoding='utf8') as fp:
            data = [line.split() for line in fp.readlines()]
        return AlignmentCollection(data)

    def save(self, filename, sort=False, compress=False):
        """Write the collection to a text file (must not exist)."""
        if os.path.isfile(filename):
            raise ValueError('{} already exist'.format(filename))

        items = sorted(self.keys()) if sort else self.keys()
        open_fun = gzip.open if compress else open
        try:
            with open_fun(filename, 'wt', encoding='utf8') as fp:
                for item in items:
                    fp.write('\n'.join(self._item_lines(item)) + '\n')
        except FileNotFoundError:
            raise ValueError(
                'cannot write to {}'.format(filename)) from None

    def _item_lines(self, item):
        return [
            '{} {} {} {}'.format(item, t0, t1, token)
            for (t0, t1, token) in self[item].to_list()]

    def get_tokens_inventory(self):
        """The set of distinct tokens across all alignments"""
        return set.union(
            *(a.get_tokens_inventory() for a in self.values()))
