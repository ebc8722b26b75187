"""The :class:`Utterance` and :class:`Utterances` classes.

An utterance names a speech segment to be processed by a pipeline and
comes in one of four formats (the port's own copy of
``shennong_tpu/utterances.py``, the methods the port calls):

* ``<utterance-id> <audio-file>``
* ``<utterance-id> <audio-file> <speaker-id>``
* ``<utterance-id> <audio-file> <tstart> <tstop>``
* ``<utterance-id> <audio-file> <speaker-id> <tstart> <tstop>``
"""

import collections
import os
import random
import warnings

from shennong_tpu_torch.audio import Audio


VALID_FORMATS = {
    1: '<utterance-id> <audio-file>',
    2: '<utterance-id> <audio-file> <speaker-id>',
    3: '<utterance-id> <audio-file> <tstart> <tstop>',
    4: '<utterance-id> <audio-file> <speaker-id> <tstart> <tstop>'}
"""The valid utterance formats, as documented above"""


class Utterance:
    """A single utterance: name, audio file, optional speaker/times."""

    def __init__(self, *args):
        if len(args) < 2 or len(args) > 5:
            raise ValueError(f'invalid utterance format: {args}')

        self._format = len(args) - 1
        self._name, self._audio = args[0], args[1]
        self._speaker, self._tstart, self._tstop = None, None, None
        if len(args) == 3:
            self._speaker = args[2]
        elif len(args) == 4:
            self._tstart, self._tstop = args[2], args[3]
        elif len(args) == 5:
            self._speaker, self._tstart, self._tstop = args[2:5]

        for attr in ('_tstart', '_tstop'):
            value = getattr(self, attr)
            if value is not None:
                try:
                    setattr(self, attr, float(value))
                except ValueError:
                    raise ValueError(
                        f'cannot cast {attr[1:]} as float: {value}') from None

        if (self._tstart is None) != (self._tstop is None):
            raise ValueError('both tstart and tstop must be defined or None')
        if self._tstart is not None and (
                self._tstart < 0 or self._tstart >= self._tstop):
            raise ValueError(
                'we must have 0 <= tstart < tstop, but '
                f'(tstart, tstop)=({self._tstart}, {self._tstop})')

        # scanning raises if the audio file is missing or unreadable
        file_duration = Audio.scan(self._audio).duration
        self._duration = file_duration
        if self._tstart is not None:
            if self._tstop > file_duration:
                warnings.warn(
                    f'{self._audio}: requested segment ({self._tstart}, '
                    f'{self._tstop}) exceeds the file duration '
                    f'{file_duration}, it will be truncated')
                self._tstop = file_duration
            self._duration = self._tstop - self._tstart

    def __eq__(self, other):
        if not isinstance(other, Utterance):
            return NotImplemented
        return str(self) == str(other)

    def __str__(self):
        fields = [self.name, self.audio_file]
        if self.speaker is not None:
            fields.append(self.speaker)
        if self.tstart is not None:
            fields += [self.tstart, self.tstop]
        return ' '.join(str(f) for f in fields)

    @property
    def format(self):
        """Numeric code (1-4) of the fields this utterance carries"""
        return self._format

    @property
    def name(self):
        """The unique <utterance-id> string"""
        return self._name

    @property
    def audio_file(self):
        """Path of the audio file holding this utterance"""
        return self._audio

    @property
    def speaker(self):
        """The <speaker-id> when present, else None"""
        return self._speaker

    @property
    def tstart(self):
        """Segment onset within the file (seconds), None for whole
        files"""
        return self._tstart

    @property
    def tstop(self):
        """Segment offset within the file (seconds), None for whole
        files"""
        return self._tstop

    @property
    def duration(self):
        """Length of the utterance's audio, in seconds"""
        return self._duration

    def load_audio(self):
        """Load (and optionally segment) the utterance's audio data."""
        data = Audio.load(self._audio)
        if self.tstart or self.tstop:
            data = data.segment([(self.tstart, self.tstop)])[0]
        return data


class Utterances:
    """An ordered collection of :class:`Utterance` with unique names."""

    def __init__(self, utterances):
        utterances = self._parse(utterances)
        if not utterances:
            raise ValueError('empty input utterances')

        formats = set(utt.format for utt in utterances)
        if len(formats) != 1:
            raise ValueError('utterances format is not homogeneous')
        self._format = formats.pop()

        counter = collections.Counter(u.name for u in utterances)
        duplicates = [name for name, count in counter.items() if count > 1]
        if duplicates:
            raise ValueError(
                f'duplicates found in utterances: {", ".join(duplicates)}')

        # sorting by audio file exploits the Audio.load cache when
        # consecutive utterances segment the same file
        utterances = sorted(utterances, key=lambda u: (u.audio_file, u.name))
        self._utterances = {u.name: u for u in utterances}

    @staticmethod
    def _parse(utterances):
        parsed = []
        for utt in utterances:
            if not isinstance(utt, Utterance):
                try:
                    utt = Utterance(*utt)
                except TypeError:
                    raise ValueError(
                        f'utterance must be an iterable, not {utt}') from None
            parsed.append(utt)
        return parsed

    def __len__(self):
        return len(self._utterances)

    def __iter__(self):
        return iter(self._utterances.values())

    def __getitem__(self, name):
        return self._utterances[name]

    def __eq__(self, other):
        if not isinstance(other, Utterances):
            return NotImplemented
        return self._utterances == other._utterances

    @classmethod
    def load(cls, filename):
        """Load utterances from a text index file (one per line)."""
        if not os.path.isfile(filename):
            raise ValueError(f'{filename} not found')
        with open(filename, 'r') as fp:
            lines = (line.strip() for line in fp)
            utterances = [line.split(' ') for line in lines if line]
        return cls(utterances)

    def format(self):
        """Numeric code (1-4) of the fields this utterance carries"""
        return self._format

    @property
    def name(self):
        """The unique <utterance-id> string"""
        return self._name

    @property
    def audio_file(self):
        """Path of the audio file holding this utterance"""
        return self._audio

    @property
    def speaker(self):
        """The <speaker-id> when present, else None"""
        return self._speaker

    @property
    def tstart(self):
        """Segment onset within the file (seconds), None for whole
        files"""
        return self._tstart

    @property
    def tstop(self):
        """Segment offset within the file (seconds), None for whole
        files"""
        return self._tstop

    @property
    def duration(self):
        """Length of the utterance's audio, in seconds"""
        return self._duration

    def load_audio(self):
        """Load (and optionally segment) the utterance's audio data."""
        data = Audio.load(self._audio)
        if self.tstart or self.tstop:
            data = data.segment([(self.tstart, self.tstop)])[0]
        return data


class Utterances:
    """An ordered collection of :class:`Utterance` with unique names."""

    def __init__(self, utterances):
        utterances = self._parse(utterances)
        if not utterances:
            raise ValueError('empty input utterances')

        formats = set(utt.format for utt in utterances)
        if len(formats) != 1:
            raise ValueError('utterances format is not homogeneous')
        self._format = formats.pop()

        counter = collections.Counter(u.name for u in utterances)
        duplicates = [name for name, count in counter.items() if count > 1]
        if duplicates:
            raise ValueError(
                f'duplicates found in utterances: {", ".join(duplicates)}')

        # sorting by audio file exploits the Audio.load cache when
        # consecutive utterances segment the same file
        utterances = sorted(utterances, key=lambda u: (u.audio_file, u.name))
        self._utterances = {u.name: u for u in utterances}

    @staticmethod
    def _parse(utterances):
        parsed = []
        for utt in utterances:
            if not isinstance(utt, Utterance):
                try:
                    utt = Utterance(*utt)
                except TypeError:
                    raise ValueError(
                        f'utterance must be an iterable, not {utt}') from None
            parsed.append(utt)
        return parsed

    def __len__(self):
        return len(self._utterances)

    def __iter__(self):
        return iter(self._utterances.values())

    def __getitem__(self, name):
        return self._utterances[name]

    def __eq__(self, other):
        if not isinstance(other, Utterances):
            return NotImplemented
        return self._utterances == other._utterances

    @classmethod
    def load(cls, filename):
        """Load utterances from a text index file (one per line)."""
        if not os.path.isfile(filename):
            raise ValueError(f'{filename} not found')
        with open(filename, 'r') as fp:
            lines = (line.strip() for line in fp)
            utterances = [line.split(' ') for line in lines if line]
        return cls(utterances)

    def save(self, filename):
        """Write the utterances index to a text file."""
        with open(filename, 'w') as fp:
            fp.write('\n'.join(str(utt) for utt in self) + '\n')

    def format(self, type=int):
        """Return the format code (int) or its description (str)."""
        return VALID_FORMATS[self._format] if type is str else self._format

    def has_speakers(self):
        """True when the utterances carry speaker information"""
        return self.format(type=int) in (2, 4)

    def by_speaker(self):
        """Group the utterances per speaker: dict speaker -> [Utterance]."""
        if not self.has_speakers():
            raise ValueError('utterances have no speaker information')
        groups = collections.defaultdict(list)
        for utt in self:
            groups[utt.speaker].append(utt)
        return groups

    def by_name(self):
        """The utterances as a dict name -> :class:`Utterance`."""
        return self._utterances

    def duration(self):
        """Total duration of the collection in seconds"""
        return sum(utt.duration for utt in self)

    def fit_to_duration(self, duration, truncate=False, shuffle=False):
        """Budget ``duration`` seconds of audio per speaker.

        Returns a new :class:`Utterances` whose segments cover at most
        ``duration`` seconds for each speaker (used to bound VTLN
        training data). With ``truncate=False`` a speaker with too
        little data raises; otherwise a warning is issued.
        """
        if duration <= 0:
            raise ValueError(
                f'duration must be a positive number, it is {duration}')

        def speaker_segments(speaker, utterances):
            budget = duration
            for utt in utterances:
                onset = utt.tstart or 0
                offset = (
                    utt.tstop if utt.tstop is not None
                    else utt.duration - onset)
                if utt.duration >= budget:
                    yield Utterance(
                        utt.name, utt.audio_file, utt.speaker,
                        onset, onset + budget)
                    return
                yield Utterance(
                    utt.name, utt.audio_file, utt.speaker, onset, offset)
                budget -= utt.duration

            message = (
                f'speaker {speaker}: only {duration - budget}s'
                f' of audio available but {duration}s requested')
            if truncate:
                warnings.warn(message)
            else:
                raise ValueError(message)

        segments = []
        for speaker, utterances in self.by_speaker().items():
            if shuffle:
                random.shuffle(utterances)
            segments.extend(speaker_segments(speaker, utterances))
        return Utterances(segments)
