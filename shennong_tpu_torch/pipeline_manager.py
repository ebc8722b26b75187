"""Pipeline stage wiring: config sections -> configured processors.

The port's own copy of ``shennong_tpu/pipeline_manager.py`` (the
methods the port calls): map YAML sections to the port's processor
classes, scan the corpus' audio metadata, share the framing parameters
across stages, and keep the CMVN state as a dict of plain
``[2, dim+1]`` statistics arrays keyed by speaker or utterance.
"""

import datetime
import importlib
import re

import numpy as np

from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.logger import get_logger
from shennong_tpu_torch.ops.postops import accumulate_cmvn_stats


class PipelineManager:
    """Builds and wires the processors of one extraction pipeline"""

    valid_features = [
        'spectrogram', 'filterbank', 'mfcc', 'plp', 'bottleneck']
    """Names of the main feature extraction algorithms"""

    valid_processors = {
        'bottleneck': ('processor', 'BottleneckProcessor'),
        'energy': ('processor', 'EnergyProcessor'),
        'filterbank': ('processor', 'FilterbankProcessor'),
        'mfcc': ('processor', 'MfccProcessor'),
        'kaldi_pitch': ('processor', 'KaldiPitchProcessor'),
        'kaldi_pitch_post': ('processor', 'KaldiPitchPostProcessor'),
        'crepe_pitch': ('processor', 'CrepePitchProcessor'),
        'crepe_pitch_post': ('processor', 'CrepePitchPostProcessor'),
        'plp': ('processor', 'PlpProcessor'),
        'spectrogram': ('processor', 'SpectrogramProcessor'),
        'ubm': ('processor', 'DiagUbmProcessor'),
        'vtln': ('processor', 'VtlnProcessor'),
        'cmvn': ('postprocessor', 'CmvnPostProcessor'),
        'delta': ('postprocessor', 'DeltaPostProcessor'),
        'sliding_window_cmvn':
            ('postprocessor', 'SlidingWindowCmvnPostProcessor'),
        'vad': ('postprocessor', 'VadPostProcessor')}
    """Config-section names mapped to their (package, class)"""

    _processor_modules = {
        'crepe_pitch': 'pitch_crepe',
        'crepe_pitch_post': 'pitch_crepe',
        'kaldi_pitch': 'pitch_kaldi',
        'kaldi_pitch_post': 'pitch_kaldi',
        'sliding_window_cmvn': 'cmvn'}

    def __init__(self, config, utterances,
                 log=get_logger('manager', 'warning'), *, device=None):
        self._config = config
        self._utterances = utterances
        self._warps = {}
        self.log = log
        #: the device of the extraction call: pass 2 runs there
        #: (``pipeline._pass_two`` raises while it is None)
        self.device = device

        by_speaker = (
            'cmvn' in config and config['cmvn'].get('by_speaker', False))
        if by_speaker and not utterances.has_speakers():
            raise ValueError(
                'cmvn normalization by speaker requested '
                'but no speaker information provided')

        # one metadata scan per distinct file; processors need the
        # sample rates at build time
        self._audio_metadata = {
            audio_file: Audio.scan(audio_file)
            for audio_file in set(utt.audio_file for utt in utterances)}

        log.info('scanning %s utterances...', len(utterances))
        self._report_corpus()

        self.features = [
            k for k in config.keys() if k in self.valid_features][0]

        # framing parameters shared by the energy/pitch stages
        proc = self.make('features', next(iter(utterances)))
        self.frame_length = proc.frame_length
        self.frame_shift = proc.frame_shift
        self._ndims = proc.ndims

        # CMVN state: plain statistics arrays, one per group key
        self.cmvn_stats = {}
        if 'cmvn' in config:
            keys = set(
                utt.speaker if by_speaker else utt.name
                for utt in utterances)
            self.cmvn_stats = {
                key: np.zeros((2, self._ndims + 1)) for key in keys}

    # ------------------------------------------------------- accessors

    @property
    def config(self):
        """The pipeline configuration"""
        return self._config

    @property
    def utterances(self):
        """Utterances on which to apply the pipeline"""
        return self._utterances

    @property
    def warps(self):
        """VTLN warps of the utterances (optional)"""
        return self._warps

    @warps.setter
    def warps(self, value):
        self._warps = value

    @property
    def audio_metadata(self):
        """Audio metadata corresponding to utterances"""
        return self._audio_metadata

    def _report_corpus(self):
        speakers = (
            '' if not self._utterances.has_speakers()
            else ' from {} speakers'.format(
                len(set(utt.speaker for utt in self._utterances))))
        self.log.info(
            'processing %s utterances%s from %s audio files '
            '(total duration %s)',
            len(self._utterances), speakers, len(self._audio_metadata),
            datetime.timedelta(seconds=self._utterances.duration()))

        if any(meta.nchannels != 1
               for meta in self._audio_metadata.values()):
            raise ValueError('all audio files are not mono')

        samplerates = set(
            meta.sample_rate for meta in self._audio_metadata.values())
        if len(samplerates) > 1:
            self.log.warning(
                'audio files mix several sample rates (%s); extraction '
                'will proceed but heterogeneous corpora are usually a '
                'mistake',
                ', '.join(str(s) + 'Hz' for s in samplerates))

    # ------------------------------------------------- class inspection

    @classmethod
    def get_processor_class(cls, name):
        """Import and return the port's processor class ``name``."""
        try:
            module_kind, class_name = cls.valid_processors[name]
        except KeyError:
            raise ValueError(f'invalid processor "{name}"') from None
        module_name = cls._processor_modules.get(name, name)
        module = importlib.import_module(
            f'shennong_tpu_torch.{module_kind}.{module_name}')
        return getattr(module, class_name)

    @classmethod
    def get_processor_params(cls, name):
        """Default parameters of processor ``name`` as a dict."""
        return cls.get_processor_class(name)().get_params()

    @classmethod
    def get_docstring(cls, processor, param, default):
        """The docstring of a processor's parameter, cleaned up for
        inclusion as a YAML comment."""
        text = getattr(
            cls.get_processor_class(processor), param).__doc__ or ''

        # flatten paragraphs into sentences, strip markup, append the
        # default value, normalize whitespace and dots
        for pattern, replacement in (
                (r'\n\n', '. '), (r'\n', ' '), (r'`', ''),
                (':func:', '')):
            text = re.sub(pattern, replacement, text)
        text += '. Default is {}.'.format(default)
        for pattern, replacement in (
                (r'\.+', '.'), (r' +', ' '), (r'\. \.', '.')):
            text = re.sub(pattern, replacement, text)
        return text.strip()

    # ------------------------------------------------ the stage factory

    def _stage_spec(self, kind):
        """(processor name, config section, wiring flags) of a stage.

        Wiring flags: 'rate' copies the utterance's sample rate in,
        'framing' copies the pipeline's shared frame geometry.
        """
        pitch_kind = (
            self.config['pitch']['processor']
            if 'pitch' in self.config else None)
        specs = {
            'features': (
                self.features, dict(self.config[self.features]),
                # bottleneck pins its own 8 kHz rate
                {'rate'} if self.features != 'bottleneck' else set()),
            'energy': ('energy', {}, {'rate', 'framing'}),
            'vad': (
                'vad', dict(self.config.get('cmvn', {}).get('vad', {})),
                set()),
            'delta': ('delta', dict(self.config.get('delta', {})), set()),
            'vtln': ('vtln', dict(self.config.get('vtln', {})), set()),
            'pitch': (
                f'{pitch_kind}_pitch',
                {k: v for k, v in self.config.get('pitch', {}).items()
                 if k not in ('processor', 'postprocessing')},
                # crepe pins its own 16 kHz rate
                {'framing'} | ({'rate'} if pitch_kind == 'kaldi'
                               else set())),
            'pitch_post': (
                f'{pitch_kind}_pitch_post',
                dict(self.config.get('pitch', {}).get(
                    'postprocessing', {})),
                set()),
        }
        return specs[kind]

    def make(self, kind, utterance=None):
        """Build the configured processor of one pipeline stage.

        ``kind`` is one of features/energy/vad/delta/vtln/pitch/
        pitch_post;
        ``utterance`` supplies the sample rate for the stages that need
        one.
        """
        name, params, wiring = self._stage_spec(kind)
        if 'framing' in wiring:
            params['frame_length'] = self.frame_length
            params['frame_shift'] = self.frame_shift
        if 'rate' in wiring and utterance is not None:
            params['sample_rate'] = (
                self._audio_metadata[utterance.audio_file].sample_rate)

        proc = self.get_processor_class(name)(**params)
        proc.log.setLevel(self.log.getEffectiveLevel())
        return proc

    def get_features_processor(self, utterance):
        """The configured main features extractor for ``utterance``"""
        return self.make('features', utterance)

    def get_energy_processor(self, utterance):
        """The energy processor sharing the pipeline's framing"""
        return self.make('energy', utterance)

    def get_vad_processor(self, _utterance=None):
        """The VAD post-processor weighting the CMVN statistics"""
        return self.make('vad')

    def get_cmvn_processor(self, utterance):
        """A CMVN post-processor over the utterance's group stats"""
        cmvn = self.get_processor_class('cmvn')(
            self._ndims, stats=self.cmvn_stats[self.cmvn_key(utterance)])
        cmvn.log.setLevel(self.log.getEffectiveLevel())
        return cmvn

    def get_pitch_processor(self, utterance):
        """The configured pitch extractor for ``utterance``"""
        return self.make('pitch', utterance)

    def get_pitch_post_processor(self, _utterance=None):
        """The configured pitch post-processor"""
        return self.make('pitch_post')

    def get_delta_processor(self, _utterance=None):
        """The configured delta post-processor"""
        return self.make('delta')

    def get_vtln_processor(self, _utterance=None):
        """The configured VTLN processor"""
        return self.make('vtln')

    def get_audio(self, utterance):
        """Load (and for bottleneck, resample) an utterance's audio."""
        audio = utterance.load_audio()
        if self.features != 'bottleneck':
            return audio

        # the bottleneck nets run at 8 kHz: convert here so every
        # downstream processor agrees on the rate
        self.log.debug(
            'resampling audio from %dHz@%db to %dHz@%db',
            audio.sample_rate, audio.dtype.itemsize * 8, 8000, 16)
        audio = audio.resample(8000).astype(np.int16)
        self._audio_metadata[utterance.audio_file] = Audio._metadata(
            audio.nchannels, audio.sample_rate,
            audio.nsamples, audio.duration)
        return audio

    def get_warp(self, utterance):
        """The VTLN warp of this utterance (1.0 when unset)"""
        return self.warps.get(utterance.name, 1.0)

    # --------------------------------------------- CMVN stats-as-arrays

    def cmvn_key(self, utterance):
        """The CMVN statistics group of an utterance"""
        if self.config['cmvn'].get('by_speaker', False):
            return utterance.speaker
        return utterance.name

    def accumulate_cmvn(self, utterance, features, weights=None):
        """Add one utterance's statistics to its group accumulator (the
        reduction is associative: utterances accumulate in any
        order)."""
        self.cmvn_stats[self.cmvn_key(utterance)] += \
            accumulate_cmvn_stats(features.data, weights=weights)

    def apply_cmvn(self, utterance, features):
        """Normalize one utterance's features with its group stats."""
        return self.get_cmvn_processor(utterance).process(features)
