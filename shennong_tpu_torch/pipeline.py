"""High-level features extraction pipeline (YAML config driven).

Counterpart of :mod:`shennong_tpu.pipeline` for the configurations
ported so far: spectrogram, filterbank, MFCC or PLP (with or without
RASTA) features with optional Kaldi pitch, CMVN (with the energy VAD)
and deltas, on utterances of any length, with optional precomputed
VTLN warps, over corpora of one or several sample rates. Bottleneck
features, CREPE pitch and a ``vtln`` section raise NotImplementedError.

:func:`extract_features` runs in two passes and picks pass 1 up front,
from the sample rates and the frame counts, as the reference does:

- **fused** (one sample rate, no hour-scale utterance): one program per
  padded utterance batch on the device
  (:class:`shennong_tpu_torch.parallel.executor.FusedPipelineExecutor`):
  the features, the energy VAD and the post-processed pitch. Pass 2
  runs on the host as soon as a CMVN group (a speaker, or one
  utterance) has landed, and a pass-2 failure stops pass 1 at once;
- **stage-wise** (one sample rate, an utterance past a processor's
  ``AUTO_CHUNK_FRAMES``): one sweep of the corpus per stage through
  :class:`shennong_tpu_torch.parallel.executor.BatchExecutor`, which
  sends the hour-scale utterances through chunked extraction; a
  :class:`shennong_tpu_torch.parallel.stream.SignalCache` replays the
  uploaded batches between sweeps;
- **per utterance** (several sample rates): each utterance through its
  own processors, built at its sample rate.

Pass 2 (CMVN statistics and their application, deltas, the pitch
concatenation) is the same on every path.
"""

import os
import textwrap

import numpy as np
import torch

from shennong_tpu.features import Features
from shennong_tpu.features_collection import FeaturesCollection
from shennong_tpu.logger import get_logger
from shennong_tpu_torch.ops.postops import (
    accumulate_cmvn_stats, compute_deltas_host)
from shennong_tpu_torch.parallel.executor import (
    BatchExecutor, FusedPipelineExecutor)
from shennong_tpu_torch.parallel.stream import SignalCache
from shennong_tpu_torch.pipeline_manager import PipelineManager
from shennong_tpu_torch.processor.base import fresh_generator


def valid_features():
    """The features extractable by the pipeline (no post-processing)"""
    return PipelineManager.valid_features


def get_default_config(
        features,
        to_yaml=False,
        yaml_commented=True,
        with_pitch=False,
        with_cmvn=False,
        with_delta=False,
        with_vtln=False):
    """Build a default pipeline configuration.

    Parameters
    ----------
    features : str
        One of :func:`valid_features`.
    to_yaml : bool, optional
        When True return a YAML string instead of a dict.
    yaml_commented : bool, optional
        When True (and ``to_yaml``) document every parameter with its
        docstring as a YAML comment.
    with_pitch : False, 'kaldi' or 'crepe', optional
        Include pitch extraction.
    with_cmvn : bool, optional
        Include CMVN normalization (by speaker, with VAD).
    with_delta : bool, optional
        Include delta features.
    with_vtln : False, 'simple' or 'full', optional
        Include VTLN warping ('simple' hides the inner features
        configuration). Incompatible with spectrogram and bottleneck.

    Returns
    -------
    config : dict or str
    """
    if features not in valid_features():
        raise ValueError('invalid features "{}", must be in {}'.format(
            features, ', '.join(valid_features())))

    if with_pitch not in (False, 'kaldi', 'crepe'):
        raise ValueError(
            f'with_pitch argument must be False, "kaldi" or "crepe" '
            f'but is "{with_pitch}"')

    if with_vtln not in (False, 'simple', 'full'):
        raise ValueError(
            f'with_vtln argument must be False, "simple" or "full" '
            f'but is "{with_vtln}"')

    if with_vtln and features in ('spectrogram', 'bottleneck'):
        raise ValueError(
            f'VTLN is not compatible with {features} features')

    config = {}

    # sample_rate is determined by the input audio, htk_compat is not
    # exposed through the pipeline
    config[features] = {
        k: v for k, v in
        PipelineManager.get_processor_params(features).items()
        if k not in ('sample_rate', 'htk_compat')}

    if with_pitch:
        config['pitch'] = {'processor': with_pitch}
        for key, value in PipelineManager.get_processor_params(
                f'{with_pitch}_pitch').items():
            if key not in ('frame_length', 'frame_shift', 'sample_rate'):
                config['pitch'][key] = value
        config['pitch']['postprocessing'] = (
            PipelineManager.get_processor_params(f'{with_pitch}_pitch_post'))

    if with_cmvn:
        config['cmvn'] = {'by_speaker': True, 'with_vad': True}
        config['cmvn']['vad'] = PipelineManager.get_processor_params('vad')

    if with_delta:
        config['delta'] = PipelineManager.get_processor_params('delta')

    if with_vtln:
        config['vtln'] = PipelineManager.get_processor_params('vtln')
        if with_vtln == 'simple':
            config['vtln']['features'] = 'default'
            config['vtln']['ubm']['features'] = 'default'

    if to_yaml:
        return _config_to_yaml(config, comments=yaml_commented)
    return config


def extract_features(configuration, utterances, warps=None, *, device,
                     generator=None, log=get_logger('pipeline', 'warning')):
    """Run a features extraction pipeline over ``utterances``.

    Parameters
    ----------
    configuration : dict or str
        Pipeline configuration (dict, YAML string or YAML file path),
        see :func:`get_default_config`.
    utterances : :class:`~shennong_tpu.utterances.Utterances`
        The utterances to process.
    warps : dict, optional
        Precomputed VTLN warps indexed by speaker or by utterance (not
        with spectrogram features, nor with a 'vtln' config section).
    device : str or torch.device
        Where pass 1 runs ('cuda', 'cuda:1', 'cpu', ...).
    generator : torch.Generator, optional
        Source of the dithers and the pitch noise, on ``device``: every
        stage, batch and chunk draws from it in turn. A fresh, randomly
        seeded one when None.
    log : logging.Logger, optional

    Returns
    -------
    features : :class:`~shennong_tpu.features_collection.FeaturesCollection`
    """
    config = init_config(configuration, log=log)
    log.info(
        'detected format for utterances index is: %s',
        utterances.format(type=str))
    if warps:
        warps = _init_warps(warps, config, utterances, log)
    if 'vtln' in config:
        raise NotImplementedError('VTLN is not yet ported')
    if generator is None:
        generator = fresh_generator(device)

    manager = PipelineManager(config, utterances, log=log)
    if warps:
        manager.warps = warps
    rates = set(
        meta.sample_rate for meta in manager.audio_metadata.values())
    utterances = list(utterances)

    if len(rates) != 1:
        log.debug('per-utterance pass 1 over %d sample rates', len(rates))
        triplets = [
            _extract_pass_one(utt, manager, device, generator, log)
            for utt in utterances]
    elif _fits_fused(manager, utterances):
        return _fused_extract(manager, utterances, device, generator, log)
    else:
        triplets = _stagewise_pass_one(
            manager, utterances, device, generator, log)
    results = _pass_two(manager, triplets, log)
    return FeaturesCollection(
        {utt.name: results[utt.name] for utt in utterances})


def _init_warps(warps, config, utterances, log):
    """The warps by utterance name, from warps by utterance or by
    speaker."""
    features = [k for k in config.keys() if k in valid_features()][0]
    if features in ('spectrogram', 'bottleneck'):
        raise ValueError(f'{features} features do not support VTLN')

    if 'vtln' in config:
        raise ValueError(
            'warps are given but "vtln" processor already defined '
            'in the configuration')

    if warps.keys() == utterances.by_name().keys():
        log.info('VTLN warps are defined by utterance')
    elif (utterances.has_speakers()
          and warps.keys() == utterances.by_speaker().keys()):
        log.info('VTLN warps are defined by speaker')
        warps = {utt.name: warps[utt.speaker] for utt in utterances}
    else:
        raise ValueError(
            'warps do not match utterances, either by speaker or by '
            'utterance')

    return {name: float(warp) for name, warp in warps.items()}


def _fits_fused(manager, utterances):
    """Whether no utterance is past the frame limit of a fused
    processor: the pitch tracker has its own frame grid and limit, so
    every fused processor is checked, not just the features one."""
    first = utterances[0]
    procs = [manager.make('features', first)]
    if 'pitch' in manager.config:
        procs.append(manager.make('pitch', first))
    for proc in procs:
        limit = proc.AUTO_CHUNK_FRAMES
        if limit and any(
                proc.output_frames(
                    int(utt.duration * float(proc.sample_rate))) > limit
                for utt in utterances):
            return False
    return True


def _with_audio_properties(manager, utterance, features):
    """Record the utterance's speaker and audio source in the
    properties of its features."""
    if utterance.speaker:
        features.properties['speaker'] = utterance.speaker
    features.properties['audio'] = {
        'file': os.path.abspath(utterance.audio_file),
        'sample_rate': manager.audio_metadata[
            utterance.audio_file].sample_rate}
    if utterance.tstart is not None:
        features.properties['audio']['tstart'] = utterance.tstart
        features.properties['audio']['tstop'] = utterance.tstop
    features.properties['audio']['duration'] = utterance.duration


def _fused_extract(manager, utterances, device, generator, log):
    """The fused pass 1, with each CMVN group's pass 2 as soon as the
    group has landed."""
    config = manager.config
    first = utterances[0]
    with_vad = 'cmvn' in config and config['cmvn']['with_vad']
    with_pitch = 'pitch' in config
    executor = FusedPipelineExecutor(
        manager.make('features', first),
        warps=dict(manager.warps) if manager.warps else None,
        energy_proc=manager.make('energy', first) if with_vad else None,
        vad_proc=manager.make('vad') if with_vad else None,
        pitch_proc=manager.make('pitch', first) if with_pitch else None,
        pitch_post=manager.make('pitch_post') if with_pitch else None,
        device=device, generator=generator)

    with_cmvn = 'cmvn' in config
    by_name = {utt.name: utt for utt in utterances}
    # CMVN group -> member names in utterance order (the accumulation
    # order); without CMVN every utterance is its own group
    groups = {}
    for utt in utterances:
        key = manager.cmvn_key(utt) if with_cmvn else utt.name
        groups.setdefault(key, []).append(utt.name)
    group_of = {
        name: key for key, names in groups.items() for name in names}
    pending = {key: len(names) for key, names in groups.items()}
    landed, stats, results = {}, {}, {}

    def on_utterance(name, features, vad, pitch):
        utterance = by_name[name]
        if with_cmvn:
            stats[name] = accumulate_cmvn_stats(features.data, weights=vad)
        _with_audio_properties(manager, utterance, features)
        landed[name] = (utterance, features, pitch)

        key = group_of[name]
        pending[key] -= 1
        if pending[key] == 0:
            # the group is complete: its pass 2 runs now, and a failure
            # propagates through the executor and stops pass 1
            if with_cmvn:
                for member in groups[key]:
                    manager.cmvn_stats[key] += stats.pop(member)
            results.update(_pass_two(
                manager, [landed.pop(member) for member in groups[key]],
                log))

    log.debug('fused pass 1 with pass 2 per group over %d groups',
              len(groups))
    executor.run(utterances, on_utterance=on_utterance)
    return FeaturesCollection(
        {utt.name: results[utt.name] for utt in utterances})


def _stagewise_pass_one(manager, utterances, device, generator, log):
    """Pass 1 as one :class:`BatchExecutor` sweep per stage, the
    hour-scale utterances in chunks. Returns the (utterance, features,
    pitch-or-None) triplets, the CMVN statistics accumulated."""
    config = manager.config
    first = utterances[0]
    with_vad = 'cmvn' in config and config['cmvn']['with_vad']
    with_pitch = 'pitch' in config
    # the sweeps stream the same audio: the first uploads it, the
    # others replay it
    cache = SignalCache(device=device) if with_vad or with_pitch else None

    log.debug('stage-wise pass 1: %s', manager.features)
    feats = BatchExecutor(
        manager.make('features', first), device=device,
        generator=generator).process_all(
            utterances,
            vtln_warp=dict(manager.warps) if manager.warps else None,
            signal_cache=cache)

    vads = None
    if with_vad:
        log.debug('stage-wise pass 1: energy + vad')
        energies = BatchExecutor(
            manager.make('energy', first), device=device,
            generator=generator).process_all(
                utterances, signal_cache=cache)
        vads = {
            name: vad.data.reshape(-1) for name, vad in
            manager.make('vad').process_all(
                energies, device=device).items()}

    pitches = None
    if with_pitch:
        log.debug('stage-wise pass 1: pitch')
        raw = BatchExecutor(
            manager.make('pitch', first), device=device).process_all(
                utterances, signal_cache=cache)
        pitches = manager.make('pitch_post').process_collection(
            raw, device=device, generator=generator)

    triplets = []
    for utterance in utterances:
        features = feats[utterance.name]
        if 'cmvn' in config:
            manager.accumulate_cmvn(
                utterance, features,
                weights=vads[utterance.name] if vads else None)
        _with_audio_properties(manager, utterance, features)
        triplets.append((
            utterance, features,
            pitches[utterance.name] if pitches else None))
    return triplets


def _extract_pass_one(utterance, manager, device, generator, log):
    """Pass 1 of one utterance through processors built at its sample
    rate; its CMVN statistics are accumulated."""
    log.debug('%s: load audio', utterance.audio_file)
    audio = manager.get_audio(utterance)
    random = {'device': device, 'generator': generator}

    log.debug('%s: extract %s', utterance.name, manager.features)
    proc = manager.make('features', utterance)
    if manager.warps:
        features = proc.process(
            audio, vtln_warp=manager.get_warp(utterance), **random)
    else:
        features = proc.process(audio, **random)

    if 'cmvn' in manager.config:
        log.debug('%s: accumulate cmvn', utterance.name)
        vad = None
        if manager.config['cmvn']['with_vad']:
            energy = manager.make('energy', utterance).process(
                audio, **random)
            vad = manager.make('vad').process(energy, device=device)
            vad = vad.data.reshape((vad.shape[0],))
        manager.accumulate_cmvn(utterance, features, weights=vad)

    pitch = None
    if 'pitch' in manager.config:
        log.debug('%s: extract kaldi pitch', utterance.name)
        pitch = manager.make('pitch', utterance).process(
            audio, device=device)
        pitch = manager.make('pitch_post').process(pitch, **random)

    _with_audio_properties(manager, utterance, features)
    return utterance, features, pitch


def _pass_two(manager, triplets, log, tolerance=2):
    """CMVN apply, deltas and pitch concatenation of one group.

    ``triplets`` are (utterance, features, pitch-or-None); returns a
    dict name -> final Features. Runs under the profiler annotation
    ``pass2``.
    """
    config = manager.config
    delta = manager.make('delta') if 'delta' in config else None
    finished = {}
    with torch.profiler.record_function('pass2'):
        for utterance, features, pitch in triplets:
            if 'cmvn' in config:
                log.debug('%s: apply cmvn', utterance.name)
                features = manager.apply_cmvn(utterance, features)
            if delta is not None:
                log.debug('%s: apply delta', utterance.name)
                out, = compute_deltas_host(
                    [features.data], order=delta.order, window=delta.window)
                # validate=False: the times are untouched and the delta
                # filter of finite input is finite
                features = Features(
                    out.astype(features.dtype, copy=False), features.times,
                    delta.get_properties(features), validate=False)
            if pitch is not None:
                log.debug('%s: concatenate pitch', utterance.name)
                features = features.concatenate(
                    pitch, tolerance=tolerance, log=log, validate=False)
            finished[utterance.name] = features
    return finished


def init_config(config, log=get_logger('pipeline', 'warning')):
    """Validate and normalize a pipeline configuration.

    Accepts a dict, a YAML string or a YAML file path; fills the
    defaulted cmvn/pitch sub-sections and checks overall consistency.
    """
    try:
        if os.path.isfile(config):
            log.debug('loading configuration from %s', config)
            with open(config, 'r') as fp:
                config = fp.read()
    except TypeError:
        pass

    if isinstance(config, str):
        import yaml
        try:
            config = yaml.load(config, Loader=yaml.FullLoader)
        except yaml.YAMLError as err:
            raise ValueError(f'error in configuration: {err}') from None

    unknown_keys = [
        k for k in config.keys()
        if k not in list(PipelineManager.valid_processors) + ['pitch']]
    if unknown_keys:
        raise ValueError(
            'invalid keys in configuration: {}'.format(
                ', '.join(unknown_keys)))

    features = [k for k in config.keys() if k in valid_features()]
    if not features:
        raise ValueError(
            'the configuration does not define any features extraction '
            '(must have one and only one entry of {})'
            .format(', '.join(valid_features())))
    if len(features) > 1:
        raise ValueError(
            'more than one features extraction processors are defined, '
            '(must have one and only one entry of {}): {}'
            .format(', '.join(valid_features()), ', '.join(features)))

    if 'vtln' in config and features[0] in ('spectrogram', 'bottleneck'):
        raise ValueError(f'{features[0]} features do not support VTLN')

    if 'cmvn' in config:
        if 'by_speaker' not in config['cmvn']:
            log.warning(
                'by_speaker option not specified for cmvn, '
                'assuming it is false and doing cmvn by utterance')
            config['cmvn']['by_speaker'] = False
        if 'with_vad' not in config['cmvn']:
            config['cmvn']['with_vad'] = True

    if 'pitch' in config:
        if 'processor' not in config['pitch']:
            # the reference dies with a bare KeyError here; an
            # explicit message beats that (the key is genuinely
            # ambiguous: kaldi or crepe)
            raise ValueError(
                "the pitch configuration must declare its processor "
                "('kaldi' or 'crepe')")
        if 'postprocessing' not in config['pitch']:
            config['pitch']['postprocessing'] = {}

    if 'vtln' in config and 'by_speaker' not in config['vtln']:
        # default to the VtlnProcessor default (the reference dies
        # with a bare KeyError on this valid minimal section)
        log.warning(
            'by_speaker option not specified for vtln, '
            'assuming it is true and computing warps by speaker')
        config['vtln']['by_speaker'] = True

    steps = []
    if 'pitch' in config:
        steps.append(f'{config["pitch"]["processor"]} pitch')
    if 'delta' in config:
        steps.append('delta')
    if 'cmvn' in config:
        steps.append('cmvn by {}{}'.format(
            'speaker' if config['cmvn']['by_speaker'] else 'utterance',
            ' with vad' if config['cmvn']['with_vad'] else ''))
    if 'vtln' in config:
        steps.append('vtln by {}'.format(
            'speaker' if config['vtln']['by_speaker'] else 'utterance'))
    log.info(
        'pipeline configured for %s features extraction%s',
        features[0], ' with {}'.format(', '.join(steps)) if steps else '')

    return config


def _config_to_yaml(config, comments=True):
    """Serialize a configuration dict to YAML, with the parameters
    docstrings as comments when requested."""
    import yaml

    # keep the dict insertion order in the YAML output
    yaml.add_representer(
        dict, lambda self, data:
        yaml.representer.SafeRepresenter.represent_dict(self, data.items()))
    # numpy scalars must be converted to Python types before dumping
    # (their numpy-2 repr is not YAML-parsable)
    for np_type in (np.float32, np.float64):
        yaml.add_representer(
            np_type, lambda dumper, d: dumper.represent_float(float(d)))
    for np_type in (np.int32, np.int64):
        yaml.add_representer(
            np_type, lambda dumper, d: dumper.represent_int(int(d)))
    yaml.add_representer(
        np.bool_, lambda dumper, d: dumper.represent_bool(bool(d)))

    try:
        pitch_processor = config['pitch']['processor']
    except KeyError:
        pitch_processor = None

    config = yaml.dump(config).strip()
    if not comments:
        return config + '\n'

    commented = []
    processors = []
    prev_offset = 0
    for line in config.split('\n'):
        key = line.split(': ')[0]
        offset = len(key) - len(key.strip())
        for _ in range((prev_offset - offset) // 2):
            processors.pop()
        if line.endswith(':'):
            processor = line[:-1].strip()
            if processor == 'postprocessing':
                processor = f'{processors[-1]}_post'
            processors.append(processor)
            if processor == 'vad' and offset != 4:
                commented.append(
                    "  # The vad options are not used if 'with_vad' "
                    "is false")
            commented.append(line)
        else:
            param = line.split(': ')[0].strip()
            default = line.split(': ')[1].strip()
            processor = processors[-1]

            if processor == 'cmvn' and param == 'by_speaker':
                docstring = (
                    'If false, do normalization by utterance, '
                    'if true do normalization by speaker.')
            elif processor == 'cmvn' and param == 'with_vad':
                docstring = (
                    'If true do normalization only on frames where '
                    'voice activity has been detected, if false do not '
                    'consider voice activity for normalization.')
            elif param == 'features' and default == 'default':
                docstring = (
                    'Features extraction configuration. Default is to use '
                    'MFCCs with default parameters. Regenerate this '
                    'configuration file with "speech-features config" using '
                    'the "--vtln-full" option to expose all the parameters.')
            elif processor == 'pitch' and param == 'processor':
                docstring = f'Computing pitch using {pitch_processor}'
            elif 'pitch' in processor and param != 'processor':
                docstring = PipelineManager.get_docstring(
                    pitch_processor + '_' + processor, param, default)
            else:
                docstring = PipelineManager.get_docstring(
                    processor, param, default)

            commented += [
                ' ' * offset + '# ' + wrapped
                for wrapped in textwrap.wrap(docstring, width=68 - offset)]
            commented.append(line)
        prev_offset = offset

    return '\n'.join(commented) + '\n'
