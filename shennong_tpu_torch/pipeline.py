"""High-level features extraction pipeline (YAML config driven).

Counterpart of :mod:`shennong_tpu.pipeline`: spectrogram, filterbank,
MFCC, PLP (with or without RASTA) or bottleneck features with optional
Kaldi or CREPE pitch, CMVN (with the energy VAD) and deltas, on
utterances of any length, with optional precomputed VTLN warps or a
``vtln`` section that trains them (a UBM-GMM and LVTLN transforms,
:class:`shennong_tpu_torch.processor.vtln.VtlnProcessor`), over corpora
of one or several sample rates.

With a ``vtln`` section, one
:class:`~shennong_tpu_torch.parallel.stream.SignalCache` spans the VTLN
training (the UBM front-end, the warp-class moments) and the warped
extraction of pass 1, so the corpus uploads once.

:func:`extract_features` runs in two passes and picks pass 1 up front,
from the sample rates and the frame counts, as the reference does:

- **fused** (one sample rate, no hour-scale utterance): one program per
  padded utterance batch on the device
  (:class:`shennong_tpu_torch.parallel.executor.FusedPipelineExecutor`):
  the features, the energy VAD and the post-processed pitch. Pass 2
  of a CMVN group (a speaker, or one utterance) runs on the host
  thread ``pass-two`` as soon as the group has landed, while later
  batches are in flight, and a pass-2 failure stops pass 1 at the next
  drained utterance;
- **stage-wise** (one sample rate, an utterance past a processor's
  ``AUTO_CHUNK_FRAMES``, or CREPE pitch): one sweep of the corpus per
  stage through
  :class:`shennong_tpu_torch.parallel.executor.BatchExecutor`, which
  sends the hour-scale utterances through chunked extraction; a
  :class:`shennong_tpu_torch.parallel.stream.SignalCache` replays the
  uploaded batches between sweeps. CREPE pitch runs its own batched
  ``process_all`` over the corpus;
- **per utterance** (several sample rates, or bottleneck features):
  each utterance through its own processors, built at its sample
  rate.

Pass 2 (CMVN statistics and their application, deltas, the pitch
concatenation) is the same on every path. :func:`warmup` pays a cold
process's start-up costs before the first real extraction. The
counters and spans of a call (its planning, pass 2's steps and the
wait for them, ...) are listed in
:mod:`shennong_tpu_torch.parallel.profiler`.
"""

import contextlib
import os
import queue
import textwrap
import threading

import numpy as np
import torch

from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.logger import get_logger, null_logger
from shennong_tpu_torch.ops.postops import (
    accumulate_cmvn_stats, compute_deltas_host)
from shennong_tpu_torch.parallel.executor import (
    BatchExecutor, FusedPipelineExecutor, check_fetch_dtype)
from shennong_tpu_torch.parallel.profiler import counters, span
from shennong_tpu_torch.parallel.stream import SignalCache
from shennong_tpu_torch.pipeline_manager import PipelineManager
from shennong_tpu_torch.processor.base import fresh_generator
from shennong_tpu_torch.utils import get_njobs


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


def extract_features(configuration, utterances, warps=None, njobs=1,
                     fetch_dtype=None, *, device, generator=None,
                     log=get_logger('pipeline', 'warning')):
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
    njobs : int, optional
        Host decode concurrency: the threads that load the audio the
        native PCM16 loader does not read (validated by
        :func:`shennong_tpu_torch.utils.get_njobs`; default 1).
    fetch_dtype : str, optional
        Precision of the device-to-host copy of the fused pass 1's
        features and pitch: 'float32' (None, the default, bit-exact),
        'float16' or 'bfloat16' (half those bytes; the values come back
        as float32 but keep the reduced precision, about 1e-3 relative
        for 'float16', and pass 2 runs on them). Any other name raises
        ValueError. The stage-wise and per-utterance paths ignore it.
    device : str or torch.device
        Where pass 1, and the VTLN training of a 'vtln' section, run
        ('cuda', 'cuda:1', 'cpu', ...).
    generator : torch.Generator, optional
        Source of the dithers and the pitch noise, on ``device``: every
        stage, batch and chunk draws from it in turn. A fresh, randomly
        seeded one when None. The VTLN training's own random draws (the
        UBM's initial frames and splits) come from its ``seed``.
    log : logging.Logger, optional

    Returns
    -------
    features : :class:`~shennong_tpu.features_collection.FeaturesCollection`
    """
    counters.add('calls')
    with span('extract_features', 'call_s'):
        with span('pipeline.plan', 'plan_s'):
            njobs = get_njobs(njobs, log=log)
            fetch_dtype = check_fetch_dtype(fetch_dtype)
            config = init_config(configuration, log=log)
            log.info(
                'detected format for utterances index is: %s',
                utterances.format(type=str))
            if warps:
                warps = _init_warps(warps, config, utterances, log)
            if generator is None:
                generator = fresh_generator(device)
            manager = PipelineManager(config, utterances, log=log)

        cache = None
        if warps:
            manager.warps = warps
        elif 'vtln' in config:
            cache = SignalCache(device=device)
            manager.warps = _train_warps(
                manager, utterances, device, generator, cache, njobs)
        utterances = list(utterances)
        results = {}
        with _pass_two_worker(manager, log, results) as pass_two:
            _pass_one(manager, utterances, device, generator, log, cache,
                      pass_two, njobs, fetch_dtype)
        return FeaturesCollection(
            {utt.name: results[utt.name] for utt in utterances})


@contextlib.contextmanager
def _pass_two_worker(manager, log, results):
    """A thread named ``pass-two`` that runs :func:`_pass_two` on the
    groups handed to the yielded ``submit(triplets)``, under
    ``counters['pass2_s']``, into the dict ``results``, while the
    caller goes on with pass 1.

    ``submit`` raises a failure of the worker, so pass 1 stops at its
    next call (the fused path calls it for every drained utterance);
    the worker is joined on every exit, and its failure raised. The
    join adds to ``counters['pass2_join_s']``, and the utterances not
    yet finished when it starts to ``counters['pass2_backlog_utts']``.
    """
    work = queue.SimpleQueue()
    failure = []
    # utterances handed to the worker (written by the caller) and
    # finished by it (written by the worker)
    submitted, finished = [0], [0]

    def worker():
        while True:
            triplets = work.get()
            if triplets is None:
                return
            try:
                with counters.timed('pass2_s'):
                    results.update(_pass_two(manager, triplets, log))
            except BaseException as error:  # raised on the caller's thread
                failure.append(error)
                return
            finished[0] += len(triplets)
            counters.add('pass2_utts', len(triplets))

    def submit(triplets):
        if failure:
            raise failure[0]
        if triplets:
            submitted[0] += len(triplets)
            work.put(triplets)

    thread = threading.Thread(target=worker, name='pass-two', daemon=True)
    thread.start()
    try:
        yield submit
    finally:
        work.put(None)
        counters.add('pass2_backlog_utts', submitted[0] - finished[0])
        with span('pass2.join', 'pass2_join_s'):
            thread.join()
    if failure:
        raise failure[0]


def _pass_one(manager, utterances, device, generator, log, cache, on_group,
              njobs, fetch_dtype='float32'):
    """Pass 1 over ``utterances`` by the path chosen up front, their
    CMVN statistics accumulated in ``manager.cmvn_stats``.

    ``on_group(triplets)`` takes the (utterance, features, pitch-or-None)
    triplets of complete CMVN groups. On the fused path it is called
    after every drained utterance, with the triplets of the group that
    utterance completed, its statistics accumulated, or with an empty
    list: pass 2 can overlap pass 1, and a failure raised by
    ``on_group`` stops pass 1 at once. On the other paths it is called
    once with every utterance. ``cache`` replays the signals VTLN
    training uploaded, or is None; ``njobs`` bounds the audio decode;
    ``fetch_dtype`` is the fused path's fetch precision.
    """
    with span('pipeline.plan', 'plan_s'):
        rates = set(
            meta.sample_rate for meta in manager.audio_metadata.values())
        per_utterance = len(rates) != 1 or manager.features == 'bottleneck'
        fused = not per_utterance and _fits_fused(manager, utterances)
    if per_utterance:
        log.debug('per-utterance pass 1 of %s over %d sample rates',
                  manager.features, len(rates))
        on_group([
            _extract_pass_one(utt, manager, device, generator, log)
            for utt in utterances])
    elif fused:
        _fused_pass_one(
            manager, utterances, device, generator, log, cache, on_group,
            njobs, fetch_dtype)
    else:
        on_group(_stagewise_pass_one(
            manager, utterances, device, generator, log, cache, njobs))


def _train_warps(manager, utterances, device, generator, cache, njobs):
    """The warps of the config's ``vtln`` section, by utterance,
    trained on ``device`` over the signal cache ``cache``."""
    vtln = manager.make('vtln')
    vtln._signal_cache = cache
    try:
        return vtln.process(utterances, njobs=njobs, device=device,
                            generator=generator)
    finally:
        vtln.__dict__.pop('_signal_cache', None)


def _warp_classes_manager(configuration, utterances, log):
    """(manager, sample rates, utterances list) of a VTLN-training
    features configuration."""
    config = init_config(configuration, log=log)
    manager = PipelineManager(config, utterances, log=log)
    rates = set(
        meta.sample_rate for meta in manager.audio_metadata.values())
    return manager, rates, list(utterances)


def _with_deltas(manager, collection):
    """``collection`` with its deltas appended when the configuration
    has a delta section (computed on the host)."""
    if 'delta' not in manager.config:
        return collection
    delta = manager.make('delta')
    names = list(collection.keys())
    outputs = compute_deltas_host(
        [collection[name].data for name in names],
        order=delta.order, window=delta.window)
    return FeaturesCollection({
        name: Features(
            out.astype(collection[name].dtype), collection[name].times,
            delta.get_properties(collection[name]))
        for name, out in zip(names, outputs)})


def extract_features_warp(configuration, utterances, warp, log, njobs=1, *,
                          device, generator=None):
    """Features (and their deltas) of every utterance at one global
    VTLN warp, with no CMVN: the per-warp feature sets of VTLN
    training. One sample rate runs through
    :class:`~shennong_tpu_torch.parallel.executor.BatchExecutor`, several
    utterance by utterance. ``njobs`` bounds the audio decode."""
    njobs = get_njobs(njobs, log=log)
    manager, rates, utterances = _warp_classes_manager(
        configuration, utterances, log)
    if len(rates) == 1:
        proc = manager.make('features', utterances[0])
        features = BatchExecutor(
            proc, device=device, generator=generator).process_all(
                utterances,
                vtln_warp={utt.name: float(warp) for utt in utterances},
                njobs=njobs)
        return _with_deltas(manager, features)

    features = FeaturesCollection()
    for utterance in utterances:
        name, feats = _process_one(
            utterance, manager, log, warp, device=device,
            generator=generator)
        features[name] = feats
    return features


def extract_features_warp_classes(configuration, utterances, class_warps,
                                  log, njobs=1, *, device, generator=None):
    """MFCC features (and their deltas) of every utterance at every
    VTLN warp class, one FeaturesCollection per class.

    A single-rate MFCC configuration frames and transforms each batch
    once and fans only the mel bank out over the classes
    (:meth:`BatchExecutor.process_all_classes`); other configurations
    take :func:`extract_features_warp` once per class. ``njobs`` bounds
    the audio decode.
    """
    njobs = get_njobs(njobs, log=log)
    manager, rates, utterances = _warp_classes_manager(
        configuration, utterances, log)
    if manager.features == 'mfcc' and len(rates) == 1:
        proc = manager.make('features', utterances[0])
        collections = BatchExecutor(
            proc, device=device, generator=generator).process_all_classes(
                utterances, [float(w) for w in class_warps], njobs=njobs)
        return [_with_deltas(manager, c) for c in collections]
    return [
        extract_features_warp(
            configuration, utterances, warp, log, njobs=njobs,
            device=device, generator=generator)
        for warp in class_warps]


def accumulate_warp_mapping_stats(configuration, utterances, class_warps,
                                  keep, log, njobs=1, *, device,
                                  generator=None, signal_cache=None):
    """The least-squares moments of the LVTLN base-transform training,
    reduced on ``device`` (:meth:`BatchExecutor.accumulate_lvtln_stats`):
    the warped features of the classes never reach the host. ``keep``
    maps utterance names to per-frame selection weights (VAD and
    subsampling); ``njobs`` bounds the audio decode.

    Returns the per-batch moments for
    :func:`shennong_tpu_torch.ops.fmllr.solve_mapping_from_moments`, or
    None when the configuration is not single-rate MFCC with no
    utterance past ``AUTO_CHUNK_FRAMES`` (the caller then materializes
    the warped collections).
    """
    njobs = get_njobs(njobs, log=log)
    manager, rates, utterances = _warp_classes_manager(
        configuration, utterances, log)
    if manager.features != 'mfcc' or len(rates) != 1:
        return None
    proc = manager.make('features', utterances[0])
    limit = proc.AUTO_CHUNK_FRAMES
    if limit and any(
            proc.output_frames(int(utt.duration * float(proc.sample_rate)))
            > limit for utt in utterances):
        return None

    delta_order = delta_window = None
    if 'delta' in manager.config:
        delta = manager.make('delta')
        delta_order, delta_window = delta.order, delta.window
    return BatchExecutor(
        proc, device=device, generator=generator).accumulate_lvtln_stats(
            utterances, [float(w) for w in class_warps], keep,
            delta_order=delta_order, delta_window=delta_window,
            njobs=njobs, signal_cache=signal_cache)


def _process_one(utterance, manager, log, warp, *, device, generator):
    """One utterance's features (and deltas) at an explicit warp, with
    no CMVN (VTLN training over several sample rates)."""
    log.debug('%s: extract %s', utterance.name, manager.features)
    features = manager.make('features', utterance).process(
        manager.get_audio(utterance), vtln_warp=warp, device=device,
        generator=generator)
    if 'delta' in manager.config:
        features = manager.make('delta').process(features, device=device)
    return utterance.name, features


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
    """Whether the fused pass 1 takes this configuration: Kaldi pitch
    if any, and no utterance past the frame limit of a fused processor
    (the pitch tracker has its own frame grid and limit, so every fused
    processor is checked, not just the features one)."""
    if manager.config.get('pitch', {}).get('processor', 'kaldi') != 'kaldi':
        return False
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


def _fused_pass_one(manager, utterances, device, generator, log, cache,
                    on_group, njobs, fetch_dtype='float32'):
    """The fused pass 1, handing each CMVN group's triplets to
    ``on_group`` as soon as the group has landed (see
    :func:`_pass_one`)."""
    config = manager.config
    first = utterances[0]
    with_vad = 'cmvn' in config and config['cmvn']['with_vad']
    with_pitch = 'pitch' in config
    with_cmvn = 'cmvn' in config
    with span('pipeline.plan', 'plan_s'):
        executor = FusedPipelineExecutor(
            manager.make('features', first),
            warps=dict(manager.warps) if manager.warps else None,
            energy_proc=manager.make('energy', first) if with_vad else None,
            vad_proc=manager.make('vad') if with_vad else None,
            pitch_proc=manager.make('pitch', first) if with_pitch else None,
            pitch_post=manager.make('pitch_post') if with_pitch else None,
            device=device, generator=generator, signal_cache=cache,
            fetch_dtype=fetch_dtype)

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
    landed, stats = {}, {}

    def on_utterance(name, features, vad, pitch):
        utterance = by_name[name]
        if with_cmvn:
            stats[name] = accumulate_cmvn_stats(features.data, weights=vad)
        _with_audio_properties(manager, utterance, features)
        landed[name] = (utterance, features, pitch)

        key = group_of[name]
        pending[key] -= 1
        complete = []
        if pending[key] == 0:
            # the statistics add up here, on this thread, in utterance
            # order: the same bits as one sweep
            if with_cmvn:
                for member in groups[key]:
                    manager.cmvn_stats[key] += stats.pop(member)
            complete = [landed.pop(member) for member in groups[key]]
        # after every utterance: a failure it raises propagates through
        # the executor and stops pass 1
        on_group(complete)

    log.debug('fused pass 1, handing on %d groups as they land',
              len(groups))
    executor.run(utterances, njobs=njobs, on_utterance=on_utterance)


def _stagewise_pass_one(manager, utterances, device, generator, log,
                        cache, njobs):
    """Pass 1 as one :class:`BatchExecutor` sweep per stage, the
    hour-scale utterances in chunks. Returns the (utterance, features,
    pitch-or-None) triplets, the CMVN statistics accumulated."""
    config = manager.config
    first = utterances[0]
    with_vad = 'cmvn' in config and config['cmvn']['with_vad']
    with_pitch = 'pitch' in config
    # the sweeps stream the same audio: the first uploads it, the
    # others replay it
    if cache is None and (with_vad or (
            with_pitch and config['pitch']['processor'] == 'kaldi')):
        cache = SignalCache(device=device)

    log.debug('stage-wise pass 1: %s', manager.features)
    feats = BatchExecutor(
        manager.make('features', first), device=device,
        generator=generator).process_all(
            utterances,
            vtln_warp=dict(manager.warps) if manager.warps else None,
            njobs=njobs, signal_cache=cache)

    vads = None
    if with_vad:
        log.debug('stage-wise pass 1: energy + vad')
        energies = BatchExecutor(
            manager.make('energy', first), device=device,
            generator=generator).process_all(
                utterances, njobs=njobs, signal_cache=cache)
        vads = {
            name: vad.data.reshape(-1) for name, vad in
            manager.make('vad').process_all(
                energies, device=device).items()}

    pitches = None
    if with_pitch and config['pitch']['processor'] == 'crepe':
        log.debug('stage-wise pass 1: crepe pitch')
        # CREPE batches by its own frame grid and loads its own audio;
        # its post-processing decides the voicing per utterance
        raw = manager.make('pitch', first).process_all(
            utterances, njobs=njobs, device=device)
        post = manager.make('pitch_post')
        with torch.profiler.record_function('crepe.post'):
            pitches = {
                name: post.process(
                    raw[name], device=device, generator=generator)
                for name in raw}
    elif with_pitch:
        log.debug('stage-wise pass 1: pitch')
        raw = BatchExecutor(
            manager.make('pitch', first), device=device).process_all(
                utterances, njobs=njobs, signal_cache=cache)
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
        log.debug('%s: extract %s pitch', utterance.name,
                  manager.config['pitch']['processor'])
        pitch = manager.make('pitch', utterance).process(
            audio, device=device)
        pitch = manager.make('pitch_post').process(pitch, **random)

    _with_audio_properties(manager, utterance, features)
    return utterance, features, pitch


def _pass_two(manager, triplets, log, tolerance=2):
    """CMVN apply, deltas and pitch concatenation of one group.

    ``triplets`` are (utterance, features, pitch-or-None); returns a
    dict name -> final Features. Runs under the profiler annotation
    ``pass2``, each step over the whole group under its own
    (``pass2.cmvn``, ``pass2.delta``, ``pass2.concat``).
    """
    config = manager.config
    delta = manager.make('delta') if 'delta' in config else None
    utterances = [utterance for utterance, _, _ in triplets]
    features = [feats for _, feats, _ in triplets]
    pitches = [pitch for _, _, pitch in triplets]
    with torch.profiler.record_function('pass2'):
        if 'cmvn' in config:
            with span('pass2.cmvn', 'pass2_cmvn_s'):
                for index, utterance in enumerate(utterances):
                    log.debug('%s: apply cmvn', utterance.name)
                    features[index] = manager.apply_cmvn(
                        utterance, features[index])
        if delta is not None:
            with span('pass2.delta', 'pass2_delta_s'):
                for index, utterance in enumerate(utterances):
                    log.debug('%s: apply delta', utterance.name)
                    data = features[index]
                    out, = compute_deltas_host(
                        [data.data], order=delta.order, window=delta.window)
                    # validate=False: the times are untouched and the
                    # delta filter of finite input is finite
                    features[index] = Features(
                        out.astype(data.dtype, copy=False), data.times,
                        delta.get_properties(data), validate=False)
        if any(pitch is not None for pitch in pitches):
            with span('pass2.concat', 'pass2_concat_s'):
                for index, utterance in enumerate(utterances):
                    if pitches[index] is None:
                        continue
                    log.debug('%s: concatenate pitch', utterance.name)
                    features[index] = features[index].concatenate(
                        pitches[index], tolerance=tolerance, log=log,
                        validate=False)
    return {utterance.name: feats
            for utterance, feats in zip(utterances, features)}


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


def warmup(configuration, utterances, *, device, njobs=1,
           log=get_logger('warmup', 'info')):
    """Pay a cold process's start-up costs before the first extraction.

    A new process pays, on its first batches, what no later batch pays
    again: on a card, the nvcc build of the kernels the configuration
    needs when ``_build/`` lacks them (a build failure raises), the
    CUDA context, cuFFT plans for each signal bucket, cuBLAS handles,
    the caching allocator's segments and the pinned host blocks. This
    entry point derives the batch geometries ``extract_features`` would
    run for ``utterances`` (rows x signal bucket, from the audio
    headers, no decode) and runs :func:`extract_features` once on
    ``device`` over a small synthetic corpus of those geometries.

    Call it at server start-up, before traffic arrives, so that the
    first real request runs at warm speed. A ``vtln`` section is warmed
    as the warped extraction path (unit warps): the training warms on
    first use. No compilation cache is involved.

    Returns a dict: the distinct ``geometries`` ([rows, samples]
    pairs), the ``programs`` count and the warm-up ``seconds``.
    """
    import shutil
    import tempfile
    import time

    import scipy.io.wavfile

    from shennong_tpu_torch.audio import Audio
    from shennong_tpu_torch.ops.framing import bucket_size
    from shennong_tpu_torch.parallel.stream import _scan_count, plan_batches
    from shennong_tpu_torch.utterances import Utterances

    config = init_config(configuration, log=null_logger())
    utterances = list(utterances if isinstance(utterances, Utterances)
                      else Utterances(utterances))
    sample_rate = Audio.scan(utterances[0].audio_file).sample_rate

    # the geometries extract_features would run (executor batch size
    # 64, length-sorted grouping, geometric signal buckets)
    geometries = sorted({
        (len(chunk), bucket_size(max(_scan_count(u) for u in chunk)))
        for chunk in plan_batches(utterances, 64)})
    log.info(
        'warming %d pipeline geometr%s for %d utterances',
        len(geometries), 'y' if len(geometries) == 1 else 'ies',
        len(utterances))

    # a synthetic corpus of those geometries: equal-length groups sort
    # adjacent, so the planner makes each (rows, bucket) batch again;
    # speech-like noise keeps every stage live (the VAD finds voiced
    # frames, the pitch locks)
    with_warps = 'vtln' in config
    if with_warps:
        config = {k: v for k, v in config.items() if k != 'vtln'}
    workdir = tempfile.mkdtemp(prefix='shennong_warmup_')
    start = time.perf_counter()
    try:
        entries = []
        rng = np.random.RandomState(0)
        for index, (rows, bucket) in enumerate(geometries):
            t = np.arange(bucket) / sample_rate
            signal = (
                np.sin(2 * np.pi * 120 * t)
                * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
                + rng.randn(bucket) * 0.05)
            wav = os.path.join(workdir, f'geom{index}.wav')
            scipy.io.wavfile.write(
                wav, int(sample_rate),
                (signal / np.abs(signal).max() * 12000).astype(np.int16))
            entries.extend(
                (f'warm{index}-{row}', wav, f'spk{row % 2}')
                for row in range(rows))
        synthetic = Utterances(entries)
        warps = ({utt.name: 1.0 for utt in synthetic} if with_warps
                 else None)
        extract_features(config, synthetic, warps=warps, njobs=njobs,
                         device=device, log=null_logger())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    seconds = time.perf_counter() - start
    log.info('warmup done in %.1fs', seconds)
    return {
        'geometries': [list(geom) for geom in geometries],
        'programs': len(geometries),
        'seconds': round(seconds, 2)}
