"""Seeded synthetic ABX benchmark: the port's quality anchor.

Counterpart of :mod:`shennong_tpu.eval.abx_bench`. The synthesizer is a
copy (numpy and scipy, so the same seed gives the same signals bit for
bit); the VTLN training, the feature extraction, the per-speaker CMVN
and the DTW divergences run on the port, on an explicit ``device``.

The corpus is a set of multi-phone utterances (a lead-in token, then
every phone in a per-utterance shuffled order); features are extracted
over whole utterances and the evaluation segments are frame slices at
the known token boundaries. Its nuisances are the ones the reference's
tables isolate: a stationary per-speaker coloring (removed by
per-speaker CMVN's mean), a per-speaker tremolo depth (equalized by
CMVN's variance normalization), a slowly varying per-utterance channel
(removed by RASTA) and a per-speaker vocal-tract factor ``alpha`` in
[0.88, 1.14] (modeled by VTLN). ``benchmark('ci')`` and
``benchmark('full')`` reproduce the JAX package's recorded tables
(``tests/test_abx_bench.py``, ``doc/performance.md``).
"""

import os
import shutil
import tempfile
import zlib

import numpy as np

from shennong_tpu_torch.logger import get_logger

RATE = 16000
TOKEN_SECONDS = 0.3

#: Standard configurations. ``full`` is the recorded headline table;
#: ``ci`` is small enough for the test suite and has its own recorded
#: magnitudes.
CONFIGS = {
    'full': dict(nspeakers=20, nphones=10, tokens=4, train_tokens=3),
    'ci': dict(nspeakers=8, nphones=4, tokens=3, train_tokens=3),
}


def phone_formants(nphones):
    """Deterministic (f1, f2) grid: adjacent phones ~9% apart in f1,
    f2 ratios interleaved so no single band separates everything."""
    out = {}
    for i in range(nphones):
        f1 = 420.0 * (1.09 ** i)
        f2 = f1 * (1.55 + 0.35 * ((i * 7) % nphones) / max(nphones - 1, 1))
        out[f'p{i:02d}'] = (f1, f2)
    return out


def speaker_profiles(nspeakers):
    """Per-speaker (alpha, fir, depth): vocal-tract scale, fixed
    spectral coloring, and tremolo depth (the dynamics nuisance that
    survives RASTA). Depths are assigned through a deterministic
    permutation so they do not correlate with alpha."""
    alphas = np.linspace(0.88, 1.14, nspeakers)
    depths = np.linspace(0.10, 0.65, nspeakers)
    order = np.random.RandomState(4243).permutation(nspeakers)
    profiles = {}
    for s in range(nspeakers):
        srng = np.random.RandomState(77000 + s)
        fir = srng.randn(24) * (0.95 ** np.arange(24))
        fir[0] = 1.0
        profiles[f's{s:02d}'] = (
            float(alphas[s]), fir, float(depths[order[s]]))
    return profiles


def _token_core(formants, alpha, tag, seed):
    """One raw phone realization (float64, no speaker coloring): two
    formant bands at ``alpha``-scaled frequencies.

    The formants glide ~±5% across the token (three crossfaded
    stages) and a syllable-like amplitude envelope shapes it, so the
    tokens carry temporal modulation — without it RASTA filtering
    (which suppresses stationary spectra by design) would erase all
    phone information and score at chance."""
    import scipy.signal

    f1, f2 = formants
    rng = np.random.RandomState(
        (zlib.crc32(tag.encode()) + 7919 * seed) % (2 ** 32))
    nsamples = int(TOKEN_SECONDS * RATE)
    excitation = rng.randn(nsamples)

    stages = (0.95, 1.0, 1.05)
    hop = nsamples // len(stages)
    window = np.zeros(nsamples)
    signal = np.zeros(nsamples)
    for k, glide in enumerate(stages):
        start = k * hop
        stop = nsamples if k == len(stages) - 1 else (k + 2) * hop
        piece = np.zeros(stop - start)
        for freq in (f1 * alpha * glide, f2 * alpha * glide):
            sos = scipy.signal.butter(
                2, [freq * 0.9, freq * 1.1], 'bandpass',
                fs=RATE, output='sos')
            piece += scipy.signal.sosfilt(
                sos, excitation[start:stop])
        fade = np.hanning(2 * (stop - start))[:stop - start] \
            if len(stages) > 1 else np.ones(stop - start)
        signal[start:stop] += piece * fade
        window[start:stop] += fade
    signal /= np.maximum(window, 1e-3)

    # syllable-like onset/offset envelope
    t = np.arange(nsamples) / nsamples
    signal *= np.sin(np.pi * np.clip(t * 1.15, 0, 1)) ** 0.5
    return signal


#: Per-utterance channel coloring strength (FIR tap scale).
CHANNEL_STRENGTH = 0.6

#: Tremolo rate band (Hz) — inside RASTA's ~1-13 Hz passband.
TREMOLO_HZ = (3.5, 4.5)


def _channel_fir(rng):
    """One random smooth coloring FIR for the utterance channel."""
    taps = rng.randn(24) * (0.9 ** np.arange(24)) * CHANNEL_STRENGTH
    taps[0] = 1.0
    return taps


def synthesize_utterance(phone_seq, phones, profile, tag, seed):
    """One multi-phone utterance for speaker ``profile``: a lead-in
    token (RASTA/filter warm-up, never scored) followed by one
    realization of each phone in ``phone_seq``, through the speaker's
    dynamics (tremolo of speaker depth, per-utterance random phase),
    the speaker's stationary coloring, and a slowly-varying
    per-utterance convolutive channel (FIR crossfade over the whole
    utterance).

    Returns the int16 signal; scored token ``k`` of ``phone_seq``
    occupies samples ``[(k+1)*T, (k+2)*T)`` with ``T`` the token
    length.
    """
    import scipy.signal

    urng = np.random.RandomState(
        (zlib.crc32(('utt:' + tag).encode()) + 104729 * seed)
        % (2 ** 32))
    alpha, fir, depth = profile

    mid = sorted(phones)[len(phones) // 2]
    parts = [_token_core(phones[mid], alpha, f'{tag}-leadin', seed)]
    parts += [
        _token_core(phones[phone], alpha, f'{phone}-{tag}-{k}', seed)
        for k, phone in enumerate(phone_seq)]
    signal = np.concatenate(parts)
    nsamples = len(signal)
    t = np.arange(nsamples) / RATE

    # speaker dynamics: tremolo depth is the speaker trait; phase and
    # exact rate are utterance noise, so the depth (not the waveform)
    # is what distinguishes speakers
    rate = urng.uniform(*TREMOLO_HZ)
    phase = urng.uniform(0, 2 * np.pi)
    signal = signal * (1.0 + depth * np.sin(2 * np.pi * rate * t + phase))

    # stationary speaker coloring
    signal = scipy.signal.lfilter(fir, [1.0], signal)

    # slowly-varying convolutive channel: crossfade between two
    # random FIRs across the utterance — one sweep per utterance,
    # i.e. ~0.3-0.7 Hz, below RASTA's highpass corner
    cola = scipy.signal.lfilter(_channel_fir(urng), [1.0], signal)
    colb = scipy.signal.lfilter(_channel_fir(urng), [1.0], signal)
    sweep = np.sin(0.5 * np.pi * np.arange(nsamples) / nsamples) ** 2
    signal = (1.0 - sweep) * cola + sweep * colb

    # tiny noise floor: the envelope starts at exactly zero, and with
    # dither disabled a digitally-silent frame would hit log(0)
    signal += 1e-4 * np.abs(signal).max() * urng.randn(nsamples)
    return (signal / np.abs(signal).max() * 12000).astype(np.int16)


def segment_slice(token_index, frame_shift=0.01, frame_length=0.025):
    """Frame slice of scored token ``token_index`` in an utterance
    (after the lead-in), 2-frame margins against coarticulation with
    the concatenation edges."""
    nsamples = int(TOKEN_SECONDS * RATE)
    shift = int(round(frame_shift * RATE))
    flen = int(round(frame_length * RATE))
    start = (token_index + 1) * nsamples
    first = -(-start // shift)
    last = (start + nsamples - flen) // shift + 1
    return slice(first + 2, last - 2)


def _utterance_order(tag, seed, phone_names):
    """Deterministic per-utterance shuffled phone order."""
    rng = np.random.RandomState(
        (zlib.crc32(('order:' + tag).encode()) + 104729 * seed)
        % (2 ** 32))
    order = list(phone_names)
    rng.shuffle(order)
    return order


def write_training_half(workdir, phones, profiles, train_tokens, seed):
    """Write the held-out training half of the corpus as WAVs under
    ``workdir``: per speaker, two utterances that concatenate
    ``train_tokens`` fresh realizations of every phone (utterance tags
    disjoint from the evaluation set). Returns the (name, wav, speaker)
    entries."""
    from shennong_tpu_torch.audio import Audio

    phone_names = sorted(phones)
    items = []
    for speaker, profile in profiles.items():
        for utt in range(2):
            tag = f'{speaker}-train-{utt}'
            phone_seq = _utterance_order(
                tag, seed, phone_names * train_tokens)
            signal = synthesize_utterance(
                phone_seq, phones, profile, tag, seed)
            wav = os.path.join(workdir, f'{speaker}-u{utt}.wav')
            Audio(signal, RATE).save(wav)
            items.append((f'{speaker}-u{utt}', wav, speaker))
    return items


def train_warps(workdir, phones, profiles, train_tokens, seed, njobs=1, *,
                device, log=get_logger('abx-bench', 'warning')):
    """Train VTLN warps on a held-out training half of the corpus
    (:func:`write_training_half`), on ``device``, decoding on ``njobs``
    threads. Returns the per-speaker warp dict.
    """
    from shennong_tpu_torch.processor.ubm import DiagUbmProcessor
    from shennong_tpu_torch.processor.vtln import VtlnProcessor
    from shennong_tpu_torch.utterances import Utterances

    items = write_training_half(workdir, phones, profiles, train_tokens, seed)
    ubm_params = DiagUbmProcessor(
        num_gauss=16, num_iters=2, num_iters_init=3,
        num_frames=100000, seed=0).get_params()
    ubm_params['features']['mfcc']['dither'] = 0
    vtln = VtlnProcessor(
        num_iters=3, min_warp=0.85, max_warp=1.25, warp_step=0.025,
        subsample=2, ubm=ubm_params)
    vtln.features['mfcc']['dither'] = 0
    vtln.log.setLevel(log.getEffectiveLevel())
    return vtln.process(Utterances(items), group_by='speaker', njobs=njobs,
                        device=device)


def _make_processor(feature):
    """The port's processor for a benchmark row (dither disabled: the
    benchmark is deterministic per seed)."""
    from shennong_tpu_torch.processor import (
        FilterbankProcessor, MfccProcessor, PlpProcessor,
        SpectrogramProcessor)

    if feature == 'spectrogram':
        return SpectrogramProcessor(dither=0.0)
    if feature == 'filterbank':
        return FilterbankProcessor(dither=0.0)
    if feature == 'mfcc':
        return MfccProcessor(dither=0.0)
    if feature == 'plp':
        return PlpProcessor(dither=0.0)
    if feature == 'rastaplp':
        return PlpProcessor(dither=0.0, rasta=True)
    raise ValueError(f'unknown benchmark feature: {feature}')


#: Rows of the reference's published tables this benchmark reproduces;
#: spectrogram takes no VTLN warp, like the reference's '-' cells.
FEATURES = ('spectrogram', 'filterbank', 'mfcc', 'plp', 'rastaplp')


def benchmark(config='full', seed=0, features=('mfcc',), workdir=None,
              njobs=1, *, device, log=get_logger('abx-bench', 'warning')):
    """Run the standing ABX benchmark at a named configuration on
    ``device`` (``njobs`` bounds the VTLN training's audio decode).

    Returns a dict: ``errors[task][feature][condition]`` in [0, 1] for task in
    ('across', 'within'), feature from ``features`` and condition in
    ('raw', '+cmvn', 'vtln+cmvn'; spectrogram has no VTLN condition),
    plus ``warps``, ``alphas``, ``nsegments``, ``config``, ``seed``
    and ``seconds``, the wall seconds of each stage ('synthesis',
    'vtln', 'extraction', 'dtw', 'abx_error'; the training corpus's
    synthesis counts in 'vtln').
    """
    import time

    from shennong_tpu_torch.audio import Audio
    from shennong_tpu_torch.eval.abx import abx_error, pairwise_distances
    from shennong_tpu_torch.postprocessor import CmvnPostProcessor

    params = CONFIGS[config] if isinstance(config, str) else dict(config)
    phones = phone_formants(params['nphones'])
    profiles = speaker_profiles(params['nspeakers'])
    seconds = dict.fromkeys(
        ('synthesis', 'vtln', 'extraction', 'dtw', 'abx_error'), 0.0)
    clock = time.perf_counter()

    def lap(stage):
        nonlocal clock
        now = time.perf_counter()
        seconds[stage] += now - clock
        clock = now

    created_workdir = workdir is None
    if created_workdir:
        workdir = tempfile.mkdtemp(prefix='abx_bench_')
    log.info('training VTLN warps (%d speakers)', len(profiles))
    try:
        warps = train_warps(
            workdir, phones, profiles, params['train_tokens'], seed,
            njobs=njobs, device=device, log=log)
    finally:
        if created_workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    lap('vtln')

    log.info('synthesizing evaluation utterances')
    phone_names = sorted(phones)
    utt_audios, phone_labels, speaker_labels = [], [], []
    per_speaker = {}
    for speaker, profile in profiles.items():
        for tok in range(params['tokens']):
            tag = f'{speaker}-eval-{tok}'
            phone_seq = _utterance_order(tag, seed, phone_names)
            signal = synthesize_utterance(
                phone_seq, phones, profile, tag, seed)
            per_speaker.setdefault(speaker, []).append(len(utt_audios))
            utt_audios.append((speaker, Audio(signal, RATE), phone_seq))
            phone_labels.extend(phone_seq)
            speaker_labels.extend([speaker] * len(phone_seq))
    lap('synthesis')

    def sliced_segments(utt_features):
        """Per-token frame slices (float64 numpy) of the utterance
        features, in phone_labels order."""
        segments = []
        for feats, (_, _, phone_seq) in zip(utt_features, utt_audios):
            for k in range(len(phone_seq)):
                segments.append(
                    np.asarray(feats.data[segment_slice(k)], np.float64))
        return segments

    def cmvn_normalized(utt_features):
        """Per-speaker CMVN over whole utterances (the pipeline's
        ``by_speaker`` semantics)."""
        out = [None] * len(utt_features)
        for indices in per_speaker.values():
            cmvn = CmvnPostProcessor(dim=utt_features[0].ndims)
            for index in indices:
                cmvn.accumulate(utt_features[index])
            for index in indices:
                out[index] = cmvn.process(utt_features[index])
        return out

    errors = {'across': {}, 'within': {}}
    for feature in features:
        proc = _make_processor(feature)
        log.info('extracting %s utterances', feature)
        plain = [proc.process(audio, device=device)
                 for _, audio, _ in utt_audios]
        conditions = {
            'raw': sliced_segments(plain),
            '+cmvn': sliced_segments(cmvn_normalized(plain)),
        }
        if feature != 'spectrogram':
            warped = [
                proc.process(audio, vtln_warp=warps[speaker], device=device)
                for speaker, audio, _ in utt_audios]
            conditions['vtln+cmvn'] = sliced_segments(
                cmvn_normalized(warped))
        lap('extraction')

        for task in ('across', 'within'):
            errors[task][feature] = {}
        for label, segments in conditions.items():
            log.info('scoring %s %s (%d segments)',
                     feature, label, len(segments))
            # 4096 pairs a batch, as the JAX package: the full
            # configuration scores 320k pairs per condition
            distances = pairwise_distances(
                segments, batch=4096, device=device)
            lap('dtw')
            for task in ('across', 'within'):
                errors[task][feature][label] = abx_error(
                    distances, phone_labels, speaker_labels, task=task)
            lap('abx_error')

    return {
        'errors': errors,
        'warps': dict(warps),
        'alphas': {s: prof[0] for s, prof in profiles.items()},
        'nsegments': len(phone_labels),
        'config': params,
        'seed': seed,
        'seconds': seconds,
    }
