"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``shennong_tpu_torch`` from the sources in
this checkout, holds each against its plain PyTorch version on the
card, checks the processors against ``tests/data/golden_real.npz``
and ``tests/kaldi_oracle.py``, and drives the port's paths over a
generated corpus of 256 utterances (4 s and 6 s, 16 speakers):

- the MFCC slice, ``extract_features`` with the default MFCC + Kaldi
  pitch + CMVN + delta configuration;
- the RASTA-PLP slice, the same with RASTA-PLP features (BASELINE
  config 2), with the cost of its RASTA and Durbin stages read from
  their profiler spans;
- the filterbank (CMVN + deltas) and spectrogram (CMVN) passes;
- the ``speech-features-torch`` CLI, ``config`` then ``extract
  --device cuda`` on 16 utterances, against the in-process result;
- long audio: one hour of audio plus 16 utterances through the MFCC
  slice (the stage-wise pass 1, the hour in chunks), chunked against
  whole extraction on a 12-minute utterance, both kernels at the chunk
  shape of hour-scale pitch [8, 8400, 417], and the stage-wise and
  mixed-sample-rate paths on the card against the CPU.

Both slices and the long-audio run must go through both Viterbi
kernels. Every phase prints
its lines; any failure raises and the script exits non-zero. The
second-to-last lines are the kernels' JSON record and the card's name
and power limit; the last line is the JSON verdict.

Exits non-zero without a result when no CUDA device is available.
Imports nothing of JAX.
"""

import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_TOL = 1e-3        # the contract of tests/test_real_audio.py
SLICE_TOL = 1e-3         # cuda vs cpu on the whole slice
ORACLE_SECONDS = 10.0    # longest audio a lag tie is proven on by the oracle
NUM_UTTERANCES = 256
NUM_SPEAKERS = 16
DURATIONS = (4.0, 6.0)   # seconds, alternating
RATE = 16000
RUNS = 5                 # timed warm runs of the slice


def say(phase, message):
    print(f'[{phase}] {message}', flush=True)


def check(condition, message):
    if not condition:
        raise RuntimeError(message)


def cuda_ms(fn, repeats):
    """Mean milliseconds of ``fn()`` on the card, from CUDA events,
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


# ------------------------------------------------------------------ probe

def probe():
    check(torch.cuda.is_available(), 'no CUDA device is available')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    nvcc = subprocess.run(['nvcc', '--version'], capture_output=True,
                          text=True, check=True).stdout.strip()
    say('probe', f'card: {card}')
    say('probe', f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'nvcc: {nvcc.splitlines()[-1]}')
    return card


# ------------------------------------------------------------------ build

def build_kernels():
    from shennong_tpu_torch.ops import cuda_viterbi

    start = time.perf_counter()
    path, log = cuda_viterbi.build()
    cuda_viterbi._load()
    seconds = time.perf_counter() - start
    say('build', f'{os.path.relpath(path, HERE)} in {seconds:.2f} s')
    for line in log.splitlines():
        if 'registers' in line or 'spill' in line:
            say('build', 'ptxas: ' + line.strip())


# ---------------------------------------------------------- kernel vs plain

def hold_kernels(shape, bounds, rng, errors):
    """Both kernels against their plain versions on random costs of
    ``shape``, row ``i`` holding ``bounds[i]`` frames: the forward
    history bit-equal over each row's valid frames, the lags equal. The
    max-abs errors go into ``errors``; returns (cost, counts, history)
    for timing."""
    from shennong_tpu_torch.ops import cuda_viterbi
    from shennong_tpu_torch.ops.pitch import PitchOpts, inter_frame_factor

    factor = inter_frame_factor(PitchOpts())
    cost = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
    counts = torch.tensor(bounds, dtype=torch.int32, device='cuda')
    hist = cuda_viterbi.viterbi_forward(cost, counts, factor)
    plain = cuda_viterbi.viterbi_forward_plain(cost, counts, factor)
    best = cuda_viterbi.viterbi_backtrace(hist, counts, factor)
    best_plain = cuda_viterbi.viterbi_backtrace_plain(plain, counts, factor)
    torch.cuda.synchronize()
    for row, bound in enumerate(bounds):
        # frame 0 is computed even for empty rows
        valid = max(bound, 1)
        mine, ref = hist[:valid, row], plain[:valid, row]
        check(torch.equal(mine, ref),
              f'forward history differs at {shape} row {row}')
        errors['viterbi_forward'] = max(
            errors['viterbi_forward'], float((mine - ref).abs().max()))
        check(torch.equal(best[:bound, row], best_plain[:bound, row]),
              f'backtrace lags differ at {shape} row {row}')
        if bound:
            errors['viterbi_backtrace'] = max(
                errors['viterbi_backtrace'],
                float((best[:bound, row] - best_plain[:bound, row])
                      .abs().max()))
    return cost, counts, hist


def time_kernels(phase, shape, cost, counts, hist, plain_repeats):
    """Kernel and plain milliseconds of both kernels (CUDA events), by
    kernel name."""
    from shennong_tpu_torch.ops import cuda_viterbi
    from shennong_tpu_torch.ops.pitch import PitchOpts, inter_frame_factor

    factor = inter_frame_factor(PitchOpts())
    times = {
        'viterbi_forward': (
            cuda_ms(lambda: cuda_viterbi.viterbi_forward(
                cost, counts, factor), 10),
            cuda_ms(lambda: cuda_viterbi.viterbi_forward_plain(
                cost, counts, factor), plain_repeats)),
        'viterbi_backtrace': (
            cuda_ms(lambda: cuda_viterbi.viterbi_backtrace(
                hist, counts, factor), 10),
            cuda_ms(lambda: cuda_viterbi.viterbi_backtrace_plain(
                hist, counts, factor), plain_repeats)),
    }
    for name, (ms, plain_ms) in times.items():
        say(phase, f'{name} at {shape}: kernel {ms:.3f} ms, '
            f'plain {plain_ms:.3f} ms (CUDA events)')
    return times


def kernels_vs_plain():
    """Every kernel against its plain version on the card, at the main
    path's shape and at edge shapes; timed at the main path's shape."""
    from shennong_tpu_torch.ops.pitch import PitchOpts, num_pitch_frames

    main_frames = num_pitch_frames(int(DURATIONS[1] * RATE), PitchOpts())
    rng = np.random.RandomState(0)
    main = ((64, main_frames, 417), [main_frames] * 32 + [
        int(n) for n in rng.randint(0, main_frames + 1, 32)])
    cases = [
        main,
        ((5, 37, 50), [37, 30, 37, 5, 1]),
        ((1, 10, 417), [10]),
        ((8, 64, 130), [64] * 8),
        ((3, 100, 7), [100, 99, 50]),
        ((6, 40, 417), [40, 0, 1, 2, 39, 40]),
        ((3, 1, 417), [1, 0, 1]),
    ]
    errors = {'viterbi_forward': 0.0, 'viterbi_backtrace': 0.0}
    for shape, bounds in cases:
        held = hold_kernels(shape, bounds, rng, errors)
        if shape == main[0]:
            timed = held
        say('kernels', f'{shape}, nframes from {min(bounds)} to '
            f'{max(bounds)}: history bit-equal, lags equal')
    times = time_kernels('kernels', main[0], *timed, plain_repeats=3)
    return errors, times


# ---------------------------------------------------------------- goldens

def goldens():
    """The port's processors on tests/data/test.wav on the card, held
    against golden_real.npz (dither and pitch noise 0)."""
    from shennong_tpu_torch import Audio
    from shennong_tpu_torch.processor.energy import EnergyProcessor
    from shennong_tpu_torch.processor.mfcc import MfccProcessor
    from shennong_tpu_torch.processor.pitch_kaldi import (
        KaldiPitchPostProcessor, KaldiPitchProcessor)

    audio = Audio.load(os.path.join(HERE, 'tests', 'data', 'test.wav'))
    golden = np.load(os.path.join(HERE, 'tests', 'data', 'golden_real.npz'))
    pitch = KaldiPitchProcessor().process(audio, device='cuda')
    outputs = {
        'mfcc': MfccProcessor(dither=0).process(audio, device='cuda'),
        'energy': EnergyProcessor(dither=0).process(audio, device='cuda'),
        'pitch': pitch,
        'pitch_post': KaldiPitchPostProcessor(
            delta_pitch_noise_stddev=0).process(pitch, device='cuda'),
    }
    for name, features in outputs.items():
        check(features.shape == golden[name].shape,
              f'{name}: shape {features.shape} != {golden[name].shape}')
        err = float(np.abs(features.data - golden[name]).max())
        check(err < GOLDEN_TOL, f'{name}: max-abs {err} >= {GOLDEN_TOL}')
        say('goldens', f'{name} {features.shape}: max-abs {err:.3g} '
            f'< {GOLDEN_TOL}')
    frontends_golden(audio, golden)


def frontends_golden(audio, golden):
    """The spectrogram, filterbank and PLP processors on the card,
    against golden_real.npz and the float64 Kaldi oracle."""
    from shennong_tpu_torch.processor.filterbank import FilterbankProcessor
    from shennong_tpu_torch.processor.plp import PlpProcessor
    from shennong_tpu_torch.processor.spectrogram import (
        SpectrogramProcessor)

    from tests import kaldi_oracle

    signal = audio.data.astype(np.float64)
    cases = {
        'fbank': (FilterbankProcessor(dither=0), kaldi_oracle.fbank),
        'spectrogram': (
            SpectrogramProcessor(dither=0), kaldi_oracle.spectrogram),
        'plp': (PlpProcessor(dither=0), kaldi_oracle.plp),
        'rastaplp': (PlpProcessor(dither=0, rasta=True),
                     lambda x: kaldi_oracle.plp(x, rasta=True)),
    }
    for name, (proc, oracle) in cases.items():
        features = proc.process(audio, device='cuda').data
        check(features.shape == golden[name].shape,
              f'{name}: shape {features.shape} != {golden[name].shape}')
        err = float(np.abs(features - golden[name]).max())
        diff = np.abs(features - oracle(signal))
        frame, column = np.unravel_index(diff.argmax(), diff.shape)
        check(err < GOLDEN_TOL, f'{name}: golden max-abs {err}')
        check(diff.max() < GOLDEN_TOL, f'{name}: oracle max-abs '
              f'{diff.max()} at frame {frame}, column {column}')
        say('goldens', f'{name} {features.shape}: max-abs {err:.3g} '
            f'against the golden, {diff.max():.3g} against the Kaldi '
            f'oracle (worst at frame {frame}, column {column}), both < '
            f'{GOLDEN_TOL}')


# ------------------------------------------------------------------ slice

def speech_like(nsamples, seed, rate=RATE):
    """Speech-like int16 waveform: voiced harmonics with a wandering
    F0 under a syllabic envelope, a little noise, a leading silence."""
    rng = np.random.RandomState(seed)
    t = np.arange(nsamples) / rate
    f0 = 100 + 80 * rng.rand() + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    voiced = sum((0.6 ** k) * np.sin((k + 1) * phase) for k in range(8))
    envelope = (0.5 * (1 + np.sin(2 * np.pi * (2.5 + rng.rand()) * t)))
    envelope = envelope ** 2
    envelope[:int(0.05 * rate)] = 0
    signal = voiced * envelope * 0.4 + rng.randn(nsamples) * 0.02
    signal = signal / np.max(np.abs(signal)) * 0.7
    return (signal * 2 ** 15 * 0.8).astype(np.int16)


def make_corpus(directory):
    import scipy.io.wavfile
    from shennong_tpu_torch import Utterances

    os.makedirs(directory, exist_ok=True)
    entries = []
    for index in range(NUM_UTTERANCES):
        duration = DURATIONS[index % len(DURATIONS)]
        path = os.path.join(directory, f'utt{index:03d}.wav')
        scipy.io.wavfile.write(
            path, RATE, speech_like(int(duration * RATE), seed=index))
        entries.append(
            (f'utt{index:03d}', path, f'spk{index % NUM_SPEAKERS:02d}'))
    return entries


def expected_frames(nsamples):
    """Output rows of the slice for ``nsamples`` samples: the smaller
    of the MFCC and the pitch frame counts (Kaldi's formulas, as in
    shennong_tpu.ops.framing.num_frames and
    shennong_tpu.ops.pitch.num_pitch_frames)."""
    mfcc = 1 + (nsamples - 400) // 160
    # LinearResample 16 kHz -> 4 kHz: one tick per input sample, four
    # per output sample
    last = nsamples // 4 - (1 if nsamples % 4 == 0 else 0)
    resampled = last + 1
    pitch = (resampled - 100) // 40 + 1
    return min(mfcc, pitch)


def slice_config(features):
    """The configuration of a slice: MFCC or RASTA-PLP features with
    Kaldi pitch, CMVN and deltas."""
    from shennong_tpu_torch import pipeline

    config = pipeline.get_default_config(
        features, with_pitch='kaldi', with_cmvn=True, with_delta=True)
    if features == 'plp':
        config['plp']['rasta'] = True
    return config


def zero_randomness(config, features):
    config[features]['dither'] = 0
    if 'pitch' in config:
        config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    return config


def warm_runs(config, utterances):
    """``RUNS`` timed runs of ``extract_features`` on the card: their
    walls in seconds, and the last run's features."""
    from shennong_tpu_torch import pipeline

    walls = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = pipeline.extract_features(
            copy.deepcopy(config), utterances, device='cuda')
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    return walls, out


def the_slice(card, entries, features):
    """One slice over the corpus: a cold run, 5 timed warm runs whose
    kernel launches are counted, a profiled run, and CUDA against the
    CPU on 8 utterances with every random source at 0."""
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.ops import cuda_viterbi

    phase = f'{features} slice'
    config = slice_config(features)
    utterances = Utterances(entries)
    audio_seconds = sum(utt.duration for utt in utterances)

    # cold run over one batch: library load, cuFFT plans, allocator
    warm = Utterances(entries[:64])
    pipeline.extract_features(copy.deepcopy(config), warm, device='cuda')

    cuda_viterbi.reset_launches()
    walls, features_out = warm_runs(config, utterances)
    launches = dict(cuda_viterbi.LAUNCHES)
    for name, count in launches.items():
        check(count > 0, f'the {phase} never launched {name}')

    check(len(features_out) == NUM_UTTERANCES,
          f'{len(features_out)} outputs for {NUM_UTTERANCES} utterances')
    for utt in utterances:
        feats = features_out[utt.name]
        nsamples = int(round(utt.duration * RATE))
        check(feats.shape == (expected_frames(nsamples), 42),
              f'{utt.name}: shape {feats.shape}')
        check(np.isfinite(feats.data).all(), f'{utt.name}: non-finite')
    seconds = float(np.median(walls))
    xrt = audio_seconds / seconds
    say(phase, f'{NUM_UTTERANCES} utterances ({audio_seconds:.0f} s of '
        f'audio), {RUNS} warm runs: wall median {seconds:.4f} s (min '
        f'{min(walls):.4f}, max {max(walls):.4f}), warm xRT median '
        f'{xrt:.1f} (min {audio_seconds / max(walls):.1f}, max '
        f'{audio_seconds / min(walls):.1f}) on {card}; launches {launches}')
    profile_layers(phase, config, utterances, seconds)

    # 8 utterances with every random source at 0: cuda against cpu
    worst, ties = cuda_against_cpu(
        config, features, Utterances(entries[:8]), pitch_batched)
    say(phase, f'cuda vs cpu on 8 utterances, no randomness: max-abs '
        f'{worst:.3g} < {SLICE_TOL} ({ties} with proven lag ties)')
    return launches, xrt


def pitch_batched(utterances, device):
    """Raw Kaldi pitch as the fused and stage-wise pass 1 compute it:
    in padded length-sorted batches (one sample rate)."""
    from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchProcessor

    raw = KaldiPitchProcessor().process_all(utterances, device=device)
    return {name: raw[name].data for name in raw}


def pitch_per_utterance(utterances, device):
    """Raw Kaldi pitch as the per-utterance pass 1 computes it."""
    from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchProcessor

    raw = {}
    for utt in utterances:
        audio = utt.load_audio()
        raw[utt.name] = KaldiPitchProcessor(
            sample_rate=audio.sample_rate).process(audio, device=device).data
    return raw


def cuda_against_cpu(config, features, utterances, raw_pitch, warps=None):
    """``extract_features`` on the card and on the CPU with every random
    source at 0 (the energy VAD's dither too): the max-abs between the
    two, under SLICE_TOL, and the count of utterances whose pitch lags
    differ, each difference a proven tie. ``raw_pitch(utterances,
    device)`` recomputes the raw pitch as the path under test does,
    batches included. The witness of a tie is the float64 oracle
    (tests/pitch_oracle.py) up to ORACLE_SECONDS of audio and the
    float64 path costs of the port's whole-signal program
    (tests/lag_ties.py) past them, where the oracle's Python loops are
    too slow. Where lags differ, the two log-pitch columns, which move
    with the lag over their windows, are left out, and the POV is held
    at every frame: CUDA against the CPU where the lags agree, each
    against its own NCCF at the ties (the ballast-free NCCF of two tied
    lags can differ widely, as in unvoiced frames)."""
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.processor import energy as energy_module
    from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchProcessor

    from tests.lag_ties import assert_ties
    from tests.pitch_oracle import assert_lag_decisions, process_pitch

    defaults = energy_module.EnergyProcessor.__init__.__defaults__
    energy_module.EnergyProcessor.__init__.__defaults__ = (
        defaults[:3] + (0.0,) + defaults[4:])
    try:
        on = {device: pipeline.extract_features(
            zero_randomness(copy.deepcopy(config), features), utterances,
            warps=warps, device=device)
            for device in ('cuda', 'cpu')}
    finally:
        energy_module.EnergyProcessor.__init__.__defaults__ = defaults
    raw = {device: raw_pitch(utterances, device)
           for device in ('cuda', 'cpu')}
    worst = 0.0
    ties = 0
    for utt in utterances:
        gpu, cpu = on['cuda'][utt.name].data, on['cpu'][utt.name].data
        check(gpu.shape == cpu.shape, f'{utt.name}: shapes differ')
        columns = gpu.shape[1]
        ours, ref = raw['cuda'][utt.name], raw['cpu'][utt.name]
        if not np.array_equal(ours[:, 1], ref[:, 1]):
            # a lag decision that differs must be a proven tie
            audio = utt.load_audio()
            if utt.duration <= ORACLE_SECONDS:
                same = assert_lag_decisions(
                    audio.data.astype(np.float64), ours, ref,
                    rate=audio.sample_rate)
                witness = 'the float64 oracle'
            else:
                assert_ties(
                    audio.astype(np.int16).data, KaldiPitchProcessor(
                        sample_rate=audio.sample_rate).options(),
                    ours, ref, 'cpu')
                witness = 'the float64 path costs'
                same = np.isclose(ours[:, 1], ref[:, 1], rtol=1e-4)
            ties += 1
            # the POV is per frame: equal where the lags agree, and at a
            # tie each device's POV is the oracle's post-processing of
            # its own NCCF at its own lag
            pov = columns - 3
            rows = gpu.shape[0]
            same = same[:rows]
            agree = float(np.abs(gpu[same, pov] - cpu[same, pov]).max())
            tied = max(
                float(np.abs(out[~same, pov] - process_pitch(
                    raw_track[:rows][~same].astype(np.float64),
                    add_norm=False, add_delta=False)[:, 0]).max())
                for out, raw_track in ((gpu, ours), (cpu, ref)))
            check(max(agree, tied) < SLICE_TOL, f'{utt.name}: POV max-abs '
                  f'{agree} where the lags agree, {tied} at the ties')
            say('cuda vs cpu', f'{utt.name}: {int((~same).sum())} of '
                f'{len(ours)} lags differ, ties by {witness}; POV max-abs '
                f'{agree:.3g} where the lags agree, {tied:.3g} against the '
                'oracle\'s POV of each device\'s NCCF at the ties')
            columns = pov  # features + deltas
        diff = np.abs(gpu[:, :columns] - cpu[:, :columns])
        frame, column = np.unravel_index(diff.argmax(), diff.shape)
        check(diff.max() < SLICE_TOL, f'{utt.name}: cuda vs cpu max-abs '
              f'{diff.max()} at frame {frame}, column {column}')
        worst = max(worst, float(diff.max()))
    return worst, ties


def frontends_pass(card, entries):
    """The filterbank (CMVN + deltas, 69 columns) and spectrogram
    (CMVN, 257 columns) passes over the corpus: a cold run whose shapes
    and finiteness are checked, 5 timed warm runs and a profiled
    run."""
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.ops import cuda_viterbi

    utterances = Utterances(entries)
    audio_seconds = sum(utt.duration for utt in utterances)
    for features, delta, columns in (
            ('filterbank', True, 69), ('spectrogram', False, 257)):
        phase = f'{features} pass'
        config = pipeline.get_default_config(
            features, with_cmvn=True, with_delta=delta)
        cuda_viterbi.reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = pipeline.extract_features(
            copy.deepcopy(config), utterances, device='cuda')
        torch.cuda.synchronize()
        cold = time.perf_counter() - start
        check(len(out) == NUM_UTTERANCES, f'{features}: {len(out)} outputs')
        for utt in utterances:
            nsamples = int(round(utt.duration * RATE))
            shape = (1 + (nsamples - 400) // 160, columns)
            check(out[utt.name].shape == shape,
                  f'{features} {utt.name}: shape {out[utt.name].shape}')
            check(np.isfinite(out[utt.name].data).all(),
                  f'{features} {utt.name}: non-finite')
        walls, _ = warm_runs(config, utterances)
        seconds = float(np.median(walls))
        say(phase, f'{NUM_UTTERANCES} utterances, {columns} columns, '
            f'finite; cold run {cold:.4f} s; {RUNS} warm runs: wall median '
            f'{seconds:.4f} s (min {min(walls):.4f}, max {max(walls):.4f}), '
            f'warm xRT median {audio_seconds / seconds:.1f} on {card}; '
            f'launches {dict(cuda_viterbi.LAUNCHES)}')
        profile_layers(phase, config, utterances, seconds)


def cli_phase(workdir, entries):
    """``speech-features-torch config`` then ``extract --device cuda``
    on 16 utterances, in a child process, against the same
    configuration run in this process (random sources at 0, CMVN
    without the VAD: no randomness left)."""
    import yaml

    from shennong_tpu_torch import FeaturesCollection, Utterances
    from shennong_tpu_torch import pipeline

    index = os.path.join(workdir, 'utterances.txt')
    with open(index, 'w') as stream:
        for name, path, speaker in entries[:16]:
            stream.write(f'{name} {path} {speaker}\n')
    config_file = os.path.join(workdir, 'config.yaml')
    output = os.path.join(workdir, 'features.npz')

    def cli(*args):
        start = time.perf_counter()
        subprocess.run(
            [sys.executable, '-m', 'shennong_tpu_torch.cli', *args],
            cwd=HERE, check=True)
        return time.perf_counter() - start

    cli('config', 'plp', '--pitch', 'kaldi', '--cmvn', '--delta', '-o',
        config_file)
    with open(config_file) as stream:
        config = yaml.safe_load(stream)
    zero_randomness(config, 'plp')
    config['plp']['rasta'] = True
    config['cmvn']['with_vad'] = False
    with open(config_file, 'w') as stream:
        yaml.safe_dump(config, stream)
    seconds = cli('extract', '-q', '--device', 'cuda', config_file, index,
                  output)

    saved = FeaturesCollection.load(output)
    ref = pipeline.extract_features(
        config_file, Utterances(entries[:16]), device='cuda')
    check(sorted(saved) == sorted(ref), 'the CLI output misses utterances')
    worst = 0.0
    for name in ref:
        check(saved[name].shape == ref[name].shape,
              f'{name}: CLI shape {saved[name].shape}')
        worst = max(worst, float(
            np.abs(saved[name].data - ref[name].data).max()))
    check(worst < 1e-5, f'CLI against in-process: max-abs {worst}')
    say('cli', f'config plp -> extract --device cuda on 16 utterances in '
        f'{seconds:.1f} s (a new process: start-up and kernel load '
        f'included); .npz against in-process: max-abs {worst:.3g} < 1e-5')


# ------------------------------------------------------------- long audio

def write_wav(path, seconds, seed, rate=RATE):
    """A speech-like mono int16 WAV of ``seconds``, written a minute at
    a time so host memory stays bounded."""
    import wave

    with wave.open(path, 'wb') as stream:
        stream.setnchannels(1)
        stream.setsampwidth(2)
        stream.setframerate(rate)
        for minute in range(int(math.ceil(seconds / 60))):
            count = int(min(60, seconds - 60 * minute) * rate)
            stream.writeframes(
                speech_like(count, seed=seed + minute, rate=rate).tobytes())
    return path


def long_audio(card, workdir, entries):
    """Hour-scale audio and the stage-wise path on the card.

    1. ``extract_features`` (the MFCC slice) over one hour and 16
       corpus utterances: the stage-wise path, its chunked routes and
       both Viterbi kernels; shapes, finiteness, wall and xRT.
    2. A 12-minute utterance (71998 frames, past AUTO_CHUNK_FRAMES):
       auto-routed (chunked) ``process`` against forced-whole
       extraction for the six processors, dither 0.
    3. Both kernels against their plain versions at the chunk shape of
       hour-scale pitch, [8, 8400, 417].
    4. CUDA against the CPU on a stage-wise corpus and on a corpus of
       mixed sample rates with warps by speaker.

    Returns the Viterbi launches of step 1 and the kernels' max-abs
    errors of step 3.
    """
    from shennong_tpu_torch import Audio, Utterances
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.ops import cuda_viterbi

    phase = 'long audio'
    start = time.perf_counter()
    hour = write_wav(os.path.join(workdir, 'hour.wav'), 3600, seed=1000)
    say(phase, f'one hour of audio written in '
        f'{time.perf_counter() - start:.1f} s')

    config = slice_config('mfcc')
    utterances = Utterances([('hour', hour, 'spkH')] + entries[:16])
    audio_seconds = sum(utt.duration for utt in utterances)
    torch.cuda.reset_peak_memory_stats()
    cuda_viterbi.reset_launches()
    torch.cuda.synchronize()
    begin = time.perf_counter()
    out = pipeline.extract_features(
        copy.deepcopy(config), utterances, device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - begin
    launches = dict(cuda_viterbi.LAUNCHES)
    for name, count in launches.items():
        check(count > 0, f'the {phase} run never launched {name}')
    for utt in utterances:
        nsamples = int(round(utt.duration * RATE))
        check(out[utt.name].shape == (expected_frames(nsamples), 42),
              f'{utt.name}: shape {out[utt.name].shape}')
        check(np.isfinite(out[utt.name].data).all(),
              f'{utt.name}: non-finite')
    say(phase, f'extract_features, MFCC slice, 1 h + 16 utterances '
        f'({audio_seconds:.0f} s of audio, the hour {out["hour"].shape}): '
        f'wall {wall:.3f} s, xRT {audio_seconds / wall:.1f}, peak device '
        f'memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on '
        f'{card}; launches {launches}')
    profile_layers(phase, config, utterances, wall)
    hour_stages(phase, Audio.load(hour))

    chunked_against_whole(phase, write_wav(
        os.path.join(workdir, 'twelve.wav'), 720, seed=2000))
    errors = chunk_shape_kernels(phase)

    # CUDA against the CPU: a 90 s utterance past a lowered features
    # limit, cut in chunks of 3000 frames, sends the corpus down the
    # stage-wise path on both devices
    from shennong_tpu_torch.processor.base import FramesProcessor
    from shennong_tpu_torch.processor.mfcc import MfccProcessor

    stagewise = Utterances([('long', write_wav(
        os.path.join(workdir, 'ninety.wav'), 90, seed=3000), 'spk00')]
        + entries[:4])
    limit = MfccProcessor.AUTO_CHUNK_FRAMES
    chunking = FramesProcessor.process_chunked.__defaults__
    MfccProcessor.AUTO_CHUNK_FRAMES = 6000
    FramesProcessor.process_chunked.__defaults__ = (3000,) + chunking[1:]
    try:
        worst, ties = cuda_against_cpu(
            config, 'mfcc', stagewise, pitch_batched)
    finally:
        MfccProcessor.AUTO_CHUNK_FRAMES = limit
        FramesProcessor.process_chunked.__defaults__ = chunking
    say(phase, f'cuda vs cpu, stage-wise path (90 s in chunks of 3000 '
        f'frames + 4 utterances): max-abs {worst:.3g} < {SLICE_TOL} '
        f'({ties} with proven lag ties)')

    mixed = entries[:6] + [
        (f'narrow{index}', write_wav(
            os.path.join(workdir, f'narrow{index}.wav'), 4.0,
            seed=4000 + index, rate=8000), f'spk{index:02d}')
        for index in range(2)]
    warps = {f'spk{index:02d}': 0.88 + 0.04 * index for index in range(6)}
    worst, ties = cuda_against_cpu(
        config, 'mfcc', Utterances(mixed), pitch_per_utterance,
        warps=warps)
    say(phase, f'cuda vs cpu, 6 utterances at 16 kHz and 2 at 8 kHz, '
        f'warps by speaker: max-abs {worst:.3g} < {SLICE_TOL} ({ties} '
        f'with proven lag ties)')
    say(phase, f'phase time {time.perf_counter() - start:.1f} s')
    return launches, errors


def hour_stages(phase, audio):
    """The hour's chunked routes alone, each timed on the card: MFCC
    (20000-frame chunks) and Kaldi pitch (8000-frame chunks in groups
    of 8)."""
    from shennong_tpu_torch.processor.mfcc import MfccProcessor
    from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchProcessor

    for name, proc in (('MFCC', MfccProcessor()),
                       ('pitch', KaldiPitchProcessor())):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        shape = proc.process(audio, device='cuda').shape
        torch.cuda.synchronize()
        say(phase, f'the hour\'s {name} alone {shape}: '
            f'{time.perf_counter() - begin:.3f} s')


def chunked_against_whole(phase, path):
    """Auto-routed (chunked) extraction of a 12-minute utterance against
    forced-whole extraction on the card, dither 0: 1e-4 for the
    frame-local processors, 1e-3 for RASTA-PLP (the bounds of
    tests/test_chunked.py); the pitch tracker's 16k -> 4k resample
    bit-equal; pitch lags equal or ties of the whole program's costs
    (tests/lag_ties.py)."""
    from shennong_tpu_torch import Audio
    from shennong_tpu_torch.ops import cuda_viterbi, resample
    from shennong_tpu_torch.processor.energy import EnergyProcessor
    from shennong_tpu_torch.processor.filterbank import FilterbankProcessor
    from shennong_tpu_torch.processor.mfcc import MfccProcessor
    from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchProcessor
    from shennong_tpu_torch.processor.plp import PlpProcessor
    from shennong_tpu_torch.processor.spectrogram import (
        SpectrogramProcessor)

    from tests.lag_ties import assert_ties

    audio = Audio.load(path)
    cases = {
        'mfcc': (MfccProcessor(dither=0), 1e-4),
        'filterbank': (FilterbankProcessor(dither=0), 1e-4),
        'spectrogram': (SpectrogramProcessor(dither=0), 1e-4),
        'energy': (EnergyProcessor(dither=0), 1e-4),
        'plp': (PlpProcessor(dither=0), 1e-4),
        'rastaplp': (PlpProcessor(dither=0, rasta=True), 1e-3),
    }
    for name, (proc, bound) in cases.items():
        routed = proc.process(audio, device='cuda')
        whole = proc.process_chunked(
            audio, chunk_frames=10 ** 9, device='cuda')
        check(routed.shape == whole.shape == (71998, proc.ndims),
              f'{name}: shapes {routed.shape}, {whole.shape}')
        err = float(np.abs(routed.data - whole.data).max())
        check(err < bound, f'{name}: chunked vs whole max-abs {err}')
        say(phase, f'12 min {name} {routed.shape}: chunked vs whole '
            f'max-abs {err:.3g} < {bound}')

    proc = KaldiPitchProcessor()
    opts = proc.options()
    signal = audio.data.astype(np.float32)
    args = (opts.sample_rate, opts.resample_freq, opts.lowpass_cutoff,
            opts.lowpass_filter_width)
    chunked = resample.linear_resample_chunked(signal, *args, device='cuda')
    whole = resample.linear_resample(
        torch.as_tensor(signal, device='cuda')[None], signal.shape[0],
        *args)[0]
    check(torch.equal(torch.as_tensor(chunked, device='cuda'), whole),
          'the chunked resample differs from the whole-signal one')
    say(phase, f'12 min resample {signal.shape[0]} -> {chunked.shape[0]} '
        'samples: linear_resample_chunked bit-equal to the whole-signal '
        'linear_resample')

    cuda_viterbi.reset_launches()
    routed = proc.process(audio, device='cuda').data
    chunked_launches = dict(cuda_viterbi.LAUNCHES)
    proc.AUTO_CHUNK_FRAMES = None
    cuda_viterbi.reset_launches()
    whole = proc.process(audio, device='cuda').data
    check(cuda_viterbi.LAUNCHES == {
        'viterbi_forward': 1, 'viterbi_backtrace': 1},
        f'the whole pitch launched {cuda_viterbi.LAUNCHES}')
    differ, margin, nccf = assert_ties(
        audio.data, proc.options(), routed, whole, 'cuda')
    say(phase, f'12 min pitch {routed.shape}: chunked (launches '
        f'{chunked_launches}) vs whole ([1, {whole.shape[0]}, 417]): '
        f'{differ} lags differ (largest tie margin {margin:.3g} < 1e-4), '
        f'NCCF max-abs {nccf:.3g} where they agree')


def chunk_shape_kernels(phase):
    """Both kernels against their plain versions at [8, 8400, 417], rows
    of full, partial and zero frames: the forward history bit-equal,
    the lags equal; kernel and plain ms from CUDA events."""
    bounds = [8400, 8400, 8400, 8400, 5000, 1, 0, 2300]
    shape = (8, 8400, 417)
    errors = {'viterbi_forward': 0.0, 'viterbi_backtrace': 0.0}
    held = hold_kernels(shape, bounds, np.random.RandomState(8), errors)
    say(phase, f'kernels at {shape}, nframes {bounds}: history '
        'bit-equal, lags equal')
    time_kernels(phase, shape, *held, plain_repeats=2)
    return errors


#: the port's profiler spans (torch.profiler.record_function)
SPANS = ('pass1.dispatch', 'pass1.wait', 'batch.dispatch', 'batch.wait',
         'batch.chunked', 'pass2', 'plp.rasta', 'plp.durbin')


def profile_layers(phase, config, utterances, wall_s):
    """One more run under torch.profiler: device busy time by kernel,
    and for each span of the port its host time and the device time of
    the kernels launched inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shennong_tpu_torch import pipeline

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        pipeline.extract_features(
            copy.deepcopy(config), utterances, device='cuda')
        torch.cuda.synchronize()
    averages = prof.key_averages()
    # the annotations appear twice: as host spans, whose device time
    # sums the kernels launched inside them, and as device-side user
    # annotations that are not kernels
    spans = sorted(
        (e.key, e.count, e.cpu_time_total / 1e3, e.device_time_total / 1e3)
        for e in averages
        if e.key in SPANS and e.device_type == DeviceType.CPU)
    kernels = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in averages if e.device_type == DeviceType.CUDA
         and e.key not in SPANS),
        reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    phase = f'{phase} profile'
    if not busy:
        say(phase, 'device time not measured (the profiler saw no '
            'kernels)')
    else:
        say(phase, f'device busy {busy:.3f} ms of {wall_s * 1e3:.1f} ms '
            f'unprofiled wall: idle share {1 - busy / (wall_s * 1e3):.3f}')
    for key, count, host_ms, device_ms in spans:
        device = f', device {device_ms:.3f} ms' if busy else ''
        say(phase, f'span {key} x{count}: host {host_ms:.3f} ms{device}')
    # the eight largest, then every cuFFT kernel
    shown = kernels[:8] + [k for k in kernels[8:] if re.search(
        'fft|radix', k[2], re.IGNORECASE)]
    for ms, count, key in shown:
        say(phase, f'{ms:9.3f} ms  x{count:<5d} {key[:90]}')


def main():
    card = probe()
    build_kernels()
    errors, times = kernels_vs_plain()
    goldens()
    workdir = os.path.join(HERE, 'build', 'chip_smoke_corpus')
    launches = {'viterbi_forward': 0, 'viterbi_backtrace': 0}
    try:
        entries = make_corpus(workdir)
        for features in ('mfcc', 'plp'):
            counts, _ = the_slice(card, entries, features)
            for name, count in counts.items():
                launches[name] += count
        frontends_pass(card, entries)
        cli_phase(workdir, entries)
        counts, chunk_errors = long_audio(card, workdir, entries)
        for name, count in counts.items():
            launches[name] += count
            errors[name] = max(errors[name], chunk_errors[name])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    replaces = {
        'viterbi_forward': 'shennong_tpu/ops/pallas_viterbi.py:77',
        'viterbi_backtrace': 'shennong_tpu/ops/pallas_viterbi.py:183',
    }
    print(json.dumps({'kernels': [
        {'name': name, 'route': 'cuda',
         'source': 'shennong_tpu_torch/csrc/viterbi.cu',
         'replaces': replaces[name], 'launches': launches[name],
         'max_abs_err': errors[name], 'ms': times[name][0],
         'plain_ms': times[name][1]}
        for name in ('viterbi_forward', 'viterbi_backtrace')]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
