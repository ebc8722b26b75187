"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``shennong_tpu_torch`` from the sources in
this checkout (one nvcc for each source, started together), holds each
against its plain PyTorch version on the card (the pitch Viterbi at
the corpus batch [64, 598, 417], edge shapes, the chunk shape of
hour-scale pitch and the 12-minute whole run [1, 71998, 417]; the
banded Viterbi of the CREPE device decode at its slice shape [33, 490,
360], [16, 1024, 360] and [1, 8192, 360], with each states-a-thread
variant and its forward timed apart from its backtrace; the ABX
evaluator's DTW at the benchmark's [4096, 24, 24], with each
rows-a-lane variant, [512, 64, 64] and [1, 300, 280]; pass 2's kernel
at a test_clean CMVN group, a half-hour group and a delta window wider
than a tile, against its plain version on the CPU and on the card, bit
for bit), prints each kernel's cluster size, registers and spills,
milliseconds, time per frame, bound and share of the bound, times the
previous designs of the banded Viterbi and the DTW against this
checkout's in turns where their sources sit under
``build/ab_previous/`` (kept out of git), checks the processors
against ``tests/data/golden_real.npz`` and ``tests/kaldi_oracle.py``
(and, on the JAX suite's synthetic signal, the spectrogram's four
option sets against the oracle and ``tests/data/golden.npz``, and the
Kaldi pitch post-processing's batched route against its single one,
bit for bit), and drives the port's paths over a generated corpus of
256 utterances (4 s and 6 s, 16 speakers):

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
  mixed-sample-rate paths on the card against the CPU;
- the host layer around the device (``host plane``): the counters of
  one MFCC slice run (``njobs=4``) checked against its 4 batches, the
  upload pool's peak over that run, over a corpus of 21 batches in
  three signal buckets and over the long-audio run against the most
  buffers the plan's batch shapes allow, a ``profiler.trace`` file that
  names both Viterbi kernels and the ``pass2`` span, the share of pass
  2 that ran before pass 1's last wait ended, and ``speech-features-torch
  warmup`` then a warmed and a cold first ``extract_features`` in fresh
  processes (``python3 chip_smoke.py --first-call warm|cold
  DIRECTORY``), their features against this process's;
- the VTLN slice (BASELINE config 4): ``extract_features`` with the
  MFCC + Kaldi pitch + CMVN + delta configuration and a ``vtln``
  section at full width (a 64-component UBM, 41 warp classes, 15
  rounds, by speaker), its wall split into the training's stages, its
  corpus uploads counted, and the trained UBM, transforms, warps and
  features on the card against the CPU on 16 utterances of 4 speakers;
- multi-process extraction and training (``parallel/distributed.py``):
  two processes on the card over gloo, spawned as ``python3
  chip_smoke.py --worker RANK DIRECTORY``, run the main path over the
  corpus (its speakers relabelled to span both processes) and the VTLN
  training at full width on the training half of the ABX 'full'
  benchmark (speakers with vocal-tract factors); their features
  against the single-process card run (1e-5, lags equal or proven
  ties), their models the same bits, the warps against the single
  process (equal or proven ties), the UBM and the transforms within
  2e-3; walls, and the collectives per EM iteration and per LVTLN
  round;
- the CREPE slice (BASELINE config 3 with CREPE 'tiny' pitch): MFCC +
  CREPE pitch + CMVN + delta over the corpus with the float64 host
  decode (cold run, 5 warm runs, peak memory, a profiled run with the
  CNN's device time and the decode's host time), then with the device
  decode, whose banded Viterbi kernel must launch, against the host
  decode; the card against the CPU on 8 utterances (argmax bins equal
  but at near-ties of the salience); the 12-minute WAV through the
  chunked path;
- the CREPE CNN at the 'full' widths with seeded weights: TFLOP/s and
  the card against the CPU;
- bottleneck features (BASELINE config 5) with seeded weights at
  BabelMulti's widths: ``process_all`` over the corpus (profiled:
  host front end, device forward), ``extract_features`` with CMVN on
  16 utterances, and the card against the CPU on 8 utterances;
- the ABX benchmark (``eval/abx_bench.py``, the port's quality
  anchor): 'ci' with mfcc and rastaplp on the card and on the CPU
  (errors against each other and the recorded values, warps), then
  'full' mfcc on the card (its wall by stage, DTW pairs a second, the
  mfcc row against ``doc/performance.md``, a profiled run);
- the examples (``examples/torch/``): ``extract_features`` with
  ``fetch_dtype`` 'float16' and 'bfloat16' against 'float32' (bytes
  down, largest gap), then every card-runnable script called in this
  process -- ``extract_corpus`` and ``vtln_warps`` on the corpus,
  ``serve_throughput`` at batches of 16 and 64, ``long_audio``,
  ``training_bench``, ``features_abx`` on 200 synthetic utterances,
  ``abx_benchmark`` 'ci', ``abx_score``, ``pitch_comparison``, the
  features of ``plot_features``, ``multihost_cmvn`` (two processes on
  cuda:0) and ``sustained_scale`` at 1 h -- each output held against
  the library calls it wraps with every random source at 0, and the
  kernel launches of each counted from 0.

``python3 chip_smoke.py --spectrogram-pass ROOT DIRECTORY`` runs the
spectrogram pass alone with the package of the checkout at ROOT (two
commits timed in turns in one call); ``python3 chip_smoke.py
--pass-two`` builds the kernels and runs the pass-2 kernel's phase
alone.

The three Kaldi-pitch slices, the long-audio run, each process of the
multi-process run and the examples with Kaldi pitch must go through both
pitch Viterbi kernels (the MFCC and RASTA-PLP slices through the pass-2
kernel too, once a speaker and run), the CREPE device decode through the
banded one, the ABX runs and ABX examples through the DTW kernel. Every
phase prints its lines; any failure raises and the script exits
non-zero. The second-to-last lines are the kernels' JSON record and the
card's name and power limit; the last line is the JSON verdict.

Exits non-zero without a result when no CUDA device is available.
Imports nothing of JAX.
"""

import contextlib
import copy
import ctypes
import dataclasses
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
VTLN_RUNS = 3            # timed runs of the VTLN slice
MODEL_TOL = 2e-3         # cuda vs cpu on the trained UBM and transforms
TIE_TOL = 1e-4           # relative objective gap of two tied warp classes


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


def kernel_device_ms(fn, repeats, kernel, attempts=3):
    """Mean device milliseconds a launch of the kernels whose name holds
    ``kernel`` over ``repeats`` calls of ``fn()`` (torch.profiler, after
    one warm-up call): the kernel alone, where CUDA events around the
    calls would also time the host's enqueue of a short kernel. The
    profiler can lose a launch's record (it saw 18 of 20 once on the
    H100): a window that did not record every launch is profiled again,
    up to ``attempts`` windows, and none counts unless it saw them
    all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    marker = torch.zeros(1, device='cuda')
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a kernel of another name opens and closes the window: the
            # profiler has dropped the record of a window's first launch
            marker.add_(1)
            for _ in range(repeats):
                fn()
            marker.add_(1)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and kernel in e.key]
        count = sum(e.count for e in events)
        if count == repeats:
            break
        say('profiler', f'window {attempt + 1} saw {count} launches of '
            f'{kernel}, not {repeats}')
    check(count == repeats, f'the profiler saw {count} launches of {kernel}, '
          f'not {repeats}, in each of {attempts} windows')
    return sum(e.self_device_time_total for e in events) / 1e3 / count


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

#: the H100 SXM's published peaks (NVIDIA's data sheet): float32 outside
#: the tensor cores, and HBM3 bandwidth
PEAK_FLOPS_FP32 = 67e12
PEAK_BYTES = 3.35e12


#: the previous designs' sources of the banded Viterbi and the DTW, for
#: their A/B against this checkout's (kept out of git; the A/B is
#: skipped where they are absent)
AB_SOURCES = os.path.join(HERE, 'build', 'ab_previous')


def kernel_resources(log):
    """ptxas's (registers, spill stores, spill loads) by kernel
    instantiation in an nvcc log, e.g. 'viterbi_forward<7>',
    'banded_viterbi<3,11>' (states a thread, halfwidth held in
    registers or 0), 'dtw_staged<1,1>' (rows a lane, lane 0 reading the
    row above from an idle lane), 'dtw_strip', and the previous
    designs' 'banded_viterbi' and 'dtw', and 'pass_two<f,f>' (the
    features' and the output's types)."""
    resources = {}
    current, spills = None, (0, 0)
    for line in log.splitlines():
        entry = re.search(
            r'(viterbi_(?:forward|backtrace))_kernelILi(\d+)E', line)
        banded = re.search(r'banded_viterbi_kernelILi(\d+)ELi(\d+)E', line)
        staged = re.search(r'dtw_kernel_stagedILi(\d+)ELb([01])E', line)
        packed = re.search(r'pass_two_kernelI([fd])([fd])E', line)
        if entry:
            current = f'{entry.group(1)}<{entry.group(2)}>'
        elif banded:
            current = f'banded_viterbi<{banded.group(1)},{banded.group(2)}>'
        elif 'banded_viterbi_kernel' in line:
            current = 'banded_viterbi'
        elif staged:
            current = f'dtw_staged<{staged.group(1)},{staged.group(2)}>'
        elif packed:
            current = 'pass_two<{},{}>'.format(*packed.groups())
        elif 'dtw_kernel_strip' in line:
            current = 'dtw_strip'
        elif 'dtw_kernel' in line:
            current = 'dtw'
        spill = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', line)
        if spill:
            spills = (int(spill.group(1)), int(spill.group(2)))
        used = re.search(r'Used (\d+) registers', line)
        if used and current:
            resources[current] = (int(used.group(1)),) + spills
            current = None
    return resources


def build_kernels():
    """Build csrc/viterbi.cu, csrc/banded_viterbi.cu, csrc/dtw.cu and
    csrc/pass_two.cu afresh, and the previous sources under AB_SOURCES
    where present, one nvcc for each source, started together; returns
    ptxas's (registers, spill stores, spill loads) by kernel
    instantiation of this checkout (:func:`kernel_resources`) and, under
    'previous', those of the previous designs and their library paths
    (or None)."""
    import concurrent.futures

    from shennong_tpu_torch.ops import cuda_viterbi, dtw, pass_two, viterbi

    start = time.perf_counter()
    sources = [cuda_viterbi._SOURCE, viterbi._SOURCE, dtw._SOURCE,
               pass_two._SOURCE]
    current = len(sources)
    old = [os.path.join(AB_SOURCES, name)
           for name in ('banded_viterbi.cu', 'dtw.cu')]
    if all(os.path.isfile(path) for path in old):
        sources += old
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(
            lambda source: cuda_viterbi.build(source, fresh=True), sources))
    cuda_viterbi._load()
    viterbi._load()
    dtw._load()
    pass_two._load()
    seconds = time.perf_counter() - start
    say('build', ', '.join(os.path.relpath(path, HERE) for path, _ in built)
        + f' in {seconds:.2f} s (one nvcc each, in parallel)')
    resources = {}
    for _, log in built[:current]:
        resources.update(kernel_resources(log))
    for name in ('banded_viterbi<3,11>', 'dtw_staged<1,1>', 'dtw_strip',
                 'pass_two<f,f>'):
        check(name in resources, f'no ptxas resources for {name}')
    resources['previous'] = None
    if len(built) > current:
        resources['previous'] = {
            'libraries': [path for path, _ in built[current:]]}
        for _, log in built[current:]:
            resources['previous'].update(kernel_resources(log))
    for name, value in sorted(
            (k, v) for k, v in resources.items() if k != 'previous'):
        registers, stores, loads = value
        say('build', f'ptxas {name}: {registers} registers, spill stores '
            f'{stores} B, spill loads {loads} B')
    if resources['previous']:
        for name in ('banded_viterbi', 'dtw'):
            registers, stores, loads = resources['previous'][name]
            say('build', f'ptxas previous {name}: {registers} registers, spill '
                f'stores {stores} B, spill loads {loads} B')
    else:
        say('build', f'no previous sources under {AB_SOURCES}: the A/B '
            'against them is skipped')
    return resources


# ---------------------------------------------------------- kernel vs plain

def instantiation(name, shape):
    """The kernel template instantiation, and the forward's cluster
    size, that the wrappers launch at ``shape``."""
    from shennong_tpu_torch.ops import cuda_viterbi

    if name == 'viterbi_forward':
        plan = cuda_viterbi.forward_plan(shape[0], shape[2], 'cuda')
        return f"{name}<{plan['lanes_lags']}>", plan['clusters']
    per_lane = -(-shape[2] // 32)
    width = next((k for k in (1, 2, 4, 8, 16) if per_lane <= k), 0)
    return f'{name}<{width}>', 1


def bound(name, shape, bounds):
    """(ms, 'operations' or 'bytes'): the least time an H100 SXM could
    take for the function on this run's data. Forward: an add and a
    min per lag pair of each computed frame; bytes, the costs of the
    computed frames read once and the history written once. Backtrace:
    the history rows it reads once and the lags written once (its
    add and compare per lag are far below)."""
    bsz, frames, lags = shape
    last = [min(max(n, 1), frames) for n in bounds]
    steps = sum(n - 1 for n in last)
    if name == 'viterbi_forward':
        ops = 2 * steps * lags * lags
        nbytes = 4 * (sum(last) * lags + frames * bsz * lags + bsz)
    else:
        ops = 2 * steps * lags
        nbytes = 4 * (sum(last) * lags + frames * bsz + bsz)
    by_ops, by_bytes = ops / PEAK_FLOPS_FP32, nbytes / PEAK_BYTES
    if by_ops >= by_bytes:
        return by_ops * 1e3, 'operations'
    return by_bytes * 1e3, 'bytes'


def hold_kernels(shape, bounds, rng, errors, repeats=3, factor=None):
    """Both kernels against their plain versions on random costs of
    ``shape``, row ``i`` holding ``bounds[i]`` frames: the forward
    history bit-equal over each row's valid frames, the lags equal, and
    ``repeats`` more launches of each equal to the first. ``factor`` is
    the inter-frame factor (None: the default pitch options'). The
    max-abs errors go into ``errors``; returns (cost, counts, history)
    for timing."""
    from shennong_tpu_torch.ops import cuda_viterbi
    from shennong_tpu_torch.ops.pitch import PitchOpts, inter_frame_factor

    if factor is None:
        factor = inter_frame_factor(PitchOpts())
    cost = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda()
    counts = torch.tensor(bounds, dtype=torch.int32, device='cuda')
    hist = cuda_viterbi.viterbi_forward(cost, counts, factor)
    plain = cuda_viterbi.viterbi_forward_plain(cost, counts, factor)
    best = cuda_viterbi.viterbi_backtrace(hist, counts, factor)
    best_plain = cuda_viterbi.viterbi_backtrace_plain(plain, counts, factor)
    torch.cuda.synchronize()
    for row, bound_ in enumerate(bounds):
        # frame 0 is computed even for empty rows
        valid = max(bound_, 1)
        mine, ref = hist[:valid, row], plain[:valid, row]
        check(torch.equal(mine, ref),
              f'forward history differs at {shape} row {row}')
        errors['viterbi_forward'] = max(
            errors['viterbi_forward'], float((mine - ref).abs().max()))
        check(torch.equal(best[:bound_, row], best_plain[:bound_, row]),
              f'backtrace lags differ at {shape} row {row}')
        if bound_:
            errors['viterbi_backtrace'] = max(
                errors['viterbi_backtrace'],
                float((best[:bound_, row] - best_plain[:bound_, row])
                      .abs().max()))
    for _ in range(repeats):
        check(torch.equal(
            cuda_viterbi.viterbi_forward(cost, counts, factor), hist),
            f'forward history changed between launches at {shape}')
        check(torch.equal(
            cuda_viterbi.viterbi_backtrace(hist, counts, factor), best),
            f'backtrace lags changed between launches at {shape}')
    return cost, counts, hist


def time_kernels(phase, shape, bounds, cost, counts, hist, resources,
                 plain_repeats, factor=None):
    """Kernel (and, with plain_repeats, plain) milliseconds of both
    kernels (CUDA events), each printed with its cluster size, ptxas
    resources, microseconds per frame, bound and share of the bound;
    returns name -> (ms, plain_ms or None, bound_ms, bound_by)."""
    from shennong_tpu_torch.ops import cuda_viterbi
    from shennong_tpu_torch.ops.pitch import PitchOpts, inter_frame_factor

    if factor is None:
        factor = inter_frame_factor(PitchOpts())
    launch = {
        'viterbi_forward': (cuda_viterbi.viterbi_forward,
                            cuda_viterbi.viterbi_forward_plain, cost),
        'viterbi_backtrace': (cuda_viterbi.viterbi_backtrace,
                              cuda_viterbi.viterbi_backtrace_plain, hist),
    }
    times = {}
    for name, (kernel, plain, first) in launch.items():
        ms = cuda_ms(lambda: kernel(first, counts, factor), 10)
        plain_ms = cuda_ms(lambda: plain(first, counts, factor),
                           plain_repeats) if plain_repeats else None
        bound_ms, bound_by = bound(name, shape, bounds)
        kind, clusters = instantiation(name, shape)
        registers, stores, loads = resources[kind]
        plain_text = (f', plain {plain_ms:.3f} ms' if plain_ms is not None
                      else '')
        say(phase, f'{name} at {shape}: kernel {ms:.3f} ms '
            f'({ms * 1e3 / shape[1]:.3f} us per frame){plain_text} (CUDA '
            f'events); {kind}, cluster {clusters}, {registers} registers, '
            f'spills {stores}/{loads} B; bound {bound_ms:.4f} ms by '
            f'{bound_by}, share of bound {bound_ms / ms:.3f}')
        times[name] = (ms, plain_ms, bound_ms, bound_by)
    return times


def kernels_vs_plain(resources):
    """Every kernel against its plain version on the card, at the main
    path's shape and at edge shapes (lags not divisible by the cluster
    size, one long row, rows of 0 and 1 frames); timed at the main
    path's shape."""
    from shennong_tpu_torch.ops import cuda_viterbi
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
        ((20, 50, 7), [50 - n for n in range(20)]),
        ((4, 20, 33), [20, 0, 1, 7]),
        ((8, 30, 417), [30, 0, 1, 30, 29, 2, 30, 15]),
        ((6, 40, 417), [40, 0, 1, 2, 39, 40]),
        ((3, 1, 417), [1, 0, 1]),
        ((1, 20000, 417), [20000]),
    ]
    lib = cuda_viterbi._load()
    room = []
    for size in range(1, cuda_viterbi.MAX_CLUSTER + 1):
        count = ctypes.c_int()
        check(lib.shennong_viterbi_forward_max_clusters(
            417, size, ctypes.byref(count)) == 0, 'occupancy query failed')
        room.append(count.value)
    say('kernels', 'forward clusters the card holds at once (one block '
        f'per SM), by cluster size 1..{cuda_viterbi.MAX_CLUSTER}: {room}')
    errors = {'viterbi_forward': 0.0, 'viterbi_backtrace': 0.0}
    for shape, bounds in cases:
        held = hold_kernels(shape, bounds, rng, errors)
        if shape == main[0]:
            timed = held
        _, clusters = instantiation('viterbi_forward', shape)
        say('kernels', f'{shape}, nframes from {min(bounds)} to '
            f'{max(bounds)}, cluster {clusters}: history bit-equal, lags '
            'equal, repeated launches equal')
    times = time_kernels('kernels', main[0], main[1], *timed, resources,
                         plain_repeats=3)
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
    synthetic_goldens()


def make_speech_like_signal(nsamples, sample_rate, seed=0):
    """A copy of ``tests/conftest.py:make_speech_like_signal`` (which
    imports jax, absent on the card; ``tests/test_torch_ref_golden.py``
    holds the two equal): voiced harmonics with a wandering F0,
    formant-shaped noise bursts and silences, the first 0.1 s near
    digital silence."""
    rng = np.random.RandomState(seed)
    t = np.arange(nsamples) / sample_rate
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    voiced = sum(
        (0.6 ** k) * np.sin((k + 1) * phase) for k in range(8))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t - 0.5))
    envelope = envelope ** 2
    envelope[: int(0.05 * sample_rate)] = 0
    noise = rng.randn(nsamples) * 0.02
    noise[: int(0.1 * sample_rate)] *= 1e-2
    signal = voiced * envelope * 0.4 + noise
    signal = signal / np.max(np.abs(signal)) * 0.7
    return (signal * 2 ** 15 * 0.8).astype(np.int16)


#: the option sets of tests/processor/test_spectral.py's oracle cases
SPECTROGRAM_OPTIONS = (
    {}, {'raw_energy': False}, {'window_type': 'hanning'},
    {'energy_floor': 1e4})


def synthetic_goldens(device='cuda'):
    """The JAX suite's synthetic signal (``audio`` of tests/conftest.py,
    22713 samples opening with near-digital silence) on ``device`` (the
    card; ``python3 -c "import chip_smoke;
    chip_smoke.synthetic_goldens('cpu')"`` runs it on the CPU): the
    spectrogram of the four option sets of its oracle cases against
    ``tests/kaldi_oracle.py`` and the default one against
    ``tests/data/golden.npz``, each under 1e-3 (ROADMAP C7); and the
    Kaldi pitch post-processing of two utterances of different lengths
    (the signal and its first 12000 samples), its batched route equal
    to its single route bit for bit (ROADMAP C8)."""
    from shennong_tpu_torch import Audio, FeaturesCollection
    from shennong_tpu_torch.processor.pitch_kaldi import (
        KaldiPitchPostProcessor, KaldiPitchProcessor)
    from shennong_tpu_torch.processor.spectrogram import (
        SpectrogramProcessor)

    from tests import kaldi_oracle

    signal = make_speech_like_signal(22713, RATE)
    audio = Audio(signal, RATE)
    golden = np.load(os.path.join(HERE, 'tests', 'data', 'golden.npz'))
    for options in SPECTROGRAM_OPTIONS:
        ours = SpectrogramProcessor(dither=0, **options).process(
            audio, device=device).data
        references = {'the Kaldi oracle': kaldi_oracle.spectrogram(
            signal.astype(np.float64),
            raw_energy=options.get('raw_energy', True),
            window_type=options.get('window_type', 'povey'),
            energy_floor=options.get('energy_floor', 0.0))}
        if not options:
            references['golden.npz'] = golden['spectrogram']
        for what, ref in references.items():
            check(ours.shape == ref.shape,
                  f'spectrogram {options}: shape {ours.shape} != '
                  f'{ref.shape}')
            diff = np.abs(ours - ref)
            frame, column = np.unravel_index(diff.argmax(), diff.shape)
            check(diff.max() < GOLDEN_TOL,
                  f'synthetic spectrogram {options}: max-abs {diff.max()} '
                  f'against {what} at frame {frame}, bin {column}')
            say('goldens', f'synthetic spectrogram {options} {ours.shape}: '
                f'max-abs {diff.max():.4g} against {what} (worst at frame '
                f'{frame}, bin {column}) < {GOLDEN_TOL}')

    raws = {
        name: KaldiPitchProcessor().process(Audio(data, RATE), device=device)
        for name, data in (('whole', signal), ('short', signal[:12000]))}
    post = KaldiPitchPostProcessor(
        delta_pitch_noise_stddev=0, add_raw_log_pitch=True)
    batched = post.process_collection(
        FeaturesCollection(raws), device=device)
    for name, raw in raws.items():
        single = post.process(raw, device=device)
        check(np.array_equal(batched[name].data, single.data),
              f'pitch post {name}: process_collection != process')
        say('goldens', f'pitch post-processing {name} {single.shape}: '
            'process_collection equals process bit for bit')


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


@contextlib.contextmanager
def energy_dither_off():
    """The energy VAD's default dither of 1.0 set to 0 (the pipeline
    configuration has no knob for it)."""
    from shennong_tpu_torch.processor import energy as energy_module

    defaults = energy_module.EnergyProcessor.__init__.__defaults__
    energy_module.EnergyProcessor.__init__.__defaults__ = (
        defaults[:3] + (0.0,) + defaults[4:])
    try:
        yield
    finally:
        energy_module.EnergyProcessor.__init__.__defaults__ = defaults


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

    phase = f'{features} slice'
    config = slice_config(features)
    utterances = Utterances(entries)
    audio_seconds = sum(utt.duration for utt in utterances)

    # cold run over one batch: library load, cuFFT plans, allocator
    warm = Utterances(entries[:64])
    pipeline.extract_features(copy.deepcopy(config), warm, device='cuda')

    reset_counters()
    walls, features_out = warm_runs(config, utterances)
    launches = launch_counts(*VITERBI, 'pass_two')
    for name, count in launches.items():
        check(count > 0, f'the {phase} never launched {name}')
    # pass 2: one launch a CMVN group (a speaker) and run
    check(launches['pass_two'] == RUNS * NUM_SPEAKERS,
          f'the {phase} launched pass_two {launches["pass_two"]} times, not '
          f'{RUNS * NUM_SPEAKERS}')

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


def pitch_batched(utterances, device, **options):
    """Raw Kaldi pitch as the fused and stage-wise pass 1 compute it:
    in padded length-sorted batches (one sample rate). ``options`` are
    the pitch processor's (the defaults when none)."""
    from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchProcessor

    raw = KaldiPitchProcessor(**options).process_all(
        utterances, device=device)
    return {name: raw[name].data for name in raw}


def pitch_per_utterance(utterances, device, **options):
    """Raw Kaldi pitch as the per-utterance pass 1 computes it."""
    from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchProcessor

    raw = {}
    for utt in utterances:
        audio = utt.load_audio()
        raw[utt.name] = KaldiPitchProcessor(
            sample_rate=audio.sample_rate, **options).process(
                audio, device=device).data
    return raw


def cuda_against_cpu(config, features, utterances, raw_pitch, warps=None,
                     pitch_options=None):
    """``extract_features`` on the card and on the CPU with every random
    source at 0 (the energy VAD's dither too): the max-abs between the
    two, under SLICE_TOL, and the count of utterances whose pitch lags
    differ, each difference a proven tie. ``raw_pitch(utterances,
    device)`` recomputes the raw pitch as the path under test does,
    batches included; ``pitch_options`` are the pitch options of
    ``config`` that differ from the defaults (the lag grid's
    ``min_f0``, ``max_f0``, ``delta_pitch``), for the witness. The
    witness of a tie is the float64 oracle
    (tests/pitch_oracle.py) up to ORACLE_SECONDS of audio and the
    float64 path costs of the port's whole-signal program
    (tests/lag_ties.py) past them, where the oracle's Python loops are
    too slow. Where lags differ, the two log-pitch columns, which move
    with the lag over their windows, are left out, and the POV is held
    at every frame: CUDA against the CPU where the lags agree, each
    against its own NCCF at the ties (the ballast-free NCCF of two tied
    lags can differ widely, as in unvoiced frames)."""
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchProcessor

    from tests.lag_ties import assert_ties
    from tests.pitch_oracle import assert_lag_decisions, process_pitch

    pitch_options = pitch_options or {}
    with energy_dither_off():
        on = {device: pipeline.extract_features(
            zero_randomness(copy.deepcopy(config), features), utterances,
            warps=warps, device=device)
            for device in ('cuda', 'cpu')}
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
                    rate=audio.sample_rate, **pitch_options)
                witness = 'the float64 oracle'
            else:
                assert_ties(
                    audio.astype(np.int16).data, KaldiPitchProcessor(
                        sample_rate=audio.sample_rate,
                        **pitch_options).options(),
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


# ---------------------------------------------------------- pitch options

#: (min_f0, max_f0, delta_pitch) over the pitch grid of
#: tests/test_fuzz_parity.py: the options that set the Viterbi's lag
#: count, 133 to 417
PITCH_GRID = tuple((low, high, step) for low in (50.0, 80.0)
                   for high in (300.0, 400.0) for step in (0.005, 0.01))
PITCH_LAGS = [133, 162, 181, 209, 266, 323, 360, 417]
PITCH_BATCH = 64         # utterances of the batched run: one batch
PITCH_SINGLES = 8        # of them, also run one at a time


def raw_against_cpu(utterances, ours, ref, options):
    """Raw pitch of the card against the CPU's, by utterance: the lags
    equal, with the NCCF within SLICE_TOL, or every differing lag a tie
    proven by the float64 oracle (which holds the NCCF within 1e-3 where
    the lags agree); returns the count of utterances with ties."""
    from tests.pitch_oracle import assert_lag_decisions

    ties = 0
    for utt in utterances:
        mine, cpu = ours[utt.name], ref[utt.name]
        check(mine.shape == cpu.shape, f'{utt.name}: raw pitch shapes '
              f'{mine.shape} and {cpu.shape}')
        if np.array_equal(mine[:, 1], cpu[:, 1]):
            gap = float(np.abs(mine[:, 0] - cpu[:, 0]).max(initial=0.0))
            check(gap < SLICE_TOL, f'{utt.name}: NCCF max-abs {gap}')
        else:
            audio = utt.load_audio()
            assert_lag_decisions(audio.data.astype(np.float64), mine, cpu,
                                 rate=audio.sample_rate, **options)
            ties += 1
    return ties


def pitch_options_phase(card, entries, resources, errors):
    """Kaldi pitch at every lag count of the fuzz grid, on the card. For
    each (min_f0, max_f0, delta_pitch) of PITCH_GRID:

    1. both Viterbi kernels against their plain versions on random
       costs [64, F, L] at the options' inter-frame factor (history
       bit-equal, lags equal, repeated launches equal; the max-abs into
       ``errors``), timed, with ``forward_plan``'s clusters and lags a
       lane;
    2. the MFCC slice with these pitch options over the first 64
       utterances of the corpus, one batch through the fused pass 1:
       a run whose kernel launches are counted from 0, then the card
       against the CPU with every random source at 0
       (:func:`cuda_against_cpu`: lags equal or proven ties, the POV
       and the features within SLICE_TOL);
    3. raw pitch per utterance on PITCH_SINGLES of them, against the
       CPU (:func:`raw_against_cpu`).

    Returns the Viterbi launches of step 2's counted runs."""
    import collections
    import functools

    from shennong_tpu_torch import Utterances, pipeline
    from shennong_tpu_torch.ops import cuda_viterbi
    from shennong_tpu_torch.ops.pitch import (
        inter_frame_factor, num_pitch_frames, select_lags)
    from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchProcessor

    phase = 'pitch options'
    begin = time.perf_counter()
    batch = Utterances(entries[:PITCH_BATCH])
    singles = Utterances(entries[:PITCH_SINGLES])
    rng = np.random.RandomState(1)
    launches = collections.Counter()
    lag_counts = []
    for low, high, step in PITCH_GRID:
        options = dict(min_f0=low, max_f0=high, delta_pitch=step)
        opts = KaldiPitchProcessor(**options).options()
        lags = len(select_lags(opts.min_f0, opts.max_f0, opts.delta_pitch))
        factor = inter_frame_factor(opts)
        frames = num_pitch_frames(int(DURATIONS[1] * RATE), opts)
        shape = (PITCH_BATCH, frames, lags)
        full = PITCH_BATCH // 2  # rows of every frame, then ragged ones
        bounds = [frames] * full + [
            int(n) for n in rng.randint(0, frames + 1, PITCH_BATCH - full)]
        held = hold_kernels(shape, bounds, rng, errors, factor=factor)
        plan = cuda_viterbi.forward_plan(PITCH_BATCH, lags, 'cuda')
        say(phase, f'{options}: {lags} lags; forward_plan at '
            f'[{PITCH_BATCH}, {frames}, {lags}]: cluster {plan["clusters"]}, '
            f'{plan["threads"]} threads, {plan["lanes_lags"]} lags a lane, '
            f'{plan["smem"]} B of shared memory; history bit-equal, lags '
            'equal, repeated launches equal')
        time_kernels(phase, shape, bounds, *held, resources,
                     plain_repeats=1, factor=factor)
        lag_counts.append(lags)

        config = slice_config('mfcc')
        config['pitch'].update(options)
        reset_counters()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = pipeline.extract_features(
            copy.deepcopy(config), batch, device='cuda')
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counted = launch_counts(*VITERBI)
        for name, count in counted.items():
            check(count > 0, f'the {phase} run at {lags} lags never launched '
                  f'{name}')
        launches.update(counted)
        check(len(out) == PITCH_BATCH and all(
            out[name].shape[1] == 42 and np.isfinite(out[name].data).all()
            for name in out), f'{lags} lags: bad outputs')
        worst, ties = cuda_against_cpu(
            config, 'mfcc', batch,
            functools.partial(pitch_batched, **options),
            pitch_options=options)
        single_ties = raw_against_cpu(
            singles, pitch_per_utterance(singles, 'cuda', **options),
            pitch_per_utterance(singles, 'cpu', **options), options)
        say(phase, f'{lags} lags: the MFCC slice on {PITCH_BATCH} utterances '
            f'(one batch, wall {wall:.3f} s, launches {counted}) against the '
            f'CPU: max-abs {worst:.3g} < {SLICE_TOL} ({ties} with proven lag '
            f'ties); per utterance on {PITCH_SINGLES}: lags equal or proven '
            f'ties ({single_ties} with ties)')
    check(sorted(lag_counts) == PITCH_LAGS,
          f'the grid gave lag counts {sorted(lag_counts)}, not {PITCH_LAGS}')
    say(phase, f'phase time {time.perf_counter() - begin:.1f} s')
    return dict(launches)


FRONTENDS = (('filterbank', True, 69), ('spectrogram', False, 257))


def frontends_pass(card, entries, passes=FRONTENDS):
    """The filterbank (CMVN + deltas, 69 columns) and spectrogram
    (CMVN, 257 columns) passes over the corpus: a cold run whose shapes
    and finiteness are checked, 5 timed warm runs and a profiled
    run."""
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch import pipeline

    utterances = Utterances(entries)
    audio_seconds = sum(utt.duration for utt in utterances)
    for features, delta, columns in passes:
        phase = f'{features} pass'
        config = pipeline.get_default_config(
            features, with_cmvn=True, with_delta=delta)
        reset_counters()
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
            f'launches {launch_counts(*VITERBI)}')
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


def long_audio(card, workdir, entries, resources):
    """Hour-scale audio and the stage-wise path on the card.

    1. ``extract_features`` (the MFCC slice) over one hour and 16
       corpus utterances: the stage-wise path, its chunked routes and
       both Viterbi kernels; shapes, finiteness, wall and xRT.
    2. A 12-minute utterance (71998 frames, past AUTO_CHUNK_FRAMES):
       auto-routed (chunked) ``process`` against forced-whole
       extraction for the six processors, dither 0.
    3. Both kernels against their plain versions at the chunk shape of
       hour-scale pitch, [8, 8400, 417], and at [1, 71998, 417].
    4. CUDA against the CPU on a stage-wise corpus and on a corpus of
       mixed sample rates with warps by speaker.

    Returns the Viterbi launches of step 1 and the kernels' max-abs
    errors of step 3.
    """
    from shennong_tpu_torch import Audio, Utterances
    from shennong_tpu_torch import pipeline

    phase = 'long audio'
    start = time.perf_counter()
    hour = write_wav(os.path.join(workdir, 'hour.wav'), 3600, seed=1000)
    say(phase, f'one hour of audio written in '
        f'{time.perf_counter() - start:.1f} s')

    config = slice_config('mfcc')
    utterances = Utterances([('hour', hour, 'spkH')] + entries[:16])
    audio_seconds = sum(utt.duration for utt in utterances)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    torch.cuda.synchronize()
    begin = time.perf_counter()
    out = pipeline.extract_features(
        copy.deepcopy(config), utterances, device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - begin
    launches = launch_counts(*VITERBI)
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
    errors = chunk_shape_kernels(phase, resources)

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
    from shennong_tpu_torch.ops import resample
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

    reset_counters()
    routed = proc.process(audio, device='cuda').data
    chunked_launches = launch_counts(*VITERBI)
    proc.AUTO_CHUNK_FRAMES = None
    reset_counters()
    whole = proc.process(audio, device='cuda').data
    whole_launches = launch_counts(*VITERBI)
    check(whole_launches == {'viterbi_forward': 1, 'viterbi_backtrace': 1},
          f'the whole pitch launched {whole_launches}')
    differ, margin, nccf = assert_ties(
        audio.data, proc.options(), routed, whole, 'cuda')
    say(phase, f'12 min pitch {routed.shape}: chunked (launches '
        f'{chunked_launches}) vs whole ([1, {whole.shape[0]}, 417]): '
        f'{differ} lags differ (largest tie margin {margin:.3g} < 1e-4), '
        f'NCCF max-abs {nccf:.3g} where they agree')


def chunk_shape_kernels(phase, resources):
    """Both kernels against their plain versions at the chunk shape of
    hour-scale pitch [8, 8400, 417], rows of full, partial and zero
    frames, and at the 12-minute whole run [1, 71998, 417]: the forward
    history bit-equal, the lags equal; kernel (and at the chunk shape
    plain) ms from CUDA events."""
    errors = {'viterbi_forward': 0.0, 'viterbi_backtrace': 0.0}
    for shape, bounds, plain_repeats in (
            ((8, 8400, 417), [8400, 8400, 8400, 8400, 5000, 1, 0, 2300], 2),
            ((1, 71998, 417), [71998], 0)):
        held = hold_kernels(shape, bounds, np.random.RandomState(8), errors,
                            repeats=1)
        say(phase, f'kernels at {shape}, nframes {bounds}: history '
            'bit-equal, lags equal, repeated launches equal')
        time_kernels(phase, shape, bounds, *held, resources,
                     plain_repeats=plain_repeats)
    cluster_sweep(phase)
    return errors


def cluster_sweep(phase):
    """The forward on one row of 8400 frames in clusters of several
    sizes: each history bit-equal to the wrapper's, and its time per
    frame as the arithmetic per block shrinks with the cluster."""
    from shennong_tpu_torch.ops import cuda_viterbi
    from shennong_tpu_torch.ops.pitch import PitchOpts, inter_frame_factor

    factor = cuda_viterbi._factor32(inter_frame_factor(PitchOpts()))
    lib = cuda_viterbi._load()
    shape = (1, 8400, 417)
    cost = torch.from_numpy(np.random.RandomState(9).rand(*shape).astype(
        np.float32)).cuda()
    counts = torch.full((1,), shape[1], dtype=torch.int32, device='cuda')
    reference = cuda_viterbi.viterbi_forward(cost, counts, factor)
    hist = torch.empty_like(reference)

    def launch(size):
        code = lib.shennong_viterbi_forward(
            cost.data_ptr(), counts.data_ptr(), hist.data_ptr(), *shape,
            factor, size, torch.cuda.current_stream().cuda_stream)
        check(code == 0, f'forward launch in clusters of {size}: {code}')

    for size in (1, 2, 4, 8, 9, 16):
        ms = cuda_ms(lambda: launch(size), 3)
        check(torch.equal(hist, reference),
              f'forward history differs in clusters of {size}')
        say(phase, f'viterbi_forward at {shape} in clusters of {size}: '
            f'{ms:.3f} ms ({ms * 1e3 / shape[1]:.3f} us per frame), history '
            'bit-equal')


# ------------------------------------------------------------ host plane

HOST_DEPTH = 2           # the fused executor's and the stream's depth
SPREAD_DURATIONS = (1.0, 1.5, 2.2)   # seconds: three signal buckets
SPREAD_BATCHES = 7       # batches of 64 of each duration


def make_spread_corpus(directory):
    """``SPREAD_BATCHES`` batches of 64 speech-like utterances of each of
    ``SPREAD_DURATIONS``, in turn: a plan of 21 batches over three
    signal buckets, more batches of each than the fused run holds at
    once. Returns the (name, path, speaker) entries."""
    import scipy.io.wavfile

    os.makedirs(directory, exist_ok=True)
    entries = []
    count = SPREAD_BATCHES * 64 * len(SPREAD_DURATIONS)
    for index in range(count):
        duration = SPREAD_DURATIONS[index % len(SPREAD_DURATIONS)]
        path = os.path.join(directory, f'spread{index:04d}.wav')
        scipy.io.wavfile.write(
            path, RATE, speech_like(int(duration * RATE), seed=10000 + index))
        entries.append((f'spread{index:04d}', path,
                        f'spk{index % NUM_SPEAKERS:02d}'))
    return entries


def pool_bound(shapes, itemsize=2):
    """The most bytes of batch buffers a fused run over a plan of
    batches of these shapes can hold (int16 (rows, samples) signals by
    default; ``itemsize`` 1 for the (bytes,) payloads of
    :func:`payload_shapes`): a buffer is made only when none of its
    shape is pooled, and at most 2 * depth + 1 batches are alive at once
    (depth decoding ahead, depth on the device, the one being
    dispatched), so each shape has at most that many buffers, and never
    more than its batches. The bound grows with the plan's shapes, not
    with its length."""
    import collections

    per_shape = collections.Counter(shapes)
    return sum(min(count, 2 * HOST_DEPTH + 1) * itemsize * math.prod(shape)
               for shape, count in per_shape.items())


def payload_shapes(utterances, fetch_dtype):
    """The (bytes,) shape of each batch's packed download in a fused run
    of the MFCC slice (:func:`slice_config`, batches of 64) over
    ``utterances``, from the plan: MFCC [rows, F, 13] and the
    post-processed pitch [rows, Fp, 3] in ``fetch_dtype``, the uint8 VAD
    [rows, F], where the batch's padded signal sets F and Fp."""
    from shennong_tpu_torch.ops.framing import (
        FrameOptions, bucket_size, num_frames)
    from shennong_tpu_torch.ops.pitch import PitchOpts, num_pitch_frames
    from shennong_tpu_torch.parallel import stream

    itemsize = torch.empty(0, dtype=getattr(torch, fetch_dtype)).itemsize
    shapes = []
    for chunk in stream.plan_batches(utterances, 64):
        samples = bucket_size(max(stream._scan_count(u) for u in chunk))
        frames = num_frames(samples, FrameOptions())
        pitch_frames = num_pitch_frames(samples, PitchOpts())
        shapes.append((len(chunk) * (frames * (13 * itemsize + 1)
                                     + pitch_frames * 3 * itemsize),))
    return shapes


def host_plane(card, workdir, entries):
    """The host layer around the device, on the MFCC slice:

    1. counters: one run with ``njobs=4``; one dispatch a batch, the
       int16 signals plus ``nsamples`` up, and decode, fetch and pass-2
       time above 0;
    2. the upload pool: its peak over that run on the process's pool
       (what earlier phases left pooled counts), then over a corpus of
       21 batches in three buckets and over the long-audio run (an hour
       and 16 utterances, the stage-wise path), each from a new pool,
       against :func:`pool_bound`;
    3. ``profiler.trace`` around one run: the file it wrote names both
       Viterbi kernels and the ``pass2`` span; the share of pass 2's
       host time that ran before the last ``pass1.wait`` ended;
    4. warm-up in fresh processes: the CLI's ``warmup``, then
       ``pipeline.warmup`` and a timed first ``extract_features``,
       then a cold first ``extract_features``; both outputs against
       this process's run, every random source at 0.

    Runs after the long-audio phase, whose hour it extracts again.
    Returns the Viterbi launches of its runs in this process.
    """
    import collections
    import glob

    from shennong_tpu_torch import FeaturesCollection, Utterances, pipeline
    from shennong_tpu_torch.ops import cuda_viterbi, dtw, viterbi
    from shennong_tpu_torch.ops.framing import bucket_size
    from shennong_tpu_torch.parallel import profiler, stream

    phase = 'host plane'
    begin = time.perf_counter()
    config = slice_config('mfcc')
    utterances = Utterances(entries)
    audio_seconds = sum(utt.duration for utt in utterances)
    launches = collections.Counter()

    def batch_shapes(utts, batch_size):
        return [(len(chunk), bucket_size(
            max(stream._scan_count(u) for u in chunk)))
            for chunk in stream.plan_batches(utts, batch_size)]

    def extract(utts, configuration=config, **kwargs):
        """One ``extract_features`` on the card, its launches counted
        from 0 just before it; returns (features, wall seconds)."""
        torch.cuda.synchronize()
        reset_counters()
        start = time.perf_counter()
        out = pipeline.extract_features(
            copy.deepcopy(configuration), utts, device='cuda', **kwargs)
        torch.cuda.synchronize()
        launches.update(launch_counts(*VITERBI))
        return out, time.perf_counter() - start

    # 1 and 2: the counters and the process's pool over one run, njobs=4
    shapes = batch_shapes(utterances, 64)
    largest = 2 * max(rows * samples for rows, samples in shapes)
    expected_up = 2 * sum(rows * samples for rows, samples in shapes) \
        + 4 * len(utterances)
    profiler.counters.reset()
    stream.pool_reset_peak()
    held = stream.pool_peak_bytes()  # what earlier phases left pooled
    _, wall = extract(utterances, njobs=4)
    snap = profiler.counters.snapshot()
    peak = stream.pool_peak_bytes()
    say(phase, f'counters of one MFCC slice run (njobs=4, wall {wall:.3f} '
        f's, xRT {audio_seconds / wall:.1f}): ' + ', '.join(
            f'{key} {snap[key]:.6g}' for key in sorted(snap)))
    check(snap.get('dispatches') == len(shapes) == 4,
          f'{snap.get("dispatches")} dispatches for {len(shapes)} batches')
    check(snap.get('bytes_up') == expected_up,
          f'bytes_up {snap.get("bytes_up")}, the batches hold {expected_up}')
    for key in ('decode_s', 'fetch_s', 'pass2_s'):
        check(snap.get(key, 0) > 0, f'counter {key} is not above 0')
    bound = held + pool_bound(shapes)
    say(phase, f'the process\'s upload pool over that run: {held} B held '
        f'at pool_reset_peak() (earlier phases), peak {peak} B, bound held '
        f'+ {pool_bound(shapes)} B ({(peak - held) / largest:.2f} batches '
        f'of {largest} B above what was held)')
    check(held <= peak <= bound, f'pool peak {peak} B past {bound} B')

    # the download payloads' pool (fetch_dtype's pinned uint8 buffers,
    # apart from pool_peak_bytes), from a new pool for each precision
    process_payloads = stream.payloads
    try:
        for fetch_dtype in ('float32', 'float16'):
            stream.payloads = stream._BufferPool(dtype=torch.uint8)
            taken, take = [], stream.payloads.take

            def recording(shape, take=take, taken=taken, **kwargs):
                taken.append(tuple(shape))
                return take(shape, **kwargs)

            stream.payloads.take = recording
            _, fetch_wall = extract(utterances, fetch_dtype=fetch_dtype)
            peak = stream.payloads.peak_bytes
            shapes = payload_shapes(utterances, fetch_dtype)
            check(sorted(taken) == sorted(shapes), f'{fetch_dtype} payloads '
                  f'of {taken} B, the plan gives {shapes}')
            bound = pool_bound(shapes, itemsize=1)
            say(phase, f'download payload pool over one MFCC slice run, '
                f'fetch_dtype {fetch_dtype} (wall {fetch_wall:.3f} s), from a '
                f'new pool: peak {peak} B ({peak / max(shapes)[0]:.2f} '
                f'payloads of the largest), bound {bound} B for '
                f'{len(shapes)} payloads of {sorted(set(shapes))} B')
            check(0 < peak <= bound, f'{fetch_dtype} payload pool peak '
                  f'{peak} B past {bound} B')
    finally:
        stream.payloads = process_payloads

    spread = Utterances(make_spread_corpus(os.path.join(workdir, 'spread')))
    shapes = batch_shapes(spread, 64)
    sizes = {2 * rows * samples for rows, samples in shapes}
    check(len(sizes) == len(SPREAD_DURATIONS)
          and len(shapes) == SPREAD_BATCHES * len(SPREAD_DURATIONS),
          f'the spread corpus plans {len(shapes)} batches of {len(sizes)} '
          'shapes')
    stream._pool = stream._BufferPool()
    out, spread_wall = extract(spread)
    peak = stream.pool_peak_bytes()
    check(sorted(out) == sorted(utt.name for utt in spread)
          and all(np.isfinite(out[name].data).all() for name in out),
          'the spread corpus misses utterances or has non-finite values')
    bound = pool_bound(shapes)
    corpus = 2 * sum(rows * samples for rows, samples in shapes)
    say(phase, f'upload pool peak over {len(spread)} utterances in '
        f'{len(shapes)} batches of {len(sizes)} shapes (wall '
        f'{spread_wall:.3f} s, xRT '
        f'{sum(utt.duration for utt in spread) / spread_wall:.1f}), from a '
        f'new pool: {peak} B ({peak / max(sizes):.2f} batches of the '
        f'largest, {peak / corpus:.3f} of the corpus\'s {corpus} B), bound '
        f'{bound} B')
    check(0 < peak <= bound < corpus,
          f'pool peak {peak} B past {bound} B (the corpus {corpus} B)')
    shutil.rmtree(os.path.join(workdir, 'spread'), ignore_errors=True)

    hour = Utterances([('hour', os.path.join(workdir, 'hour.wav'), 'spkH')]
                      + entries[:16])
    shapes = batch_shapes(list(hour)[1:], 16)
    stream._pool = stream._BufferPool()
    _, hour_wall = extract(hour)
    peak = stream.pool_peak_bytes()
    bound = pool_bound(shapes)
    say(phase, f'upload pool peak over the long-audio run (1 h + 16 '
        f'utterances, wall {hour_wall:.3f} s), from a new pool: {peak} B, '
        f'bound {bound} B')
    check(0 < peak <= bound, f'pool peak {peak} B past {bound} B')

    # 3: a trace file names the kernels and the pass2 span
    logdir = os.path.join(workdir, 'trace')
    shutil.rmtree(logdir, ignore_errors=True)
    with profiler.trace(logdir):
        extract(utterances)
    files = glob.glob(os.path.join(logdir, '*.pt.trace.json'))
    check(len(files) == 1, f'trace wrote {files}')
    with open(files[0]) as fp:
        events = json.load(fp)['traceEvents']
    names = {event.get('name', '') for event in events}
    for kernel in ('viterbi_forward_kernel', 'viterbi_backtrace_kernel'):
        check(any(kernel in name for name in names),
              f'the trace names no {kernel}')
    check('pass2' in names, 'the trace names no pass2 span')
    spans = [(event['ts'], event['ts'] + event['dur'], event['name'],
              event['tid']) for event in events
             if event.get('ph') == 'X' and event.get('name') in (
                 'pass2', 'pass1.wait')]
    last_wait = max(end for _, end, name, _ in spans
                    if name == 'pass1.wait')
    pass2 = [(s, e, tid) for s, e, name, tid in spans if name == 'pass2']
    total = sum(e - s for s, e, _ in pass2)
    before = sum(max(0.0, min(e, last_wait) - s) for s, e, _ in pass2)
    say(phase, f'trace {os.path.basename(files[0])} '
        f'({os.path.getsize(files[0]) / 2 ** 20:.1f} MiB): both Viterbi '
        f'kernels and {len(pass2)} pass2 spans on thread(s) '
        f'{sorted({tid for _, _, tid in pass2})}; pass2 host '
        f'{total / 1e3:.3f} ms, of which {before / 1e3:.3f} ms '
        f'({before / max(total, 1e-9):.3f}) before the last pass1.wait '
        f'ended')

    # 4: warm-up in fresh processes
    index = os.path.join(workdir, 'host_plane_index.txt')
    with open(index, 'w') as fp:
        for name, path, speaker in entries:
            fp.write(f'{name} {path} {speaker}\n')
    config_file = os.path.join(workdir, 'host_plane_config.yaml')
    with open(config_file, 'w') as fp:
        fp.write(pipeline.get_default_config(
            'mfcc', to_yaml=True, with_pitch='kaldi', with_cmvn=True,
            with_delta=True))
    built = all(os.path.isfile(cuda_viterbi.library_path(source))
                for source in (cuda_viterbi._SOURCE, viterbi._SOURCE,
                               dtw._SOURCE))
    say(phase, '_build/ was ' + (
        'warm: the kernel libraries of this checkout were there (this '
        'run built them), so the fresh processes load them and build '
        'nothing' if built else 'cold: a fresh process builds them'))
    start = time.perf_counter()
    line = subprocess.run(
        [sys.executable, '-m', 'shennong_tpu_torch.cli', 'warmup',
         '--device', 'cuda', '-j', '4', config_file, index],
        cwd=HERE, check=True, capture_output=True, text=True).stdout.strip()
    say(phase, f'speech-features-torch warmup --device cuda -j 4 (256 '
        f'utterances): "{line}", the process '
        f'{time.perf_counter() - start:.1f} s')
    check(line.startswith('warmed 2 pipeline geometries in '),
          f'warmup printed {line!r}')

    with energy_dither_off():
        reference, _ = extract(utterances, zero_randomness(
            copy.deepcopy(config), 'mfcc'))
    for mode in ('warm', 'cold'):
        for suffix in ('npz', 'json'):
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(workdir, f'{mode}.{suffix}'))
        start = time.perf_counter()
        subprocess.run(
            [sys.executable, os.path.join(HERE, 'chip_smoke.py'),
             '--first-call', mode, workdir],
            cwd=HERE, check=True)
        with open(os.path.join(workdir, f'{mode}.json')) as fp:
            timing = json.load(fp)
        out = FeaturesCollection.load(os.path.join(workdir, f'{mode}.npz'))
        check(sorted(out) == sorted(reference),
              f'the {mode} process misses utterances')
        worst = max(float(np.abs(out[name].data - reference[name].data)
                          .max()) for name in reference)
        check(worst == 0, f'the {mode} process against this one: max-abs '
              f'{worst}')
        warmed = (f'pipeline.warmup {timing["warmup_s"]:.3f} s '
                  f'({timing["geometries"]}), then ' if mode == 'warm'
                  else '')
        say(phase, f'{mode} process: {warmed}first extract_features '
            f'{timing["first_s"]:.3f} s (xRT '
            f'{audio_seconds / timing["first_s"]:.1f}), launches '
            f'{timing["launches"]}; the process '
            f'{time.perf_counter() - start:.1f} s; features equal to this '
            f'process\'s (max-abs {worst:g})')
    say(phase, f'phase time {time.perf_counter() - begin:.1f} s')
    return dict(launches)


def first_call(mode, directory):
    """A fresh process's first ``extract_features`` of the MFCC slice
    over the corpus index of :func:`host_plane` on the card, every
    random source at 0, after ``pipeline.warmup`` when ``mode`` is
    'warm'; writes ``<mode>.npz`` (the features) and ``<mode>.json``
    (the timings) into ``directory``."""
    from shennong_tpu_torch import Utterances, pipeline

    utterances = Utterances.load(
        os.path.join(directory, 'host_plane_index.txt'))
    config = zero_randomness(slice_config('mfcc'), 'mfcc')
    timing = {}
    with energy_dither_off():
        if mode == 'warm':
            warm = pipeline.warmup(copy.deepcopy(config), utterances,
                                   device='cuda')
            timing['warmup_s'] = warm['seconds']
            timing['geometries'] = warm['geometries']
        reset_counters()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = pipeline.extract_features(
            copy.deepcopy(config), utterances, device='cuda')
        torch.cuda.synchronize()
        timing['first_s'] = time.perf_counter() - start
        timing['launches'] = launch_counts(*VITERBI)
    out.save(os.path.join(directory, f'{mode}.npz'))
    with open(os.path.join(directory, f'{mode}.json'), 'w') as fp:
        json.dump(timing, fp)


def spectrogram_pass(root, directory):
    """``python3 chip_smoke.py --spectrogram-pass ROOT DIRECTORY``: the
    ``spectrogram pass`` phase alone, over a corpus written under
    DIRECTORY, with the ``shennong_tpu_torch`` of the checkout at ROOT
    (this one, or another commit unpacked under the ignored ``build/``):
    two versions timed in turns in one call, each in a fresh process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import shennong_tpu_torch

    package = os.path.dirname(os.path.abspath(shennong_tpu_torch.__file__))
    check(package == os.path.join(root, 'shennong_tpu_torch'),
          f'imported {package}, not the package under {root}')
    card = probe()
    say('spectrogram pass', f'package {package}')
    try:
        frontends_pass(card, make_corpus(directory), FRONTENDS[1:])
    finally:
        shutil.rmtree(directory, ignore_errors=True)


# ------------------------------------------------------------ VTLN slice

def vtln_config():
    """BASELINE config 4: MFCC + Kaldi pitch + CMVN + delta, with the
    warps trained by a 'vtln' section at the JAX package's defaults."""
    from shennong_tpu_torch import pipeline

    return pipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True,
        with_vtln='simple')


class UploadCounter:
    """Counts the signal batches decoded for an upload to the card
    (``parallel.stream.decode_batch``): a corpus whose sweeps share one
    SignalCache decodes each batch once."""

    def __init__(self):
        from shennong_tpu_torch.parallel import stream

        self.stream, self.count = stream, 0
        self.decode = stream.decode_batch

    def __enter__(self):
        def counted(*args, **kwargs):
            self.count += 1
            return self.decode(*args, **kwargs)
        self.stream.decode_batch = counted
        return self

    def __exit__(self, *exc):
        self.stream.decode_batch = self.decode


#: the stages of a VTLN slice run, each from the first start of its
#: span to the first start of the next one (the stages end on host
#: reads, so these intervals split the wall)
VTLN_PARTS = (
    ('UBM front-end', 'ubm.frontend'), ('UBM init EM', 'ubm.init'),
    ('UBM main EM, then the VTLN set-up', 'ubm.em'),
    ('warp moments (42 banks)', 'vtln.moments'),
    ('base-transform solve', 'vtln.solve'), ('gselect', 'vtln.gselect'),
    ('LVTLN rounds', 'vtln.rounds'),
    ('warped extraction (pass 1 + pass 2)', 'pass1.dispatch'))


def vtln_slice(card, entries):
    """The VTLN slice over the corpus: a cold run, VTLN_RUNS timed runs
    (launches, uploads, peak memory), the outputs and the 16 warps
    checked, a profiled run split into the training's stages, and the
    card against the CPU on 16 utterances of 4 speakers. Returns the
    Viterbi launches of the timed runs."""
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch import pipeline

    phase = 'vtln slice'
    begin = time.perf_counter()
    config = vtln_config()
    utterances = Utterances(entries)
    audio_seconds = sum(utt.duration for utt in utterances)
    vtln = config['vtln']
    say(phase, f"{vtln['ubm']['num_gauss']}-component UBM "
        f"({vtln['ubm']['num_iters_init']} init + {vtln['ubm']['num_iters']} "
        f"EM iterations), warps {vtln['min_warp']} to {vtln['max_warp']} by "
        f"{vtln['warp_step']}, {vtln['num_iters']} LVTLN iterations, "
        f"norm {vtln['norm_type']}, by speaker")

    torch.cuda.synchronize()
    start = time.perf_counter()
    pipeline.extract_features(copy.deepcopy(config), utterances,
                              device='cuda')
    torch.cuda.synchronize()
    cold = time.perf_counter() - start

    reset_counters()
    walls, peaks = [], []
    with UploadCounter() as uploads:
        for _ in range(VTLN_RUNS):
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = pipeline.extract_features(
                copy.deepcopy(config), utterances, device='cuda')
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    launches = launch_counts(*VITERBI)
    for name, count in launches.items():
        check(count > 0, f'the {phase} never launched {name}')
    batches = -(-NUM_UTTERANCES // 64)
    check(uploads.count == VTLN_RUNS * batches,
          f'{uploads.count} batch uploads in {VTLN_RUNS} runs, not '
          f'{batches} per run: the sweeps do not share one SignalCache')

    check(len(out) == NUM_UTTERANCES, f'{len(out)} outputs')
    warps = {}
    for utt in utterances:
        feats = out[utt.name]
        nsamples = int(round(utt.duration * RATE))
        check(feats.shape == (expected_frames(nsamples), 42),
              f'{utt.name}: shape {feats.shape}')
        check(np.isfinite(feats.data).all(), f'{utt.name}: non-finite')
        warp = feats.properties['mfcc']['vtln_warp']
        check(warps.setdefault(utt.speaker, warp) == warp,
              f'{utt.name}: warp {warp} is not its speaker\'s')
    check(len(warps) == NUM_SPEAKERS, f'{len(warps)} speaker warps')
    last = round((vtln['max_warp'] - vtln['min_warp']) / vtln['warp_step'])
    for speaker, warp in warps.items():
        index = round((warp - vtln['min_warp']) / vtln['warp_step'])
        check(0 <= index <= last and abs(
            vtln['min_warp'] + index * vtln['warp_step'] - warp) < 1e-12,
            f'{speaker}: warp {warp} is off the {last + 1}-class grid')
    seconds = float(np.median(walls))
    say(phase, f'{NUM_UTTERANCES} utterances ({audio_seconds:.0f} s of '
        f'audio, {NUM_SPEAKERS} speakers): cold run {cold:.3f} s; '
        f'{VTLN_RUNS} timed runs: wall median {seconds:.4f} s (min '
        f'{min(walls):.4f}, max {max(walls):.4f}), xRT median '
        f'{audio_seconds / seconds:.1f} on {card}; peak device memory '
        f'{max(peaks):.2f} GiB; corpus uploads {uploads.count // VTLN_RUNS} '
        f'batches of 64 per run ({batches} batches: the UBM front-end, the '
        f'warp moments and pass 1 share them); launches {launches}')
    say(phase, f'warps by speaker, on the {last + 1}-class grid: '
        + ', '.join(f'{spk} {warps[spk]:.2f}' for spk in sorted(warps)))
    profile_layers(phase, config, utterances, seconds, parts=VTLN_PARTS)
    vtln_against_cpu(phase, config, entries)
    say(phase, f'phase time {time.perf_counter() - begin:.1f} s')
    return launches


def vtln_trainer(config, device):
    """The VTLN trainer of ``config``'s section and its UBM, every
    random source at 0 (dither off; the UBM's draws from its seed)."""
    from shennong_tpu_torch.processor.ubm import DiagUbmProcessor
    from shennong_tpu_torch.processor.vtln import VtlnProcessor

    params = copy.deepcopy(config['vtln'])
    ubm_params = params.pop('ubm')
    vtln = VtlnProcessor(**params)
    vtln.features['mfcc']['dither'] = 0
    ubm_params['features'] = copy.deepcopy(vtln.features)
    return vtln, DiagUbmProcessor(**ubm_params)


def class_objective(stats, group, base, norm_type, classes):
    """The fMLLR objective of ``group`` at each of ``classes`` (float64,
    Kaldi LinearVtln::ComputeTransform) from the final round's
    statistics (beta [S], K [S, D, D+1], G [S, D, D+1, D+1])."""
    from shennong_tpu_torch.ops import fmllr

    beta, K, G = stats
    group_stats = fmllr.FmllrStats(K.shape[1])
    group_stats.beta = float(beta[group])
    group_stats.K, group_stats.G = K[group], G[group]
    solve = {'offset': fmllr.solve_offset, 'diag': fmllr.solve_diagonal}
    values = []
    for c in classes:
        moved = fmllr.apply_transform_to_stats(base[c], group_stats)
        secondary = (solve[norm_type](moved) if norm_type in solve
                     else np.concatenate(
                         [np.eye(moved.dim), np.zeros((moved.dim, 1))], 1))
        values.append(fmllr.auxf(secondary, moved))
    return values


def training_frames(config, utterances, cmvn, device='cpu'):
    """The VTLN training's selected frames (voiced, subsampled),
    computed on ``device``, float64 [N, D] on the host: with its sliding
    CMVN (the frames the speaker transforms act on) or without (the base
    transforms')."""
    from shennong_tpu_torch.processor import ubm as ubm_module

    vtln, ubm = vtln_trainer(config, device)
    features = copy.deepcopy(vtln.features)
    if not cmvn:
        del features['sliding_window_cmvn']
    flat, _, w_em, _, _ = ubm_module.stream_frontend(
        features, ubm.vad, vtln.subsample, utterances, device=device)
    return flat[w_em > 0].to(torch.float64).cpu().numpy()


def action_gap(ours, ref, frames):
    """How far two transforms (linear [D, D] or affine [D, D+1]) differ
    in what they do to ``frames``: the largest over output dimensions
    of the RMS over the frames of their difference, relative past 1 to
    the RMS of ``ref``'s output."""
    if ref.shape[1] > frames.shape[1]:
        frames = np.concatenate([frames, np.ones((len(frames), 1))], 1)
    diff = np.sqrt(((frames @ (ours - ref).T) ** 2).mean(axis=0))
    scale = np.sqrt(((frames @ ref.T) ** 2).mean(axis=0))
    return float((diff / np.maximum(1.0, scale)).max())


def vtln_against_cpu(phase, config, entries):
    """The UBM and the VTLN training on the card against the CPU on 16
    utterances of 4 speakers, every random source at 0: the warps equal
    or a proven tie (the two classes' objectives within TIE_TOL of each
    other on each device's final statistics), the UBM (trained, and
    after the rounds) within MODEL_TOL, the base and speaker transforms
    within MODEL_TOL in what they do to the training frames
    (:func:`action_gap`; their entries are printed too: the
    least-squares fit of the base transforms is ill-conditioned, so
    entries move where the frames have no variance), and the features
    of the warped extraction within SLICE_TOL where the warps are
    equal. Every difference is printed before any is checked."""
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch.ops import fmllr

    subset = Utterances([e for i, e in enumerate(entries) if i % 16 < 4][:16])
    solve = fmllr.solve_warp_classes
    trained = {}
    for device in ('cuda', 'cpu'):
        stats = []

        def recorded(beta, K, G, *args, **kwargs):
            stats[:] = [beta, K, G]
            return solve(beta, K, G, *args, **kwargs)

        vtln, ubm = vtln_trainer(config, device)
        start = time.perf_counter()
        fmllr.solve_warp_classes = recorded
        try:
            ubm.process(subset, device=device)
            ubm_gmm = copy.deepcopy(ubm.gmm)
            warps = vtln.process(subset, ubm=ubm, group_by='speaker',
                                 device=device)
        finally:
            fmllr.solve_warp_classes = solve
        trained[device] = dict(
            warps=warps, ubm=ubm_gmm, gmm=ubm.gmm, vtln=vtln,
            stats=[a.cpu().numpy().astype(np.float64) for a in stats],
            seconds=time.perf_counter() - start)

    gpu, cpu = trained['cuda'], trained['cpu']
    speakers = sorted(cpu['warps'])
    equal = [spk for spk in speakers if gpu['warps'][spk] == cpu['warps'][spk]]
    say(phase, f'cuda vs cpu, 16 utterances of 4 speakers, no randomness '
        f'(training {gpu["seconds"]:.2f} s on the card, {cpu["seconds"]:.2f} '
        f's on the CPU): warps {[gpu["warps"][s] for s in speakers]} and '
        f'{[cpu["warps"][s] for s in speakers]}, {len(equal)} of '
        f'{len(speakers)} equal')
    step = config['vtln']['warp_step']
    low = config['vtln']['min_warp']
    gaps = []
    for group, spk in enumerate(speakers):
        if spk in equal:
            continue
        classes = [round((run['warps'][spk] - low) / step)
                   for run in (gpu, cpu)]
        for name, run in (('cuda', gpu), ('cpu', cpu)):
            values = class_objective(
                run['stats'], group, run['vtln'].lvtln.transforms,
                config['vtln']['norm_type'], classes)
            gaps.append((spk, name, abs(values[0] - values[1])
                         / abs(values[1])))
            say(phase, f'{spk}: warps {gpu["warps"][spk]} (cuda) and '
                f'{cpu["warps"][spk]} (cpu), relative objective gap on the '
                f'{name} run\'s statistics {gaps[-1][2]:.3g} (a tie under '
                f'{TIE_TOL})')

    def worst(a, b):
        return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())

    errors = {}
    for stage in ('ubm', 'gmm'):
        for field in ('weights', 'means', 'inv_vars'):
            errors[f'{stage}.{field}'] = worst(
                getattr(gpu[stage], field), getattr(cpu[stage], field))
    base = gpu['vtln'].lvtln.transforms, cpu['vtln'].lvtln.transforms
    raw = training_frames(config, subset, cmvn=False)
    errors['base transforms on the frames'] = max(
        action_gap(ours, ref, raw) for ours, ref in zip(*base))
    normalized = training_frames(config, subset, cmvn=True)
    same = [utt for utt in subset if utt.speaker in equal]
    errors['speaker transforms on the frames'] = max(
        [action_gap(gpu['vtln'].transforms[utt.name],
                    cpu['vtln'].transforms[utt.name], normalized)
         for utt in same] + [0.0])
    say(phase, 'cuda vs cpu, max-abs (relative past 1): '
        + ', '.join(f'{k} {v:.3g}' for k, v in errors.items())
        + f'; the entries of the base transforms {worst(*base):.3g}, of '
        'the speaker transforms ' + '{:.3g}'.format(max(
            [worst(gpu['vtln'].transforms[utt.name],
                   cpu['vtln'].transforms[utt.name]) for utt in same]
            + [0.0])) + ' (the condition number of the unwarped frames\' '
        f'covariance, which the base fit inverts: '
        f'{np.linalg.cond(np.cov(raw, rowvar=False)):.3g})')
    for spk, name, gap in gaps:
        check(gap < TIE_TOL, f'{spk}: the warps are not tied on the {name} '
              f'run: relative objective gap {gap:.3g}')
    for name, err in errors.items():
        check(err < MODEL_TOL, f'cuda vs cpu {name}: {err} >= {MODEL_TOL}')

    same = Utterances([(u.name, u.audio_file, u.speaker) for u in same])
    check(len(same) > 0, 'every speaker\'s warps differ between devices')
    plain = copy.deepcopy(config)
    del plain['vtln']
    worst_feats, ties = cuda_against_cpu(
        plain, 'mfcc', same, pitch_batched,
        warps={spk: gpu['warps'][spk] for spk in equal})
    say(phase, f'cuda vs cpu, the warped extraction of the {len(same)} '
        f'utterances whose warps are equal: max-abs {worst_feats:.3g} < '
        f'{SLICE_TOL} ({ties} with proven lag ties)')


# ------------------------------------------------------------ distributed

DIST_WORLD = 2           # processes of the distributed phase, on one card
DIST_TIMEOUT = 120       # seconds, the timeout of their process group
DIST_WAIT = 600          # seconds, the phase's wait on its processes
DIST_TOL = 1e-5          # their features against the single process's
#: the VTLN training corpus: the training half of the ABX 'full'
#: benchmark (eval/abx_bench.py, seed 0), speakers with vocal-tract
#: factors 0.88 to 1.14
DIST_TRAINING = dict(nspeakers=20, nphones=10, train_tokens=3)


def distributed_entries(entries):
    """The corpus with its 16 speakers relabelled so that each spans
    both processes: the round-robin shards send the even utterances
    (4 s) to process 0 and the odd ones (6 s) to process 1, and speaker
    ``k`` owns the utterances ``32 j + 2 k`` and ``32 j + 2 k + 1``."""
    return [(name, path, f'spk{(index // 2) % NUM_SPEAKERS:02d}')
            for index, (name, path, _) in enumerate(entries)]


def training_vtln(config):
    """The VTLN trainer of ``config``'s section, every random source at
    0, its UBM configuration carried in ``vtln.ubm``: both the single-
    and the multi-process trainers build their UBM from it."""
    vtln, ubm = vtln_trainer(config, 'cuda')
    vtln.ubm = ubm.get_params()
    return vtln


class TrainingRecorder:
    """Records a VTLN training: the UBM before and after the LVTLN
    rounds, the last statistics (beta, K, G) the rounds solved, and the
    collectives (count, host seconds) of the UBM training and of the
    rounds."""

    def __enter__(self):
        from shennong_tpu_torch.ops import fmllr
        from shennong_tpu_torch.parallel import distributed
        from shennong_tpu_torch.processor.vtln import VtlnProcessor

        record = {'collectives': {}}
        self.patched = [(fmllr, 'solve_warp_classes'),
                        (VtlnProcessor, '_rounds_fused_arrays'),
                        (distributed, '_train_ubm')]
        self.originals = [getattr(owner, name) for owner, name in self.patched]
        solve, rounds, train_ubm = self.originals

        def collect(label, fn, *args, **kwargs):
            calls = distributed.COLLECTIVES['calls']
            seconds = distributed.COLLECTIVES['seconds']
            try:
                return fn(*args, **kwargs)
            finally:
                record['collectives'][label] = (
                    distributed.COLLECTIVES['calls'] - calls,
                    distributed.COLLECTIVES['seconds'] - seconds)

        def solving(beta, K, G, *args, **kwargs):
            record['stats'] = [beta, K, G]
            return solve(beta, K, G, *args, **kwargs)

        def rounding(vtln, ubm, *args, **kwargs):
            record['ubm'] = copy.deepcopy(ubm.gmm)
            out = collect('rounds', rounds, vtln, ubm, *args, **kwargs)
            record['gmm'] = copy.deepcopy(ubm.gmm)
            return out

        def training_ubm(*args, **kwargs):
            return collect('ubm', train_ubm, *args, **kwargs)

        for (owner, name), fn in zip(self.patched,
                                     (solving, rounding, training_ubm)):
            setattr(owner, name, fn)
        return record

    def __exit__(self, *exc):
        for (owner, name), fn in zip(self.patched, self.originals):
            setattr(owner, name, fn)


def trained_arrays(vtln, record):
    """The arrays of a recorded VTLN training."""
    arrays = {'base': vtln.lvtln.transforms}
    for stage in ('ubm', 'gmm'):
        for field in ('weights', 'means', 'inv_vars'):
            arrays[f'{stage}.{field}'] = getattr(record[stage], field)
    for i, stat in enumerate(record['stats']):
        arrays[f'stats.{i}'] = stat.cpu().numpy().astype(np.float64)
    for utt, transform in vtln.transforms.items():
        arrays[f'transform/{utt}'] = transform
    return arrays


def distributed_worker(rank, directory):
    """One process of the distributed phase, ``python3 chip_smoke.py
    --worker RANK DIRECTORY``: joins the group of DIST_WORLD processes
    (gloo, through a file store in ``directory``) on the card, runs the
    main path over its shard twice (a cold run, then a run whose kernel
    launches are counted), the raw pitch of its shard, and the VTLN
    training twice (a cold run, then a recorded one), and writes its
    results to ``directory``."""
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch.logger import null_logger
    from shennong_tpu_torch.parallel import distributed

    with open(os.path.join(directory, 'job.json')) as stream:
        job = json.load(stream)
    distributed.initialize(
        'file://' + os.path.join(directory, 'store'), DIST_WORLD, rank,
        backend='gloo', timeout=DIST_TIMEOUT)
    corpus = Utterances([tuple(entry) for entry in job['corpus']])
    config = zero_randomness(slice_config('mfcc'), 'mfcc')
    report = {}

    def timed(label, run):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        report[label] = time.perf_counter() - start
        return out

    def extract():
        return distributed.extract_features(
            copy.deepcopy(config), corpus, device='cuda', log=null_logger())

    with energy_dither_off():
        timed('cold_s', extract)
        reset_counters()
        features = timed('extract_s', extract)
        report['launches'] = launch_counts(*VITERBI, 'pass_two')
    raw = pitch_batched(distributed.shard_utterances(list(corpus)), 'cuda')
    arrays = {}
    for name in features:
        arrays[f'features/{name}'] = features[name].data
        arrays[f'pitch/{name}'] = raw[name]

    training = Utterances([tuple(entry) for entry in job['training']])

    def train(vtln):
        return distributed.train_vtln(vtln, training, group_by='speaker',
                                      device='cuda', log=null_logger())

    # a cold run first: the single process it is compared with is warm
    timed('train_cold_s', lambda: train(training_vtln(vtln_config())))
    vtln = training_vtln(vtln_config())
    with TrainingRecorder() as record:
        report['warps'] = timed('train_s', lambda: train(vtln))
    report['collectives'] = record['collectives']
    arrays.update(trained_arrays(vtln, record))
    np.savez(os.path.join(directory, f'rank{rank}.npz'), **arrays)
    with open(os.path.join(directory, f'rank{rank}.json'), 'w') as stream:
        json.dump(report, stream)


def run_workers(directory):
    """DIST_WORLD worker processes, spawned (never forked: each starts
    CUDA afresh); fails unless every one exits 0 within DIST_WAIT.
    Returns the wall from the spawn to the last exit."""
    logs = [open(os.path.join(directory, f'rank{rank}.log'), 'w+')
            for rank in range(DIST_WORLD)]
    start = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, 'chip_smoke.py'), '--worker',
         str(rank), directory], cwd=HERE, stdout=log,
        stderr=subprocess.STDOUT) for rank, log in enumerate(logs)]
    try:
        deadline = start + DIST_WAIT
        for proc in procs:
            proc.wait(timeout=max(deadline - time.perf_counter(), 1))
        wall = time.perf_counter() - start
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
        for rank, (proc, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            if proc.returncode != 0:
                say('distributed', f'process {rank} exited with '
                    f'{proc.returncode}; the end of its output:\n'
                    + log.read()[-6000:])
            log.close()
    for rank, proc in enumerate(procs):
        check(proc.returncode == 0,
              f'distributed: process {rank} exited with {proc.returncode}')
    return wall


def distributed_phase(card, workdir, entries):
    """The multi-process path (parallel/distributed.py): DIST_WORLD
    processes on the card over gloo. The main path on the 256-utterance
    corpus, speakers relabelled to span both processes
    (:func:`distributed_entries`): the merged features against the
    single-process card run (DIST_TOL; a pitch lag that differs a proven
    tie, its three pitch columns left out), both Viterbi kernels and the
    pass-2 kernel launched in every process. The VTLN training at the
    JAX package's defaults (64 Gaussians, 41 warp classes, 15 rounds) on
    the ABX 'full' training half: the processes' UBM, base and speaker
    transforms and warps the same bits, and against the single-process
    card run the warps equal or proven ties, the UBM within MODEL_TOL,
    the transforms within MODEL_TOL in their action on the training
    frames. Prints the walls (the processes share the card: an
    observation, not a speed-up) and the collectives per EM iteration
    and per LVTLN round. Returns the Viterbi and pass-2 launches of the
    processes' counted runs, summed."""
    from shennong_tpu_torch import Utterances, pipeline
    from shennong_tpu_torch.eval import abx_bench

    from tests.pitch_oracle import assert_lag_decisions

    phase = 'distributed'
    begin = time.perf_counter()
    directory = os.path.join(workdir, 'distributed')
    os.makedirs(directory, exist_ok=True)
    corpus = distributed_entries(entries)
    training = abx_bench.write_training_half(
        directory, abx_bench.phone_formants(DIST_TRAINING['nphones']),
        abx_bench.speaker_profiles(DIST_TRAINING['nspeakers']),
        DIST_TRAINING['train_tokens'], seed=0)
    with open(os.path.join(directory, 'job.json'), 'w') as stream:
        json.dump({'corpus': corpus, 'training': training}, stream)

    # the single-process runs on the card, before the processes start
    config = zero_randomness(slice_config('mfcc'), 'mfcc')
    walls = {}
    with energy_dither_off():
        torch.cuda.synchronize()
        start = time.perf_counter()
        single = pipeline.extract_features(
            copy.deepcopy(config), Utterances(corpus), device='cuda')
        torch.cuda.synchronize()
        walls['extract'] = time.perf_counter() - start
    single_raw = pitch_batched(Utterances(corpus), 'cuda')
    vtln = training_vtln(vtln_config())
    with TrainingRecorder() as record:
        start = time.perf_counter()
        single_warps = vtln.process(Utterances(training), group_by='speaker',
                                    device='cuda')
        torch.cuda.synchronize()
        walls['train'] = time.perf_counter() - start
    reference = trained_arrays(vtln, record)

    spawn = run_workers(directory)
    reports, results = [], []
    for rank in range(DIST_WORLD):
        with open(os.path.join(directory, f'rank{rank}.json')) as stream:
            reports.append(json.load(stream))
        results.append(dict(np.load(os.path.join(directory,
                                                 f'rank{rank}.npz'))))
    launches = {'viterbi_forward': 0, 'viterbi_backtrace': 0, 'pass_two': 0}
    for rank, report in enumerate(reports):
        for name in launches:
            count = report['launches'].get(name, 0)
            check(count > 0, f'{phase}: process {rank} never launched {name}')
            launches[name] += count

    # the main path: the merged shards against the single process
    merged, raw = {}, {}
    for rank, result in enumerate(results):
        names = [key.split('/', 1)[1] for key in result
                 if key.startswith('features/')]
        check(sorted(names) == sorted(name for name, _, _ in corpus[rank::2]),
              f'{phase}: process {rank} did not return its shard')
        for name in names:
            merged[name] = result[f'features/{name}']
            raw[name] = result[f'pitch/{name}']
    check(sorted(merged) == sorted(single.keys()),
          f'{phase}: {len(merged)} utterances merged, not {len(single)}')
    worst, ties = 0.0, 0
    for utt in Utterances(corpus):
        ours, ref = merged[utt.name], single[utt.name].data
        check(ours.shape == ref.shape, f'{utt.name}: shape {ours.shape}')
        columns = ours.shape[1]
        if not np.array_equal(raw[utt.name][:, 1], single_raw[utt.name][:, 1]):
            audio = utt.load_audio()
            assert_lag_decisions(audio.data.astype(np.float64), raw[utt.name],
                                 single_raw[utt.name], rate=audio.sample_rate)
            ties += 1
            columns -= 3
        gap = float(np.abs(ours[:, :columns] - ref[:, :columns]).max())
        check(gap < DIST_TOL, f'{phase}: {utt.name} max-abs {gap} against '
              'the single process')
        worst = max(worst, gap)
    cold = max(report['cold_s'] for report in reports)
    warm = max(report['extract_s'] for report in reports)
    say(phase, f'main path over {len(corpus)} utterances in {DIST_WORLD} '
        f'processes on the card (gloo; each speaker in both): against the '
        f'single process max-abs {worst:.3g} < {DIST_TOL} ({ties} with '
        f'proven lag ties); walls: {DIST_WORLD} processes {warm:.3f} s '
        f'(cold run {cold:.3f} s), one process {walls["extract"]:.3f} s; '
        f'launches by process '
        + ', '.join(str(report['launches']) for report in reports))

    # the training: the processes hold the same bits
    for key, value in results[0].items():
        if key.startswith(('ubm.', 'gmm.', 'base', 'transform/')):
            check(all(value.tobytes() == result[key].tobytes()
                      for result in results[1:]),
                  f'{phase}: {key} differs between the processes')
    check(all(report['warps'] == reports[0]['warps'] for report in reports),
          f'{phase}: the warps differ between the processes')
    dist, warps = results[0], reports[0]['warps']
    params = vtln_config()['vtln']
    speakers = sorted(single_warps)
    check(sorted(warps) == speakers, f'{phase}: speakers {sorted(warps)}')
    equal = [spk for spk in speakers if warps[spk] == single_warps[spk]]
    gaps = []
    for group, spk in enumerate(speakers):
        if spk in equal:
            continue
        classes = [round((w - params['min_warp']) / params['warp_step'])
                   for w in (warps[spk], single_warps[spk])]
        for run in (dist, reference):
            values = class_objective(
                [run[f'stats.{i}'] for i in range(3)], group, run['base'],
                params['norm_type'], classes)
            gaps.append(abs(values[0] - values[1]) / abs(values[1]))
            check(gaps[-1] < TIE_TOL, f'{phase}: {spk} warps {warps[spk]} '
                  f'and {single_warps[spk]} are not tied: relative objective '
                  f'gap {gaps[-1]:.3g}')
    edges = (params['min_warp'], params['max_warp'])
    inside = [spk for spk in speakers
              if not any(abs(warps[spk] - edge) < 1e-9 for edge in edges)]
    check(inside, f'{phase}: every warp is at the grid\'s edge')

    def gap(a, b):
        return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())

    errors = {f'{stage}.{field}': gap(dist[f'{stage}.{field}'],
                                       reference[f'{stage}.{field}'])
              for stage in ('ubm', 'gmm')
              for field in ('weights', 'means', 'inv_vars')}
    corpus_utts = Utterances(training)
    base_frames = training_frames(vtln_config(), corpus_utts, cmvn=False,
                                  device='cuda')
    errors['base transforms on the frames'] = max(
        action_gap(ours, ref, base_frames)
        for ours, ref in zip(dist['base'], reference['base']))
    frames = training_frames(vtln_config(), corpus_utts, cmvn=True,
                             device='cuda')
    errors['speaker transforms on the frames'] = max(
        [action_gap(dist[f'transform/{name}'], reference[f'transform/{name}'],
                    frames)
         for name, _, speaker in training if speaker in equal] + [0.0])
    say(phase, f'VTLN training on {len(training)} utterances of '
        f'{len(speakers)} speakers ({params["ubm"]["num_gauss"]} Gaussians, '
        f'{len(vtln.lvtln.warps)} warp classes, {params["num_iters"]} '
        f'rounds): the {DIST_WORLD} processes hold the same bits; against '
        f'the single process {len(equal)} of {len(speakers)} warps equal '
        f'({len(speakers) - len(equal)} proven ties, relative objective gap '
        f'at most {max(gaps + [0.0]):.3g}), {len(inside)} off the grid\'s '
        'edge; max-abs (relative past 1) '
        + ', '.join(f'{k} {v:.3g}' for k, v in errors.items()))
    say(phase, 'warps by speaker (alpha: processes / single): ' + ', '.join(
        f'{spk} ({alpha:.3f}): {warps[spk]:.2f} / {single_warps[spk]:.2f}'
        for spk, (alpha, _, _) in sorted(abx_bench.speaker_profiles(
            DIST_TRAINING['nspeakers']).items())))
    for name, err in errors.items():
        check(err < MODEL_TOL, f'{phase}: {name} {err} >= {MODEL_TOL}')

    ubm_iters = params['ubm']['num_iters_init'] + params['ubm']['num_iters']
    for rank, report in enumerate(reports):
        (ubm_calls, ubm_s), (round_calls, round_s) = (
            report['collectives'][k] for k in ('ubm', 'rounds'))
        say(phase, f'process {rank}: training wall {report["train_s"]:.3f} s '
            f'(cold run {report["train_cold_s"]:.3f} s; one process '
            f'{walls["train"]:.3f} s); UBM {ubm_calls} '
            f'collectives, {ubm_s * 1e3:.1f} ms host, '
            f'{ubm_s * 1e3 / ubm_iters:.2f} ms per EM iteration '
            f'({ubm_iters}); '
            f'LVTLN rounds {round_calls} collectives, {round_s * 1e3:.1f} ms '
            f'host, {round_s * 1e3 / params["num_iters"]:.2f} ms per round')
    say(phase, f'{DIST_WORLD} processes from spawn to exit {spawn:.1f} s; '
        f'phase time {time.perf_counter() - begin:.1f} s on {card}')
    return launches


# ------------------------------------------------ CREPE: the banded Viterbi

BANDED_HALFWIDTH = 11   # the CREPE smoothing prior's band


def banded_prior():
    """(log start, band, uniform weight, self weight) of the CREPE
    smoothing prior, as the processor's device decode passes them."""
    from shennong_tpu_torch.processor.pitch_crepe import _crepe_prior_logs

    log_start, _, uniform, self_w, band = _crepe_prior_logs(360)
    return log_start, band, uniform, self_w


def banded_bound(shape, bounds):
    """(ms, 'operations' or 'bytes'): the least time an H100 SXM could
    take for the banded decode on this run's data. Operations: for each
    state of each computed frame, W candidate adds, W - 1 compares, the
    two emission adds, the row maximum's compare and the subtraction;
    bytes: the observations and lengths read once, the band and start
    read once, the paths written once."""
    rows, frames, states = shape
    width = 2 * BANDED_HALFWIDTH + 1
    steps = sum(min(max(n, 1), frames) - 1 for n in bounds)
    ops = steps * states * (2 * width + 3)
    nbytes = 4 * (2 * rows * frames + rows + states * (width + 1))
    by_ops, by_bytes = ops / PEAK_FLOPS_FP32, nbytes / PEAK_BYTES
    if by_ops >= by_bytes:
        return by_ops * 1e3, 'operations'
    return by_bytes * 1e3, 'bytes'


def banded_inputs(rng, shape):
    """Observations of ``shape`` = (rows, frames, states) along argmax
    tracks: a wandering pitch, jumps, a plateau of ties (row 0), and
    one row of random bins; on the card."""
    rows, frames, states = shape
    obs = np.cumsum(rng.randint(-3, 4, (rows, frames)), axis=1) + states // 2
    obs[-1] = rng.randint(0, states, frames)
    obs[0, 100:600] = obs[0, 100]
    return torch.as_tensor(np.clip(obs, 0, states - 1).astype(np.int32),
                           device='cuda')


#: states a thread of the banded Viterbi's variants (its default at 360
#: states is 3: four warps a row)
BANDED_VARIANTS = (1, 2, 3, 4)


def banded_kernel_phase(resources):
    """The banded Viterbi kernel against its plain version on the card,
    at the CREPE slice's decode shape [33, 490, 360], at [16, 1024, 360]
    (rows of 1 frame, partial and full lengths) and at a chunk's [1,
    8192, 360] (back-pointer tiles spilled to device memory): the paths
    bit-equal, and again over repeated launches. Timed at every shape:
    the kernel's device time a launch (profiler), a wrapper call and the
    plain version (CUDA events). At the slice's shape, every variant of
    BANDED_VARIANTS bit-equal and timed; at the slice's and the chunk's
    shapes, the forward alone against the whole kernel (the argmax and
    backtrace apart). Returns (max-abs error, times at the slice's
    shape)."""
    from shennong_tpu_torch.ops import viterbi

    phase = 'banded kernel'
    log_start, band, uniform, self_w = banded_prior()
    log_start_t = torch.as_tensor(log_start, dtype=torch.float32,
                                  device='cuda')
    band_t = torch.as_tensor(band, dtype=torch.float32, device='cuda')
    weights = viterbi._weights32(uniform, self_w)
    rng = np.random.RandomState(6)
    error, timed = 0.0, None
    for shape, bounds, plain_repeats in (
            # the CREPE slice's device decode: 33 rows of 4 s in a bucket
            # of 490 frames (and 26 rows of 6 s in 613)
            ((33, 490, 360), [401] * 33, 2),
            ((16, 1024, 360), [1024] * 6 + [1, 1, 2, 700, 1023, 300, 64,
                                            1024, 5, 900], 2),
            ((1, 8192, 360), [8192], 1)):
        rows, frames, states = shape
        obs = banded_inputs(rng, shape)
        counts = torch.tensor(bounds, dtype=torch.int32, device='cuda')

        def kernel():
            return viterbi.viterbi_banded_obs_batch(
                log_start, band, uniform, self_w, obs, counts,
                BANDED_HALFWIDTH)

        def plain():
            return viterbi.viterbi_banded_obs_batch_plain(
                log_start_t, band_t, uniform, self_w, obs, counts,
                BANDED_HALFWIDTH)

        def variant(states_per_thread=0, forward_only=False):
            out = torch.empty_like(obs)
            viterbi.launch_banded(log_start_t, band_t, *weights, obs, counts,
                                  out, states_per_thread, forward_only)
            return out

        paths, reference = kernel(), plain()
        torch.cuda.synchronize()
        check(torch.equal(paths, reference),
              f'banded Viterbi paths differ from the plain version at '
              f'{shape}')
        error = max(error, float((paths - reference).abs().max()))
        for _ in range(3):
            check(torch.equal(kernel(), paths),
                  f'banded Viterbi paths changed between launches at {shape}')
        ms = kernel_device_ms(variant, 20, 'banded_viterbi_kernel')
        call_ms = cuda_ms(kernel, 10)
        plain_ms = cuda_ms(plain, plain_repeats)
        bound_ms, bound_by = banded_bound(shape, bounds)
        plan = viterbi.banded_plan(rows, frames, states, 2 * BANDED_HALFWIDTH + 1)
        kind = f"banded_viterbi<{plan['states']},{BANDED_HALFWIDTH}>"
        registers, stores, loads = resources[kind]
        decoded = sum(min(max(n, 1), frames) for n in bounds) / rows
        say(phase, f'{shape}, nframes from {min(bounds)} to {max(bounds)}: '
            f'paths bit-equal to the plain version, repeated launches '
            f'equal; kernel {ms:.4f} ms (profiler, device time a launch; '
            f'{ms * 1e3 / frames:.4f} us a padded frame, '
            f'{ms * 1e3 / decoded:.4f} us a decoded frame), a call '
            f'{call_ms:.4f} ms and plain {plain_ms:.3f} ms (CUDA events); '
            f"{kind}, {plan['threads']} threads, back-pointer tiles of "
            f"{plan['tile']} frames, {plan['smem']} B shared, spill "
            f"{plan['spill']} B; {registers} registers, spills "
            f'{stores}/{loads} B; bound {bound_ms:.5f} ms by {bound_by}, '
            f'share of bound {bound_ms / ms:.5f}')
        if shape[1] == 490:
            timed = (ms, plain_ms, bound_ms, bound_by)
            for k in BANDED_VARIANTS:
                check(torch.equal(variant(k), paths),
                      f'banded Viterbi with {k} states a thread differs')
                vms = kernel_device_ms(lambda: variant(k), 20,
                                       'banded_viterbi_kernel')
                registers, stores, loads = resources[
                    f'banded_viterbi<{k},{BANDED_HALFWIDTH}>']
                threads = viterbi.banded_plan(
                    rows, frames, states, 2 * BANDED_HALFWIDTH + 1, k)['threads']
                say(phase, f'variant {k} states a thread ({threads} threads, '
                    f'{threads // 32} warps) at {shape}: paths bit-equal; '
                    f'{vms:.4f} ms ({vms * 1e3 / decoded:.4f} us a decoded '
                    f'frame; profiler); {registers} registers, spills '
                    f'{stores}/{loads} B')
        if shape[1] in (490, 8192):
            forward = kernel_device_ms(lambda: variant(0, True), 20,
                                       'banded_viterbi_kernel')
            say(phase, f'split at {shape}: forward alone {forward:.4f} ms '
                f'({forward * 1e3 / decoded:.4f} us a decoded frame), the '
                f'argmax and backtrace {ms - forward:.4f} ms of the '
                f'kernel\'s {ms:.4f} (profiler)')
    return error, timed


# ------------------------------------------------------------ CREPE slice

def crepe_config(decode='host'):
    """BASELINE config 3: MFCC + CREPE pitch ('tiny', the shipped
    weights) + CMVN + delta."""
    from shennong_tpu_torch import pipeline

    config = pipeline.get_default_config(
        'mfcc', with_pitch='crepe', with_cmvn=True, with_delta=True)
    config['pitch']['model_capacity'] = 'tiny'
    config['pitch']['decode'] = decode
    return config


def crepe_slice(card, workdir, entries):
    """The CREPE slice over the corpus: a cold run, RUNS timed warm runs
    (peak memory), a profiled run (the CNN's device ms, the host decode
    and pass 2); the device decode through ``extract_features`` with its
    banded Viterbi launches counted, against the host decode; the card
    against the CPU on 8 utterances; and the 12-minute WAV through the
    chunked path. Returns the banded Viterbi's launches of the device
    decode run."""
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.processor.pitch_crepe import CrepePitchProcessor

    phase = 'crepe slice'
    begin = time.perf_counter()
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          'TF32 is on: the convolutions would round to 10 bits')
    config = crepe_config()
    utterances = Utterances(entries)
    audio_seconds = sum(utt.duration for utt in utterances)

    torch.cuda.synchronize()
    start = time.perf_counter()
    pipeline.extract_features(copy.deepcopy(config), utterances,
                              device='cuda')
    torch.cuda.synchronize()
    cold = time.perf_counter() - start
    torch.cuda.reset_peak_memory_stats()
    walls, out = warm_runs(config, utterances)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(out) == NUM_UTTERANCES, f'{len(out)} outputs')
    for utt in utterances:
        nsamples = int(round(utt.duration * RATE))
        check(out[utt.name].shape == (1 + (nsamples - 400) // 160, 42),
              f'{utt.name}: shape {out[utt.name].shape}')
        check(np.isfinite(out[utt.name].data).all(), f'{utt.name}: non-finite')
    seconds = float(np.median(walls))
    say(phase, f'{NUM_UTTERANCES} utterances ({audio_seconds:.0f} s of '
        f'audio), CREPE tiny, host decode: cold run {cold:.3f} s; {RUNS} '
        f'warm runs: wall median {seconds:.4f} s (min {min(walls):.4f}, max '
        f'{max(walls):.4f}), warm xRT median {audio_seconds / seconds:.1f} '
        f'(min {audio_seconds / max(walls):.1f}, max '
        f'{audio_seconds / min(walls):.1f}) on {card}; peak device memory '
        f'{peak:.2f} GiB')
    profile_layers(phase, config, utterances, seconds)

    # the device decode, through the entry point a user calls
    device_config = crepe_config('device')
    pipeline.extract_features(copy.deepcopy(device_config),
                              Utterances(entries[:16]), device='cuda')
    reset_counters()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = pipeline.extract_features(
        copy.deepcopy(device_config), utterances, device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = launch_counts('banded_viterbi')
    check(launches['banded_viterbi'] > 0,
          'the device decode never launched banded_viterbi')
    check(len(out) == NUM_UTTERANCES and all(
        np.isfinite(out[utt.name].data).all() for utt in utterances),
        'the device decode gave missing or non-finite features')
    say(phase, f'device decode (extract_features, decode device): wall '
        f'{wall:.4f} s, xRT {audio_seconds / wall:.1f} on {card}; launches '
        f'{launches}')
    profile_layers(f'{phase} device decode', device_config, utterances, wall)

    decode_bins(phase, utterances)
    host = CrepePitchProcessor(model_capacity='tiny').process_all(
        utterances, device='cuda')
    device = CrepePitchProcessor(
        model_capacity='tiny', decode='device').process_all(
            utterances, device='cuda')
    confidence, moved, frames = 0.0, 0, 0
    for utt in utterances:
        h, d = host[utt.name].data, device[utt.name].data
        check(h.shape == d.shape, f'{utt.name}: decode shapes differ')
        confidence = max(confidence, float(np.abs(h[:, 0] - d[:, 0]).max()))
        moved += int((np.abs(h[:, 1] - d[:, 1]) > 0.1).sum())
        frames += h.shape[0]
    check(confidence < 1e-5, f'device vs host decode: confidence max-abs '
          f'{confidence}')
    say(phase, f'device decode vs float64 host decode over the corpus: '
        f'confidence max-abs {confidence:.3g} < 1e-5; pitch moved by more '
        f'than 0.1 Hz on {moved} of {frames} frames '
        f'({moved / frames:.5f})')

    crepe_against_cpu(phase, config, entries[:8])
    twelve = os.path.join(workdir, 'twelve.wav')
    if not os.path.isfile(twelve):
        write_wav(twelve, 720, seed=2000)
    crepe_long(phase, card, twelve)
    say(phase, f'phase time {time.perf_counter() - begin:.1f} s')
    return launches


def decode_bins(phase, utterances):
    """The smoothed bins of the device decode against the float64 host
    decode on the model grid: every utterance's argmax bins from the
    card, all rows through one launch of the banded Viterbi kernel, and
    each row through the host decoder; prints the share of frames whose
    bin differs."""
    from shennong_tpu_torch.ops import viterbi
    from shennong_tpu_torch.processor.pitch_crepe import (
        CrepePitchProcessor, _viterbi_bin_path)

    proc = CrepePitchProcessor(model_capacity='tiny')
    tracks = [proc._device_salience(
        proc._check_audio(utt.load_audio()).data, 'cuda').argmax
        for utt in utterances]
    obs = np.zeros((len(tracks), max(map(len, tracks))), np.int32)
    for row, track in enumerate(tracks):
        obs[row, :len(track)] = track
    log_start, band, uniform, self_w = banded_prior()
    device = viterbi.viterbi_banded_obs_batch(
        log_start, band, uniform, self_w,
        torch.as_tensor(obs, device='cuda'),
        torch.tensor([len(t) for t in tracks], dtype=torch.int32,
                     device='cuda'), BANDED_HALFWIDTH).cpu().numpy()
    differ = sum(int((device[row, :len(track)] != _viterbi_bin_path(
        track, 360)).sum()) for row, track in enumerate(tracks))
    frames = sum(map(len, tracks))
    say(phase, f'smoothed bins of the device decode (one kernel launch at '
        f'{list(obs.shape) + [360]}) against the float64 host decode: '
        f'{differ} of {frames} frames differ ({differ / frames:.5f})')


def crepe_against_cpu(phase, config, entries):
    """CREPE on the card against the CPU on ``entries``: the argmax bins
    equal wherever the CPU's two best saliences differ by more than
    1e-5 (a bin that differs elsewhere is a near-tie, counted); the
    salience within 1e-4; the features of ``extract_features`` (random
    sources at 0) within SLICE_TOL on the utterances whose bins all
    agree."""
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.processor import energy as energy_module
    from shennong_tpu_torch.processor.pitch_crepe import CrepePitchProcessor

    proc = CrepePitchProcessor(model_capacity='tiny')
    utterances = Utterances(entries)
    agree, near, ties, worst_sal = [], 0, 0, 0.0
    for utt in utterances:
        audio = proc._check_audio(utt.load_audio())
        salience = {
            device: proc._device_salience(audio.data, device)
            for device in ('cuda', 'cpu')}
        gpu = torch.cat([s[:n] for s, n in zip(
            salience['cuda'].chunks, salience['cuda'].counts)]).cpu()
        cpu = torch.cat([s[:n] for s, n in zip(
            salience['cpu'].chunks, salience['cpu'].counts)])
        worst_sal = max(worst_sal, float((gpu - cpu).abs().max()))
        top = cpu.topk(2, dim=-1).values
        clear = (top[:, 0] - top[:, 1] > 1e-5).numpy()
        same = salience['cuda'].argmax == salience['cpu'].argmax
        check(same[clear].all(), f'{utt.name}: argmax bins differ where the '
              'CPU\'s two best saliences are more than 1e-5 apart')
        near += int((~clear).sum())
        ties += int((~same).sum())
        if same.all():
            agree.append(utt.name)
    check(worst_sal < 1e-4, f'CREPE salience cuda vs cpu max-abs {worst_sal}')

    config = copy.deepcopy(config)
    config['mfcc']['dither'] = 0
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    defaults = energy_module.EnergyProcessor.__init__.__defaults__
    energy_module.EnergyProcessor.__init__.__defaults__ = (
        defaults[:3] + (0.0,) + defaults[4:])
    try:
        on = {device: pipeline.extract_features(
            copy.deepcopy(config), utterances, device=device)
            for device in ('cuda', 'cpu')}
    finally:
        energy_module.EnergyProcessor.__init__.__defaults__ = defaults
    worst = 0.0
    for name in agree:
        diff = np.abs(on['cuda'][name].data - on['cpu'][name].data)
        check(diff.max() < SLICE_TOL, f'{name}: cuda vs cpu max-abs '
              f'{diff.max()}')
        worst = max(worst, float(diff.max()))
    say(phase, f'cuda vs cpu on {len(entries)} utterances: salience max-abs '
        f'{worst_sal:.3g} < 1e-4; argmax bins equal wherever the CPU\'s two '
        f'best saliences differ by more than 1e-5; {near} frames where they '
        f'do not, {ties} frames with a bin that differs; features of the '
        f'{len(agree)} '
        f'utterances whose bins all agree: max-abs {worst:.3g} < {SLICE_TOL}')


def crepe_long(phase, card, path):
    """The 12-minute WAV through ``CrepePitchProcessor.process``: the
    chunked path, in chunks of CHUNK_FRAMES; wall and peak memory."""
    from shennong_tpu_torch import Audio
    from shennong_tpu_torch.processor.pitch_crepe import CrepePitchProcessor

    audio = Audio.load(path)
    proc = CrepePitchProcessor(model_capacity='tiny')
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = proc.process(audio, device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    frames = 1 + audio.nsamples // 160  # centered: 512 samples each side
    check(out.shape == (1 + (audio.nsamples - 400) // 160, 2)
          and np.isfinite(out.data).all(), f'12 min CREPE: {out.shape}')
    say(phase, f'12 min CREPE tiny ({frames} model frames in '
        f'{-(-frames // proc.CHUNK_FRAMES)} chunks of {proc.CHUNK_FRAMES}): '
        f'{out.shape}, wall {wall:.3f} s, xRT {audio.duration / wall:.1f}, '
        f'peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} '
        f'GiB on {card}')


def crepe_flops(channels):
    """Multiply-adds times 2 of one frame through the CREPE CNN of
    ``channels`` (the six convolutions at their output widths and the
    classifier)."""
    from shennong_tpu_torch.models import crepe

    flops, width, cin = 0, crepe.FRAME, 1
    for cout, kernel, stride in zip(channels, crepe.LAYER_WIDTHS,
                                    crepe.LAYER_STRIDES):
        width = -(-width // stride)
        flops += 2 * width * cin * cout * kernel
        width //= 2
        cin = cout
    return flops + 2 * width * cin * crepe.BINS


def crepe_full(card, entries):
    """The CREPE CNN at the 'full' widths (channel multiplier 32) with
    seeded synthetic weights, built through weights.crepe_from_numpy and
    not installed: timed over 16 utterances' frames (CUDA events, ms,
    TFLOP/s and share of the float32 peak), peak memory, and the card
    against the CPU on 4 frames."""
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch.models import crepe
    from shennong_tpu_torch.processor.pitch_crepe import CrepePitchProcessor
    from shennong_tpu_torch.weights import crepe_from_numpy

    phase = 'crepe full'
    rng = np.random.RandomState(32)
    mult = crepe.CAPACITY_MULTIPLIER['full']
    params, cin = {}, 1
    for i, (filters, width) in enumerate(
            zip(crepe.LAYER_FILTERS, crepe.LAYER_WIDTHS), start=1):
        cout = filters * mult
        params[f'conv{i}/kernel'] = (rng.randn(width, cin, cout)
                                     / np.sqrt(width * cin)).astype(np.float32)
        params[f'conv{i}/bias'] = (0.01 * rng.randn(cout)).astype(np.float32)
        params[f'conv{i}/gamma'] = (1 + 0.1 * rng.randn(cout)).astype(
            np.float32)
        params[f'conv{i}/beta'] = (0.1 * rng.randn(cout)).astype(np.float32)
        params[f'conv{i}/mean'] = (0.1 * rng.rand(cout)).astype(np.float32)
        params[f'conv{i}/var'] = (0.5 + rng.rand(cout)).astype(np.float32)
        cin = cout
    params['classifier/kernel'] = (rng.randn(4 * cin, 360)
                                   / np.sqrt(4 * cin)).astype(np.float32)
    params['classifier/bias'] = np.zeros(360, np.float32)
    model = crepe_from_numpy(params)
    check(crepe.capacity_of(params) == 'full', 'not the full widths')

    proc = CrepePitchProcessor(model_capacity='tiny')
    frames = np.concatenate([
        proc._model_frames(utt.load_audio().data)
        for utt in Utterances(entries[:16])])
    gpu_model = copy.deepcopy(model).to('cuda')
    inputs = torch.as_tensor(frames, device='cuda')
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ms = cuda_ms(lambda: gpu_model(inputs), 3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gpu = gpu_model(inputs[:4]).cpu()
        cpu = model(torch.as_tensor(frames[:4]))
    err = float((gpu - cpu).abs().max())
    check(err < 1e-4, f'CREPE full cuda vs cpu max-abs {err}')
    flops = crepe_flops(model.channels) * frames.shape[0]
    rate = flops / (ms * 1e-3) / 1e12
    say(phase, f'channels {model.channels}, {crepe_flops(model.channels) / 1e9:.3f} '
        f'GFLOP a frame: {frames.shape[0]} frames of 16 utterances in '
        f'{ms:.3f} ms (CUDA events), {rate:.2f} TFLOP/s, share of the '
        f'67 TFLOP/s float32 peak {rate / 67:.3f}; peak device memory '
        f'{peak:.2f} GiB on {card}; cuda vs cpu on 4 frames max-abs '
        f'{err:.3g} < 1e-4')


# ------------------------------------------------------------- bottleneck

def bottleneck_weights(directory):
    """Seeded synthetic weights at BabelMulti's published widths (hidden
    1500, bottleneck 80), in the layer layout and context (5 frames) of
    tests/processor/test_bottleneck.py, written where the processor
    looks for BabelMulti; returns the directory."""
    rng = np.random.RandomState(15)
    hidden = 1500
    params = {
        'context': np.int64(5),
        'input_mean': rng.randn(144) * 0.1,
        'input_std': np.abs(rng.randn(144)) * 0.5 + 0.5,
        'bn_mean': rng.randn(400) * 0.1,
        'bn_std': np.abs(rng.randn(400)) * 0.5 + 0.5,
    }
    for name, (nin, nout) in {
            'W1': (144, hidden), 'W2': (hidden, hidden),
            'W3': (hidden, 80), 'W5': (400, hidden),
            'W6': (hidden, hidden), 'W7': (hidden, hidden),
            'W8': (hidden, 80)}.items():
        params[name] = (rng.randn(nin, nout) / np.sqrt(nin)).astype(np.float32)
        params['b' + name[1:]] = (rng.randn(nout) * 0.1).astype(np.float32)
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(
        directory, 'Babel-ML17_FBANK_HL1500_SBN80_PhnStates3096.npz'),
        **params)
    return directory


def bottleneck_phase(card, workdir, entries):
    """Bottleneck features (BASELINE config 5) with synthetic BabelMulti
    weights: ``process_all`` over the corpus (a warm-up, a timed run,
    a profiled run: the host front end and the device forward),
    ``extract_features`` with bottleneck features and CMVN on 16
    utterances, and the card against the CPU on 8 utterances."""
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.processor import bottleneck as bn_module

    phase = 'bottleneck'
    begin = time.perf_counter()
    bn_module._SHARE_DIR = bottleneck_weights(
        os.path.join(workdir, 'bottleneck_weights'))
    bn_module.BottleneckProcessor._loaded_weights.clear()
    proc = bn_module.BottleneckProcessor(weights='BabelMulti')
    utterances = Utterances(entries)
    audio_seconds = sum(utt.duration for utt in utterances)

    proc.process_all(Utterances(entries[:16]), device='cuda')
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = proc.process_all(utterances, device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    for utt in utterances:
        nsamples = int(round(utt.duration * 8000))
        check(out[utt.name].shape == ((nsamples - 200) // 80 + 1, 80)
              and np.isfinite(out[utt.name].data).all(),
              f'{utt.name}: bottleneck {out[utt.name].shape}')
    say(phase, f'process_all, BabelMulti widths (synthetic weights), '
        f'{NUM_UTTERANCES} utterances ({audio_seconds:.0f} s): wall '
        f'{wall:.4f} s, xRT {audio_seconds / wall:.1f}, peak device memory '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {card}')
    profile_layers(phase, None, utterances, wall, run=lambda: proc.process_all(
        utterances, device='cuda'))

    config = pipeline.get_default_config('bottleneck', with_cmvn=True)
    sixteen = Utterances(entries[:16])
    torch.cuda.synchronize()
    start = time.perf_counter()
    feats = pipeline.extract_features(config, sixteen, device='cuda')
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    for utt in sixteen:
        check(feats[utt.name].shape == out[utt.name].shape
              and np.isfinite(feats[utt.name].data).all(),
              f'{utt.name}: bottleneck + cmvn {feats[utt.name].shape}')
    say(phase, f'extract_features, bottleneck + CMVN on 16 utterances: wall '
        f'{seconds:.3f} s, shapes and finiteness checked')

    still = bn_module.BottleneckProcessor(weights='BabelMulti', dither=0)
    eight = Utterances(entries[:8])
    on = {device: still.process_all(eight, device=device)
          for device in ('cuda', 'cpu')}
    worst = max(float(np.abs(on['cuda'][name].data - on['cpu'][name].data)
                      .max()) for name in on['cpu'].keys())
    check(worst < SLICE_TOL, f'bottleneck cuda vs cpu max-abs {worst}')
    say(phase, f'cuda vs cpu on 8 utterances, dither 0: max-abs {worst:.3g} '
        f'< {SLICE_TOL}')
    say(phase, f'phase time {time.perf_counter() - begin:.1f} s')


# ------------------------------------------------------- ABX: the DTW kernel

DTW_TOL = 1e-5           # kernel vs plain on real-valued costs
DTW_TIE_SHARE = 1e-3     # most near-ties accepted: one in 1000 pairs


def dtw_bound(nx, ny):
    """(ms, 'operations' or 'bytes'): the least time an H100 SXM could
    take for the DTW divergences of pairs of ``nx`` x ``ny`` valid
    frames. Bytes: the valid cells' costs read once, the two counts
    read and the divergence written (12 bytes a pair); operations:
    about 4 a valid cell (an add, two lexicographic compares, the
    length's add)."""
    cells = float(np.sum(np.asarray(nx, np.float64) * np.asarray(ny)))
    by_ops = 4 * cells / PEAK_FLOPS_FP32
    by_bytes = (4 * cells + 12 * len(nx)) / PEAK_BYTES
    if by_ops >= by_bytes:
        return by_ops * 1e3, 'operations'
    return by_bytes * 1e3, 'bytes'


def dtw_near_tie(costs, n, m, div_a, div_b):
    """Whether two float32 divergences of one pair are a near-tie of
    two path lengths, proven in float64.

    ``by_length[L]``, the least float64 cost of the paths of L cells,
    is computed for every L. ``r`` bounds the float32 rounding of a
    path's cost in either version: the kernel adds at most ``L_max = n
    + m - 1`` costs one by one (``L_max^2 / 2`` eps max|c|), the plain
    version takes each of n rows' prefix sums of m costs, subtracts two
    of them and adds twice (``n (m (m + 1) / 2 + 2 L_max)`` eps
    max|c|). A length L explains a divergence d when ``by_length[L]``
    lies within ``2 r`` of the least cost of all paths and ``d L``
    within ``r`` and d's own rounding of ``by_length[L]``. The two
    divergences are a near-tie when lengths that differ explain them:
    a gap between two divergences of one length is a rounding error,
    not a tie. ``costs`` is the pair's [Ta, Tb] matrix (numpy array or
    CPU tensor), ``n``, ``m`` its valid counts."""
    c = np.asarray(costs, np.float64)[:n, :m]
    longest = n + m - 1
    # best[i, j, L]: the least cost of the paths of L cells to (i, j)
    best = np.full((n, m, longest + 1), math.inf)
    best[0, 0, 1] = c[0, 0]
    for i in range(n):
        for j in range(m):
            if i == 0 and j == 0:
                continue
            entry = np.full(longest, math.inf)
            for a, b in ((i - 1, j), (i - 1, j - 1), (i, j - 1)):
                if a >= 0 and b >= 0:
                    entry = np.minimum(entry, best[a, b, :-1])
            best[i, j, 1:] = entry + c[i, j]
    by_length = best[n - 1, m - 1]
    eps = float(np.finfo(np.float32).eps)
    rounding = max(longest ** 2 / 2, n * (m * (m + 1) / 2 + 2 * longest)) \
        * eps * float(np.abs(c).max())
    tied = np.flatnonzero(by_length <= by_length.min() + 2 * rounding)

    def explaining(div):
        return {int(length) for length in tied
                if abs(div * length - by_length[length])
                <= rounding + length * abs(div) * eps}

    return any(a != b for a in explaining(float(div_a))
               for b in explaining(float(div_b)))


def dtw_against_plain(costs, nx, ny, div, reference):
    """The DTW kernel's divergences ``div`` against the plain version's
    ``reference`` on the same pairs: (max-abs gap off the near-ties,
    the near-ties, their max-abs gap, what failed). A pair past DTW_TOL
    fails unless it is a proven near-tie (:func:`dtw_near_tie`), and
    the near-ties fail when they pass DTW_TIE_SHARE of the pairs (one
    is always allowed)."""
    gaps = (div - reference).abs().cpu()
    ties, failed = [], []
    for b in torch.nonzero(gaps > DTW_TOL)[:, 0].tolist():
        if dtw_near_tie(costs[b].cpu(), int(nx[b]), int(ny[b]),
                        float(div[b]), float(reference[b])):
            ties.append(b)
        else:
            failed.append(f'pair {b}: {float(div[b])} against '
                          f'{float(reference[b])}, not a near-tie')
    allowed = max(1, int(DTW_TIE_SHARE * len(gaps)))
    if len(ties) > allowed:
        failed.append(f'{len(ties)} near-ties in {len(gaps)} pairs, more '
                      f'than {allowed}')
    tie_gap = float(gaps[ties].max()) if ties else 0.0
    gaps[ties] = 0.0
    return float(gaps.max()), len(ties), tie_gap, failed


def dtw_kernel_phase(resources):
    """The DTW kernel against its plain version on the card: at the ABX
    benchmark's [4096, 24, 24] (13-dimensional segments, both metrics,
    full and ragged counts from 1), [512, 64, 64], one [1, 300, 280]
    pair (within DTW_TOL), and integer-valued costs with ties at [4096,
    24, 24] and [64, 40, 70] (torch.equal); repeated launches equal.
    A pair past DTW_TOL must be a near-tie of two path lengths, proven
    in float64, and at most DTW_TIE_SHARE of a case's pairs may be
    (dtw_against_plain). Timed at every shape: the kernel's device time
    a launch (profiler), a wrapper call and the plain version (CUDA
    events). The costs stay warm in L2 between launches, as in
    pairwise_distances, where the batched product writes them just
    before. Returns (max-abs error off the near-ties, times at the
    benchmark's cosine shape, the near-ties' count and max-abs gap for
    the kernels' JSON line)."""
    from shennong_tpu_torch.eval import abx
    from shennong_tpu_torch.ops import dtw

    phase = 'dtw kernel'
    begin = time.perf_counter()
    rng = np.random.RandomState(7)
    error, timed = 0.0, None
    near_ties, near_tie_gap = 0, 0.0

    def counts(size, limit, ragged):
        values = (rng.randint(1, limit + 1, size) if ragged
                  else np.full(size, limit))
        values[0] = limit
        return torch.tensor(values, dtype=torch.int32, device='cuda')

    cases = []
    for label, (bsz, rows, cols), ragged, metric in (
            ('benchmark', (4096, 24, 24), False, 'cosine'),
            ('benchmark', (4096, 24, 24), False, 'euclidean'),
            ('ragged', (4096, 24, 24), True, 'cosine'),
            ('strips', (512, 64, 64), True, 'cosine'),
            ('long pair', (1, 300, 280), False, 'cosine')):
        x = torch.from_numpy(
            rng.randn(bsz, rows, 13).astype(np.float32)).cuda()
        y = torch.from_numpy(
            rng.randn(bsz, cols, 13).astype(np.float32)).cuda()
        cases.append((f'{label} {metric}', abx._frame_costs(x, y, metric),
                      counts(bsz, rows, ragged), counts(bsz, cols, ragged),
                      False))
    for bsz, rows, cols in ((4096, 24, 24), (64, 40, 70)):
        costs = torch.from_numpy(
            rng.randint(0, 3, (bsz, rows, cols)).astype(np.float32)).cuda()
        cases.append(('integer costs', costs, counts(bsz, rows, True),
                      counts(bsz, cols, True), True))

    for label, costs, nx, ny, exact in cases:
        shape = tuple(costs.shape)

        def kernel():
            return dtw.dtw_divergences(costs, nx, ny)

        def plain():
            return dtw.dtw_divergences_plain(costs, nx, ny)

        div, reference = kernel(), plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(div).all()), f'dtw: {label} not finite')
        if exact:
            gap = float((div - reference).abs().max())
            check(torch.equal(div, reference),
                  f'dtw: {label} at {shape} differs from the plain version '
                  f'({gap})')
        else:
            gap, ties, tie_gap, failed = dtw_against_plain(
                costs, nx, ny, div, reference)
            check(not failed, f'dtw: {label} at {shape}: ' + '; '.join(failed))
            error = max(error, gap)
            near_ties += ties
            near_tie_gap = max(near_tie_gap, tie_gap)
        for _ in range(3):
            check(torch.equal(kernel(), div),
                  f'dtw: {label} at {shape} changed between launches')
        ms = kernel_device_ms(kernel, 20, 'dtw_kernel')
        call_ms = cuda_ms(kernel, 20)
        # pairwise_distances' call: the counts checked on the host before
        unchecked_ms = cuda_ms(
            lambda: dtw.divergences_unchecked(costs, nx, ny), 20)
        plain_ms = cuda_ms(plain, 3)
        bound_ms, bound_by = dtw_bound(nx.cpu().numpy(), ny.cpu().numpy())
        kind = dtw_instantiation(*shape[1:])
        registers, stores, loads = resources[kind]
        say(phase, f'{label} {shape}, counts {int(nx.min())}-{int(nx.max())}'
            f' x {int(ny.min())}-{int(ny.max())}: '
            + ('equal to' if exact else
               f'max-abs {gap:.3g} ({ties} proven near-ties apart, '
               f'max-abs {tie_gap:.3g}) from')
            + f' the plain version, repeated launches equal; kernel '
            f'{ms:.4f} ms (profiler, device time a launch), a call '
            f'{call_ms:.4f} ms (counts checked on the card), an unchecked '
            f'call {unchecked_ms:.4f} ms and plain {plain_ms:.3f} ms (CUDA '
            f'events, costs warm in L2); {kind}, {registers} registers, '
            f'spills {stores}/{loads} B; bound {bound_ms:.5f} ms by {bound_by}, '
            f'share of bound {bound_ms / ms:.4f}')
        if timed is None:
            timed = (ms, plain_ms, bound_ms, bound_by)
            dtw_variants(phase, costs, nx, ny, div, resources)
    say(phase, f'phase time {time.perf_counter() - begin:.1f} s')
    return error, timed, {'near_ties': near_ties,
                          'near_tie_max_abs_err': near_tie_gap}


#: rows a lane of the staged DTW kernel's variants (its default is 1:
#: one pair of 24 rows a warp)
DTW_VARIANTS = (1, 2, 3, 4)


def dtw_variants(phase, costs, nx, ny, div, resources):
    """Each variant of DTW_VARIANTS at the benchmark's shape: the same
    bits as the default launch ``div``, and its device time a launch
    (profiler)."""
    from shennong_tpu_torch.ops import dtw

    shape = tuple(costs.shape)
    for rows in DTW_VARIANTS:
        out = torch.empty_like(div)

        def launch():
            dtw.launch_dtw(costs, nx, ny, out, rows)

        launch()
        check(torch.equal(out, div),
              f'dtw with {rows} rows a lane differs from the default')
        ms = kernel_device_ms(launch, 20, 'dtw_kernel')
        registers, stores, loads = resources[
            dtw_instantiation(*shape[1:], rows)]
        say(phase, f'variant {rows} rows a lane ({32 // _segment(24, rows)} '
            f'pairs a warp) at {shape}: the default\'s bits; {ms:.4f} ms '
            f'(profiler); {registers} registers, spills {stores}/{loads} B')


def dtw_instantiation(rows, cols, requested=0):
    """The DTW kernel the wrapper launches for [rows, cols] pairs with
    ``requested`` rows a lane (0: the default), as kernel_resources
    names it."""
    from shennong_tpu_torch.ops import dtw

    per_lane = dtw.rows_per_lane(rows, cols, requested)
    if not per_lane:
        return 'dtw_strip'
    walked = min(rows, cols)
    idle = per_lane == 1 and _segment(walked, 1) == 32 and walked < 32
    return f'dtw_staged<{per_lane},{int(idle)}>'


def _segment(rows, per_lane):
    """Lanes of a pair in the staged DTW kernel: the power of two that
    covers ``rows`` rows at ``per_lane`` a lane."""
    seg = 1
    while seg * per_lane < rows:
        seg *= 2
    return seg


# ---------------------------------- the previous designs against this one

#: the pass-2 kernel's cases: a test_clean CMVN group (65 utterances,
#: about 48,000 frames), the half hour of the benchmark's longest
#: utterance's speaker, and a delta window wider than a tile
PASS_TWO_CASES = (('test_clean group', 0.134, (2, 2)),
                  ('half-hour group', 0.5, (2, 2)),
                  ('wide window', 0.02, (2, 300)))


def pass_two_group(hours, delta, seed):
    """Pass 2's packed input for one CMVN group of about ``hours`` of
    utterances of LibriSpeech test-clean's shape (log-normal 1.3-35 s):
    (features [T_i, 13] float32, pitch [T_i + s_i, 3], rows, the
    affine (scale, offset) [1, 13], delta), pitch off by -2..2 frames
    as the tolerance allows."""
    rng = np.random.RandomState(seed)
    features, pitches, rows = [], [], []
    while sum(rows) < hours * 360000:
        seconds = min(max(np.exp(rng.normal(1.85, 0.55)), 1.3), 35.0)
        nframes = int(seconds * 100) - 2
        shift = int(rng.randint(-2, 3))
        features.append((rng.randn(nframes, 13) * 5 + 3).astype(np.float32))
        pitches.append(rng.randn(nframes + shift, 3).astype(np.float32))
        rows.append(min(nframes, nframes + shift))
    affine = (np.abs(rng.randn(1, 13)) + 0.1, rng.randn(1, 13))
    return features, pitches, rows, affine, delta


def pass_two_kernel_phase(resources):
    """The pass-2 kernel against its plain version (on the CPU and on
    the card) at PASS_TWO_CASES, bit for bit, repeated launches equal;
    timed at each: the kernel's device time a launch (profiler), a
    ``compute`` call (the launch and the download of the rows, host
    clock), the packing and upload (``pack``), the plain version on the
    card (CUDA events) and on the CPU, beside the bound (the group's
    bytes read and written once at 3.35 TB/s). Returns (0.0, the times
    at the test_clean group for the kernels' JSON line)."""
    from shennong_tpu_torch.ops import pass_two

    phase = 'pass two kernel'
    begin = time.perf_counter()
    timed = None
    for label, hours, delta in PASS_TWO_CASES:
        features, pitches, rows, affine, delta = pass_two_group(
            hours, delta, seed=19)
        groups = [0] * len(features)

        def packed(device):
            return pass_two.pack(features, pitches, rows, groups, affine,
                                 delta, device=device)

        on_card = packed('cuda')
        out, nonfinite = pass_two.compute(on_card)
        host = packed('cpu')
        cpu_start = time.perf_counter()
        reference, cpu_nonfinite = pass_two.compute(host)
        cpu_ms = (time.perf_counter() - cpu_start) * 1e3

        def plain():
            return pass_two.pass_two_plain(
                *[on_card.tensor(name) for name in (
                    'feats', 'pitch', 'layout', 'scale', 'offset')],
                on_card.order, on_card.window)

        card_plain, _ = plain()
        check(nonfinite == cpu_nonfinite == 0,
              f'pass_two: {label} counted {nonfinite} non-finite values')
        check(out.shape == reference.shape and np.array_equal(out, reference),
              f'pass_two: {label} differs from the plain version on the CPU')
        check(np.array_equal(card_plain.cpu().numpy(), reference),
              f'pass_two: {label}: the plain version on the card differs '
              'from the CPU')
        for _ in range(3):
            check(np.array_equal(pass_two.compute(on_card)[0], out),
                  f'pass_two: {label} changed between launches')

        ms = kernel_device_ms(lambda: pass_two.compute(on_card), 20,
                              'pass_two_kernel')
        start = time.perf_counter()
        for _ in range(20):
            pass_two.compute(on_card)
        compute_ms = (time.perf_counter() - start) / 20 * 1e3
        start = time.perf_counter()
        for _ in range(20):
            packed('cuda')
        torch.cuda.synchronize()
        pack_ms = (time.perf_counter() - start) / 20 * 1e3
        plain_ms = cuda_ms(plain, 5)
        nbytes = 4 * (int(np.prod(on_card.shape('feats')))
                      + int(np.prod(on_card.shape('pitch'))) + out.size)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        kind = 'pass_two<f,f>'
        registers, stores, loads = resources[kind]
        say(phase, f'{label}: {len(features)} utterances, '
            f'{on_card.shape("feats")[0]} frames -> {tuple(out.shape)}, delta '
            f'{delta}, {on_card.tiles} tiles of {pass_two.TILE_ROWS} frames: '
            'equal to the plain version on the CPU and on the card, repeated '
            f'launches equal; kernel {ms:.4f} ms (profiler, device time a '
            'launch), '
            f'compute {compute_ms:.3f} ms (launch and download, host clock), '
            f'pack {pack_ms:.3f} ms (host, upload enqueued), plain on the '
            f'card {plain_ms:.3f} ms (CUDA events), plain on the CPU '
            f'{cpu_ms:.1f} ms; {kind}, {registers} registers, spills '
            f'{stores}/{loads} B; bound {bound_ms:.5f} ms by bytes '
            f'({nbytes} B), share of bound {bound_ms / ms:.4f}')
        if timed is None:
            timed = (ms, plain_ms, bound_ms, 'bytes')
    say(phase, f'phase time {time.perf_counter() - begin:.1f} s')
    return 0.0, timed


def ab_phase(resources):
    """The previous designs of the banded Viterbi and the DTW against
    this checkout's, in one process, in turns (previous, new, new,
    previous), at
    the CREPE slice's [33, 490, 360] and the ABX benchmark's [4096, 24,
    24]: the same outputs (paths equal; divergences the same bits, both
    adding cell by cell), and each turn's device time a launch
    (profiler). Returns {name: (previous ms, new ms)}, or None without
    the previous sources (AB_SOURCES, kept out of git)."""
    from shennong_tpu_torch.eval import abx
    from shennong_tpu_torch.ops import dtw, viterbi

    phase = 'a/b'
    if not resources['previous']:
        say(phase, f'skipped: no previous sources under {AB_SOURCES}; the '
            'times compare only with the spreads recorded in PERF.md')
        return None
    banded_path, dtw_path = resources['previous']['libraries']
    pointer, size = ctypes.c_void_p, ctypes.c_int
    old_banded = ctypes.CDLL(banded_path)
    old_banded.shennong_banded_viterbi.restype = ctypes.c_int
    old_banded.shennong_banded_viterbi.argtypes = [
        pointer, pointer, pointer, pointer, ctypes.c_float, ctypes.c_float,
        size, size, size, size, pointer, pointer, pointer]
    old_dtw = ctypes.CDLL(dtw_path)
    old_dtw.shennong_dtw.restype = ctypes.c_int
    old_dtw.shennong_dtw.argtypes = [
        pointer, pointer, pointer, size, size, size, pointer, pointer,
        pointer, pointer]
    stream = torch.cuda.current_stream().cuda_stream
    results = {}

    log_start, band, uniform, self_w = banded_prior()
    log_start_t = torch.as_tensor(log_start, dtype=torch.float32,
                                  device='cuda')
    band_t = torch.as_tensor(band, dtype=torch.float32, device='cuda')
    weights = viterbi._weights32(uniform, self_w)
    shape = (33, 490, 360)
    obs = banded_inputs(np.random.RandomState(6), shape)
    counts = torch.full((shape[0],), 401, dtype=torch.int32, device='cuda')
    back = torch.empty(shape, dtype=torch.int8, device='cuda')
    old_paths, new_paths = torch.empty_like(obs), torch.empty_like(obs)

    def old_k1():
        code = old_banded.shennong_banded_viterbi(
            obs.data_ptr(), counts.data_ptr(), log_start_t.data_ptr(),
            band_t.data_ptr(), *weights, *shape, band_t.shape[1],
            back.data_ptr(), old_paths.data_ptr(), stream)
        check(code == 0, f'previous banded Viterbi launch: CUDA error {code}')

    def new_k1():
        viterbi.launch_banded(log_start_t, band_t, *weights, obs, counts,
                              new_paths)

    rng = np.random.RandomState(7)
    pairs = (4096, 24, 24)
    x = torch.from_numpy(rng.randn(pairs[0], pairs[1], 13).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.randn(pairs[0], pairs[2], 13).astype(
        np.float32)).cuda()
    costs = abx._frame_costs(x, y, 'cosine').contiguous()
    nx = torch.full((pairs[0],), pairs[1], dtype=torch.int32, device='cuda')
    ny = torch.full((pairs[0],), pairs[2], dtype=torch.int32, device='cuda')
    old_div, new_div = (torch.empty(pairs[0], device='cuda')
                        for _ in range(2))
    empty = torch.empty(0, device='cuda')

    def old_k2():
        code = old_dtw.shennong_dtw(
            costs.data_ptr(), nx.data_ptr(), ny.data_ptr(), *pairs,
            empty.data_ptr(), empty.data_ptr(), old_div.data_ptr(), stream)
        check(code == 0, f'previous dtw launch: CUDA error {code}')

    def new_k2():
        dtw.launch_dtw(costs, nx, ny, new_div)

    for name, where, old, new, kernel, same in (
            ('banded_viterbi', shape, old_k1, new_k1, 'banded_viterbi_kernel',
             lambda: torch.equal(old_paths, new_paths)),
            ('dtw', pairs, old_k2, new_k2, 'dtw_kernel',
             lambda: torch.equal(old_div, new_div))):
        old()
        new()
        torch.cuda.synchronize()
        check(same(), f'{name}: the previous design and this checkout '
              f'disagree at {where}')
        turns = [(label, kernel_device_ms(fn, 20, kernel))
                 for label, fn in (('previous', old), ('new', new),
                                   ('new', new), ('previous', old))]
        before = (turns[0][1] + turns[3][1]) / 2
        after = (turns[1][1] + turns[2][1]) / 2
        results[name] = (before, after)
        say(phase, f'{name} at {where}, outputs equal; turns '
            + ', '.join(f'{label} {ms:.4f}' for label, ms in turns)
            + f' ms (profiler, device time a launch); previous {before:.4f} '
            f'ms, new {after:.4f} ms, {before / after:.2f}x')
    return results


# ------------------------------------------------------- ABX: the benchmark

ABX_DEVICE_TOL = 0.005   # card vs CPU on every ci error
ABX_CI_BAND = 0.030      # the magnitude locks of tests/test_abx_bench.py
ABX_FULL_BAND = 0.010    # the mfcc row of doc/performance.md
ABX_CI = {               # tests/test_abx_bench.py:35-42, 61-65
    ('across', 'mfcc'): {'raw': 0.339, '+cmvn': 0.207, 'vtln+cmvn': 0.171},
    ('within', 'mfcc'): {'raw': 0.308, '+cmvn': 0.259, 'vtln+cmvn': 0.252},
    ('across', 'rastaplp'): {'raw': 0.200, '+cmvn': 0.172,
                             'vtln+cmvn': 0.135},
    ('within', 'rastaplp'): {'raw': 0.160, '+cmvn': 0.139},
}
ABX_FULL = {             # doc/performance.md:343-361, seed 0
    'across': {'raw': 0.184, '+cmvn': 0.139, 'vtln+cmvn': 0.082},
    'within': {'raw': 0.110, '+cmvn': 0.109, 'vtln+cmvn': 0.109},
}


def abx_errors_line(errors, feature):
    return '; '.join(
        f'{task} ' + ' / '.join(
            f'{label} {100 * value:.2f}'
            for label, value in errors[task][feature].items())
        for task in ('across', 'within'))


def abx_phase(card):
    """The ABX benchmark (the port's quality anchor): 'ci' with mfcc and
    rastaplp on the card and on the CPU (every error within
    ABX_DEVICE_TOL of the CPU's and ABX_CI_BAND of the recorded values,
    their directions, the warps equal for every speaker), then 'full'
    mfcc on the card: its wall split by stage, DTW pairs a second, the
    DTW kernel's launches, the mfcc row against doc/performance.md
    (ABX_FULL_BAND), and a profiled run for the kernel's device time.
    Returns the DTW kernel's launches in the 'ci' and 'full' runs on
    the card, and the card's 'ci' result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shennong_tpu_torch.eval import abx_bench

    phase = 'abx'
    begin = time.perf_counter()
    ci = {}
    launches = 0
    for device in ('cuda', 'cpu'):
        reset_counters()
        start = time.perf_counter()
        ci[device] = abx_bench.benchmark(
            'ci', seed=0, features=('mfcc', 'rastaplp'), device=device)
        wall = time.perf_counter() - start
        count = launch_counts('dtw')['dtw']
        if device == 'cuda':
            launches += count
            check(count >= 6, f'abx ci: {count} DTW kernel launches')
        else:
            check(count == 0, 'abx ci on the cpu launched the DTW kernel')
        for feature in ('mfcc', 'rastaplp'):
            say(phase, f'ci on {device}, {feature} (%): '
                + abx_errors_line(ci[device]['errors'], feature))
        say(phase, f'ci on {device}: wall {wall:.2f} s ('
            + ', '.join(f'{stage} {seconds:.2f}' for stage, seconds
                        in ci[device]['seconds'].items())
            + f'), DTW kernel launches {count}')

    gap = 0.0
    for (task, feature), recorded in ABX_CI.items():
        for label, value in recorded.items():
            got = ci['cuda']['errors'][task][feature][label]
            cpu = ci['cpu']['errors'][task][feature][label]
            gap = max(gap, abs(got - cpu))
            check(abs(got - cpu) < ABX_DEVICE_TOL,
                  f'abx ci {task} {feature} {label}: cuda {got} cpu {cpu}')
            check(abs(got - value) < ABX_CI_BAND,
                  f'abx ci {task} {feature} {label}: {got} not within '
                  f'{ABX_CI_BAND} of {value}')
        errors = ci['cuda']['errors'][task][feature]
        check(errors['raw'] > errors['+cmvn'],
              f'abx ci {task} {feature}: cmvn does not help')
        if task == 'across':
            check(errors['+cmvn'] > errors['vtln+cmvn'],
                  f'abx ci across {feature}: vtln does not help')
    warps, alphas = ci['cuda']['warps'], ci['cuda']['alphas']
    differ = sorted(s for s in warps if warps[s] != ci['cpu']['warps'][s])
    check(not differ, f'abx ci: warps differ between cuda and cpu for '
          f'{differ}: {warps} vs {ci["cpu"]["warps"]}')
    ordered = [warps[s] for s in sorted(alphas, key=alphas.get)]
    check(all(a >= b for a, b in zip(ordered, ordered[1:])),
          f'abx ci: warps not monotone in alpha: {ordered}')
    say(phase, f'ci: cuda vs cpu max error gap {gap:.5f} < '
        f'{ABX_DEVICE_TOL}, every error within {ABX_CI_BAND} of the '
        f'recorded values, directions hold; warps equal for '
        f'{len(warps)} of {len(warps)} speakers, by alpha '
        + ', '.join(f'{alphas[s]:.3f}:{warps[s]}'
                    for s in sorted(alphas, key=alphas.get)))

    reset_counters()
    start = time.perf_counter()
    full = abx_bench.benchmark('full', seed=0, features=('mfcc',),
                               device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    count = launch_counts('dtw')['dtw']
    launches += count
    pairs = full['nsegments'] * (full['nsegments'] - 1) // 2
    conditions = len(full['errors']['across']['mfcc'])
    check(count >= conditions * -(-pairs // 4096),
          f'abx full: {count} DTW kernel launches')
    say(phase, 'full on cuda, mfcc (%): '
        + abx_errors_line(full['errors'], 'mfcc'))
    say(phase, f'full on cuda: {full["nsegments"]} segments, {pairs} pairs '
        f'per condition, {conditions} conditions; wall {wall:.2f} s ('
        + ', '.join(f'{stage} {seconds:.2f}'
                    for stage, seconds in full['seconds'].items())
        + f'); DTW {conditions * pairs / full["seconds"]["dtw"]:.0f} pairs '
        f'a second; DTW kernel launches {count} on {card}')
    for task, recorded in ABX_FULL.items():
        for label, value in recorded.items():
            got = full['errors'][task]['mfcc'][label]
            check(abs(got - value) < ABX_FULL_BAND,
                  f'abx full {task} mfcc {label}: {got} not within '
                  f'{ABX_FULL_BAND} of {value}')
    say(phase, f'full: the mfcc row within {ABX_FULL_BAND} of '
        'doc/performance.md')

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        abx_bench.benchmark('full', seed=0, features=('mfcc',),
                            device='cuda')
        torch.cuda.synchronize()
    # the spans appear on the device too, as annotations, not kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.key not in SPANS + (RUN_SPAN,)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    dtw_ms = sum(e.self_device_time_total for e in kernels
                 if 'dtw_kernel' in e.key) / 1e3
    dtw_count = sum(e.count for e in kernels if 'dtw_kernel' in e.key)
    if not busy:
        say(phase, 'full profile: device time not measured (the profiler '
            'saw no kernels)')
    else:
        say(phase, f'full profile: device busy {busy:.3f} ms of '
            f'{wall * 1e3:.1f} ms unprofiled wall (idle share '
            f'{1 - busy / (wall * 1e3):.3f}); dtw_kernel x{dtw_count} '
            f'{dtw_ms:.3f} ms')
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            say(phase, f'{e.self_device_time_total / 1e3:9.3f} ms  '
                f'x{e.count:<5d} {e.key[:90]}')
    say(phase, f'phase time {time.perf_counter() - begin:.1f} s')
    return launches, ci['cuda']


# --------------------------------------------------------------- examples

EXAMPLES = os.path.join(HERE, 'examples', 'torch')
#: tests/test_torch_pipeline.py's bounds of a reduced-precision fetch
FETCH_TOL = {'float16': 2e-3, 'bfloat16': 8 * 2e-3}
SUSTAINED_HOURS = 1.0    # the examples phase's sustained_scale run


def load_example(name):
    """The script ``examples/torch/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f'torch_example_{name}', os.path.join(EXAMPLES, name + '.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: the kernels B1 and B2, by their counter names
VITERBI = ('viterbi_forward', 'viterbi_backtrace')


def reset_counters():
    """Set every counter of the port to 0, the kernels' launch counts
    (``counters['launches.<kernel>']``) among them."""
    from shennong_tpu_torch.parallel.profiler import counters

    counters.reset()


def launch_counts(*kernels):
    """The launches of each of ``kernels`` (``'viterbi_forward'``,
    ``'banded_viterbi'``, ``'dtw'``, ...) since the counters' last
    reset, 0 for a kernel never launched."""
    from shennong_tpu_torch.parallel.profiler import counters

    snap = counters.snapshot()
    return {name: int(snap.get(f'launches.{name}', 0)) for name in kernels}


def counted(run):
    """``run()``, with every kernel's launch count set to 0 just before
    it: (its result, the launches of each kernel during it)."""
    reset_counters()
    out = run()
    torch.cuda.synchronize()
    return out, launch_counts(*VITERBI, 'banded_viterbi', 'dtw')


def same_collections(ours, ref, what):
    """Two FeaturesCollections with the same names and the same bits."""
    check(sorted(ours) == sorted(ref), f'{what}: other utterances')
    for name in ref:
        check(np.array_equal(ours[name].data, ref[name].data),
              f'{what}: {name} differs from the library call')


def dither_off(params):
    """A deep copy of a UBM's or a VTLN trainer's parameters with the
    MFCC dither of its features (and of its UBM's) at 0."""
    params = copy.deepcopy(params)
    for features in (params.get('features'),
                     params.get('ubm', {}).get('features')):
        if features:
            features['mfcc']['dither'] = 0.0
    return params


def examples_phase(card, workdir, entries, abx_ci):
    """Every card-runnable script of ``examples/torch/``, called in this
    process on 'cuda' (``multihost_cmvn`` starts its two processes on
    cuda:0): its numbers on lines of their own, its output held against
    the library calls it wraps on the same inputs with every random
    source at 0 (equal), its kernel launches counted from 0. Before
    them, the MFCC slice with ``fetch_dtype`` 'float16' and 'bfloat16'
    against 'float32': the bytes down and the largest relative gap.
    ``abx_ci`` is the 'ci' result of the abx phase. Returns the launches
    of each kernel over the scripts' runs."""
    from shennong_tpu_torch import Utterances, pipeline
    from shennong_tpu_torch.audio import Audio
    from shennong_tpu_torch.features_collection import FeaturesCollection
    from shennong_tpu_torch.parallel.profiler import counters

    phase = 'examples'
    begin = time.perf_counter()
    directory = os.path.join(workdir, 'examples')
    os.makedirs(directory, exist_ok=True)
    launches = {'viterbi_forward': 0, 'viterbi_backtrace': 0, 'dtw': 0}

    def tally(name, counts):
        for kernel in launches:
            launches[kernel] += counts[kernel]
        say(phase, f'{name}: launches ' + ', '.join(
            f'{kernel} {count}' for kernel, count in counts.items()))

    corpus = Utterances(entries)
    config = zero_randomness(slice_config('mfcc'), 'mfcc')

    # extract_features(fetch_dtype=...): the MFCC slice for the bytes
    # down (its CMVN scales the rounding of a column by 1 / its
    # deviation, so its gap is printed), then MFCC + pitch alone, the
    # configuration of tests/test_pipeline.py's bound, for the gap
    plain = zero_randomness(pipeline.get_default_config(
        'mfcc', with_pitch='kaldi'), 'mfcc')
    out, down = {}, {}
    with energy_dither_off():
        for fetch in ('float32', 'float16', 'bfloat16'):
            counters.reset()
            out['slice', fetch] = pipeline.extract_features(
                copy.deepcopy(config), corpus, fetch_dtype=fetch,
                device='cuda')
            down[fetch] = counters.snapshot()['bytes_down']
            out['plain', fetch] = pipeline.extract_features(
                copy.deepcopy(plain), corpus, fetch_dtype=fetch,
                device='cuda')
    floats = 2 * (down['float32'] - down['float16'])
    vad = down['float32'] - floats
    check(down['float16'] == down['bfloat16'] and 0 < vad < floats / 20,
          f'fetch_dtype: bytes down {down}')

    def gap(kind, fetch):
        exact = out[kind, 'float32']
        return max(float((np.abs(out[kind, fetch][n].data - exact[n].data)
                          / np.maximum(np.abs(exact[n].data), 1.0)).max())
                   for n in exact)

    for fetch in ('float16', 'bfloat16'):
        plain_gap = gap('plain', fetch)
        check(plain_gap < FETCH_TOL[fetch], f'fetch_dtype {fetch}: relative '
              f'gap {plain_gap} to float32, past {FETCH_TOL[fetch]}')
        say(phase, f'fetch_dtype {fetch}: MFCC slice bytes down '
            f'{int(down[fetch])} against {int(down["float32"])} for float32 '
            f'({down[fetch] / down["float32"]:.4f}; float parts '
            f'{int(floats)} -> {int(floats // 2)} B, VAD {int(vad)} B '
            f'unchanged); largest gap to float32 relative to max(|x|, 1): '
            f'MFCC + pitch {plain_gap:.3g} < {FETCH_TOL[fetch]}, the slice '
            f'(after CMVN) {gap("slice", fetch):.3g}')

    # extract_corpus: the phase's corpus, --pitch --cmvn --delta, to .npz
    module = load_example('extract_corpus')
    output = os.path.join(directory, 'corpus.npz')
    with energy_dither_off():
        report, counts = counted(lambda: module.extract(
            corpus, output, pitch=True, cmvn=True, delta=True, device='cuda',
            config=copy.deepcopy(config)))
        ref = pipeline.extract_features(
            copy.deepcopy(config), corpus, device='cuda')
    same_collections(report['features'], ref, 'extract_corpus')
    same_collections(FeaturesCollection.load(output), ref,
                     'extract_corpus file')
    say(phase, f'extract_corpus: {len(ref)} utterances, '
        f'{report["hours"] * 3600:.0f} s of audio in '
        f'{report["seconds"]:.3f} s, xRT {report["xrt"]:.1f}; equal to '
        'extract_features')
    tally('extract_corpus', counts)

    # serve_throughput at its defaults (batches of 16), then of 64
    from shennong_tpu_torch.ops import mel as melmod
    from shennong_tpu_torch.ops.framing import num_frames
    from shennong_tpu_torch.ops.pitch import (
        PitchOpts, ProcessPitchOpts, num_pitch_frames)
    from shennong_tpu_torch.ops.spectral import MfccOpts
    from shennong_tpu_torch.parallel.fused import mfcc_pitch_pipeline

    module = load_example('serve_throughput')
    for batch in (16, 64):
        report, counts = counted(
            lambda: module.serve(batch=batch, device='cuda'))
        frames = report['features'].shape[1]
        check(counts['viterbi_forward'] == counts['viterbi_backtrace'] == 16,
              f'serve_throughput: {counts}')
        say(phase, f'serve_throughput batch {batch} x 5 s: xRT by window '
            + ', '.join(f'{x:.1f}' for x in report['xrt'])
            + ' (ms a batch ' + ', '.join(
                f'{ms:.3f}' for ms in report['ms_per_batch'])
            + f'), first batch {report["first_s"]:.3f} s; B1 at [{batch}, '
            f'{frames}, 417] on {card}')
        tally(f'serve_throughput batch {batch}', counts)
    report = module.serve(batch=16, windows=1, iterations=1, dither=0.0,
                          device='cuda')
    opts = MfccOpts()
    opts = dataclasses.replace(
        opts, frame=dataclasses.replace(opts.frame, dither=0.0))
    ref, ref_frames = mfcc_pitch_pipeline(
        report['signals'], report['nsamples'], torch.as_tensor(
            melmod.mel_banks(23, opts.frame.padded_window_size, 16000.0,
                             20.0, 0.0, 100.0, -500.0, 1.0)[0],
            device='cuda'),
        opts, PitchOpts(), ProcessPitchOpts(), num_frames(80000, opts.frame),
        num_pitch_frames(80000, PitchOpts()), device='cuda')
    check(torch.equal(report['features'], ref)
          and torch.equal(report['frames'], ref_frames),
          'serve_throughput: not the bits of mfcc_pitch_pipeline')
    say(phase, 'serve_throughput, no dither: equal to mfcc_pitch_pipeline')

    # long_audio at its default 2 minutes, every dither at 0
    module = load_example('long_audio')
    report, counts = counted(lambda: module.run(dither=0.0, device='cuda'))
    for name, proc in module.stages(dither=0.0):
        ref = proc.process(report['audio'], device='cuda')
        check(np.array_equal(report['stages'][name]['features'].data,
                             ref.data), f'long_audio {name}: differs')
        stage = report['stages'][name]
        say(phase, f'long_audio {name}: {report["seconds"]:.0f} s, cold '
            f'{stage["cold"]:.3f} s, warm {stage["warm"]:.3f} s, xRT '
            f'{stage["xrt"]:.1f}; equal to the processor')
    tally('long_audio', counts)

    # vtln_warps on the phase's corpus, the default trainer, no dither
    module = load_example('vtln_warps')
    from shennong_tpu_torch.processor import VtlnProcessor

    params = dither_off(VtlnProcessor().get_params())
    features_config = pipeline.get_default_config(
        'mfcc', with_cmvn=True, with_delta=True)
    features_config['mfcc']['dither'] = 0
    with energy_dither_off():
        start = time.perf_counter()
        report, counts = counted(lambda: module.train(
            corpus, os.path.join(directory, 'warps.yaml'),
            os.path.join(directory, 'warped.npz'), device='cuda',
            vtln=VtlnProcessor(**copy.deepcopy(params)),
            config=copy.deepcopy(features_config)))
        wall = time.perf_counter() - start
        training = corpus.fit_to_duration(300.0, truncate=True, shuffle=False)
        warps = VtlnProcessor(**copy.deepcopy(params)).process(
            training, group_by='speaker', device='cuda')
        ref = pipeline.extract_features(
            copy.deepcopy(features_config), corpus, warps=warps,
            device='cuda')
    check(report['warps'] == warps, f'vtln_warps: warps {report["warps"]} '
          f'against {warps}')
    same_collections(report['features'], ref, 'vtln_warps')
    say(phase, f'vtln_warps: {len(warps)} speakers warped to '
        f'{sorted(set(warps.values()))} in {wall:.2f} s (training and '
        'warped extraction); warps and features equal to the library')
    tally('vtln_warps', counts)

    # training_bench at its defaults, then features_abx --synthetic 200,
    # on one synthetic corpus
    from shennong_tpu_torch.processor.ubm import DiagUbmProcessor

    synthetic = os.path.join(directory, 'abx')
    module = load_example('training_bench')
    ubm = dict(module.UBM, features=dither_off(
        {'features': DiagUbmProcessor(64).features})['features'])
    vtln = dither_off(dict(VtlnProcessor().get_params(), **module.VTLN))
    vtln['ubm'] = dict(vtln['ubm'], **ubm)
    report, counts = counted(lambda: module.bench(
        synthetic, device='cuda', ubm=ubm, vtln=vtln))
    bench_corpus = Utterances(load_example('example_utils')
                              .make_synthetic_corpus(
                                  os.path.join(synthetic, 'corpus'), 200))
    ref_ubm = DiagUbmProcessor(**copy.deepcopy(ubm))
    ref_ubm.process(bench_corpus, njobs=4, device='cuda')
    ref_warps = VtlnProcessor(**copy.deepcopy(vtln)).process(
        bench_corpus, group_by='speaker', njobs=4, device='cuda')
    gap = max(float(np.abs(getattr(report['ubm_model'].gmm, name)
                           - getattr(ref_ubm.gmm, name)).max())
              for name in ('weights', 'means', 'inv_vars'))
    check(gap == 0, f'training_bench: the UBM differs from the library '
          f'call by {gap}')
    check(report['warps'] == ref_warps, 'training_bench: warps differ')
    for label in ('ubm', 'vtln'):
        walls = report[label]
        say(phase, f'training_bench {label} ({report["seconds"]:.0f} s of '
            f'audio): cold {walls[0]:.3f} s, warm ' + ', '.join(
                f'{w:.3f}' for w in walls[1:]) + ' s; xRT warm '
            + ', '.join(f'{report["seconds"] / w:.1f}' for w in walls[1:]))
    say(phase, 'training_bench: the UBM and the warps equal to the library')
    tally('training_bench', counts)

    module = load_example('features_abx')
    with energy_dither_off():
        report, counts = counted(lambda: module.prepare(
            synthetic, synthetic=200, ext='.npz', device='cuda',
            vtln=VtlnProcessor(**copy.deepcopy(params)), dither=0.0))
        training = bench_corpus.fit_to_duration(
            100.0, truncate=True, shuffle=False)
        warps = VtlnProcessor(**copy.deepcopy(params)).process(
            training, group_by='speaker', device='cuda')
        check(report['warps'] == warps, 'features_abx: warps differ')
        for name, with_cmvn, warped in module.CONFIGS:
            abx_config = pipeline.get_default_config(
                'mfcc', with_cmvn=with_cmvn, with_delta=True)
            abx_config['mfcc']['dither'] = 0.0
            same_collections(report['features'][name],
                             pipeline.extract_features(
                                 abx_config, bench_corpus,
                                 warps=warps if warped else None,
                                 device='cuda'), f'features_abx {name}')
            same_collections(FeaturesCollection.load(report['outputs'][name]),
                             report['features'][name],
                             f'features_abx {name} file')
    say(phase, f'features_abx ({report["seconds"]:.0f} s of audio): '
        + ', '.join(f'{stage} {wall:.3f} s (xRT '
                    f'{report["seconds"] / wall:.1f})'
                    for stage, wall in report['timings'].items())
        + '; warps and features equal to the library')
    tally('features_abx', counts)

    # abx_benchmark --config ci (every feature) and abx_score
    module = load_example('abx_benchmark')
    report, counts = counted(lambda: module.run('ci', device='cuda'))
    check(counts['dtw'] > 0, 'abx_benchmark: the DTW kernel never ran')
    for feature in ('mfcc', 'rastaplp'):
        for task in ('across', 'within'):
            check(report['errors'][task][feature]
                  == abx_ci['errors'][task][feature],
                  f'abx_benchmark {task} {feature}: not the abx phase\'s')
    say(phase, f'abx_benchmark ci: {len(report["errors"]["across"])} '
        f'features in {report["elapsed"]:.2f} s; mfcc and rastaplp equal to '
        'the abx phase\'s benchmark call')
    for feature in report['errors']['across']:
        say(phase, f'abx_benchmark ci {feature} (%): '
            + abx_errors_line(report['errors'], feature))
    tally('abx_benchmark', counts)

    module = load_example('abx_score')
    start = time.perf_counter()
    report, counts = counted(
        lambda: module.run(os.path.join(directory, 'score'), device='cuda'))
    wall = time.perf_counter() - start
    cpu = module.run(os.path.join(directory, 'score_cpu'), device='cpu')
    for label, errors in report['errors'].items():
        check(all(abs(a - b) < ABX_DEVICE_TOL
                  for a, b in zip(errors, cpu['errors'][label])),
              f'abx_score {label}: cuda {errors} cpu {cpu["errors"][label]}')
        say(phase, f'abx_score {label}: across {errors[0]:.4f}, within '
            f'{errors[1]:.4f} (cpu {cpu["errors"][label][0]:.4f}, '
            f'{cpu["errors"][label][1]:.4f})')
    check(counts['dtw'] > 0, 'abx_score: the DTW kernel never ran')
    say(phase, f'abx_score: {wall:.2f} s on the card')
    tally('abx_score', counts)

    # pitch_comparison on tests/data/test.wav
    from shennong_tpu_torch.processor import (
        CrepePitchProcessor, KaldiPitchProcessor)

    module = load_example('pitch_comparison')
    start = time.perf_counter()
    report, counts = counted(lambda: module.run(device='cuda'))
    wall = time.perf_counter() - start
    clean = Audio.load(module.DEFAULT_AUDIO).channel(0)
    kaldi, crepe = report['tracks'][float('inf')]
    ref_kaldi = KaldiPitchProcessor().process(clean, device='cuda').data
    ref_crepe = CrepePitchProcessor(model_capacity='tiny').process(
        clean, device='cuda').data
    check(np.array_equal(kaldi, ref_kaldi[:len(kaldi)])
          and np.array_equal(crepe, ref_crepe[:len(crepe)]),
          'pitch_comparison: the clean tracks differ from the processors')
    check(counts['viterbi_forward'] == len(module.SNR_LIST),
          f'pitch_comparison: {counts}')
    say(phase, f'pitch_comparison: {len(module.SNR_LIST)} conditions in '
        f'{wall:.2f} s; the clean tracks equal to the processors')
    tally('pitch_comparison', counts)

    # plot_features: its features (matplotlib may be missing here)
    module = load_example('plot_features')
    audio = Audio.load(module.DEFAULT_WAV).channel(0)
    (features, skipped), counts = counted(
        lambda: module.extract(audio, device='cuda', dither=0.0))
    from shennong_tpu_torch import processor as processors

    for name, cls in (('spectrogram', processors.SpectrogramProcessor),
                      ('filterbank', processors.FilterbankProcessor),
                      ('mfcc', processors.MfccProcessor),
                      ('plp', processors.PlpProcessor)):
        check(np.array_equal(features[name].data, cls(dither=0).process(
            audio, device='cuda').data), f'plot_features {name}: differs')
    say(phase, f'plot_features: {sorted(features)} equal to the '
        f'processors; skipped {skipped}')
    tally('plot_features', counts)

    # multihost_cmvn: two processes on cuda:0 over gloo
    module = load_example('multihost_cmvn')
    start = time.perf_counter()
    report = module.launch(2, device='cuda:0',
                           workdir=os.path.join(directory, 'multihost'))
    say(phase, f'multihost_cmvn: 2 processes on cuda:0 in '
        f'{time.perf_counter() - start:.2f} s, {report["frames"]} frames, '
        f'statistics bit-equal to one process\'s (mean[:3] '
        f'{np.round(report["mean"][:3], 4).tolist()})')

    # sustained_scale at 1 h
    module = load_example('sustained_scale')
    report, counts = counted(lambda: module.run(
        SUSTAINED_HOURS, os.path.join(directory, 'scale'), device='cuda'))
    check(counts['viterbi_forward'] > 0, 'sustained_scale: no B1 launch')
    say(phase, f'sustained_scale {report["audio_hours"]:.3f} h, '
        f'{report["utterances"]} utterances: extract '
        f'{report["extract_s"]:.3f} s, xRT {report["sustained_xrt"]:.1f}; '
        f'RSS {report["rss_baseline_mb"]:.1f} -> '
        f'{report["rss_peak_mb"]:.1f} MB; pool peak '
        f'{report["pool_peak_bytes"]} B <= held {report["pool_held_bytes"]} B '
        f'+ bound {report["pool_bound_bytes"]} B')
    tally('sustained_scale', counts)

    say(phase, f'phase time {time.perf_counter() - begin:.1f} s, launches '
        f'{launches}')
    return launches


#: the port's profiler spans (torch.profiler.record_function)
SPANS = ('pass1.dispatch', 'pass1.wait', 'batch.dispatch', 'batch.wait',
         'batch.chunked', 'pass2', 'plp.rasta', 'plp.durbin', 'ubm.frontend',
         'ubm.init', 'ubm.em', 'vtln.moments', 'vtln.solve', 'vtln.gselect',
         'vtln.rounds', 'crepe.load', 'crepe.cnn', 'crepe.decode',
         'crepe.post', 'bottleneck.frontend', 'bottleneck.forward')
RUN_SPAN = 'chip_smoke.run'


def print_parts(phase, prof, parts):
    """The profiled run's wall split at the first start of each part's
    span (host clock): the set-up before the first, each part up to the
    next, the last up to the end of the run."""
    from torch.autograd import DeviceType

    events = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.name in SPANS + (RUN_SPAN,) and e.device_type == DeviceType.CPU)
    run = next((s, e) for s, e, name in events if name == RUN_SPAN)
    marks, cursor = [('set-up', run[0])], run[0]
    for label, span in parts:
        found = next((s for s, _, name in events
                      if name == span and s >= cursor), None)
        check(found is not None, f'{phase}: no span {span} after {label}')
        marks.append((label, found))
        cursor = found
    marks.append(('end', run[1]))
    pieces = [(label, (marks[i + 1][1] - at) / 1e3)
              for i, (label, at) in enumerate(marks[:-1])]
    say(phase, f'profiled wall {(run[1] - run[0]) / 1e3:.1f} ms: ' + ', '.join(
        f'{label} {ms:.1f} ms' for label, ms in pieces))


def profile_layers(phase, config, utterances, wall_s, parts=None, run=None):
    """One more run under torch.profiler (``extract_features`` of
    ``config``, or ``run()``): device busy time by kernel, and for each
    span of the port its host time and the device time of the kernels
    launched inside it; with ``parts``, the run's wall split into
    stages (:func:`print_parts`)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.parallel.profiler import profiler_options

    # every thread's spans: pass 2 runs on the thread pass-two
    with profile(**profiler_options()) as prof:
        with torch.profiler.record_function(RUN_SPAN):
            if run is None:
                pipeline.extract_features(
                    copy.deepcopy(config), utterances, device='cuda')
            else:
                run()
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
         and e.key not in SPANS + (RUN_SPAN,)),
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
    if parts:
        print_parts(phase, prof, parts)


def main():
    card = probe()
    resources = build_kernels()
    errors, times = kernels_vs_plain(resources)
    errors['banded_viterbi'], times['banded_viterbi'] = banded_kernel_phase(
        resources)
    errors['dtw'], times['dtw'], dtw_ties = dtw_kernel_phase(resources)
    errors['pass_two'], times['pass_two'] = pass_two_kernel_phase(resources)
    ab_phase(resources)
    goldens()
    workdir = os.path.join(HERE, 'build', 'chip_smoke_corpus')
    launches = {'viterbi_forward': 0, 'viterbi_backtrace': 0, 'pass_two': 0}
    try:
        entries = make_corpus(workdir)
        for features in ('mfcc', 'plp'):
            counts, _ = the_slice(card, entries, features)
            for name, count in counts.items():
                launches[name] += count
        counts = pitch_options_phase(card, entries, resources, errors)
        for name, count in counts.items():
            launches[name] += count
        frontends_pass(card, entries)
        cli_phase(workdir, entries)
        counts, chunk_errors = long_audio(card, workdir, entries, resources)
        for name, count in counts.items():
            launches[name] += count
            errors[name] = max(errors[name], chunk_errors[name])
        for name, count in host_plane(card, workdir, entries).items():
            launches[name] += count
        for name, count in vtln_slice(card, entries).items():
            launches[name] += count
        for name, count in distributed_phase(card, workdir, entries).items():
            launches[name] += count
        launches.update(crepe_slice(card, workdir, entries))
        crepe_full(card, entries)
        bottleneck_phase(card, workdir, entries)
        launches['dtw'], abx_ci = abx_phase(card)
        for name, count in examples_phase(
                card, workdir, entries, abx_ci).items():
            launches[name] += count
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels = {
        'viterbi_forward': ('shennong_tpu_torch/csrc/viterbi.cu',
                            'shennong_tpu/ops/pallas_viterbi.py:77'),
        'viterbi_backtrace': ('shennong_tpu_torch/csrc/viterbi.cu',
                              'shennong_tpu/ops/pallas_viterbi.py:183'),
        # a lax.scan, not a Pallas kernel: the CREPE device decode
        'banded_viterbi': ('shennong_tpu_torch/csrc/banded_viterbi.cu',
                           'shennong_tpu/ops/viterbi.py:133'),
        # a lax.scan with an associative_scan: the ABX evaluator's DTW
        'dtw': ('shennong_tpu_torch/csrc/dtw.cu',
                'shennong_tpu/eval/abx.py:65'),
        # host code in both packages: pass 2 of the pipeline
        'pass_two': ('shennong_tpu_torch/csrc/pass_two.cu', None),
    }
    print(json.dumps({'kernels': [
        {'name': name, 'route': 'cuda', 'source': source,
         'replaces': replaces, 'launches': launches[name],
         'max_abs_err': errors[name], 'ms': times[name][0],
         'plain_ms': times[name][1], 'bound_ms': times[name][2],
         'bound_by': times[name][3],
         # no single PyTorch call computes a Viterbi, a DTW or pass 2
         'library_ms': None,
         # the DTW's pairs past DTW_TOL, each a proven near-tie, are
         # counted here and kept out of its max_abs_err
         **(dtw_ties if name == 'dtw' else {})}
        for name, (source, replaces) in kernels.items()]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--worker']:
        distributed_worker(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ['--first-call']:
        first_call(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ['--spectrogram-pass']:
        spectrogram_pass(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ['--pass-two']:
        probe()
        pass_two_kernel_phase(build_kernels())
    else:
        main()
