#!/usr/bin/env python
"""Sustained-scale extraction on a card: hours of audio, one call.

The PyTorch port's counterpart of ``examples/sustained_scale.py``. It
synthesizes a WAV corpus of about ``--hours`` hours on disk (20 s and
30 s utterances in turn, 16 speakers), runs one ``extract_features``
(MFCC + Kaldi pitch + CMVN/VAD + deltas, the pitch Viterbi in the CUDA
kernels) over it while a thread samples the process's RSS, and reports
the sustained real-time factor, the RSS and the host audio plane.

The audio plane is bounded by the port's own rule, which this script
checks: the upload pool (:func:`shennong_tpu_torch.parallel.stream.
pool_peak_bytes`) holds at most min(batches, 2 * depth + 1) int16
buffers of each batch shape of the plan, on top of what it held when
the run began. It grows with the plan's distinct shapes, not with the
corpus's length.

Run:  python examples/torch/sustained_scale.py [--hours 7.2] [--workdir D]
          [--device cuda]
"""

import os
import sys

# run from a source checkout without installation
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, os.pardir), HERE]

import argparse
import collections
import gc
import json
import shutil
import tempfile
import threading
import time

import numpy as np

from example_utils import add_device_option, device_of

DEPTH = 2        # the fused executor's and the stream's depth
BATCH_SIZE = 64  # utterances a batch of the fused executor


def make_signal(nsamples, sample_rate, seed):
    """Speech-like int16 waveform, the JAX example's."""
    rng = np.random.RandomState(seed)
    t = np.arange(nsamples) / sample_rate
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t + seed)
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    voiced = sum((0.6 ** k) * np.sin((k + 1) * phase) for k in range(6))
    envelope = (0.5 * (1 + np.sin(2 * np.pi * 3.1 * t))) ** 2
    signal = voiced * envelope * 0.4 + rng.randn(nsamples) * 0.02
    return (signal / np.abs(signal).max() * 2 ** 15 * 0.7).astype(
        np.int16)


def build_corpus(path, hours, sample_rate=16000):
    """Write a WAV corpus of about ``hours`` hours, 20 s and 30 s
    utterances in turn (two signal buckets): the JAX example's files.
    Returns (Utterances, audio seconds)."""
    import scipy.io.wavfile

    from shennong_tpu_torch.utterances import Utterances

    entries, total = [], 0.0
    durations = (20.0, 30.0)
    i = 0
    while total < hours * 3600:
        duration = durations[i % len(durations)]
        nsamples = int(sample_rate * duration)
        wav = os.path.join(path, f'utt{i:05d}.wav')
        scipy.io.wavfile.write(
            wav, sample_rate, make_signal(nsamples, sample_rate, i))
        entries.append((f'utt{i:05d}', wav, f'spk{i % 16}'))
        total += duration
        i += 1
    return Utterances(entries), total


def rss_mb():
    """The process's RSS in MB, from /proc/self/status."""
    with open('/proc/self/status') as fp:
        for line in fp:
            if line.startswith('VmRSS:'):
                return int(line.split()[1]) / 1024.0
    return 0.0


class RssSampler:
    """A thread sampling the RSS every ``interval`` seconds."""

    def __init__(self, interval=0.2):
        self.interval = interval
        self.peak = rss_mb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval):
            self.peak = max(self.peak, rss_mb())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_mb())


def pool_bound(utterances):
    """The most bytes of int16 batch buffers that one fused run over
    ``utterances`` adds to the upload pool: a buffer is made only when
    none of its shape is pooled, and at most 2 * depth + 1 batches are
    alive at once (depth decoding ahead, depth on the device, the one
    being dispatched), so a shape has at most that many buffers, and
    never more than its batches."""
    from shennong_tpu_torch.ops.framing import bucket_size
    from shennong_tpu_torch.parallel.stream import _scan_count, plan_batches

    shapes = collections.Counter(
        (len(chunk), bucket_size(max(_scan_count(u) for u in chunk)))
        for chunk in plan_batches(list(utterances), BATCH_SIZE))
    return sum(min(count, 2 * DEPTH + 1) * 2 * rows * samples
               for (rows, samples), count in shapes.items())


def run(hours=7.2, workdir=None, njobs=None, *, device):
    """Synthesize the corpus under ``workdir`` (a fresh temporary
    directory, removed afterwards, when None), extract it once on
    ``device`` after a warm pass over its first quarter, and check the
    audio plane's bound. Returns the report dict (also printed)."""
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.parallel import stream
    from shennong_tpu_torch.utterances import Utterances

    created = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix='shennong_scale_')
    os.makedirs(workdir, exist_ok=True)
    try:
        print(f'synthesizing ~{hours:.2f} h corpus under {workdir}...',
              flush=True)
        start = time.perf_counter()
        utterances, audio_seconds = build_corpus(workdir, hours)
        synthesis_s = time.perf_counter() - start
        wav_bytes = sum(
            os.path.getsize(os.path.join(workdir, f))
            for f in os.listdir(workdir) if f.endswith('.wav'))
        print(f'  {len(utterances)} utterances, '
              f'{audio_seconds / 3600:.2f} h, '
              f'{wav_bytes / 2 ** 30:.2f} GiB on disk '
              f'({synthesis_s:.0f} s)', flush=True)

        config = pipeline.get_default_config(
            'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
        njobs = njobs or os.cpu_count() or 1

        # a warm pass over the first quarter (the same batch geometries):
        # the CUDA context, cuFFT plans, the allocators and the pool
        # materialize here, so the run below measures what scales
        quarter = Utterances(list(utterances)[:max(1, len(utterances) // 4)])
        start = time.perf_counter()
        warm = pipeline.extract_features(
            config, quarter, njobs=njobs, device=device)
        warm_s = time.perf_counter() - start
        print(f'  warm pass: {len(warm)} utterances in {warm_s:.1f} s',
              flush=True)
        del warm
        gc.collect()

        baseline = rss_mb()
        stream.pool_reset_peak()
        held = stream.pool_peak_bytes()
        with RssSampler() as sampler:
            start = time.perf_counter()
            features = pipeline.extract_features(
                config, utterances, njobs=njobs, device=device)
            extract_s = time.perf_counter() - start
        assert len(features) == len(utterances)
        peak = stream.pool_peak_bytes()
        bound = pool_bound(utterances)

        features_bytes = sum(
            f.data.nbytes + f.times.nbytes for f in features.values())
        report = {
            'utterances': len(utterances),
            'audio_hours': audio_seconds / 3600,
            'synthesis_s': synthesis_s,
            'warm_s': warm_s,
            'extract_s': extract_s,
            'sustained_xrt': audio_seconds / extract_s,
            'rss_baseline_mb': baseline,
            'rss_peak_mb': sampler.peak,
            'rss_delta_mb': sampler.peak - baseline,
            'pool_held_bytes': held,
            'pool_peak_bytes': peak,
            'pool_bound_bytes': bound,
            'features_mb': features_bytes / 2 ** 20,
            'corpus_int16_mb': audio_seconds * 16000 * 2 / 2 ** 20,
        }
        print(json.dumps(report, indent=1), flush=True)
        if peak > held + bound:
            raise AssertionError(
                f'the audio plane peaked at {peak} B, past the {held} B the '
                f'pool held plus the plan bound of {bound} B')
        return report
    finally:
        if created:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--hours', type=float, default=7.2)
    parser.add_argument(
        '--workdir', default=None,
        help='corpus directory (default: a fresh temporary directory, '
        'removed afterwards)')
    parser.add_argument('-j', '--njobs', type=int, default=None,
                        help='decode threads [the CPU count]')
    add_device_option(parser)
    args = parser.parse_args(argv)
    run(args.hours, args.workdir, args.njobs, device=device_of(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
