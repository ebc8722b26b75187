#!/usr/bin/env python
"""Serving-style throughput of the fused extraction pipeline on a card.

The PyTorch port's counterpart of ``examples/serve_throughput.py``. It
runs the one-call MFCC + CMVN + delta + Kaldi-pitch pipeline
(:func:`shennong_tpu_torch.parallel.fused.mfcc_pitch_pipeline`, the
pitch Viterbi in the CUDA kernels) the way a feature service would:
the batches of a window are uploaded first, then dispatched back to
back, and the device is synchronized once per window. Each window
reports its real-time factor with no decode, upload or host pass 2 in
it: what the card sustains as fast as the host enqueues the call's
operations.

    python examples/torch/serve_throughput.py --batch 16 --seconds 5
"""

import os
import sys

# run from a source checkout without installation
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, os.pardir), HERE]

import argparse
import dataclasses
import time

import numpy as np
import torch

from example_utils import add_device_option, device_of, synchronize


def serve(batch=16, seconds=5.0, windows=3, iterations=5, dither=1.0, *,
          device):
    """Dispatch ``windows`` windows of ``iterations`` batches of
    ``batch`` utterances of ``seconds`` seconds on ``device``.

    The utterances are a 130 Hz harmonic with fresh noise a batch (a
    ``numpy.random.RandomState(0)``, as the JAX example draws them);
    the MFCC dither, ``dither``, draws from a ``torch.Generator`` seeded
    with 0. Returns a dict: ``first_s`` (the first batch, its
    setup included), per window ``xrt`` and ``ms_per_batch``, and the
    last window's last batch: its ``signals`` and ``nsamples``, and its
    ``features`` [B, F, 42] and ``frames`` [B] on ``device``.
    """
    from shennong_tpu_torch.ops import mel as melmod
    from shennong_tpu_torch.ops.framing import num_frames
    from shennong_tpu_torch.ops.pitch import (
        PitchOpts, ProcessPitchOpts, num_pitch_frames)
    from shennong_tpu_torch.ops.spectral import MfccOpts
    from shennong_tpu_torch.parallel.fused import mfcc_pitch_pipeline

    device = torch.device(device)
    rate = 16000
    count = int(rate * seconds)
    rng = np.random.RandomState(0)
    t = np.arange(count) / rate
    base = np.sin(2 * np.pi * 130 * t) * 8000

    mfcc_opts = MfccOpts()
    mfcc_opts = dataclasses.replace(
        mfcc_opts, frame=dataclasses.replace(mfcc_opts.frame, dither=dither))
    pitch_opts = PitchOpts()
    post_opts = ProcessPitchOpts()
    mel_weights = torch.as_tensor(melmod.mel_banks(
        23, mfcc_opts.frame.padded_window_size, float(rate),
        20.0, 0.0, 100.0, -500.0, 1.0)[0], device=device)
    nframes_max = num_frames(count, mfcc_opts.frame)
    pitch_max = num_pitch_frames(count, pitch_opts)
    nsamples = torch.full((batch,), count, dtype=torch.int32, device=device)
    generator = torch.Generator(device).manual_seed(0)

    def new_batch():
        noise = rng.randn(batch, count) * 50
        return torch.from_numpy(
            (base[None, :] + noise).astype(np.float32)).to(device)

    def run(signals):
        return mfcc_pitch_pipeline(
            signals, nsamples, mel_weights, mfcc_opts, pitch_opts,
            post_opts, nframes_max, pitch_max, device=device,
            generator=generator)

    start = time.perf_counter()
    run(new_batch())
    synchronize(device)
    first_s = time.perf_counter() - start

    report = {'first_s': first_s, 'xrt': [], 'ms_per_batch': []}
    audio = batch * seconds * iterations
    for window in range(windows):
        batches = [new_batch() for _ in range(iterations)]
        # the uploads are done: the window measures extraction, not the
        # host-to-device link
        synchronize(device)
        start = time.perf_counter()
        outs = [run(signals) for signals in batches]
        synchronize(device)
        elapsed = time.perf_counter() - start
        report['xrt'].append(audio / elapsed)
        report['ms_per_batch'].append(elapsed * 1000 / iterations)
        print(f'window {window}: {audio / elapsed:10.0f}x real-time '
              f'({elapsed * 1000 / iterations:.1f} ms/batch, {device})',
              flush=True)
    report['signals'] = batches[-1]
    report['nsamples'] = nsamples
    report['features'], report['frames'] = outs[-1]
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--batch', type=int, default=16,
                        help='utterances per batch [%(default)s]')
    parser.add_argument('--seconds', type=float, default=5.0,
                        help='seconds per utterance [%(default)s]')
    parser.add_argument('--windows', type=int, default=3,
                        help='measurement windows [%(default)s]')
    parser.add_argument('--iterations', type=int, default=5,
                        help='batches per window [%(default)s]')
    add_device_option(parser)
    args = parser.parse_args(argv)
    report = serve(args.batch, args.seconds, args.windows, args.iterations,
                   device=device_of(args.device))
    print(f'first batch (setup included): {report["first_s"]:.2f} s')
    return 0


if __name__ == '__main__':
    sys.exit(main())
