#!/usr/bin/env python
"""Hour-scale extraction of one recording on a card.

The PyTorch port's counterpart of ``examples/long_audio.py``. The
processors route signals past their ``AUTO_CHUNK_FRAMES`` through
bounded-memory chunked extraction on their own: frame computers past
60,000 frames, the Kaldi pitch tracker with Viterbi context halos (the
CUDA Viterbi kernels at [8, 8400, 417] a chunk group), and CREPE. This
script synthesizes an N-minute waveform and reports the cold and warm
wall clock and the real-time factor of each extractor.

Usage:
    python examples/torch/long_audio.py [--minutes 2] [--crepe] [--device cuda]
"""

import os
import sys

# run from a source checkout without installation
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, os.pardir), HERE]

import argparse
import time

import numpy as np

from example_utils import add_device_option, device_of, synchronize


def make_signal(minutes, rate=16000):
    """A speech-like waveform of ``minutes`` minutes, the JAX example's."""
    n = int(minutes * 60 * rate)
    t = np.arange(n) / rate
    rng = np.random.RandomState(0)
    f0 = 120 + 25 * np.sin(2 * np.pi * 0.23 * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    sig = sum((0.6 ** k) * np.sin((k + 1) * phase) for k in range(5))
    sig = (sig * (0.5 + 0.5 * np.sin(2 * np.pi * 1.1 * t) ** 2)
           + 0.02 * rng.randn(n))
    return (sig / np.abs(sig).max() * 0.6).astype(np.float32)


def stages(crepe=False, dither=None):
    """(name, processor) of each extractor, as the JAX example makes
    them; ``dither`` other than None sets the dither of those that have
    one."""
    from shennong_tpu_torch.processor import (
        CrepePitchProcessor, KaldiPitchProcessor, MfccProcessor,
        PlpProcessor)

    plp = PlpProcessor(rasta=True)
    if dither is not None:
        plp.dither = dither
    out = [('mfcc', MfccProcessor(dither=0 if dither is None else dither)),
           ('plp+rasta', plp),
           ('kaldi pitch', KaldiPitchProcessor())]
    if crepe:
        out.append(('crepe', CrepePitchProcessor(model_capacity='tiny')))
    return out


def run(minutes=2.0, crepe=False, dither=None, *, device):
    """Extract ``minutes`` minutes of audio with each extractor on
    ``device``, twice (cold, then warm).

    Returns a dict: the ``audio`` (an Audio), the ``seconds`` of audio,
    and by extractor name its ``cold`` and ``warm`` walls, ``xrt`` (of
    the warm run) and the warm run's ``features``.
    """
    from shennong_tpu_torch.audio import Audio

    audio = Audio(make_signal(minutes), 16000)
    seconds = audio.duration
    print(f'{seconds:.0f} s of audio '
          f'({int(seconds / 0.01)} frames at 10 ms shift)')
    print(f'{"stage":<14} {"cold (s)":>9} {"warm (s)":>9} {"xRT":>8}')
    report = {'audio': audio, 'seconds': seconds, 'stages': {}}
    for name, proc in stages(crepe, dither):
        walls = []
        for _ in range(2):
            start = time.perf_counter()
            feats = proc.process(audio, device=device)
            synchronize(device)
            walls.append(time.perf_counter() - start)
        cold, warm = walls
        report['stages'][name] = {
            'cold': cold, 'warm': warm, 'xrt': seconds / warm,
            'features': feats}
        print(f'{name:<14} {cold:>9.1f} {warm:>9.1f} '
              f'{seconds / warm:>8.0f}  -> {feats.shape}', flush=True)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--minutes', type=float, default=2.0)
    parser.add_argument(
        '--crepe', action='store_true',
        help="also run CREPE pitch (its 'tiny' weights ship with the port)")
    add_device_option(parser)
    args = parser.parse_args(argv)
    run(args.minutes, args.crepe, device=device_of(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
