#!/usr/bin/env python
"""Compare the Kaldi and CREPE pitch trackers under noise, on a card.

The PyTorch port's counterpart of ``examples/pitch_comparison.py``
(itself the counterpart of the reference's examples/pitch_comparison
study, which scores both trackers on the KEELE corpus under noise at
several SNRs). It degrades a local recording with seeded gaussian
noise on the same SNR grid, tracks it with Kaldi pitch (the CUDA
Viterbi kernels on a card) and CREPE 'tiny', and reports the trackers'
agreement a condition.

Usage:
    python examples/torch/pitch_comparison.py [<audio-file>] [--plot out.png]
        [--device cuda]
"""

import argparse
import os
import sys

# run from a source checkout without installation
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, os.pardir), HERE]

import numpy as np

from example_utils import add_device_option, device_of

SNR_LIST = [-15, -10, -5, 0, 5, 10, 15, float('inf')]  # dB, as upstream
DEFAULT_AUDIO = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    'tests', 'data', 'test.wav')


def add_noise(audio, snr_db, seed=0):
    """The signal mixed with gaussian noise at a given SNR (the JAX
    example's noise)."""
    from shennong_tpu_torch.audio import Audio

    if np.isinf(snr_db):
        return audio
    signal = audio.data.astype(np.float64)
    power = np.mean(signal ** 2)
    noise_power = power / (10 ** (snr_db / 10))
    noise = np.random.RandomState(seed).randn(len(signal))
    noisy = signal + noise * np.sqrt(noise_power)
    peak = np.abs(noisy).max()
    if peak >= 2 ** 15:  # rescale into the int16 range
        noisy *= (2 ** 15 - 1) / peak
    return Audio(noisy.astype(np.int16), audio.sample_rate)


def track(audio, *, device):
    """((kaldi nccf, f0), (crepe confidence, f0)) a frame, on the
    frames both trackers have."""
    from shennong_tpu_torch.processor import (
        CrepePitchProcessor, KaldiPitchProcessor)

    kaldi = KaldiPitchProcessor(
        sample_rate=audio.sample_rate).process(audio, device=device)
    crepe = CrepePitchProcessor(model_capacity='tiny').process(
        audio, device=device)
    nframes = min(kaldi.nframes, crepe.nframes)
    return kaldi.data[:nframes], crepe.data[:nframes]


def compare(kaldi, crepe, confidence_threshold=0.5):
    """Agreement statistics of the two trackers: the share of frames
    both call voiced, and on those the mean absolute gap in cents and
    the share within 50 cents."""
    voiced = crepe[:, 0] >= confidence_threshold
    both = voiced & (kaldi[:, 1] > 0) & (crepe[:, 1] > 0)
    if not both.any():
        return {'voiced_pct': 0.0, 'mean_abs_cents': float('nan'),
                'within_50c_pct': float('nan')}
    cents = 1200 * np.abs(np.log2(kaldi[both, 1] / crepe[both, 1]))
    return {
        'voiced_pct': 100 * both.mean(),
        'mean_abs_cents': float(np.mean(cents)),
        'within_50c_pct': 100 * float(np.mean(cents <= 50))}


def run(audio_file=DEFAULT_AUDIO, plot=None, *, device):
    """Track ``audio_file`` at each SNR of :data:`SNR_LIST` on
    ``device``, print the agreement table and, with ``plot``, write the
    F0 tracks of the clean signal there (it needs matplotlib). Returns a
    dict: by SNR its ``stats`` and ``tracks`` (kaldi, crepe), the printed
    ``table`` and the ``figure`` path or None."""
    from shennong_tpu_torch.audio import Audio

    clean = Audio.load(audio_file).channel(0)
    print(f'audio: {audio_file} ({clean.duration:.2f} s '
          f'@ {clean.sample_rate} Hz)')
    lines = [f'{"SNR dB":>8s} {"voiced %":>9s} {"|Δf0| cents":>12s} '
             f'{"within 50c %":>13s}']
    print(lines[0])
    report = {'stats': {}, 'tracks': {}, 'figure': None}
    for snr in SNR_LIST:
        kaldi, crepe = track(add_noise(clean, snr), device=device)
        stats = compare(kaldi, crepe)
        report['stats'][snr] = stats
        report['tracks'][snr] = (kaldi, crepe)
        label = 'inf' if np.isinf(snr) else f'{snr:+d}'
        lines.append(f'{label:>8s} {stats["voiced_pct"]:9.1f} '
                     f'{stats["mean_abs_cents"]:12.1f} '
                     f'{stats["within_50c_pct"]:13.1f}')
        print(lines[-1], flush=True)
    report['table'] = '\n'.join(lines)

    if plot:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        kaldi, crepe = report['tracks'][float('inf')]
        times = np.arange(len(kaldi)) * 0.01
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.plot(times, kaldi[:, 1], label='kaldi pitch', lw=1)
        voiced = crepe[:, 0] >= 0.5
        ax.plot(times[voiced], crepe[voiced, 1], '.', ms=3,
                label='crepe (voiced)')
        ax.set_xlabel('time (s)')
        ax.set_ylabel('F0 (Hz)')
        ax.legend()
        fig.tight_layout()
        fig.savefig(plot, dpi=120)
        plt.close(fig)
        report['figure'] = plot
        print(f'figure written to {plot}')
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('audio', nargs='?', default=DEFAULT_AUDIO)
    parser.add_argument('--plot', help='write an F0-track figure (PNG)')
    add_device_option(parser)
    args = parser.parse_args(argv)
    run(args.audio, args.plot, device=device_of(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
