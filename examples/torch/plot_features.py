#!/usr/bin/env python
"""Extract every main feature type of a wav file on a card, and plot
them.

The PyTorch port's counterpart of ``examples/plot_features.py`` (the
reference's examples/simple/features_plot.py): one figure with the
waveform and the spectrogram, filterbank, MFCC, PLP and, when its
weights are installed, bottleneck features of one recording.

Only what is missing by nature is skipped: the bottleneck features
when no weights file is installed (the error of
``BottleneckProcessor.available_weights``), and the figure when
matplotlib is not installed. Any other failure of a processor stops
the script.

Usage: python examples/torch/plot_features.py [<wav>] [-o figure.png]
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

DEFAULT_WAV = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    'tests', 'data', 'test.wav')


def extract(audio, *, device, dither=None):
    """The features of ``audio`` by processor name, on ``device``, and
    what was skipped, by name, with its reason. ``dither`` other than
    None sets the processors' dither."""
    from shennong_tpu_torch.processor import (
        BottleneckProcessor, FilterbankProcessor, MfccProcessor,
        PlpProcessor, SpectrogramProcessor)

    rate = audio.sample_rate
    processors = {
        'spectrogram': SpectrogramProcessor(sample_rate=rate),
        'filterbank': FilterbankProcessor(sample_rate=rate),
        'mfcc': MfccProcessor(sample_rate=rate),
        'plp': PlpProcessor(sample_rate=rate)}
    skipped = {}
    try:
        BottleneckProcessor.available_weights()
        processors['bottleneck'] = BottleneckProcessor()
    except RuntimeError as why:  # no weights file installed
        skipped['bottleneck'] = str(why)
        print(f'skipping bottleneck: {why}')
    if dither is not None:
        for proc in processors.values():
            proc.dither = dither

    features = {}
    for name, proc in sorted(processors.items()):
        print(f'extracting {name}...')
        features[name] = proc.process(audio, device=device)
    return features, skipped


def run(wav=DEFAULT_WAV, output_file=None, *, device, dither=None):
    """Extract every feature type of ``wav`` on ``device`` and, with
    ``output_file``, draw them there. Returns a dict: the ``audio``,
    the ``features`` by processor name, what was ``skipped`` and the
    ``figure`` path (None when none was drawn)."""
    from shennong_tpu_torch.audio import Audio

    audio = Audio.load(wav).channel(0)
    features, skipped = extract(audio, device=device, dither=dither)
    report = {'audio': audio, 'features': features, 'skipped': skipped,
              'figure': None}
    if output_file is None:
        return report
    try:
        import matplotlib
    except ImportError as why:
        skipped['figure'] = str(why)
        print(f'skipping the figure: {why}')
        return report
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(
        len(features) + 1, 1, figsize=(10, 2.2 * (len(features) + 1)),
        sharex=True)
    time = np.arange(audio.nsamples) / audio.sample_rate
    axes[0].plot(time, audio.astype(np.float32).data, lw=0.4)
    axes[0].set_ylabel('waveform')
    for axis, (name, feats) in zip(axes[1:], sorted(features.items())):
        axis.imshow(
            feats.data.T, origin='lower', aspect='auto',
            interpolation='nearest',
            extent=(0, audio.duration, 0, feats.ndims))
        axis.set_ylabel(name)
    axes[-1].set_xlabel('time (s)')
    fig.tight_layout()
    fig.savefig(output_file, dpi=120)
    plt.close(fig)
    report['figure'] = output_file
    print(f'figure written to {output_file}')
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('wav', nargs='?', default=DEFAULT_WAV)
    parser.add_argument('-o', '--output-file', default='features.png',
                        help='output image [%(default)s]')
    add_device_option(parser)
    args = parser.parse_args(argv)
    run(args.wav, args.output_file, device=device_of(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
