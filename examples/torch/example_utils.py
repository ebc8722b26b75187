"""What several of the port's examples share: the ``--device`` option
and the synthetic multi-speaker corpus of ``features_abx.py``.

Imports nothing of the JAX package.
"""

import os

import numpy as np
import torch


def add_device_option(parser):
    """Add ``--device`` (default 'cuda') to an argparse parser."""
    parser.add_argument(
        '--device', default='cuda',
        help="torch device to run on: 'cuda' (the default), "
        "'cuda:<index>' or 'cpu'; a CUDA device that is not available is "
        'an error')


def device_of(name):
    """The torch device ``name``; a CUDA device without CUDA raises
    RuntimeError (nothing carries on on the CPU)."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {name} requested but no CUDA device is available '
            '(pass --device cpu to run on the CPU)')
    return device


def synchronize(device):
    """Wait for the work queued on ``device`` (nothing to wait for on
    the CPU)."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def make_synthetic_corpus(directory, nutts, nspeakers=10, rate=16000):
    """A multi-speaker corpus of speech-like WAVs, one F0 range and
    formant identity a speaker so that VTLN has speaker structure;
    the same files as ``examples/features_abx.py`` writes. Returns the
    (name, path, speaker) entries; existing files are kept."""
    import scipy.io.wavfile

    os.makedirs(directory, exist_ok=True)
    items = []
    for i in range(nutts):
        speaker = i % nspeakers
        path = os.path.join(directory, f'utt{i:04d}.wav')
        if not os.path.isfile(path):
            rng = np.random.RandomState(1000 + i)
            seconds = 4.0 + (i % 5)
            t = np.arange(int(seconds * rate)) / rate
            f0 = 90 + 12 * speaker + 10 * np.sin(2 * np.pi * 0.6 * t)
            phase = 2 * np.pi * np.cumsum(f0) / rate
            voiced = sum(
                (0.6 ** k) * np.sin((k + 1) * phase) for k in range(8))
            envelope = 0.5 * (1 + np.sin(2 * np.pi * 2.7 * t - 0.5)) ** 2
            signal = voiced * envelope + rng.randn(len(t)) * 0.03
            signal = signal / np.abs(signal).max() * 0.7
            scipy.io.wavfile.write(
                path, rate, (signal * 2 ** 15 * 0.9).astype(np.int16))
        items.append((f'utt{i:04d}', path, f'spk{speaker:02d}'))
    return items
