"""In-framework ABX phone discriminability, end to end on a card.

The PyTorch port's counterpart of ``examples/abx_score.py``. The
reference evaluates its features with the external ABXpy stack
(``examples/features_abx/run.sh``: h5features files, then abx-task /
abx-score on a SLURM cluster); this script closes the loop inside the
port. It synthesizes a small multi-speaker phone corpus on disk,
extracts MFCCs through the YAML pipeline (raw, and with per-speaker
CMVN), cuts the features into phone segments with the alignments, and
scores the machine-ABX error with the evaluator's DTW on the device
(:mod:`shennong_tpu_torch.eval.abx`, the CUDA DTW kernel on a card).

The speakers differ by a stationary spectral coloring, the nuisance
per-speaker CMVN removes, so the table reproduces the *direction* of
the reference's published Buckeye results (across-speaker MFCC 27.2%
-> +CMVN 24.0%, reference ``doc/source/intro_features.rst:99-117``).

Run:  python examples/torch/abx_score.py [workdir] [--device cuda]
"""

import argparse
import os
import sys
import tempfile
import zlib

import numpy as np
import scipy.io.wavfile
import scipy.signal

# run from a source checkout without installation
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, os.pardir), HERE]

from example_utils import add_device_option, device_of

PHONES = ('aa', 'ao', 'ah')
FORMANTS = {'aa': (700, 1200), 'ao': (600, 950), 'ah': (650, 1350)}
NSPEAKERS = 4
TOKENS = 4
RATE = 16000
TOKEN_SECONDS = 0.25


def synthesize_token(phone, speaker, token):
    """One phone realization: two formant bands and the speaker's
    coloring (the JAX example's samples)."""
    f1, f2 = FORMANTS[phone]
    rng = np.random.RandomState(
        zlib.crc32(f'{phone}-{speaker}-{token}'.encode()))
    nsamples = int(TOKEN_SECONDS * RATE)
    excitation = rng.randn(nsamples)
    signal = np.zeros(nsamples)
    for freq in (f1, f2):
        sos = scipy.signal.butter(
            2, [freq * 0.85, freq * 1.15], 'bandpass',
            fs=RATE, output='sos')
        signal += scipy.signal.sosfilt(sos, excitation)
    srng = np.random.RandomState(1000 + speaker)
    fir = srng.randn(24) * (0.95 ** np.arange(24))
    fir[0] = 1.0
    signal = scipy.signal.lfilter(fir, [1.0], signal)
    return (signal / np.abs(signal).max() * 12000).astype(np.int16)


def build_corpus(workdir):
    """One WAV a speaker (its phone tokens back to back) and its
    alignment. Returns (Utterances, {utterance: Alignment})."""
    from shennong_tpu_torch.alignment import Alignment
    from shennong_tpu_torch.utterances import Utterances

    entries, alignments = [], {}
    for speaker in range(NSPEAKERS):
        pieces, times, labels = [], [], []
        cursor = 0.0
        for phone in PHONES:
            for token in range(TOKENS):
                pieces.append(synthesize_token(phone, speaker, token))
                times.append((cursor, cursor + TOKEN_SECONDS))
                labels.append(phone)
                cursor += TOKEN_SECONDS
        name = f'spk{speaker}'
        wav = os.path.join(workdir, f'{name}.wav')
        scipy.io.wavfile.write(wav, RATE, np.concatenate(pieces))
        entries.append((name, wav, name))
        alignments[name] = Alignment(np.asarray(times), np.asarray(labels))
    return Utterances(entries), alignments


def cut(features, alignments):
    """The phone segments of a FeaturesCollection: (segments, phones,
    speakers), segments of at least 2 frames."""
    from shennong_tpu_torch.eval import segments_from_alignment

    segments, phones, speakers = [], [], []
    for name, feats in features.items():
        for token, data in segments_from_alignment(
                feats, alignments[name], min_frames=2):
            segments.append(data)
            phones.append(token)
            speakers.append(name)
    return segments, phones, speakers


def score(features, alignments, *, device):
    """(across, within) ABX errors of a FeaturesCollection; the DTW
    distances, shared by both tasks, are computed once on ``device``."""
    from shennong_tpu_torch.eval import abx_error, pairwise_distances

    segments, phones, speakers = cut(features, alignments)
    distances = pairwise_distances(segments, device=device)
    return (abx_error(distances, phones, speakers, task='across'),
            abx_error(distances, phones, speakers, task='within'))


def conditions():
    """(label, configuration) of each scored condition, no dither."""
    from shennong_tpu_torch import pipeline

    raw = pipeline.get_default_config('mfcc')
    raw['mfcc']['dither'] = 0.0
    cmvn = pipeline.get_default_config('mfcc', with_cmvn=True)
    cmvn['mfcc']['dither'] = 0.0
    cmvn['cmvn']['with_vad'] = False
    return (('mfcc raw', raw), ('mfcc + cmvn (by speaker)', cmvn))


def run(workdir=None, *, device):
    """Synthesize the corpus under ``workdir`` (a fresh temporary
    directory when None), extract and score each condition on
    ``device``. Returns a dict: by condition label its ``features`` and
    ``errors`` (across, within), the ``alignments`` and the printed
    ``table``."""
    from shennong_tpu_torch import pipeline

    workdir = workdir or tempfile.mkdtemp(prefix='abx_score_')
    os.makedirs(workdir, exist_ok=True)
    print(f'corpus: {NSPEAKERS} speakers x {len(PHONES)} phones x '
          f'{TOKENS} tokens under {workdir}')
    utterances, alignments = build_corpus(workdir)

    report = {'alignments': alignments, 'features': {}, 'errors': {}}
    lines = ['', f'{"condition":<28}{"across-spk":>12}{"within-spk":>12}']
    for label, config in conditions():
        features = pipeline.extract_features(config, utterances, device=device)
        across, within = score(features, alignments, device=device)
        report['features'][label] = features
        report['errors'][label] = (across, within)
        lines.append(f'{label:<28}{across:>11.1%}{within:>11.1%}')
    lines += ['', 'reference direction (Buckeye, intro_features.rst): '
              'across-speaker error drops with per-speaker CMVN']
    report['table'] = '\n'.join(lines)
    print(report['table'])
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('workdir', nargs='?', default=None)
    add_device_option(parser)
    args = parser.parse_args(argv)
    run(args.workdir, device=device_of(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
