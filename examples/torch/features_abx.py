#!/usr/bin/env python
"""Corpus-scale ABX feature preparation, end to end on one card.

The PyTorch port's counterpart of ``examples/features_abx.py`` (itself
the counterpart of the reference's ``examples/features_abx`` SLURM
recipe): per-speaker VTLN training (UBM-GMM EM, 41 warp classes of
LVTLN), then three feature sets -- MFCC, MFCC + per-speaker CMVN, and
warped MFCC + per-speaker CMVN, each with deltas -- all on the device
in one process, written as h5features ``.h5f`` files (or any other
serializer's extension) for the ABX evaluation tooling.

Usage (a real corpus, an utterances file with speakers):

    python examples/torch/features_abx.py output_dir --utterances utts.txt

or on a synthetic multi-speaker corpus:

    python examples/torch/features_abx.py output_dir --synthetic 200

It prints the wall clock and real-time factor of each stage and end to
end (host IO included).
"""

import os
import sys

# run from a source checkout without installation
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, os.pardir), HERE]

import argparse
import time

from example_utils import add_device_option, device_of, make_synthetic_corpus

#: the feature sets: (name, CMVN by speaker, warped)
CONFIGS = (('mfcc', False, False),
           ('mfcc_cmvn', True, False),
           ('mfcc_vtln_cmvn', True, True))


def prepare(output_dir, utterances=None, synthetic=0, vtln_duration=100.0,
            ext='.h5f', *, device, vtln=None, dither=None):
    """Train the warps and write the three feature sets under
    ``output_dir``, on ``device``.

    ``utterances`` is an Utterances or an index file; with ``synthetic``
    N instead, an N-utterance synthetic corpus is written under
    ``output_dir/corpus``. ``vtln`` is the VtlnProcessor to train (the
    defaults when None); ``dither`` other than None sets the MFCC
    dither of the three feature sets. Returns a dict: the stage
    ``timings`` (seconds), the audio ``seconds``, the ``warps`` by
    speaker, and by feature set its ``features`` collection and
    ``outputs`` path.
    """
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch.logger import get_logger
    from shennong_tpu_torch.pipeline import (
        extract_features, get_default_config)
    from shennong_tpu_torch.processor import VtlnProcessor

    log = get_logger('abx', 'info')
    os.makedirs(output_dir, exist_ok=True)
    if synthetic:
        utterances = Utterances(make_synthetic_corpus(
            os.path.join(output_dir, 'corpus'), synthetic))
    elif isinstance(utterances, str):
        utterances = Utterances.load(utterances)
    elif utterances is None:
        raise ValueError('pass utterances or synthetic=N')

    total_audio = sum(utt.duration for utt in utterances)
    log.info('corpus: %d utterances, %d speakers, %.1f minutes',
             len(utterances), len(utterances.by_speaker()), total_audio / 60)
    timings = {}

    # step 1: per-speaker VTLN warps on a bounded duration a speaker,
    # as the reference recipe does
    start = time.perf_counter()
    training = utterances.fit_to_duration(
        vtln_duration, truncate=True, shuffle=False)
    if vtln is None:
        vtln = VtlnProcessor()
        vtln.set_logger('warning')
    warps = vtln.process(training, group_by='speaker', device=device)
    warps_file = os.path.join(output_dir, 'warps.yaml')
    if os.path.exists(warps_file):
        os.unlink(warps_file)
    vtln.warps = warps
    vtln.save_warps(warps_file)
    timings['vtln training'] = time.perf_counter() - start
    log.info('warps: %s', {k: round(v, 3) for k, v in warps.items()})

    # step 2: the ABX feature sets
    features, outputs = {}, {}
    for name, with_cmvn, warped in CONFIGS:
        start = time.perf_counter()
        config = get_default_config(
            'mfcc', with_cmvn=with_cmvn, with_delta=True)
        if dither is not None:
            config['mfcc']['dither'] = dither
        features[name] = extract_features(
            config, utterances, warps=warps if warped else None,
            device=device)
        outputs[name] = os.path.join(output_dir, name + ext)
        if os.path.exists(outputs[name]):
            os.unlink(outputs[name])
        features[name].save(outputs[name])
        timings[f'extract {name}'] = time.perf_counter() - start

    print()
    print(f'{"stage":<24}{"wall (s)":>10}{"xRT":>10}')
    for stage, wall in timings.items():
        print(f'{stage:<24}{wall:>10.2f}{total_audio / wall:>10.0f}')
    end_to_end = sum(timings.values())
    print(f'{"END TO END":<24}{end_to_end:>10.2f}'
          f'{total_audio / end_to_end:>10.0f}')
    print(f'\nfeatures written to {output_dir}/*{ext}')
    return {'timings': timings, 'seconds': total_audio, 'warps': warps,
            'features': features, 'outputs': outputs}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('output_dir')
    parser.add_argument(
        '--utterances', help='utterances index file (with speakers)')
    parser.add_argument(
        '--synthetic', type=int, default=0, metavar='N',
        help='generate a synthetic N-utterance corpus instead')
    parser.add_argument(
        '--vtln-duration', type=float, default=100.0,
        help='seconds of audio per speaker for VTLN training')
    add_device_option(parser)
    args = parser.parse_args(argv)
    if not (args.synthetic or args.utterances):
        parser.error('pass --utterances or --synthetic N')
    prepare(args.output_dir, args.utterances, args.synthetic,
            args.vtln_duration, device=device_of(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
