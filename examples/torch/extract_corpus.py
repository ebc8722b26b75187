#!/usr/bin/env python
"""Extract features for a whole corpus on a CUDA device.

The PyTorch port's counterpart of ``examples/extract_corpus.py``: the
utterances run through the YAML pipeline as padded batches, one fused
pass-1 program a batch (Kaldi pitch through the CUDA Viterbi kernels
with ``--pitch``), and the features are written with the serializer
that the output's extension names.

Usage:
    python examples/torch/extract_corpus.py <utterances.txt> <output.h5f> \\
        [--features mfcc] [--pitch] [--cmvn] [--delta] [-j 4] \\
        [--fetch-dtype float16] [--device cuda]

The utterances file uses the standard index format, e.g.:
    utt1 /data/speech/utt1.wav speaker1
"""

import os
import sys

# run from a source checkout without installation
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, os.pardir), HERE]

import argparse
import time

from example_utils import add_device_option, device_of
from shennong_tpu_torch import Utterances
from shennong_tpu_torch.logger import get_logger
from shennong_tpu_torch.pipeline import extract_features, get_default_config


def extract(utterances, output, features='mfcc', pitch=False, cmvn=False,
            delta=False, njobs=1, fetch_dtype=None, *, device,
            config=None, log=get_logger('extract', 'info')):
    """Extract ``utterances`` (an Utterances or an index file) on
    ``device`` and save the features to ``output``.

    ``config`` replaces the default configuration of ``features``,
    ``pitch``, ``cmvn`` and ``delta`` when given. Returns a dict: the
    ``features`` collection, the ``output`` path, the audio ``hours``,
    the extraction's wall ``seconds`` and its real-time factor ``xrt``.
    """
    if config is None:
        config = get_default_config(
            features, with_pitch='kaldi' if pitch else False,
            with_cmvn=cmvn, with_delta=delta)
    if isinstance(utterances, str):
        utterances = Utterances.load(utterances)
    hours = utterances.duration() / 3600
    log.info('%s utterances, %.1f hours of audio', len(utterances), hours)

    start = time.perf_counter()
    collection = extract_features(
        config, utterances, njobs=njobs, fetch_dtype=fetch_dtype,
        device=device, log=log)
    seconds = time.perf_counter() - start
    xrt = hours * 3600 / seconds
    log.info('extracted in %.1fs (%.0fx real-time)', seconds, xrt)

    collection.save(output)
    log.info('saved to %s', output)
    return {'features': collection, 'output': output, 'hours': hours,
            'seconds': seconds, 'xrt': xrt}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('utterances')
    parser.add_argument('output')
    parser.add_argument('--features', default='mfcc',
                        choices=['mfcc', 'filterbank', 'plp',
                                 'spectrogram', 'bottleneck'])
    parser.add_argument('--pitch', action='store_true')
    parser.add_argument('--cmvn', action='store_true')
    parser.add_argument('--delta', action='store_true')
    parser.add_argument('-j', '--njobs', type=int, default=1)
    parser.add_argument('--fetch-dtype', default=None,
                        choices=['float32', 'float16', 'bfloat16'],
                        help='precision of the device-to-host copy of the '
                        'features [float32]')
    add_device_option(parser)
    args = parser.parse_args(argv)
    extract(args.utterances, args.output, args.features, args.pitch,
            args.cmvn, args.delta, args.njobs, args.fetch_dtype,
            device=device_of(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
