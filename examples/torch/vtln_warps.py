#!/usr/bin/env python
"""Train per-speaker VTLN warps and extract warped features on a card.

The PyTorch port's counterpart of ``examples/vtln_warps.py``: the
UBM-GMM EM, the MFCCs of the 41 warp classes and the LVTLN estimation
run on the device, then the warped MFCC + CMVN + delta features are
extracted with the warps.

Usage:
    python examples/torch/vtln_warps.py <utterances.txt> <warps.yaml> \\
        [<features.h5f>] [--duration 300] [--device cuda]

The utterances file must carry speaker information, e.g.:
    utt1 /data/speech/utt1.wav speaker1
"""

import os
import sys

# run from a source checkout without installation
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, os.pardir), HERE]

import argparse

from example_utils import add_device_option, device_of
from shennong_tpu_torch import Utterances
from shennong_tpu_torch.logger import get_logger
from shennong_tpu_torch.pipeline import extract_features, get_default_config
from shennong_tpu_torch.processor import VtlnProcessor


def train(utterances, warps_output, features_output=None, duration=300.0,
          *, device, vtln=None, config=None,
          log=get_logger('vtln', 'info')):
    """Train the warps of ``utterances`` (an Utterances or an index
    file) on at most ``duration`` seconds of each speaker, save them to
    ``warps_output`` and, with ``features_output``, extract and save the
    warped features.

    ``vtln`` is the VtlnProcessor to train (the defaults when None),
    ``config`` the features configuration (MFCC + CMVN + deltas when
    None). Returns a dict: the ``warps``, the ``vtln`` processor, the
    ``warps_output`` path, and the ``features`` collection (or None).
    """
    if isinstance(utterances, str):
        utterances = Utterances.load(utterances)
    # bound the training data of each speaker, as the reference recipe
    training = utterances.fit_to_duration(
        duration, truncate=True, shuffle=False)

    if vtln is None:
        vtln = VtlnProcessor()
        vtln.set_logger('info')
    # one warp a speaker when the speakers are known, as the reference
    # recipe does (examples/simple/mfcc_vtln.py:104)
    group_by = 'speaker' if training.has_speakers() else 'utterance'
    warps = vtln.process(training, group_by=group_by, device=device)
    vtln.save_warps(warps_output)
    log.info('saved %s warps to %s', len(warps), warps_output)

    features = None
    if features_output:
        if config is None:
            config = get_default_config(
                'mfcc', with_cmvn=True, with_delta=True)
        features = extract_features(
            config, utterances, warps=warps, device=device, log=log)
        features.save(features_output)
        log.info('saved warped features to %s', features_output)
    return {'warps': warps, 'vtln': vtln, 'warps_output': warps_output,
            'features': features}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('utterances')
    parser.add_argument('warps_output')
    parser.add_argument('features_output', nargs='?')
    parser.add_argument(
        '--duration', type=float, default=300.0,
        help='seconds of audio per speaker used for training')
    add_device_option(parser)
    args = parser.parse_args(argv)
    train(args.utterances, args.warps_output, args.features_output,
          args.duration, device=device_of(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
