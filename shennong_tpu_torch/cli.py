"""The ``speech-features-torch`` command line interface.

Counterpart of the ``config``, ``extract``, ``warmup`` and
``convert-crepe`` commands of :mod:`shennong_tpu.cli`, on the PyTorch
port's pipeline: a ``config`` subcommand generating commented YAML
pipeline configurations, an ``extract`` subcommand running a pipeline
over an utterances index file on the device given by ``--device``
(default ``cuda``; nothing falls back to the CPU when CUDA is missing)
with ``-j`` threads of audio decode, a ``warmup`` subcommand paying a
cold process's start-up costs for a corpus's batch geometries, and a
``convert-crepe`` subcommand turning a published keras CREPE
checkpoint into the port's npz weights.

The extraction pipeline is::

     <input-config>     |--> features --> CMVN --> delta -->|
         and         -->|                                   |--> <output-file>
  <input-utterances>    |---------------> pitch ----------->|

Utterances index lines follow one of the four formats::

  <utterance-id> <audio-file>
  <utterance-id> <audio-file> <speaker-id>
  <utterance-id> <audio-file> <tstart> <tstop>
  <utterance-id> <audio-file> <speaker-id> <tstart> <tstop>

Output formats (guessed from the extension): .pkl .h5f .npz .mat .ark
or a folder of CSV files.
"""

import argparse
import os
import sys

import torch

import shennong_tpu_torch.logger as logger
import shennong_tpu_torch.utils as utils
from shennong_tpu_torch.serializers import supported_extensions
from shennong_tpu_torch.utterances import Utterances
from shennong_tpu_torch import __version__, pipeline


def _parser_config(subparsers, epilog):
    parser = subparsers.add_parser(
        'config',
        description='Generate a configuration for features extraction, '
        "have a 'speech-features-torch --help' for more details",
        epilog=epilog,
        formatter_class=argparse.RawDescriptionHelpFormatter)

    parser.add_argument(
        '-o', '--output', metavar='config-file', default=None,
        help='The YAML configuration file to write. '
        'If not specified, write to stdout')
    parser.add_argument(
        '--no-comments', action='store_true',
        help='Do not include comments in the output YAML configuration '
        'file. By default all parameters in the YAML are explained in '
        'comments.')

    group = parser.add_argument_group('pipeline arguments')
    group.add_argument(
        'features', type=str, choices=pipeline.valid_features(),
        help='Configure the pipeline to extract those features')
    group.add_argument(
        '--cmvn', action='store_true',
        help='Configure with CMVN normalization')
    group.add_argument(
        '--delta', action='store_true',
        help='Configure with deltas extraction')
    group.add_argument(
        '--pitch', choices=['kaldi', 'crepe'],
        help='Configure with Kaldi or CREPE pitch extraction, '
        'no pitch by default')
    group.add_argument(
        '--vtln', choices=['simple', 'full'],
        help='Configure with VTLN normalization, no VTLN by default. '
        'VTLN is not compatible with spectrogram and bottleneck '
        'features.')


def _command_config(args):
    config = pipeline.get_default_config(
        args.features,
        to_yaml=True, yaml_commented=not args.no_comments,
        with_pitch=args.pitch or False,
        with_cmvn=args.cmvn,
        with_delta=args.delta,
        with_vtln=args.vtln or False)

    if not args.output:
        sys.stdout.write(config)
        return
    with open(args.output, 'w') as output:
        output.write(config)


def _add_device_njobs(parser):
    parser.add_argument(
        '--device', default='cuda', metavar='<device>',
        help="the torch device the extraction runs on, 'cuda' (the "
        "default), 'cuda:<index>' or 'cpu'; a CUDA device that is not "
        'available is an error')
    parser.add_argument(
        '-j', '--njobs', type=int, default=1, metavar='<int>',
        help='number of parallel jobs to use, default to %(default)s')


def _device(name):
    """The torch device ``name``; a CUDA device without CUDA raises."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {name} requested but no CUDA device is '
            'available (pass --device cpu to run on the CPU)')
    return device


def _parser_extract(subparsers, epilog):
    parser = subparsers.add_parser(
        'extract',
        description='Extract features from wav files given a '
        "configuration, have a 'speech-features-torch --help' for more "
        'details',
        epilog=epilog,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    _add_device_njobs(parser)

    group = parser.add_argument_group('input/output arguments')
    group.add_argument(
        'config', metavar='<input-config>', type=str,
        help='pipeline configuration file in YAML format, as generated '
        "by the 'speech-features-torch config' command")
    group.add_argument(
        'utterances', metavar='<input-utterances>', type=str,
        help='utterances index file defining utterances on which to '
        'compute features')
    group.add_argument(
        'output_file', metavar='<output-file>',
        help='file to save the computed features (must not exist)')

    group = parser.add_argument_group('log messages arguments')
    group = group.add_mutually_exclusive_group()
    group.add_argument(
        '-v', '--verbose', action='count', default=0,
        help="increase the amount of logging on stderr (a single '-v' "
        "adds info messages and '-vv' adds debug messages, use "
        "'--quiet' to disable logging)")
    group.add_argument(
        '-q', '--quiet', action='store_true',
        help='do not display any log message')


def _command_extract(args):
    if args.quiet:
        log = logger.null_logger()
    else:
        level = ('warning', 'info', 'debug')[min(args.verbose, 2)]
        log = logger.get_logger(name='speech-features-torch', level=level)

    device = _device(args.device)
    output_file = args.output_file
    if os.path.exists(output_file):
        raise ValueError(f'output file already exists: {output_file}')
    output_ext = os.path.splitext(output_file)[1]
    if output_ext not in supported_extensions():
        raise ValueError(
            f'output file has an unsupported extension "{output_ext}", '
            f'must be in {", ".join(supported_extensions())}')
    for filename in (args.config, args.utterances):
        if not os.path.exists(filename):
            raise ValueError(f'input file not found: {filename}')

    utterances = Utterances.load(args.utterances)
    features = pipeline.extract_features(
        args.config, utterances, njobs=args.njobs, device=device, log=log)

    log.info('saving the features to %s', output_file)
    features.save(output_file)


def _parser_warmup(subparsers, epilog):
    parser = subparsers.add_parser(
        'warmup',
        description=(
            'Pay the start-up costs of a cold process for a corpus '
            'geometry (batch rows x signal buckets, from the audio '
            'headers): the kernel builds when their library is missing, '
            'the CUDA context, cuFFT plans, cuBLAS handles and the '
            'allocators. Call shennong_tpu_torch.pipeline.warmup() at '
            'server start-up so that the first real extraction runs at '
            'warm speed.'),
        epilog=epilog,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    _add_device_njobs(parser)
    parser.add_argument(
        'config', metavar='<input-config>', type=str,
        help='pipeline configuration file in YAML format, as generated '
        "by the 'speech-features-torch config' command")
    parser.add_argument(
        'utterances', metavar='<input-utterances>', type=str,
        help='utterances index whose corpus geometry to warm')


def _command_warmup(args):
    log = logger.get_logger(name='speech-features-torch', level='info')
    device = _device(args.device)
    for filename in (args.config, args.utterances):
        if not os.path.exists(filename):
            raise ValueError(f'input file not found: {filename}')
    out = pipeline.warmup(
        args.config, Utterances.load(args.utterances), device=device,
        njobs=args.njobs, log=log)
    print(f'warmed {out["programs"]} pipeline geometries '
          f'in {out["seconds"]}s')


def _parser_convert_crepe(subparsers, epilog):
    parser = subparsers.add_parser(
        'convert-crepe',
        description=(
            'Convert a published keras CREPE checkpoint (model-tiny.h5 '
            '... model-full.h5, from github.com/marl/crepe) into the '
            'npz parameter file the CREPE network loads. The converted '
            'file is written next to the input or into --output; '
            'install it into shennong_tpu_torch/share/crepe/ to make '
            'the capacity available to CrepePitchProcessor. Needs '
            'h5py.'),
        epilog=epilog,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        'checkpoint', help='path to a keras CREPE .h5 checkpoint')
    parser.add_argument(
        '-o', '--output', default=None,
        help='output .npz path (default: alongside the checkpoint, '
        'or directly into the package share directory with --install)')
    parser.add_argument(
        '--install', action='store_true',
        help='write into shennong_tpu_torch/share/crepe/ so the capacity '
        'is immediately usable')


def _command_convert_crepe(args):
    import numpy as np
    from shennong_tpu_torch.models import crepe

    params = crepe.convert_keras_h5(args.checkpoint)
    capacity = crepe.capacity_of(params)

    if args.output:
        output = args.output
    elif args.install:
        output = os.path.join(
            os.path.abspath(crepe.SHARE_DIR), f'model-{capacity}.npz')
    else:
        output = os.path.join(
            os.path.dirname(os.path.abspath(args.checkpoint)),
            f'model-{capacity}.npz')

    np.savez(output, **params)
    print(f'converted {args.checkpoint} (capacity {capacity}) '
          f'-> {output}')


@utils.CatchExceptions
def main():
    """Entry point of the ``speech-features-torch`` program"""
    epilog = 'speech-features-torch is part of the shennong-tpu library'

    parser = argparse.ArgumentParser(
        description=__doc__,
        epilog=epilog,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        '-V', '--version', action='version',
        version=f'shennong_tpu_torch {__version__}',
        help='display version information and exit')

    subparsers = parser.add_subparsers(
        title='speech-features-torch commands',
        description="use 'speech-features-torch <command> --help' for "
        'details',
        help="the 'config' command generates configuration templates, "
        "the 'extract' command extracts features given a configuration, "
        "the 'warmup' command warms a process for a corpus geometry, "
        "the 'convert-crepe' command converts CREPE weights",
        dest='command', required=True)

    _parser_config(subparsers, epilog)
    _parser_extract(subparsers, epilog)
    _parser_warmup(subparsers, epilog)
    _parser_convert_crepe(subparsers, epilog)

    args = parser.parse_args()
    if args.command == 'config':
        _command_config(args)
    elif args.command == 'extract':
        _command_extract(args)
    elif args.command == 'warmup':
        _command_warmup(args)
    else:
        _command_convert_crepe(args)


if __name__ == '__main__':
    main()
