#!/usr/bin/env python
"""Corpus CMVN statistics over several processes with torch.distributed.

The PyTorch port's counterpart of ``examples/multihost_cmvn.py``: each
process computes the MFCCs of its shard of the utterances on its
device and the corpus CMVN statistics are summed over the processes
(:func:`shennong_tpu_torch.parallel.distributed.reduce_cmvn_stats`: a
float64 all-gather summed in rank order, so every process holds the
same bits, those of one process summing the shards in that order).

Run it alone to start two processes on this machine, joined by gloo
over a ``file://`` store in a temporary directory:

    python examples/torch/multihost_cmvn.py [--device cuda]

or start one process per rank with torchrun, which sets the group's
environment:

    torchrun --nproc-per-node 2 examples/torch/multihost_cmvn.py
"""

import os
import sys

# run from a source checkout without installation
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, os.pardir), HERE]

import argparse
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from example_utils import add_device_option, device_of

BATCH = 4        # utterances of a process's shard
NSAMPLES = 8000  # samples an utterance
TIMEOUT = 300    # seconds, of the process group and of the launcher's wait


def shard_stats(process_id, *, device):
    """The [2, 14] float64 CMVN statistics (Kaldi layout) of the MFCCs
    of process ``process_id``'s synthetic shard (noise from a
    ``numpy.random.RandomState(process_id)``, as the JAX example), no
    dither, computed on ``device`` and accumulated utterance by
    utterance."""
    from shennong_tpu_torch.ops import mel as melmod
    from shennong_tpu_torch.ops.framing import FrameOptions, num_frames
    from shennong_tpu_torch.ops.postops import accumulate_cmvn_stats
    from shennong_tpu_torch.ops.spectral import MfccOpts, mfcc_batch

    rng = np.random.RandomState(process_id)
    signals = torch.from_numpy(
        (rng.randn(BATCH, NSAMPLES) * 5000).astype(np.float32)).to(device)
    lengths = torch.full((BATCH,), NSAMPLES, dtype=torch.int32, device=device)
    opts = MfccOpts(frame=FrameOptions(dither=0.0))
    mel_weights = torch.as_tensor(melmod.mel_banks(
        23, opts.frame.padded_window_size, 16000.0,
        20.0, 0.0, 100.0, -500.0, 1.0)[0], device=device)
    feats = mfcc_batch(signals, lengths, mel_weights, opts,
                       num_frames(NSAMPLES, opts.frame)).cpu().numpy()
    return sum(accumulate_cmvn_stats(utt) for utt in feats)


def summary(stats):
    """(frames, mean, std) of [2, dim + 1] CMVN statistics."""
    count = stats[0, -1]
    mean = stats[0, :-1] / count
    std = np.sqrt(np.maximum(stats[1, :-1] / count - mean ** 2, 0))
    return int(count), mean, std


def worker(device, output=None, init_method=None, world_size=None,
           rank=None):
    """Join the group, reduce this process's shard statistics, and save
    the sum to ``output`` (.npy) on rank 0. ``init_method`` None reads
    torchrun's environment."""
    import torch.distributed as dist

    from shennong_tpu_torch.parallel import distributed

    distributed.initialize(init_method, world_size, rank, backend='gloo',
                           timeout=TIMEOUT)
    try:
        rank = dist.get_rank()
        total = distributed.reduce_cmvn_stats(
            {'corpus': shard_stats(rank, device=device)}, ['corpus'])['corpus']
        if rank == 0:
            frames, mean, std = summary(total)
            print(f'processes: {dist.get_world_size()}, global frames: '
                  f'{frames}')
            print('global mean[:3]:', np.round(mean[:3], 4))
            print('global std[:3]: ', np.round(std[:3], 4))
            if output:
                np.save(output, total)
    finally:
        dist.destroy_process_group()


def launch(processes=2, *, device, workdir=None):
    """Start ``processes`` worker processes on ``device``, joined over a
    ``file://`` store under ``workdir`` (a temporary directory, removed
    afterwards, when None), and hold their statistics against this
    process's sum of the shards in rank order.

    Returns a dict: the reduced ``stats``, the single process's
    ``single``, whether they are ``equal`` bit for bit, the global
    ``frames``, ``mean`` and ``std``, and each worker's ``logs``. Raises
    when a worker fails or the two sums differ.
    """
    created = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix='multihost_cmvn_')
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, 'store')
    output = os.path.join(workdir, 'stats.npy')
    try:
        procs, logs = [], []
        for rank in range(processes):
            logs.append(os.path.join(workdir, f'rank{rank}.log'))
            with open(logs[-1], 'w') as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     '--process-id', str(rank), '--processes',
                     str(processes), '--store', store, '--output', output,
                     '--device', str(device)],
                    stdout=log, stderr=subprocess.STDOUT))
        try:
            codes = [proc.wait(timeout=TIMEOUT) for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        texts = []
        for path in logs:
            with open(path) as log:
                texts.append(log.read())
        if any(codes):
            raise RuntimeError(
                f'worker exit codes {codes}:\n' + '\n'.join(texts))

        stats = np.load(output)
        single = sum(shard_stats(rank, device=device)
                     for rank in range(processes))
        equal = bool(np.array_equal(stats, single))
        frames, mean, std = summary(stats)
        print(texts[0], end='')
        print(f'{processes} processes against one: '
              f'{"bit-equal" if equal else "DIFFERENT"} statistics')
        if not equal:
            raise AssertionError(
                'the reduced statistics differ from one process\'s: '
                f'max abs {np.abs(stats - single).max()}')
        return {'stats': stats, 'single': single, 'equal': equal,
                'frames': frames, 'mean': mean, 'std': std, 'logs': texts}
    finally:
        if created:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--processes', type=int, default=2,
                        help=argparse.SUPPRESS)
    parser.add_argument('--process-id', type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument('--store', default=None, help=argparse.SUPPRESS)
    parser.add_argument('--output', default=None, help=argparse.SUPPRESS)
    add_device_option(parser)
    args = parser.parse_args(argv)
    device = device_of(args.device)
    if args.process_id is not None:
        worker(device, args.output, 'file://' + args.store, args.processes,
               args.process_id)
    elif 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
        worker(device)  # started by torchrun
    else:
        launch(args.processes, device=device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
