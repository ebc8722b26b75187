"""Timings of UBM-GMM and 41-class LVTLN training on a card, in one
process.

The PyTorch port's counterpart of ``examples/training_bench.py``: a
200-utterance, about 1200 s, 10-speaker synthetic corpus (the corpus of
``features_abx.py``) and the reference's training setup (a UBM of 64
gaussians, 8 initial and 4 main EM iterations; LVTLN with the default
41-class warp grid and 3 estimation rounds; the reference trains the
same models in ``shennong/processor/ubm.py:714-772`` and
``vtln.py:511-664``), each trained ``--runs`` times in one process.

Run 0 is the first in the process: it pays what no later run pays
again, the CUDA context, cuFFT plans for each signal bucket, cuBLAS
and cuSOLVER handles, the allocators' first segments, and the g++
build of the native IO runtime when ``_build/`` lacks it. The training
launches none of the hand-written CUDA kernels, so no nvcc build. The
later runs are warm.

Usage::

    python examples/torch/training_bench.py [<workdir>] [--utterances N]
        [--runs N] [--device cuda]
"""

import argparse
import copy
import os
import sys
import tempfile
import time

# run from a source checkout without installation
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, os.pardir), HERE]

from example_utils import add_device_option, device_of, make_synthetic_corpus

#: the reference's training setup
UBM = dict(num_gauss=64, num_iters=4, num_iters_init=8)
VTLN = dict(num_iters=3, ubm=UBM)


def bench(workdir, utterances=200, runs=3, *, device, ubm=None, vtln=None):
    """Train the UBM, then the LVTLN warps by speaker, ``runs`` times
    each on ``device``, over the synthetic corpus written under
    ``workdir/corpus``.

    ``ubm`` and ``vtln`` are the processors' parameters (:data:`UBM` and
    :data:`VTLN` when None). Returns a dict: the audio ``seconds``, by
    model (``'ubm'``, ``'vtln'``) the ``walls`` of each run, and the
    last run's trained processors (``ubm_model``, ``vtln_model``) and
    ``warps``.
    """
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch.processor import VtlnProcessor
    from shennong_tpu_torch.processor.ubm import DiagUbmProcessor

    corpus = Utterances(make_synthetic_corpus(
        os.path.join(workdir, 'corpus'), utterances))
    total = sum(utt.duration for utt in corpus)
    print(f'corpus: {len(corpus)} utterances, {total:.0f} s of audio',
          flush=True)

    setups = (
        ('ubm', lambda: DiagUbmProcessor(**copy.deepcopy(ubm or UBM))),
        ('vtln', lambda: VtlnProcessor(**copy.deepcopy(vtln or VTLN))))
    report = {'seconds': total}
    for label, make in setups:
        walls = []
        for run in range(runs):
            proc = make()
            proc.set_logger('warning')
            start = time.perf_counter()
            if label == 'ubm':
                proc.process(corpus, njobs=4, device=device)
            else:
                report['warps'] = proc.process(
                    corpus, group_by='speaker', njobs=4, device=device)
            walls.append(time.perf_counter() - start)
            tag = 'cold' if run == 0 else 'warm'
            print(f'{label} run {run} ({tag}): {walls[-1]:.2f} s '
                  f'({total / walls[-1]:.0f}x RT)', flush=True)
        report[label] = walls
        report[f'{label}_model'] = proc
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        'workdir', nargs='?', default=None,
        help='where the corpus is written (default: a directory under the '
        "system's temporary directory)")
    parser.add_argument('--utterances', type=int, default=200)
    parser.add_argument('--runs', type=int, default=3)
    add_device_option(parser)
    args = parser.parse_args(argv)
    workdir = args.workdir or os.path.join(
        tempfile.gettempdir(), 'shennong_torch_train_bench')
    bench(workdir, args.utterances, args.runs,
          device=device_of(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
