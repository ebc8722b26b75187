"""Wall of the MFCC slice with pass 2 on its worker thread against pass
2 inline on the main thread, on the card.

Usage: ``python3 pass_two_turns.py [PAIRS]`` (default 10).

Pass 2 (CMVN apply, deltas, pitch concatenation of each CMVN group)
runs on the thread ``pass-two`` while pass 1 goes on
(``shennong_tpu_torch.pipeline._pass_two_worker``). This script swaps
that worker for one that runs each group inline, as the pipeline did
before the worker, and times ``extract_features`` of the
``chip_smoke.py`` corpus (256 utterances, the MFCC + Kaldi pitch + CMVN
+ delta configuration at full width) in turns: inline, worker, worker,
inline, ... ``PAIRS`` runs of each after one warm run. Prints each wall,
both medians, the pairs the worker won, and the card's name and power
limit. Exits with another code than 0 when no CUDA device is available.
"""

import contextlib
import copy
import os
import shutil
import sys
import time

import numpy as np
import torch

import chip_smoke


def main(pairs):
    from shennong_tpu_torch import Utterances, pipeline

    card = chip_smoke.probe()
    workdir = os.path.join(chip_smoke.HERE, 'build', 'pass_two_turns')
    try:
        utterances = Utterances(chip_smoke.make_corpus(workdir))
        config = chip_smoke.slice_config('mfcc')

        def extract():
            torch.cuda.synchronize()
            start = time.perf_counter()
            pipeline.extract_features(
                copy.deepcopy(config), utterances, device='cuda')
            torch.cuda.synchronize()
            return time.perf_counter() - start

        @contextlib.contextmanager
        def inline(manager, log, results):
            yield lambda triplets: results.update(
                pipeline._pass_two(manager, triplets, log))

        worker = pipeline._pass_two_worker
        extract()  # builds or loads the kernels, warms the caches
        walls = {'inline': [], 'worker': []}
        for turn in range(2 * pairs):
            mode = ('inline', 'worker', 'worker', 'inline')[turn % 4]
            pipeline._pass_two_worker = inline if mode == 'inline' else worker
            try:
                walls[mode].append(extract())
            finally:
                pipeline._pass_two_worker = worker
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    for mode, values in walls.items():
        print(f'{mode}: ' + ' '.join(f'{w:.4f}' for w in values)
              + f' s; median {np.median(values):.4f} s')
    won = sum(i > w for i, w in zip(walls['inline'], walls['worker']))
    print(f'the worker faster in {won} of {pairs} pairs; median of the '
          'pairwise differences (inline - worker) '
          f'{np.median(np.subtract(walls["inline"], walls["worker"])):.4f} s')
    print(card)


if __name__ == '__main__':
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10)
