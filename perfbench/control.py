"""The readings the limits of ``correct`` are set from.

``python3 perfbench/control.py --workload <cell> --seeds <n>...
--control-seeds <n>...`` on a card: for each seed, the cell's corpus,
one ``extract_features`` call over it as the window makes them (the
lower readings: sound runs of the program) or the control in its
place (the upper readings), each held against the reference by the
cell's harness (:mod:`perfbench.harness`), as
:func:`perfbench.bench.compare` holds a run. One JSON line per seed.

The control is named by the cell's ``perfbench/checks/<cell>.json``:

- ``program_tf32``: the program with TF32 matrix products switched back
  on (the port turns them off: its float32 is float32 with TF32 off),
  the cells' control;
- ``program_bfloat16_fetch``: the program with its bfloat16 path switched
  on (``extract_features(..., fetch_dtype='bfloat16')``, pass 1's outputs
  fetched in bfloat16), a coarser one that the CPU can run too.

The benchmark's own runs never run this.
"""

import argparse
import copy
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import bench, check, corpus  # noqa: E402
from perfbench.harness import merge  # noqa: E402
from perfbench.manifest import Manifest  # noqa: E402


def outputs_of(config, entries, compared, seed, device, control):
    """One call's outputs of the compared utterances under the pipeline
    configuration ``config``: the program's, or the control's named by
    ``control``."""
    import numpy as np
    import torch

    from shennong_tpu_torch import Utterances, pipeline
    from shennong_tpu_torch.logger import null_logger

    fetch = 'bfloat16' if control == 'program_bfloat16_fetch' else None
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    if control == 'program_tf32':
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        collection = pipeline.extract_features(
            copy.deepcopy(config), Utterances(entries), device=device,
            generator=torch.Generator(device=device).manual_seed(
                int(seed) + bench.DITHER_SEED),
            fetch_dtype=fetch, log=null_logger())
        bench.synchronize(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
    return {name: np.asarray(collection[name].data) for name in compared}


def readings(cell, seed, device, workdir, control=None, warm=False):
    """The compared numbers of one seed's call (or its control)."""
    from shennong_tpu_torch import Utterances, pipeline
    from shennong_tpu_torch.logger import null_logger

    entries, samples = corpus.write_corpus(cell.traffic, seed, workdir,
                                           device)
    config = merge(cell.pipeline, cell.harness.prepare(seed, workdir, device))
    if warm:
        pipeline.extract_features(
            copy.deepcopy(config), Utterances(entries), device=device,
            log=null_logger())
    compared = check.compared_names(samples, entries, cell.traffic, seed)
    begin = time.perf_counter()
    outputs = outputs_of(config, entries, compared, seed, device, control)
    call_s = time.perf_counter() - begin
    numbers, details = bench.compare(cell, entries, compared, [outputs],
                                     device, seed)
    return dict(numbers, **details, call_s=call_s,
                reference_s=time.perf_counter() - begin - call_s,
                compared=len(compared))


def main(argv=None):
    parser = argparse.ArgumentParser(prog='perfbench/control.py')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='*', default=[])
    parser.add_argument('--control-seeds', type=int, nargs='*', default=[])
    parser.add_argument('--control', help='the control to read (default: '
                        "the one the cell's checks file names)")
    args = parser.parse_args(argv)
    bench.configure_caches()
    cell = Manifest().cell(args.workload)
    bench.require_cards(cell.chips)
    control = args.control or json.load(open(os.path.join(
        cell.manifest.here, 'checks', f'{cell.name}.json')))['control']
    runs = ([(s, None) for s in args.seeds]
            + [(s, control) for s in args.control_seeds])
    for index, (seed, who) in enumerate(runs):
        workdir = tempfile.mkdtemp(prefix='perfbench-control-')
        try:
            line = readings(cell, seed, 'cuda', workdir, who,
                            warm=index == 0)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps(dict(line, workload=cell.name, seed=seed,
                              who=who or 'program')), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
