"""The standing ABX benchmark table, on a card.

The PyTorch port's counterpart of ``examples/abx_benchmark.py``: it
runs :func:`shennong_tpu_torch.eval.abx_bench.benchmark` -- a fixed,
seeded synthetic corpus whose speakers differ by a stationary coloring
(the nuisance CMVN removes) and a vocal-tract formant scaling (the
nuisance VTLN models) -- on the device, the DTW in the CUDA kernel,
and prints the across- and within-speaker ABX error table in the
reference's published row structure (spectrogram / filterbank / mfcc /
plp / rastaplp, raw / +CMVN / VTLN+CMVN).

Run:  python examples/torch/abx_benchmark.py [--config full|ci] [--seed N]
          [--features mfcc,plp,...] [--json out.json] [--device cuda]
"""

import argparse
import json
import os
import sys
import time

# run from a source checkout without installation
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, os.pardir, os.pardir), HERE]

from example_utils import add_device_option, device_of


def table(out, features):
    """The printed tables of a benchmark result: the errors by task,
    feature and condition, then the learned warps against the true
    vocal-tract factors (the JAX example's layout)."""
    lines = []
    for task in ('across', 'within'):
        lines.append(f'\n{task}-speaker ABX error '
                     f'({out["nsegments"]} segments):')
        lines.append(f'{"features":<14}{"raw":>8}{"+CMVN":>8}'
                     f'{"VTLN+CMVN":>11}')
        for feature in features:
            conds = out['errors'][task][feature]
            vtln = (f'{conds["vtln+cmvn"]:>10.1%}'
                    if 'vtln+cmvn' in conds else f'{"-":>10}')
            lines.append(f'{feature:<14}{conds["raw"]:>8.1%}'
                         f'{conds["+cmvn"]:>8.1%}{vtln}')
    warps, alphas = out['warps'], out['alphas']
    ordered = sorted(alphas, key=alphas.get)
    lines.append('\nlearned warps vs true vocal-tract factor:')
    lines.append('  alpha: ' + ' '.join(f'{alphas[s]:.3f}' for s in ordered))
    lines.append('  warp : ' + ' '.join(f'{warps[s]:.3f}' for s in ordered))
    return '\n'.join(lines)


def run(config='full', seed=0, features='all', json_path=None, *, device):
    """Run the benchmark at ``config`` ('full' or 'ci') on ``device``
    over ``features`` ('all' or a comma list), print its tables and,
    with ``json_path``, append one JSON line to that file. Returns the
    benchmark's result with the printed ``table`` and the wall
    ``elapsed`` seconds added."""
    from shennong_tpu_torch.eval.abx_bench import CONFIGS, FEATURES, benchmark
    from shennong_tpu_torch.logger import get_logger

    features = (FEATURES if features == 'all'
                else tuple(features.split(',')))
    params = CONFIGS[config]
    print(f'config {config}: {params["nspeakers"]} speakers x '
          f'{params["nphones"]} phones x {params["tokens"]} tokens, '
          f'seed {seed}')

    start = time.perf_counter()
    out = benchmark(config, seed=seed, features=features, device=device,
                    log=get_logger('abx-bench', 'info'))
    out['elapsed'] = time.perf_counter() - start
    out['table'] = table(out, features)
    print(out['table'])
    print(f'\ntotal {out["elapsed"]:.1f}s')

    if json_path:
        record = {
            'config': config, 'seed': seed,
            'elapsed_s': round(out['elapsed'], 1),
            'errors': {
                task: {
                    feat: {k: round(v, 5) for k, v in conds.items()}
                    for feat, conds in out['errors'][task].items()}
                for task in out['errors']},
        }
        with open(json_path, 'a') as fp:
            fp.write(json.dumps(record) + '\n')
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--config', default='full', choices=('full', 'ci'))
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--features', default='all',
                        help='comma list, or "all"')
    parser.add_argument('--json', default=None,
                        help='append one JSON line to this file')
    add_device_option(parser)
    args = parser.parse_args(argv)
    run(args.config, args.seed, args.features, args.json,
        device=device_of(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
