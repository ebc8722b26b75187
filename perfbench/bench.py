"""One run of one cell: set-up, the measured window, the check.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. Set-up writes the cell's
corpus from the seed (WAV files under the run's ``TMPDIR``, read back
through the port's own decode path), runs the harness's ``prepare``
(:mod:`perfbench.harness`: what else the configuration needs, merged
into the pipeline configuration) and warms the port with one untimed
call over the corpus. The window is a closed loop of
``extract_features`` over the whole corpus, each call ended by a
device synchronisation, until ``--seconds`` have passed: the last call
may run past them by up to one call. ``xrt``, the audio seconds of
those calls over the wall from the first call's start to the last
call's end, goes to standard error.

With ``--trace 0`` the run reports the cell's end-to-end metrics:
``setup_s`` and ``xrt`` from the host's clock, and those of the
device's trace (``source`` ``device_trace``) each by its module in
``perfbench/metrics/``, over a trace of the card's operations alone
taken around the window. With ``--trace 1`` the window runs under
``torch.profiler`` with the host's operations and the port's spans,
and the run reports the per-layer metrics instead (each read by its
module), with the device's busy time and a breakdown.

After the window the outputs of every call are checked: each
utterance's shape against the harness's ``expected_shape``, the
compared utterances by the harness's ``compare`` (:mod:`perfbench.check`
for what every harness shares); the last line of standard output is the
result, and the numbers compared, each beside its limit, close both
the result and standard error.

This module knows no pipeline: a configuration of a new shape comes
with its own harness module and files, and edits none of these
(:mod:`perfbench.manifest` lists them).
"""

import argparse
import contextlib
import copy
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from perfbench import check, corpus, guard, tracing
from perfbench.harness import merge
from perfbench.manifest import HERE, Manifest

#: the program's random source (dither, pitch noise) is seeded with the
#: run's seed plus this, apart from the corpus's own draws
DITHER_SEED = 7
#: toolchain caches, at fixed paths inside the checkout
CACHES = {'TRITON_CACHE_DIR': 'triton',
          'TORCH_EXTENSIONS_DIR': 'torch_extensions',
          'CUDA_CACHE_PATH': 'nv'}


class NoCard(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def configure_caches(root=HERE):
    for variable, name in CACHES.items():
        path = os.path.join(root, '.cache', name)
        os.makedirs(path, exist_ok=True)
        os.environ[variable] = path


def parse(argv):
    parser = argparse.ArgumentParser(prog='perfbench/run.py')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def require_cards(chips):
    """The card's name; raises :class:`NoCard` without enough cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard('no CUDA device is available: the benchmark measures '
                     'the card and does not fall back to the CPU')
    if torch.cuda.device_count() < chips:
        raise NoCard(f'{torch.cuda.device_count()} CUDA devices, the cell '
                     f'asks for {chips}')
    return torch.cuda.get_device_name(0)


def power_limit():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return 'not read'
    return out.strip().splitlines()[0] if out.strip() else 'not read'


def synchronize(device):
    import torch

    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def reads_device(cell):
    """Whether an end-to-end metric of the cell is read from the
    device's trace."""
    return any(m['source'] == 'device_trace' for m in cell.end_to_end)


def device_profiler(on_card):
    """A profiler of the card's operations alone (on the CPU, which has
    none, of the host's), for the end-to-end metrics read from the
    device's trace: it records no host operation or span, so it leaves
    the host's work as it is."""
    import torch
    from torch.profiler import ProfilerActivity

    return torch.profiler.profile(activities=[
        ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU])


def measure(cell, seed, seconds, trace, device, start, workdir):
    """Set up, run the window and check it. Returns (result dict without
    ``device``'s name, the checks, a list of lines for standard
    error)."""
    import numpy as np
    import torch

    from shennong_tpu_torch import Utterances, pipeline
    from shennong_tpu_torch.logger import null_logger
    from shennong_tpu_torch.parallel.profiler import (
        counters, profiler_options)

    harness = cell.harness
    rate = harness.sample_rate
    on_card = torch.device(device).type == 'cuda'

    entries, samples = corpus.write_corpus(cell.traffic, seed, workdir,
                                           device)
    written = time.perf_counter()
    config = merge(cell.pipeline, harness.prepare(seed, workdir, device))
    prepared = time.perf_counter()
    utterances = Utterances(entries)
    quiet = null_logger()
    # one untimed call over the corpus warms what the timed ones use:
    # pipeline.warmup's synthetic geometries left the first timed call
    # about 2 s slower than the next on the H100
    pipeline.extract_features(
        copy.deepcopy(config), utterances, device=device, log=quiet,
        generator=torch.Generator(device=device).manual_seed(
            seed + DITHER_SEED + 1))
    synchronize(device)
    warmed = time.perf_counter()
    generator = torch.Generator(device=device).manual_seed(
        seed + DITHER_SEED)
    names = list(samples)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - start

    # the window keeps, of each call, every utterance's shape and the
    # compared utterances' arrays (no copy), and drops the collection at
    # once (holding every call's outputs made each later call about a
    # third slower on the H100's machine); the rest is checked after the
    # window
    compared = check.compared_names(samples, entries, cell.traffic, seed)
    shapes, outputs, walls = [], [], []
    profiler = (torch.profiler.profile(**profiler_options()) if trace
                else device_profiler(on_card) if reads_device(cell)
                else contextlib.nullcontext())
    counters.reset()
    with profiler as prof:
        first = time.perf_counter()
        while True:
            begin = time.perf_counter()
            with torch.profiler.record_function(tracing.CALL_SPAN):
                collection = pipeline.extract_features(
                    copy.deepcopy(config), utterances, device=device,
                    generator=generator, log=quiet)
                synchronize(device)
            end = time.perf_counter()
            walls.append(end - begin)
            shapes.append([collection[name].data.shape
                           if name in collection else None
                           for name in names])
            outputs.append({name: collection[name].data
                            for name in compared if name in collection})
            del collection
            if end - first >= seconds:
                break
    window_s = end - first
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    counts = counters.snapshot()
    audio_s = len(walls) * sum(samples.values()) / rate

    expected = [harness.expected_shape(samples[name]) for name in names]
    failed = sum(check.count_failures(call, expected) for call in shapes)
    outputs = [{name: np.asarray(data) for name, data in call.items()}
               for call in outputs]
    failed += sum(check.count_unfinished(call) for call in outputs)
    attempted = len(walls) * len(samples)

    result = {'correct': False, 'attempted': attempted, 'failed': failed}
    lines = [f'set-up {setup_s:.3f} s: corpus written at '
             f'{written - start:.3f} s, prepared at {prepared - start:.3f} '
             f's, warm-up {warmed - prepared:.3f} s; '
             f'{torch.get_num_threads()} host threads a pool',
             f'calls {len(walls)}: walls ' + ', '.join(
        f'{w:.4f}' for w in walls) + f' s; window {window_s:.4f} s; '
             f'xrt {audio_s / window_s!r} audio_s/s']
    run = None
    if trace or reads_device(cell):
        begin = time.perf_counter()
        run = tracing.collect(prof, audio_s, counts, harness.trace_inputs(
            list(samples.values()) * len(walls)))
        del prof
        lines.append(f'trace of {len(run.device)} device operations read '
                     f'in {time.perf_counter() - begin:.1f} s; busy '
                     f'{run.busy_us() / 1e6!r} s, of which kernels '
                     f'{run.busy_us(tracing.is_kernel) / 1e6!r} s')
    if trace:
        result['metrics'] = reported(cell, cell.per_layer, run)
        result['busy_s'] = run.busy_us() / 1e6
        result['window_s'] = run.window_us / 1e6
        result['breakdown'] = tracing.breakdown(run)
    else:
        result['metrics'] = reported(
            cell, cell.end_to_end, run,
            {'xrt': audio_s / window_s, 'setup_s': setup_s})
    result['memory_peak_bytes'] = memory_peak

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    begin = time.perf_counter()
    readings, details = compare(cell, entries, compared, outputs, device,
                                seed)
    checks = {name: {'value': value, 'limit': cell.limits[name]}
              for name, value in readings.items()}
    checks['failed'] = {'value': failed, 'limit': 0}
    result['correct'] = bool(attempted) and all(
        c['value'] <= c['limit'] for c in checks.values())
    lines.append(f'reference check of {len(compared)} utterances in '
                 f'{time.perf_counter() - begin:.1f} s; ' + '; '.join(
                     f'{key} {value!r}' for key, value in details.items()))
    return result, checks, lines


def reported(cell, metrics, run, clock=None):
    """``{name: {'value', 'unit'}}`` of ``metrics``: each the host's
    clock gives from ``clock``, the others by their readers over the
    traced ``run``; a metric whose reader found nothing is left out."""
    clock = clock or {}
    values = {}
    for metric in metrics:
        name = metric['name']
        value = (clock[name] if name in clock
                 else cell.manifest.reader(name)(run))
        if value is not None:
            values[name] = {'value': value, 'unit': metric['unit']}
    return values


def compare(cell, entries, compared, outputs, device, seed):
    """The harness's ``(numbers, details)`` for the program's outputs;
    raises where a number has no limit or a limit no number."""
    numbers, details = cell.harness.compare(entries, compared, outputs,
                                            device, seed)
    if set(numbers) != set(cell.limits):
        raise ValueError(
            f'{cell.name}: the harness gives the numbers {sorted(numbers)}, '
            f'the checks file has limits for {sorted(cell.limits)}')
    return numbers, details


def result_line(result, checks, kind, chips, power):
    """The last line's object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (with ``busy_s`` and ``window_s`` when
    traced), the optional ``breakdown``, and ``checks`` last."""
    result = dict(result)
    device = {'platform': 'gpu', 'kind': kind, 'count': chips,
              'memory_peak_bytes': result.pop('memory_peak_bytes'),
              'power_limit': power}
    for key in ('busy_s', 'window_s'):
        if key in result:
            device[key] = result.pop(key)
    breakdown = result.pop('breakdown', None)
    line = dict(result, device=device)
    if breakdown is not None:
        line['breakdown'] = breakdown
    line['checks'] = checks
    return line


def main(argv, start):
    args = parse(argv)
    configure_caches()
    try:
        cell = Manifest().cell(args.workload)
        kind = require_cards(cell.chips)
    except (KeyError, ValueError, FileNotFoundError, NoCard) as error:
        print(f'perfbench: {error}', file=sys.stderr)
        return 2
    found = guard.loaded()
    if found:
        print(f'perfbench: loaded before the run: {found}', file=sys.stderr)
        return 3
    workdir = tempfile.mkdtemp(prefix=f'perfbench-{cell.name}-')
    try:
        result, checks, lines = measure(
            cell, args.seed, args.seconds, args.trace, 'cuda', start, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = guard.loaded()
    if found:
        print(f'perfbench: the run loaded {found}', file=sys.stderr)
        return 3
    line = result_line(result, checks, kind, cell.chips, power_limit())
    for text in lines:
        print(f'perfbench: {text}', file=sys.stderr)
    for name, c in checks.items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
