#!/usr/bin/env python
"""Serializer I/O benchmark of the port at the reference's published
corpus scale.

The PyTorch port's counterpart of ``examples/serializer_bench.py``; it
runs on the host only (the serializers use no device). The reference
documents write/read times and file sizes for all six
serializers on MFCC features of the full Buckeye corpus — ~38 hours,
254 files (`shennong/features_collection.py:17-26`, reproduced in
BASELINE.md). This script builds a synthetic collection of the same
shape (254 utterances, 13.7M frames of 13-dim float32 MFCC +
[nframes, 2] float64 times) and times each serializer of
``shennong_tpu_torch``.

Usage: python examples/torch/serializer_bench.py [output-directory]
           [--scale S]
"""

import argparse
import datetime
import os
import shutil
import sys
import tempfile
import time

# run from a source checkout without installation
sys.path.insert(
    0, os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))

import numpy as np

from shennong_tpu_torch import Features, FeaturesCollection


def make_collection(nfiles, total_frames, ndims=13, seed=0):
    rng = np.random.RandomState(seed)
    frames_per_file = total_frames // nfiles
    collection = FeaturesCollection()
    # one shared MFCC-like block, offset per utterance: cepstra are
    # smooth along time (an AR(1) fit of real MFCCs has rho ~0.9), and
    # zlib-bound serializers behave very differently on smooth vs
    # white data. Building 900 MB of unique frames would dominate the
    # benchmark setup time.
    noise = rng.randn(frames_per_file, ndims).astype(np.float32)
    block = np.empty_like(noise)
    block[0] = noise[0]
    rho = np.float32(0.9)
    scale = np.float32(np.sqrt(1 - 0.9 ** 2))
    for row in range(1, frames_per_file):
        block[row] = rho * block[row - 1] + scale * noise[row]
    block *= np.linspace(18.0, 0.5, ndims, dtype=np.float32)
    for index in range(nfiles):
        nframes = frames_per_file
        starts = np.arange(nframes, dtype=np.float64) * 0.01
        times = np.stack([starts, starts + 0.025], axis=1)
        data = block + np.float32(index)  # distinct values per item
        collection[f'utt_{index:03d}'] = Features(
            data, times,
            properties={'pipeline': [], 'mfcc': {'num_ceps': ndims}},
            validate=False)
    return collection


def fmt_seconds(seconds):
    return str(datetime.timedelta(seconds=round(seconds)))


def fmt_size(nbytes):
    return f'{nbytes / 1e6:,.1f} MB'


def path_size(path):
    if os.path.isdir(path):
        return sum(
            os.path.getsize(os.path.join(path, f))
            for f in os.listdir(path))
    return os.path.getsize(path)


#: (format, save keyword arguments): the CSV serializer writes a folder,
#: selected by an extension-less target (one .csv file an utterance);
#: '.ark compact' is the opt-in float32 ark layout (half the bytes of
#: the reference-compatible double layout, still valid Kaldi)
FORMATS = (
    ('.pkl', {}), ('.h5f', {}), ('.npz', {}), ('.mat', {}),
    ('.ark', {}), ('.ark compact', {'compact': True}),
    ('csv-folder', {}))


def bench(outdir, scale=1.0):
    """Write and read the synthetic collection at ``scale`` (1.0 is the
    published 38 h) in each of :data:`FORMATS` under ``outdir``. Returns
    the (format, bytes, write seconds, read seconds) of each."""
    os.makedirs(outdir, exist_ok=True)
    nfiles = max(2, int(254 * min(scale, 1.0)))
    total_frames = int(13_680_000 * scale)
    print(f'building the collection: {nfiles} utterances, '
          f'{total_frames:,} frames '
          f'(~{total_frames / 100 / 3600:.1f} h of audio)...')
    collection = make_collection(nfiles, total_frames)

    results = []
    for ext, save_kwargs in FORMATS:
        target = os.path.join(
            outdir,
            'features_csv' if ext == 'csv-folder'
            else 'features' + ext.split(' ')[0])
        for stale in (target, target.replace('.ark', '.times.ark'),
                      target.replace('.ark', '.properties.json')):
            if os.path.isdir(stale):
                shutil.rmtree(stale)
            elif os.path.exists(stale):
                os.remove(stale)

        # settle pending writeback so the previous stage's (or the
        # collection build's) dirty pages don't tax this one
        os.sync()

        start = time.perf_counter()
        collection.save(target, **save_kwargs)
        write_time = time.perf_counter() - start

        start = time.perf_counter()
        loaded = FeaturesCollection.load(target)
        read_time = time.perf_counter() - start

        # spot-check integrity on one utterance
        name = sorted(collection.keys())[len(collection) // 2]
        assert np.allclose(
            loaded[name].data, collection[name].data, atol=1e-5), ext

        size = path_size(target)
        if ext.startswith('.ark'):
            for sidecar in ('features.times.ark',
                            'features.properties.json'):
                sidecar = os.path.join(outdir, sidecar)
                if os.path.exists(sidecar):
                    size += os.path.getsize(sidecar)
        results.append((ext, size, write_time, read_time))
        print(f'{ext:6s} {fmt_size(size):>12s} '
              f'write {fmt_seconds(write_time)} ({write_time:6.1f} s)  '
              f'read {fmt_seconds(read_time)} ({read_time:6.1f} s)')
        del loaded

    print('\n| format | file size | write time | read time |')
    print('|---|---|---|---|')
    for ext, size, wtime, rtime in results:
        print(f'| {ext} | {fmt_size(size)} | {fmt_seconds(wtime)} '
              f'| {fmt_seconds(rtime)} |')
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        'outdir', nargs='?', default=None,
        help='where the files are written (default: a directory under the '
        "system's temporary directory)")
    parser.add_argument(
        '--scale', type=float, default=1.0,
        help='corpus scale factor (1.0 = the published 38 h setup)')
    args = parser.parse_args(argv)
    bench(args.outdir or os.path.join(
        tempfile.gettempdir(), 'shennong_torch_serializer_bench'),
        args.scale)
    return 0


if __name__ == '__main__':
    sys.exit(main())
