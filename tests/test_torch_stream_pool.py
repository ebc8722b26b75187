"""The port's upload buffer pool and the extraction plane's counters.

Ports of tests/test_stream.py's pool tests (reuse, views rejected, a
poisoned recycled buffer zero-padded, stale shapes evicted), the pool's
accounting against the JAX package's on the same sequence, and the
counters of one CPU extraction of each package over the same corpus:
the JAX package's keys and the port's own split of the call, the same
``bytes_up``, and half the JAX package's ``dispatches`` (it counts its
payload packing as a second program).
"""

import copy

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from shennong_tpu import pipeline as jpipeline
from shennong_tpu.parallel import profiler as jprofiler
from shennong_tpu.parallel import stream as jstream
from shennong_tpu.utterances import Utterances as JUtterances
from shennong_tpu_torch import native, pipeline
from shennong_tpu_torch.ops.framing import bucket_size
from shennong_tpu_torch.parallel import profiler
from shennong_tpu_torch.parallel import stream
from shennong_tpu_torch.utterances import Utterances
from tests.test_torch_tracing import NEW_COUNTERS


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp('pool')
    rng = np.random.RandomState(5)
    entries = []
    for index, nsamples in enumerate((9000, 17000, 12500, 30000, 22000)):
        t = np.arange(nsamples) / 16000
        signal = np.sin(2 * np.pi * (110 + 20 * index) * t) * (
            0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + rng.randn(nsamples) * 0.05
        wav = str(path / f'u{index}.wav')
        scipy.io.wavfile.write(
            wav, 16000, (signal / np.abs(signal).max() * 12000).astype(
                np.int16))
        entries.append((f'u{index}', wav, f'spk{index % 2}'))
    return entries


def test_buffer_pool_reuses_and_rejects_views():
    pool = stream._BufferPool(max_per_key=2)
    buf = pool.take((3, 5), False)
    assert buf.dtype == torch.int16
    buf[:] = 7
    pool.give(buf)
    again = pool.take((3, 5), False)
    assert again is buf  # recycled, pages already touched
    other = pool.take((3, 5), False)
    assert other is not buf  # the stack was empty
    # views are never pooled (their memory belongs to another tensor),
    # nor tensors the pool did not lend
    pool.give(buf[:2])
    pool.give(torch.zeros((2, 5), dtype=torch.int16))
    fresh = pool.take((2, 5), False)
    assert fresh._base is None
    assert fresh.data_ptr() != buf.data_ptr()
    # a buffer given twice comes back once
    pool.give(other)
    pool.give(other)
    assert pool.take((3, 5), False) is other
    assert pool.take((3, 5), False) is not other


@pytest.mark.parametrize('python_path', [False, True])
def test_recycled_buffers_are_zero_padded(corpus, python_path, monkeypatch):
    """A dirty recycled buffer must not leak samples into the padding
    of the next batch that reuses it, on either decode route."""
    if python_path:
        monkeypatch.setattr(native, 'available', lambda: False)
    utterances = Utterances(corpus)
    chunk = stream.plan_batches(utterances, 4)[0]
    names, signals, nsamples, nvalid = stream.decode_batch(chunk, False)
    reference = signals.clone()
    poisoned = signals
    poisoned[:] = 123  # worst case: a recycled buffer full of garbage
    stream.recycle(poisoned)
    names2, signals2, nsamples2, nvalid2 = stream.decode_batch(chunk, False)
    assert signals2 is poisoned  # the pool handed the buffer back
    assert names2 == names and nvalid2 == nvalid == len(chunk)
    np.testing.assert_array_equal(nsamples2, nsamples)
    for row in range(nvalid2):
        assert not signals2[row, nsamples2[row]:].any()
    assert not signals2[nvalid2:].any()
    assert torch.equal(signals2, reference)
    stream.recycle(signals2)


def test_buffer_pool_evicts_stale_shapes():
    """A long-lived service over many corpus geometries must not hoard
    buffers for shapes it never sees again."""
    pool = stream._BufferPool(max_per_key=2, max_keys=4)
    for i in range(10):
        pool.give(pool.take((2, 100 + i), False))
    assert len(pool._free) <= 4
    # the most recently given shape survived
    kept = pool.take((2, 109), False)
    assert kept.shape == (2, 109)
    assert pool._pooled == sum(
        b.numel() * b.element_size()
        for stack in pool._free.values() for b in stack)


def test_pool_accounting_matches_jax():
    """The same take/give sequence gives the same footprint and
    high-water mark as the JAX package's numpy pool."""
    ours = stream._BufferPool(max_per_key=2, max_keys=3)
    theirs = jstream._BufferPool(max_per_key=2, max_keys=3)
    shapes = [(4, 1000), (4, 1000), (4, 2000), (2, 3000), (4, 1000),
              (3, 500), (4, 2000), (1, 100)]
    held = []
    for step, shape in enumerate(shapes):
        held.append((ours.take(shape, False),
                     theirs.take(shape, np.int16)))
        if step % 3 == 2:  # give back all but the newest
            for mine, ref in held[:-1]:
                ours.give(mine)
                theirs.give(ref)
            held = held[-1:]
        assert ours.peak_bytes == theirs.peak_bytes, step
        assert ours._outstanding == theirs._outstanding, step
        assert ours._pooled == theirs._pooled, step
    ours.reset_peak()
    theirs.reset_peak()
    assert ours.peak_bytes == theirs.peak_bytes


def test_pending_uploads_recycle_on_the_cpu():
    pool = stream._pool
    buffer = pool.take((2, 7), False)
    uploads = stream.PendingUploads('cpu')
    uploads.add(buffer)
    assert pool.lends(buffer)
    uploads.release()
    assert not pool.lends(buffer)
    assert pool.take((2, 7), False) is buffer
    stream.recycle(buffer)


def test_extraction_counters_match_jax(corpus):
    config = pipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
    profiler.counters.reset()
    pipeline.extract_features(
        copy.deepcopy(config), Utterances(corpus), njobs=2, device='cpu')
    ours = profiler.counters.snapshot()
    jprofiler.counters.reset()
    jpipeline.extract_features(
        copy.deepcopy(config), JUtterances(corpus), njobs=2)
    theirs = jprofiler.counters.snapshot()
    assert sorted(theirs) == sorted(
        ('decode_s', 'dispatch_s', 'dispatches', 'bytes_up', 'fetch_s',
         'bytes_down', 'pass2_s'))
    # the port also splits the call's time and pass 2
    # (tests/test_torch_tracing.py); no kernel launches on the CPU
    assert set(theirs) <= set(ours)
    assert set(ours) - set(theirs) == set(NEW_COUNTERS)
    assert ours['bytes_up'] == theirs['bytes_up']
    # one batch of 5: int16 [5, bucket] signals and int32 nsamples
    assert ours['bytes_up'] == 5 * bucket_size(30000) * 2 + 5 * 4
    assert ours['dispatches'] == theirs['dispatches'] / 2 == 1
    for key in ('decode_s', 'dispatch_s', 'fetch_s', 'pass2_s'):
        assert ours[key] > 0, key
