"""Counterpart of ``tests/test_stream.py``: the port's streaming host
data plane (``shennong_tpu_torch.parallel.stream``) on the same corpus,
with the JAX cases' checks. The streamed payloads equal an eager decode
of the whole corpus, the look-ahead is bounded (at most ``depth``
decoded batches in flight), and the executor built on it matches the
per-utterance processor (2e-4 absolute, 1e-5 relative).

Where the port differs:

- its stream yields the pool's int16 buffers, whatever route decoded
  them, so ``test_native_i16_path_matches_float_fallback`` holds the
  Python route's int16 rows equal to the native route's;
- ``test_stream_pad_to_multiple`` has no counterpart: the port's
  streaming has no ``pad_to_multiple`` (rows divisible by a mesh's data
  axis; ``tests/test_torch_api.py:SIGNATURES``);
- the buffer pool's three cases run in ``tests/test_torch_stream_pool.py``
  with the same checks: ``test_buffer_pool_reuses_and_rejects_views``,
  ``test_recycled_buffers_are_zero_padded`` (both decode routes) and
  ``test_buffer_pool_evicts_stale_shapes``.
"""

import threading
import time

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from shennong_tpu_torch.parallel import batch as batching
from shennong_tpu_torch.parallel import stream as streaming
from shennong_tpu_torch.utterances import Utterances


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """12 wav files of staggered lengths + the utterance index."""
    path = tmp_path_factory.mktemp('stream_corpus')
    rng = np.random.RandomState(7)
    entries = []
    for i in range(12):
        nsamples = 4000 + 1713 * i
        sig = (rng.randn(nsamples) * 2000).astype(np.int16)
        wav = path / f'u{i:02d}.wav'
        scipy.io.wavfile.write(str(wav), 16000, sig)
        entries.append((f'u{i:02d}', str(wav), f'spk{i % 3}'))
    return Utterances(entries)


def _eager_batches(utterances, batch_size):
    items = batching.load_signals(list(utterances))
    return list(batching.make_batches(items, batch_size))


def _assert_same_batches(eager, streamed):
    assert len(eager) == len(streamed)
    for (en, es, ec, ev), (sn, ss, sc, sv) in zip(eager, streamed):
        assert en == sn
        assert ev == sv
        np.testing.assert_array_equal(ec, sc)
        assert ss.dtype == torch.int16
        np.testing.assert_array_equal(es, ss.numpy())


def test_stream_equals_eager(corpus):
    _assert_same_batches(
        _eager_batches(corpus, batch_size=5),
        list(streaming.stream_batches(corpus, batch_size=5,
                                      pin_memory=False)))


def test_stream_bounded_lookahead(corpus, monkeypatch):
    """Never more than ``depth`` decodes in flight ahead of the
    consumer: with the consumer stalled, at most depth batches decode."""
    lock = threading.Lock()
    state = {'running': 0, 'done': 0, 'max_done_ahead': 0}
    consumed = {'count': 0}
    real_decode = streaming.decode_batch

    def tracking_decode(chunk, pin_memory, njobs=4):
        with lock:
            state['running'] += 1
        out = real_decode(chunk, pin_memory, njobs)
        with lock:
            state['running'] -= 1
            state['done'] += 1
            ahead = state['done'] - consumed['count']
            state['max_done_ahead'] = max(state['max_done_ahead'], ahead)
        return out

    monkeypatch.setattr(streaming, 'decode_batch', tracking_decode)

    batches = 0
    for _ in streaming.stream_batches(
            corpus, batch_size=2, pin_memory=False, depth=2):
        # stall so the prefetcher runs as far ahead as it ever will
        time.sleep(0.05)
        consumed['count'] += 1
        batches += 1
    assert batches == 6
    # depth in-flight jobs + the one being handed over
    assert state['max_done_ahead'] <= 3


def test_plan_matches_scan_lengths(corpus):
    plans = streaming.plan_batches(corpus, batch_size=5)
    seen = [u.name for chunk in plans for u in chunk]
    assert sorted(seen) == sorted(u.name for u in corpus)
    # within the plan order, scanned lengths are non-decreasing
    lengths = [streaming._scan_count(u) for chunk in plans for u in chunk]
    assert lengths == sorted(lengths)


def test_executor_streaming_matches_single(corpus):
    from shennong_tpu_torch.parallel.executor import BatchExecutor
    from shennong_tpu_torch.processor.mfcc import MfccProcessor

    proc = MfccProcessor(dither=0)
    batched = BatchExecutor(
        proc, batch_size=5, device='cpu').process_all(corpus)
    for utt in corpus:
        single = MfccProcessor(dither=0).process(
            utt.load_audio(), device='cpu')
        np.testing.assert_allclose(
            batched[utt.name].data, single.data, atol=2e-4, rtol=1e-5)


def test_stream_segment_utterances(corpus):
    """tstart/tstop segments decode to the same payloads streaming
    and eager."""
    first = list(corpus)[3]
    utts = Utterances([
        ('seg1', first.audio_file, 0.0, 0.25),
        ('seg2', first.audio_file, 0.1, 0.5)])
    _assert_same_batches(
        _eager_batches(utts, batch_size=4),
        list(streaming.stream_batches(utts, batch_size=4,
                                      pin_memory=False)))


def test_native_i16_path_matches_float_fallback(corpus, monkeypatch):
    """PCM16 corpora decode through the native int16 loader; forcing
    the Python route must give value-identical payloads."""
    fast = [(n, s.clone(), c, v) for n, s, c, v in streaming.stream_batches(
        corpus, batch_size=4, pin_memory=False)]
    calls = []
    real_load = batching.load_signals
    monkeypatch.setattr(batching, '_native_plan', lambda chunk: None)
    monkeypatch.setattr(
        batching, 'load_signals',
        lambda *args, **kwargs: calls.append(1) or real_load(
            *args, **kwargs))
    slow = list(streaming.stream_batches(
        corpus, batch_size=4, pin_memory=False))
    assert len(calls) == len(slow) == len(fast)
    for (fn, fs, fc, fv), (sn, ss, sc, sv) in zip(fast, slow):
        assert fn == sn and fv == sv
        assert ss.dtype == fs.dtype == torch.int16
        assert torch.equal(fs, ss)
        np.testing.assert_array_equal(fc, sc)
