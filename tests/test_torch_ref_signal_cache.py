"""Counterpart of ``tests/test_signal_cache.py``: the port's
device-signal cache (:class:`shennong_tpu_torch.parallel.stream.SignalCache`,
one corpus upload spanning many sweeps), its consumers (BatchExecutor,
the UBM front-end) and the UBM->VTLN front-end reuse, on the same
corpus, with the JAX cases' checks (replays bit-equal, one decode).

Where the port differs:

- it keys an entry on the batch size, where the JAX package keys on
  ``pad_to_multiple`` and re-chunks a replay to the consumer's batch
  size: ``test_replay_rechunks_to_consumer_batch_size`` holds that a
  second batch size streams afresh, with the same rows, and
  ``test_budget_is_global_across_entries`` makes its second key with
  another batch size;
- ``test_vtln_decodes_once_with_default_mesh`` has no counterpart: the
  port has no device mesh (``tests/test_torch_api.py:EXEMPT``,
  ``parallel:set_default_mesh``); ``test_vtln_reuses_ubm_frontend``
  holds the decode-once guarantee of its one-device path.
"""

import numpy as np
import pytest
import torch

from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.parallel import stream as streaming
from shennong_tpu_torch.parallel.stream import SignalCache
from shennong_tpu_torch.utterances import Utterances

from tests.conftest import make_speech_like_signal


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """Five wav files of different lengths, two speakers."""
    path = tmp_path_factory.mktemp('cache_corpus')
    items = []
    for i, nsamples in enumerate(
            [8000, 12000, 16000, 17000, 24000]):
        signal = make_speech_like_signal(nsamples, 16000, seed=i)
        wav = str(path / f'utt{i}.wav')
        Audio(signal, 16000).save(wav)
        items.append(
            (f'utt{i}', wav, 'spk1' if i % 2 else 'spk2'))
    return Utterances(items)


def _collect(source):
    """name -> (valid signal row as float, nsamples) for a stream."""
    rows = {}
    for names, signals, nsamples, nvalid in source:
        host = signals.numpy()
        for row, name in enumerate(names):
            count = int(nsamples[row])
            rows[name] = host[row, :count].astype(np.float32)
    return rows


def _stream(utterances, batch_size):
    return streaming.stream_batches(utterances, batch_size, False)


def test_replay_matches_stream(corpus):
    cache = SignalCache(device='cpu')
    fresh = _collect(_stream(corpus, 2))
    first = _collect(cache.stream(corpus, batch_size=2))
    replay = _collect(cache.stream(corpus, batch_size=2))
    assert set(fresh) == set(first) == set(replay)
    for name in fresh:
        np.testing.assert_array_equal(fresh[name], first[name])
        np.testing.assert_array_equal(fresh[name], replay[name])


def test_populate_yields_device_arrays(corpus, monkeypatch):
    cache = SignalCache(device='cpu')
    for _, signals, _, _ in cache.stream(corpus, batch_size=2):
        # copies on the cache's device, uploaded as int16 (PCM16
        # corpus), never the pool's host buffers
        assert signals.device == cache.device
        assert signals.dtype == torch.int16
        assert not streaming._pool.lends(signals)

    def boom(*args, **kwargs):  # pragma: nocover
        raise AssertionError('replay must not decode')

    monkeypatch.setattr(streaming, 'decode_batch', boom)
    assert len(list(cache.stream(corpus, batch_size=2))) == 3


def test_replay_rechunks_to_consumer_batch_size(corpus):
    """A recorded 5-row batch, then a 2-row consumer: the port keys its
    entries on the batch size, so the second consumer streams its own
    chunks, with identical rows, and both entries are kept."""
    cache = SignalCache(device='cpu')
    recorded = list(cache.stream(corpus, batch_size=5))
    assert len(recorded) == 1
    replayed = list(cache.stream(corpus, batch_size=2))
    assert [len(names) for names, *_ in replayed] == [2, 2, 1]
    assert len(cache._entries) == 2
    fresh = _collect(_stream(corpus, 5))
    chunks = _collect(iter(replayed))
    assert set(chunks) == set(fresh)
    for name in fresh:
        np.testing.assert_array_equal(fresh[name], chunks[name])


def test_budget_is_global_across_entries(corpus):
    """max_bytes caps TOTAL retention: a second key that would exceed
    the remaining budget streams instead of retaining."""
    probe = SignalCache(device='cpu')
    list(probe.stream(corpus, batch_size=2))
    one_copy = probe._bytes
    assert one_copy > 0

    cache = SignalCache(max_bytes=one_copy, device='cpu')
    list(cache.stream(corpus, batch_size=2))
    assert cache._bytes == one_copy
    # same audio under another batch size -> a distinct key that no
    # longer fits the remaining (zero) budget
    list(cache.stream(corpus, batch_size=3))
    assert cache._bytes == one_copy
    assert len(cache._oversize) == 1
    assert len(cache._entries) == 1


def test_oversize_falls_back_to_streaming(corpus):
    cache = SignalCache(max_bytes=128, device='cpu')
    first = _collect(cache.stream(corpus, batch_size=2))
    assert cache._entries == {}
    assert len(cache._oversize) == 1
    second = list(cache.stream(corpus, batch_size=2))
    # the fallback is the plain host streaming path: the pool's buffers
    assert all(streaming._pool.lends(signals)
               for _, signals, _, _ in second)
    assert set(_collect(iter(second))) == set(first)
    for _, signals, _, _ in second:
        streaming.recycle(signals)


def test_executor_replay_equality(corpus):
    from shennong_tpu_torch.processor.mfcc import MfccProcessor
    from shennong_tpu_torch.parallel.executor import BatchExecutor

    proc = MfccProcessor(dither=0)
    plain = BatchExecutor(proc, device='cpu').process_all(corpus, njobs=1)
    cache = SignalCache(device='cpu')
    populated = BatchExecutor(proc, device='cpu').process_all(
        corpus, njobs=1, signal_cache=cache)
    replayed = BatchExecutor(proc, device='cpu').process_all(
        corpus, njobs=1, signal_cache=cache)
    for name in plain.keys():
        np.testing.assert_array_equal(
            plain[name].data, populated[name].data)
        np.testing.assert_array_equal(
            plain[name].data, replayed[name].data)


def test_depth_bounds_the_copies_in_flight(corpus, monkeypatch):
    """``SignalCache(depth=...)`` (the JAX package's constructor
    argument): at most ``depth`` uploads wait before the oldest is
    released."""
    kept = []
    real_release = streaming.PendingUploads.release

    def recording(self, keep=None):
        kept.append(keep)
        return real_release(self, keep)

    monkeypatch.setattr(streaming.PendingUploads, 'release', recording)
    list(SignalCache(depth=3, device='cpu').stream(corpus, batch_size=2))
    assert set(kept) == {3, 0}  # one per batch, then the drain


def _no_dither_features():
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.postprocessor.cmvn import (
        SlidingWindowCmvnPostProcessor)

    config = pipeline.get_default_config('mfcc', with_delta=True)
    config['mfcc']['dither'] = 0
    config['sliding_window_cmvn'] = (
        SlidingWindowCmvnPostProcessor().get_params())
    config['sliding_window_cmvn']['cmn_window'] = 300
    config['delta']['window'] = 3
    return config


def test_frontend_cache_transparent(corpus):
    """stream_frontend through a populated cache returns bit-identical
    features (dither=0)."""
    from shennong_tpu_torch.processor.ubm import (
        DiagUbmProcessor, stream_frontend)

    config = _no_dither_features()
    vad = DiagUbmProcessor(4).vad
    plain = stream_frontend(
        config, vad, 5, corpus, batch_size=2, device='cpu')
    cache = SignalCache(device='cpu')
    via_cache = stream_frontend(
        config, vad, 5, corpus, batch_size=2, signal_cache=cache,
        device='cpu')
    replay = stream_frontend(
        config, vad, 5, corpus, batch_size=2, signal_cache=cache,
        device='cpu')
    assert plain is not None and via_cache is not None
    assert torch.equal(plain[0], via_cache[0])
    assert torch.equal(plain[0], replay[0])
    assert torch.equal(plain[2], replay[2])


def test_vtln_reuses_ubm_frontend(corpus, monkeypatch):
    """With identical feature configs the VTLN trainer reuses the
    UBM's front-end pass: stream_frontend runs exactly once and the
    audio decodes exactly once."""
    from shennong_tpu_torch.processor import ubm as ubm_module
    from shennong_tpu_torch.processor.vtln import VtlnProcessor

    config = _no_dither_features()
    calls = []
    real_frontend = ubm_module.stream_frontend

    def counting_frontend(*args, **kwargs):
        calls.append(kwargs.get('signal_cache'))
        return real_frontend(*args, **kwargs)

    monkeypatch.setattr(
        ubm_module, 'stream_frontend', counting_frontend)

    decodes = []
    real_decode = streaming.decode_batch

    def counting_decode(chunk, pin_memory, njobs=4):
        decodes.append(len(chunk))
        return real_decode(chunk, pin_memory, njobs)

    monkeypatch.setattr(streaming, 'decode_batch', counting_decode)

    vtln = VtlnProcessor(
        num_iters=2, min_warp=0.95, max_warp=1.05, warp_step=0.05,
        subsample=5, features=config,
        ubm={'num_gauss': 4, 'num_iters': 1, 'num_iters_init': 2,
             'num_frames': 1000, 'features': config})
    warps = vtln.process(corpus, device='cpu')
    assert sorted(warps.keys()) == [u.name for u in sorted(
        corpus, key=lambda u: u.name)]
    # one front-end pass (the UBM's), reused by the VTLN trainer
    assert len(calls) == 1
    assert calls[0] is not None  # it rode the signal cache
    # the corpus decoded exactly once: the warp-moment pass replayed
    # the cached uploads
    assert sum(decodes) == len(list(corpus))


def test_vtln_mismatched_config_recomputes(corpus, monkeypatch):
    """A VTLN subsample differing from the UBM's must NOT reuse the
    UBM front-end."""
    from shennong_tpu_torch.processor import ubm as ubm_module
    from shennong_tpu_torch.processor.vtln import VtlnProcessor

    config = _no_dither_features()
    calls = []
    real_frontend = ubm_module.stream_frontend

    def counting_frontend(*args, **kwargs):
        calls.append(args)
        return real_frontend(*args, **kwargs)

    monkeypatch.setattr(
        ubm_module, 'stream_frontend', counting_frontend)

    vtln = VtlnProcessor(
        num_iters=1, min_warp=0.95, max_warp=1.05, warp_step=0.05,
        subsample=2, features=config,
        ubm={'num_gauss': 4, 'num_iters': 1, 'num_iters_init': 2,
             'num_frames': 1000, 'subsample': 5, 'features': config})
    warps = vtln.process(corpus, device='cpu')
    assert len(warps) == len(list(corpus))
    assert len(calls) == 2




def test_train_ubm_rides_the_signal_cache(corpus, monkeypatch):
    """``parallel.distributed.train_ubm(..., signal_cache=...)`` (the
    JAX package's parameter), here in one process: the same model as
    without the cache, and a later sweep of the same batches replays
    the uploads with no decode."""
    from shennong_tpu_torch.parallel import distributed
    from shennong_tpu_torch.processor.ubm import DiagUbmProcessor

    def train(signal_cache):
        ubm = DiagUbmProcessor(
            4, num_iters=1, num_iters_init=2, num_frames=1000, seed=3,
            features=_no_dither_features())
        return distributed.train_ubm(
            ubm, corpus, signal_cache=signal_cache, device='cpu')

    plain = train(None)
    cache = SignalCache(device='cpu')
    cached = train(cache)
    for name in ('weights', 'means', 'inv_vars'):
        np.testing.assert_array_equal(
            getattr(plain, name), getattr(cached, name))
    assert len(cache._entries) == 1

    def boom(*args, **kwargs):  # pragma: nocover
        raise AssertionError('replay must not decode')

    monkeypatch.setattr(streaming, 'decode_batch', boom)
    (key, entries), = cache._entries.items()
    assert len(list(cache.stream(corpus, batch_size=key[1]))) == \
        len(entries)
