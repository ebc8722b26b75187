"""Streaming host data plane: bounded look-ahead batch decoding.

Counterpart of :mod:`shennong_tpu.parallel.stream`: utterances are
planned into padded batches from their header metadata alone (sorted
by length, so batches waste little padding), and a small thread pool
decodes at most ``depth`` batches ahead of the consumer. Mono PCM16 WAV
batches decode with the native loader straight into an int16 buffer,
pinned when it feeds a CUDA device, so the host-to-device copy is
asynchronous and moves half the bytes of float32; other audio loads
through :func:`shennong_tpu_torch.parallel.batch.load_signals` on
``njobs`` threads. A :class:`SignalCache` keeps a corpus's uploaded
batches on the device and replays them to later sweeps over the same
utterances.

Batch buffers come from a pool: a consumer hands a buffer back with
:func:`recycle` once the device copy that reads it has finished, and
the next batch of that shape reuses it. The pool's accounting is the
audio plane's host footprint (:func:`pool_peak_bytes`): it stays at a
few batches, ``(depth + 1)`` in flight plus what the pool keeps,
whatever the corpus size.

Batches are ``(names, signals [B, T], nsamples [B] int32, nvalid)``
with ``signals`` an int16 tensor: on the CPU when decoded, on the
cache's device when replayed.

Its counters and spans (the plan, the decode, the wait for it, the
bytes up) are listed in :mod:`shennong_tpu_torch.parallel.profiler`.
"""

import collections
import concurrent.futures
import threading
import weakref

import numpy as np
import torch

from shennong_tpu_torch import native
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.ops.framing import bucket_size
from shennong_tpu_torch.parallel import batch as batching
from shennong_tpu_torch.parallel.profiler import counters, span


class _BufferPool:
    """Recycled batch buffers of one dtype (int16 signals by default),
    keyed by (shape, pinned).

    Counterpart of the JAX package's pool of numpy buffers. A buffer is
    touched once and reused, and a pinned one is page-locked once:
    :func:`recycle` hands back a buffer that :meth:`take` lent, once
    the device copy that reads it is complete. The pool holds the
    tensors it keeps (it never returns them to PyTorch's caching host
    allocator while counting them free); unreturned buffers are
    garbage collected.
    """

    def __init__(self, max_per_key=4, max_keys=32, dtype=torch.int16):
        self._dtype = dtype
        self._free = {}
        self._max = max_per_key
        self._max_keys = max_keys
        self._lock = threading.Lock()
        # the buffers lent and not yet returned: only those come back
        # (a cached batch or a caller's own tensor never enters)
        self._lent = weakref.WeakValueDictionary()
        # the boundedness claim of this module, as a measurement:
        # outstanding (lent, not yet recycled) + pooled bytes, and the
        # high-water mark of their sum. An unreturned buffer counts as
        # outstanding until process exit: an upper bound on the audio
        # plane's footprint.
        self._outstanding = 0
        self._pooled = 0
        self.peak_bytes = 0

    def take(self, shape, pin_memory):
        key = (tuple(shape), bool(pin_memory))
        with self._lock:
            stack = self._free.get(key)
            if stack:
                buffer = stack.pop()
                if not stack:
                    del self._free[key]  # keep insertion order fresh
                nbytes = _nbytes(buffer)
                self._pooled -= nbytes
            else:
                buffer = torch.empty(key[0], dtype=self._dtype,
                                     pin_memory=key[1])
                nbytes = _nbytes(buffer)
            self._outstanding += nbytes
            self.peak_bytes = max(
                self.peak_bytes, self._outstanding + self._pooled)
            self._lent[id(buffer)] = buffer
            return buffer

    def give(self, tensor):
        with self._lock:
            if self._lent.get(id(tensor)) is not tensor:
                return  # not lent by this pool: a view, a replay, ...
            del self._lent[id(tensor)]
            nbytes = _nbytes(tensor)
            self._outstanding = max(0, self._outstanding - nbytes)
            key = (tuple(tensor.shape), tensor.is_pinned())
            stack = self._free.setdefault(key, [])
            if len(stack) < self._max:
                stack.append(tensor)
                self._pooled += nbytes
            # a long-lived service over many corpus geometries must not
            # hoard buffers for shapes it will never see again: evict
            # the least recently refreshed keys beyond the cap
            while len(self._free) > self._max_keys:
                oldest = next(iter(self._free))
                if oldest == key:
                    break
                self._pooled -= sum(_nbytes(b) for b in self._free[oldest])
                del self._free[oldest]

    def lends(self, tensor):
        """Whether ``tensor`` is a buffer this pool lent and that has
        not come back."""
        with self._lock:
            return self._lent.get(id(tensor)) is tensor

    def reset_peak(self):
        """Restart the high-water mark from the current footprint."""
        with self._lock:
            self.peak_bytes = self._outstanding + self._pooled


def _nbytes(tensor):
    return tensor.numel() * tensor.element_size()


_pool = _BufferPool()

#: the pinned uint8 buffers that the fused pass 1 downloads its packed
#: outputs into (:func:`shennong_tpu_torch.parallel.fused.pack_payload`),
#: apart from the audio plane: :func:`pool_peak_bytes` does not count
#: them
payloads = _BufferPool(dtype=torch.uint8)


def recycle(tensor):
    """Return a batch buffer to the pool for reuse.

    Call this once the batch's device copy has completed (after the
    synchronisation or the event that follows it), never while a copy
    may still read the buffer. Anything the pool did not lend (a
    replayed device batch, a view) is ignored.
    """
    _pool.give(tensor)


def pool_peak_bytes():
    """High-water mark of the host audio plane, in bytes: the most
    batch-buffer memory (outstanding + pooled) ever alive at once.
    A buffer is made only when none of its shape is pooled, so a run
    holds no more buffers of a shape than it has in flight at once
    (``2 * depth + 1`` in the fused pass 1), and the pool keeps up to
    4 of each of 32 shapes after: the peak follows the plan's distinct
    batch shapes, not the corpus length."""
    return _pool.peak_bytes


def pool_reset_peak():
    """Restart :func:`pool_peak_bytes` from the current footprint."""
    _pool.reset_peak()


def count_upload(signals, nsamples):
    """Add a batch's host-to-device bytes (its int16 signals and int32
    ``nsamples``) to ``counters['bytes_up']`` when its signals are a
    decoded buffer of the pool; a batch replayed from a
    :class:`SignalCache` uploads nothing (the cache counted it when it
    first copied it)."""
    if _pool.lends(signals):
        counters.add('bytes_up', _nbytes(signals) + nsamples.nbytes)


class PendingUploads:
    """Host batch buffers whose asynchronous copy to ``device`` may
    still be reading them: each goes back to the pool once an event
    recorded after its copy has completed (at once on the CPU, whose
    copies are synchronous)."""

    def __init__(self, device):
        self._device = torch.device(device)
        self._pending = collections.deque()

    def add(self, buffer):
        """Register ``buffer`` after enqueueing its copy."""
        event = None
        if self._device.type == 'cuda':
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
        self._pending.append((buffer, event))

    def release(self, keep=None):
        """Recycle the buffers whose copies have finished; with
        ``keep``, also wait for the oldest ones until at most ``keep``
        are pending."""
        while self._pending:
            buffer, event = self._pending[0]
            if event is not None and not event.query():
                if keep is None or len(self._pending) <= keep:
                    return
                event.synchronize()
            self._pending.popleft()
            recycle(buffer)

    def drain(self):
        """Wait for every pending copy and recycle its buffer."""
        self.release(keep=0)


def _scan_count(utt):
    """Utterance sample count from header metadata only (no decode)."""
    meta = Audio.scan(utt.audio_file)
    start, count = batching._utterance_bounds(utt, meta.sample_rate)
    return meta.nsamples - start if count is None else count


def as_int16_if_lossless(signals):
    """The int16 copy of integer-valued audio, else the input.

    Integer-valued rows (always true for PCM WAV) upload at half the
    float32 bytes; the consumers convert back on the device.
    """
    if signals.dtype == np.int16 or not isinstance(signals, np.ndarray):
        return signals
    as_i16 = signals.astype(np.int16)
    return as_i16 if np.array_equal(as_i16, signals) else signals


def streamed_order(utterances):
    """Indices of ``utterances`` in streaming order: sorted by scanned
    sample count, ties keeping collection order (a stable sort).

    The order of the rows a stream yields; distributed UBM training
    indexes the global voiced-frame sequence in it
    (:func:`shennong_tpu_torch.parallel.distributed.train_ubm`).
    """
    utterances = list(utterances)
    return sorted(range(len(utterances)),
                  key=lambda i: _scan_count(utterances[i]))


def plan_batches(utterances, batch_size):
    """Partition utterances into batches of at most ``batch_size``,
    in :func:`streamed_order`. Returns a list of lists. Adds its time to
    ``counters['plan_s']``."""
    with span('stream.plan', 'plan_s'):
        utterances = list(utterances)
        order = streamed_order(utterances)
        return [[utterances[i] for i in order[start:start + batch_size]]
                for start in range(0, len(order), batch_size)]


def decode_batch(chunk, pin_memory, njobs=4):
    """Decode one planned batch into ``(names, signals, nsamples,
    nvalid)``; the padded length is a geometric bucket of the longest
    utterance. The signals are a pooled int16 buffer, page-locked with
    ``pin_memory`` (for an asynchronous copy to a CUDA device), every
    row zero past its count. Mono PCM16 WAVs decode natively; other
    audio loads on ``njobs`` threads. Adds its time to
    ``counters['decode_s']``."""
    with span('decode', 'decode_s'):
        return _decode_batch(chunk, pin_memory, njobs)


def _decode_batch(chunk, pin_memory, njobs):
    names = [utt.name for utt in chunk]
    rows = len(chunk)
    plan = batching._native_plan(chunk)
    if plan is not None:
        paths, starts, counts = plan
        signals = _pool.take((rows, bucket_size(max(counts))), pin_memory)
        # the loader zeroes each row past its count
        loaded = native.load_wav_batch_i16(
            paths, starts, counts, signals.shape[1], out=signals.numpy())
        if loaded is not None:
            return names, signals, np.asarray(loaded[1], np.int32), rows
        recycle(signals)

    items = batching.load_signals(chunk, njobs=njobs)
    stride = bucket_size(max(len(sig) for _, sig in items))
    signals = _pool.take((rows, stride), pin_memory)
    host = signals.numpy()
    for row, (_, sig) in enumerate(items):
        host[row, :len(sig)] = sig
        host[row, len(sig):] = 0  # a recycled buffer holds old samples
    nsamples = np.asarray([len(sig) for _, sig in items], dtype=np.int32)
    return names, signals, nsamples, rows


def stream_batches(utterances, batch_size, pin_memory, njobs=4, depth=2):
    """Yield padded batches with at most ``depth`` decoded ahead: the
    next batches decode on host threads while the consumer works on
    the current one. ``njobs`` bounds each batch's Python decode (the
    native loader has its own 8 threads). The consumer recycles each
    batch's signals once their device copy is done. The time it blocks
    on the next decoded batch adds to ``counters['decode_wait_s']``."""
    plans = plan_batches(utterances, batch_size)
    depth = max(1, int(depth))
    with concurrent.futures.ThreadPoolExecutor(max_workers=depth) as pool:
        pending = [pool.submit(decode_batch, chunk, pin_memory, njobs)
                   for chunk in plans[:depth]]
        nextp = len(pending)
        while pending:
            with span('decode.wait', 'decode_wait_s'):
                batch = pending.pop(0).result()
            if nextp < len(plans):
                pending.append(pool.submit(
                    decode_batch, plans[nextp], pin_memory, njobs))
                nextp += 1
            yield batch


def stream_source(signal_cache, utterances, batch_size, pin_memory,
                  njobs=4, depth=2):
    """The batch stream of a corpus sweep: the cache's when one is
    given, plain host streaming otherwise."""
    if signal_cache is not None:
        return signal_cache.stream(
            utterances, batch_size, njobs=njobs, depth=depth)
    return stream_batches(
        utterances, batch_size, pin_memory, njobs=njobs, depth=depth)


class SignalCache:
    """Device-resident cache of a corpus's uploaded signal batches.

    Counterpart of :class:`shennong_tpu.parallel.stream.SignalCache`.
    The stage-wise pipeline sweeps the same audio once per stage
    (features, energy, pitch): the first :meth:`stream` call of a set
    of utterances and a batch size uploads its int16 batches to
    ``device`` and keeps them, and later calls replay them, with no
    decode and no host-to-device copy. Retention is capped at
    ``max_bytes`` of device memory over all entries; a sweep past the
    remaining budget streams normally every time. The cache is an
    optimisation and never changes what a sweep yields. Its entries
    are copies (on the CPU too), and the host buffers go back to the
    pool once an event after their copy has completed; ``depth`` copies
    stay in flight before the first of them is waited for.
    """

    def __init__(self, max_bytes=1 << 30, depth=2, *, device):
        self._entries = {}
        self._oversize = set()
        self._max_bytes = int(max_bytes)
        self._bytes = 0
        self._depth = max(1, int(depth))
        self.device = torch.device(device)

    @staticmethod
    def _key(utterances, batch_size):
        # names alone would collide for segments of one corpus with
        # other bounds
        return (tuple(sorted(
            (u.name, u.audio_file, u.tstart or 0.0, u.tstop or 0.0)
            for u in utterances)), int(batch_size))

    def stream(self, utterances, batch_size, njobs=4, depth=2):
        """Yield padded batches, populating or replaying the cache: the
        contract of :func:`stream_batches`, with ``signals`` on the
        cache's device."""
        utterances = list(utterances)
        key = self._key(utterances, batch_size)
        cached = self._entries.get(key)
        if cached is not None:
            yield from cached
            return
        pin_memory = self.device.type == 'cuda'
        if key in self._oversize:
            yield from stream_batches(
                utterances, batch_size, pin_memory, njobs=njobs, depth=depth)
            return

        entries, store = [], True
        uploads = PendingUploads(self.device)
        for names, signals, nsamples, nvalid in stream_batches(
                utterances, batch_size, pin_memory, njobs=njobs,
                depth=depth):
            count_upload(signals, nsamples)
            dev = signals.to(self.device, non_blocking=True, copy=True)
            uploads.add(signals)
            batch = (list(names), dev, nsamples.copy(), nvalid)
            nbytes = dev.numel() * dev.element_size()
            if store and self._bytes + nbytes > self._max_bytes:
                store = False
                for _, old, _, _ in entries:
                    self._bytes -= old.numel() * old.element_size()
                entries = []
            elif store:
                self._bytes += nbytes
                entries.append(batch)
            # a small window of copies in flight keeps the pool fed
            # without a wait on every batch
            uploads.release(keep=self._depth)
            yield batch
        uploads.drain()
        if store:
            self._entries[key] = entries
        else:
            self._oversize.add(key)
