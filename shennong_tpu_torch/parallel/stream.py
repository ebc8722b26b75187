"""Streaming host data plane: bounded look-ahead batch decoding.

Counterpart of :mod:`shennong_tpu.parallel.stream`: utterances are
planned into padded batches from their header metadata alone (sorted
by length, so batches waste little padding), and a small thread pool
decodes at most ``depth`` batches ahead of the consumer. Mono PCM16 WAV
batches decode with the native loader straight into an int16 buffer,
pinned when it feeds a CUDA device, so the host-to-device copy is
asynchronous and moves half the bytes of float32. A
:class:`SignalCache` keeps a corpus's uploaded batches on the device
and replays them to later sweeps over the same utterances.

Batches are ``(names, signals [B, T], nsamples [B] int32, nvalid)``
with ``signals`` an int16 tensor: on the CPU when decoded, on the
cache's device when replayed.
"""

import concurrent.futures

import numpy as np
import torch

from shennong_tpu_torch import native
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.ops.framing import bucket_size


def _utterance_bounds(utt, sample_rate):
    """(first_sample, sample_count or None) of an utterance."""
    if utt.tstart is None:
        return 0, None
    start = int(utt.tstart * sample_rate)
    return start, int(utt.tstop * sample_rate) - start


def _scan_count(utt):
    """Utterance sample count from header metadata only (no decode)."""
    meta = Audio.scan(utt.audio_file)
    start, count = _utterance_bounds(utt, meta.sample_rate)
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
    in :func:`streamed_order`. Returns a list of lists."""
    utterances = list(utterances)
    order = streamed_order(utterances)
    return [[utterances[i] for i in order[start:start + batch_size]]
            for start in range(0, len(order), batch_size)]


def _native_plan(chunk):
    """(paths, starts, counts) when every utterance is a mono PCM16
    WAV the native int16 loader reads, else None."""
    if not native.available():
        return None
    paths, starts, counts = [], [], []
    for utt in chunk:
        scan = native.wav_scan2(utt.audio_file)
        if scan is None:
            return None
        channels, rate, nsamples, fmt, bits = scan
        if channels != 1 or fmt != 1 or bits != 16:
            return None
        start, count = _utterance_bounds(utt, rate)
        paths.append(utt.audio_file)
        starts.append(start)
        counts.append(nsamples - start if count is None else count)
    return paths, starts, counts


def decode_batch(chunk, pin_memory):
    """Decode one planned batch into ``(names, signals, nsamples,
    nvalid)``; the padded length is a geometric bucket of the longest
    utterance. ``pin_memory`` allocates the signals in page-locked
    memory (for an asynchronous copy to a CUDA device)."""
    names = [utt.name for utt in chunk]
    rows = len(chunk)
    plan = _native_plan(chunk)
    if plan is not None:
        paths, starts, counts = plan
        stride = bucket_size(max(counts))
        signals = torch.empty((rows, stride), dtype=torch.int16,
                              pin_memory=pin_memory)
        loaded = native.load_wav_batch_i16(
            paths, starts, counts, stride, out=signals.numpy())
        if loaded is not None:
            nsamples = np.asarray(loaded[1], dtype=np.int32)
            return names, signals, nsamples, rows

    items = []
    for utt in chunk:
        audio = utt.load_audio()
        if audio.nchannels != 1:
            raise ValueError(
                'audio signal must have one channel, but it has {}'
                .format(audio.nchannels))
        items.append(audio.astype(np.int16).data)
    stride = bucket_size(max(len(sig) for sig in items))
    signals = torch.zeros((rows, stride), dtype=torch.int16,
                          pin_memory=pin_memory)
    host = signals.numpy()
    for row, sig in enumerate(items):
        host[row, :len(sig)] = sig
    nsamples = np.asarray([len(sig) for sig in items], dtype=np.int32)
    return names, signals, nsamples, rows


def stream_batches(utterances, batch_size, pin_memory, depth=2):
    """Yield padded batches with at most ``depth`` decoded ahead: the
    next batches decode on host threads while the consumer works on
    the current one."""
    plans = plan_batches(utterances, batch_size)
    depth = max(1, int(depth))
    with concurrent.futures.ThreadPoolExecutor(max_workers=depth) as pool:
        pending = [pool.submit(decode_batch, chunk, pin_memory)
                   for chunk in plans[:depth]]
        nextp = len(pending)
        while pending:
            batch = pending.pop(0).result()
            if nextp < len(plans):
                pending.append(
                    pool.submit(decode_batch, plans[nextp], pin_memory))
                nextp += 1
            yield batch


def stream_source(signal_cache, utterances, batch_size, pin_memory,
                  depth=2):
    """The batch stream of a corpus sweep: the cache's when one is
    given, plain host streaming otherwise."""
    if signal_cache is not None:
        return signal_cache.stream(utterances, batch_size, depth=depth)
    return stream_batches(utterances, batch_size, pin_memory, depth=depth)


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
    optimisation and never changes what a sweep yields.
    """

    def __init__(self, max_bytes=1 << 30, *, device):
        self._entries = {}
        self._oversize = set()
        self._max_bytes = int(max_bytes)
        self._bytes = 0
        self.device = torch.device(device)

    @staticmethod
    def _key(utterances, batch_size):
        # names alone would collide for segments of one corpus with
        # other bounds
        return (tuple(sorted(
            (u.name, u.audio_file, u.tstart or 0.0, u.tstop or 0.0)
            for u in utterances)), int(batch_size))

    def stream(self, utterances, batch_size, depth=2):
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
                utterances, batch_size, pin_memory, depth=depth)
            return

        entries, store = [], True
        for names, signals, nsamples, nvalid in stream_batches(
                utterances, batch_size, pin_memory, depth=depth):
            dev = signals.to(self.device, non_blocking=True)
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
            yield batch
        if store:
            self._entries[key] = entries
        else:
            self._oversize.add(key)
