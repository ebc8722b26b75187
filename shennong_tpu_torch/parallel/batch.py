"""Whole-corpus signal loading and padded batch assembly (host).

Counterpart of :mod:`shennong_tpu.parallel.batch`. Mono PCM16 WAVs
decode through the native threaded loader
(:func:`shennong_tpu_torch.native.load_wav_batch_i16`); other audio
goes through :meth:`Utterance.load_audio` on a thread pool of ``njobs``
workers. The streaming plane (:mod:`shennong_tpu_torch.parallel.stream`)
takes the same two routes for each of its batches.
"""

import concurrent.futures

import numpy as np

from shennong_tpu_torch import native
from shennong_tpu_torch.ops.framing import bucket_size


def _utterance_bounds(utt, sample_rate):
    """(first_sample, sample_count or None) of an utterance."""
    if utt.tstart is None:
        return 0, None
    start = int(utt.tstart * sample_rate)
    return start, int(utt.tstop * sample_rate) - start


def _native_plan(utterances):
    """(paths, starts, counts) when every utterance is a mono PCM16
    WAV the native int16 loader reads, else None."""
    if not native.available():
        return None
    paths, starts, counts = [], [], []
    for utt in utterances:
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


def _load_signals_native(utterances):
    """Decode all utterances with the native int16 loader, or None."""
    plan = _native_plan(utterances)
    if plan is None:
        return None
    paths, starts, counts = plan
    loaded = native.load_wav_batch_i16(paths, starts, counts, max(counts))
    if loaded is None:
        return None
    batch, out_counts = loaded
    return [(utt.name, batch[i, :out_counts[i]].astype(np.float32))
            for i, utt in enumerate(utterances)]


def load_signals(utterances, njobs=4):
    """Load all utterance audio (the native loader, else ``njobs``
    Python loads at once).

    Returns a list of (name, float32 samples in int16 range) in
    utterance order.
    """
    utterances = list(utterances)
    items = _load_signals_native(utterances)
    if items is not None:
        return items

    def load_one(utt):
        audio = utt.load_audio()
        if audio.nchannels != 1:
            # the native loader rejects multichannel files too; without
            # this the 2-D samples crash batch assembly with an opaque
            # broadcast error
            raise ValueError(
                'audio signal must have one channel, but it has {}'
                .format(audio.nchannels))
        return utt.name, audio.astype(np.int16).data.astype(np.float32)

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, njobs)) as pool:
        return list(pool.map(load_one, utterances))


def make_batches(items, batch_size, pad_to_multiple=1):
    """Group (name, signal) pairs into padded batches.

    Items are sorted by length so each batch wastes little padding;
    the batch signal length is rounded to a geometric bucket and the
    batch is padded with silent rows up to ``pad_to_multiple``.

    Yields (names, signals [B, T] float32, nsamples [B] int32, nvalid)
    with ``nvalid`` the number of real (non padding) rows; a padding
    row counts one sample.
    """
    order = sorted(range(len(items)), key=lambda i: len(items[i][1]))

    for start in range(0, len(order), batch_size):
        chunk = [items[i] for i in order[start:start + batch_size]]
        nvalid = len(chunk)
        rows = nvalid
        if rows % pad_to_multiple:
            rows += pad_to_multiple - rows % pad_to_multiple

        max_len = bucket_size(max(len(sig) for _, sig in chunk))
        signals = np.zeros((rows, max_len), dtype=np.float32)
        nsamples = np.full(rows, 1, dtype=np.int32)
        names = []
        for row, (name, sig) in enumerate(chunk):
            signals[row, :len(sig)] = sig
            nsamples[row] = len(sig)
            names.append(name)

        yield names, signals, nsamples, nvalid
