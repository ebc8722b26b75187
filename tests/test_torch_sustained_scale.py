"""The port's audio plane stays bounded, whatever the corpus size.

Counterpart of tests/test_sustained_scale.py on the port's pool
accounting (``parallel.stream.pool_peak_bytes``: the most batch-buffer
memory, lent and pooled, ever alive at once). Process RSS is the wrong
observable on the CPU: the transient tensors of the extraction
dominate it. A plan that decoded the whole corpus would hold the whole
corpus; the stream holds ``depth`` batches decoding ahead, the one the
consumer works on and at most 4 pooled buffers of each shape.

The two corpus-scale cases (2 h of audio, and 15 min against 1 h) are
marked ``slow`` (run with ``pytest -m slow``): they write and decode
hundreds of MB. The tier-1 cases hold the same bound on a few batches,
through the stream and through the fused executor, and, over three
signal buckets, the bound of the shapes: at most min(batches,
2 * depth + 1) buffers of each.
"""

import numpy as np
import pytest
import scipy.io.wavfile

from shennong_tpu_torch.ops.framing import bucket_size
from shennong_tpu_torch.parallel import stream
from shennong_tpu_torch.utterances import Utterances

DEPTH = 2
POOLED = 4  # buffers the pool keeps of a shape


def build_corpus(directory, hours, seed=0):
    """Utterances of 20 and 30 s of noise in turn, ``hours`` of audio in
    all: two signal buckets, as a corpus sorted by length mostly gives
    a batch plan (the JAX package's ``examples/sustained_scale.py``).
    Returns (Utterances, audio seconds)."""
    rng = np.random.RandomState(seed)
    entries, total = [], 0.0
    while total < hours * 3600:
        seconds = (20.0, 30.0)[len(entries) % 2]
        wav = f'{directory}/u{len(entries):05d}.wav'
        scipy.io.wavfile.write(wav, 16000, (rng.randn(
            int(seconds * 16000)) * 1000).astype(np.int16))
        entries.append((f'u{len(entries):05d}', wav, 'spk'))
        total += seconds
    return Utterances(entries), total


@pytest.fixture(autouse=True)
def fresh_pool(monkeypatch):
    """A new upload pool for each test: what other tests left pooled
    does not count."""
    monkeypatch.setattr(stream, '_pool', stream._BufferPool())


def drain(utterances, batch_size):
    """Consume the stream as the executors do: each batch's buffer goes
    back to the pool once the consumer is done with it (here a
    checksum). Returns the peak of the audio plane, in bytes (what the
    pool kept from an earlier sweep counts)."""
    stream.pool_reset_peak()
    rows = 0
    for _, signals, _, nvalid in stream.stream_batches(
            utterances, batch_size, pin_memory=False, njobs=2, depth=DEPTH):
        rows += nvalid
        assert signals[0].any()
        stream.recycle(signals)
    assert rows == len(list(utterances))
    return stream.pool_peak_bytes()


def batch_bytes(utterances, batch_size):
    """The bytes of the largest int16 batch buffer of the plan."""
    return max(
        len(chunk) * 2 * bucket_size(max(stream._scan_count(u) for u in chunk))
        for chunk in stream.plan_batches(utterances, batch_size))


@pytest.fixture
def few_batches(tmp_path):
    rng = np.random.RandomState(2)
    entries = []
    for index in range(12):
        wav = str(tmp_path / f'u{index:02d}.wav')
        scipy.io.wavfile.write(wav, 16000, (rng.randn(
            8000 + 500 * (index % 3)) * 1000).astype(np.int16))
        entries.append((f'u{index:02d}', wav, f'spk{index % 2}'))
    return Utterances(entries)


def test_pool_peak_bounded_on_a_few_batches(few_batches):
    """6 batches of 2 through the stream, then through the fused pass 1:
    the peak stays within (depth + 1 + 4) batch buffers."""
    from shennong_tpu_torch.parallel.executor import FusedPipelineExecutor
    from shennong_tpu_torch.processor.mfcc import MfccProcessor

    bound = (DEPTH + 1 + POOLED) * batch_bytes(few_batches, 2)
    peak = drain(few_batches, 2)
    assert 0 < peak <= bound, (peak, bound)

    stream._pool = stream._BufferPool()
    executor = FusedPipelineExecutor(
        MfccProcessor(dither=0), device='cpu', batch_size=2, depth=DEPTH)
    features, _, _ = executor.run(few_batches)
    assert len(features) == 12
    assert 0 < stream.pool_peak_bytes() <= bound


@pytest.mark.parametrize('batches', [3, 7])
def test_pool_peak_bounded_across_buckets(tmp_path, batches):
    """Three signal buckets, ``batches`` batches of 2 each, through the
    fused pass 1: a buffer is made only when none of its shape is
    pooled, and at most 2 * depth + 1 batches are alive at once, so the
    peak holds at most min(batches, 2 * depth + 1) buffers of each
    shape. With 7 batches a bucket that is less than the plan's
    buffers: the peak follows the shapes, not the corpus length."""
    from shennong_tpu_torch.parallel.executor import FusedPipelineExecutor
    from shennong_tpu_torch.processor.mfcc import MfccProcessor

    rng = np.random.RandomState(batches)
    entries = []
    for index in range(3 * 2 * batches):
        wav = str(tmp_path / f'u{index:02d}.wav')
        scipy.io.wavfile.write(wav, 16000, (rng.randn(
            (4000, 4800, 6000)[index % 3]) * 1000).astype(np.int16))
        entries.append((f'u{index:02d}', wav, f'spk{index % 2}'))
    utterances = Utterances(entries)
    shapes = [(len(chunk), bucket_size(
        max(stream._scan_count(u) for u in chunk)))
        for chunk in stream.plan_batches(utterances, 2)]
    assert sorted(set(shapes)) == [(2, 4096), (2, 5120), (2, 6400)]
    bound = sum(min(batches, 2 * DEPTH + 1) * 2 * rows * samples
                for rows, samples in set(shapes))

    executor = FusedPipelineExecutor(
        MfccProcessor(dither=0), device='cpu', batch_size=2, depth=DEPTH)
    features, _, _ = executor.run(utterances)
    assert len(features) == len(entries)
    peak = stream.pool_peak_bytes()
    assert 0 < peak <= bound, (peak, bound)
    if batches > 2 * DEPTH + 1:
        assert bound < 2 * sum(rows * samples for rows, samples in shapes)


@pytest.mark.slow
def test_streaming_audio_plane_bounded(tmp_path):
    """2 h of audio through the stream hold (depth + 1 + 4) padded
    batches at most, not the corpus (230 MB of int16 at this scale)."""
    utterances, seconds = build_corpus(str(tmp_path), 2.0)
    assert seconds >= 2.0 * 3600
    peak = drain(utterances, 8)
    assert 0 < peak <= (DEPTH + 1 + POOLED) * batch_bytes(utterances, 8)
    assert peak < 0.25 * seconds * 16000 * 2


@pytest.mark.slow
def test_streaming_peak_corpus_independent(tmp_path):
    """The high-water mark does not grow with the corpus: 1 h through
    the same plan peaks within pool slack of 15 min."""
    (tmp_path / 'small').mkdir()
    (tmp_path / 'big').mkdir()
    small, _ = build_corpus(str(tmp_path / 'small'), 0.25, seed=1)
    big, _ = build_corpus(str(tmp_path / 'big'), 1.0, seed=2)
    peak_small = drain(small, 8)
    peak_big = drain(big, 8)
    assert peak_big < 1.5 * peak_small, (peak_small, peak_big)
