"""Counterpart of ``tests/test_native.py``, case for case: the port's
native C++ IO runtime (``shennong_tpu_torch/native/``) and its Python
fallback, on the conftest's WAVs, with the JAX cases' checks.

The JAX package's ``native.wav_scan`` and ``native.load_wav_batch`` have
no counterpart of that name (``tests/test_torch_api.py:EXEMPT``): their
cases run on the port's ``wav_scan2`` (which adds the format and the
bit depth) and ``load_wav_batch_i16`` (PCM16 rows; a float32 WAV is
refused, and ``parallel.batch.load_signals`` reads it in Python).
"""

import numpy as np
import pytest

from shennong_tpu_torch import Utterances, native
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.parallel.batch import load_signals

from tests.torch_ref import audio  # noqa: F401 (fixture)

pytestmark = pytest.mark.skipif(
    not native.available(), reason='native library not built')


def test_wav_scan(wav_file):
    channels, rate, nsamples, fmt, bits = native.wav_scan2(wav_file)
    assert channels == 1
    assert rate == 16000
    assert nsamples == 22713
    assert (fmt, bits) == (1, 16)

    assert native.wav_scan2('/no/such/file.wav') is None


def test_wav_scan_matches_python(wav_file, wav_file_8k,
                                 wav_file_float32):
    for path in (wav_file, wav_file_8k, wav_file_float32):
        meta = Audio.scan(path)
        channels, rate, nsamples, _, _ = native.wav_scan2(path)
        assert channels == meta.nchannels
        assert rate == meta.sample_rate
        assert nsamples == meta.nsamples


def test_load_wav_batch(wav_file, audio):
    batch, counts = native.load_wav_batch_i16(
        [wav_file, wav_file], [0, 8000], [22713, 8000], 22713)
    assert batch.shape == (2, 22713)
    assert batch.dtype == np.int16
    assert counts.tolist() == [22713, 8000]
    assert np.array_equal(batch[0], audio.data)
    assert np.array_equal(batch[1, :8000], audio.data[8000:16000])
    # padding is zero
    assert np.all(batch[1, 8000:] == 0)


def test_load_wav_batch_float32(wav_file_float32, wav_file):
    """float32 WAVs decode to the same int16-range values: the native
    PCM16 loader refuses them, and the loader's Python path reads
    them."""
    assert native.load_wav_batch_i16(
        [wav_file_float32], [0], [22713], 22713) is None
    (_, signal), = load_signals(Utterances([('u', wav_file_float32)]))
    reference = Audio.load(wav_file).data.astype(np.float32)
    assert np.allclose(signal, reference, atol=1.0)


def test_load_signals_native_vs_python(wav_file):
    utterances = Utterances([
        ('u1', wav_file, 0.0, 0.5),
        ('u2', wav_file, 0.5, 1.4)])

    items_native = load_signals(utterances)

    # force the python path
    native_avail = native.available
    try:
        native.available = lambda: False
        items_python = load_signals(utterances)
    finally:
        native.available = native_avail

    assert [n for n, _ in items_native] == [n for n, _ in items_python]
    for (_, a), (_, b) in zip(items_native, items_python):
        assert np.array_equal(a, b)


def test_ark_index_and_read(tmpdir):
    from shennong_tpu_torch.serializers import read_ark, write_ark_matrix

    path = str(tmpdir.join('test.ark'))
    mats = {
        'utt_a': np.random.RandomState(0).rand(7, 3).astype(np.float32),
        'utt_b': np.random.RandomState(1).rand(4, 5),
    }
    with open(path, 'wb') as fp:
        for key, mat in mats.items():
            write_ark_matrix(fp, key, mat)

    index = native.ark_index(path)
    assert [entry[0] for entry in index] == ['utt_a', 'utt_b']
    for key, offset, rows, cols, is_double in index:
        loaded = native.ark_read_matrix(
            path, offset, rows, cols, is_double)
        assert np.array_equal(loaded, mats[key])

    # and the serializer-level reader agrees
    python_read = dict(read_ark(path))
    for key in mats:
        assert np.array_equal(python_read[key], mats[key])


def test_shard_utterances(wav_file):
    """Host-level utterance sharding covers the collection exactly."""
    from shennong_tpu_torch.parallel.distributed import shard_utterances
    utterances = Utterances([
        (f'u{i}', wav_file, 0.0, 0.5) for i in range(7)])

    shards = [
        shard_utterances(utterances, process_index=p, process_count=3)
        for p in range(3)]
    names = sorted(
        utt.name for shard in shards if shard for utt in shard)
    assert names == sorted(u.name for u in utterances)
    sizes = [len(s) for s in shards if s]
    assert max(sizes) - min(sizes) <= 1


def test_csv_write_roundtrip_exact(tmpdir):
    """The native to_chars rendering reads back bit-exact through
    numpy.loadtxt (correctly-rounded strtod)."""
    rng = np.random.RandomState(7)
    table = np.concatenate([
        rng.randn(200, 5),
        rng.randn(200, 5) * 1e-300,   # subnormal territory
        rng.randn(200, 5) * 1e300,    # huge exponents
        np.zeros((3, 5)),
    ])
    path = str(tmpdir.join('table.csv'))
    assert native.csv_write(path, '# header line\n', table)

    with open(path) as fp:
        assert fp.readline() == '# header line\n'
    back = np.loadtxt(path)
    assert np.array_equal(back, table)


def test_csv_write_matches_serializer(tmpdir):
    """FeaturesCollection CSV round trip stays exact through the
    native writer."""
    from shennong_tpu_torch import Features, FeaturesCollection
    rng = np.random.RandomState(3)
    fc = FeaturesCollection()
    starts = np.arange(50, dtype=np.float64) * 0.01
    fc['one'] = Features(
        rng.randn(50, 4).astype(np.float32),
        np.stack([starts, starts + 0.025], axis=1))
    folder = str(tmpdir.join('csvdir'))
    fc.save(folder)
    back = FeaturesCollection.load(folder)
    assert np.array_equal(back['one'].data, fc['one'].data)
    assert np.array_equal(back['one'].times, fc['one'].times)
    assert back['one'].dtype == fc['one'].dtype
