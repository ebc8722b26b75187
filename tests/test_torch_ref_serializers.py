"""Counterpart of ``tests/test_serializers.py``, case for case: round
trips of every serializer of the port, with the JAX cases' checks
(``tests/test_torch_serializers.py`` holds the files across the
packages)."""

import numpy as np
import pytest

from shennong_tpu_torch import Features, FeaturesCollection
from shennong_tpu_torch.serializers import (
    get_serializer, read_ark, supported_extensions, supported_serializers)


@pytest.fixture
def collection():
    rng = np.random.RandomState(42)
    fc = FeaturesCollection()
    fc['utt_a'] = Features(
        rng.rand(12, 4), np.arange(12, dtype=float),
        properties={'proc': {'param': 1},
                    'pipeline': [{'name': 'proc', 'columns': [0, 3]}]})
    fc['utt_b'] = Features(
        rng.rand(7, 4).astype(np.float32),
        np.stack([np.arange(7.0), np.arange(7.0) + 0.02], axis=1),
        properties={'arr': np.array([1.5, 2.5])})
    return fc


EXTENSIONS = ['.npz', '.mat', '.pkl', '.h5f', '.ark', '']


@pytest.mark.parametrize('ext', EXTENSIONS)
def test_roundtrip(collection, tmpdir, ext):
    path = str(tmpdir.join('feats' + ext))
    collection.save(path)
    loaded = FeaturesCollection.load(path)
    assert sorted(loaded.keys()) == sorted(collection.keys())
    for key in collection:
        # .mat does not preserve dtype exactly (always double), compare
        # contents with tolerance
        assert np.allclose(
            loaded[key].data.astype(np.float64),
            collection[key].data.astype(np.float64), atol=1e-6)
        assert np.allclose(
            np.asarray(loaded[key].times, dtype=float),
            np.asarray(collection[key].times, dtype=float))


@pytest.mark.parametrize('ext', ['.npz', '.pkl', '.h5f', '.ark'])
def test_roundtrip_exact(collection, tmpdir, ext):
    """Formats that must preserve dtypes and properties exactly."""
    path = str(tmpdir.join('feats' + ext))
    collection.save(path)
    loaded = FeaturesCollection.load(path)
    for key in collection:
        assert loaded[key].dtype == collection[key].dtype
        assert np.array_equal(loaded[key].data, collection[key].data)
        assert np.array_equal(loaded[key].times, collection[key].times)
    assert loaded.is_close(collection)


def test_no_properties(collection, tmpdir):
    path = str(tmpdir.join('feats.pkl'))
    collection.save(path, with_properties=False)
    loaded = FeaturesCollection.load(path)
    assert all(not f.properties for f in loaded.values())


def test_save_twice(collection, tmpdir):
    path = str(tmpdir.join('feats.npz'))
    collection.save(path)
    with pytest.raises(IOError, match='already exists'):
        collection.save(path)


def test_load_missing(tmpdir):
    with pytest.raises(IOError, match='not found'):
        FeaturesCollection.load(str(tmpdir.join('nope.npz')))


def test_bad_extension(collection, tmpdir):
    with pytest.raises(ValueError, match='invalid extension'):
        collection.save(str(tmpdir.join('feats.xyz')))
    with pytest.raises(ValueError, match='invalid serializer'):
        collection.save(str(tmpdir.join('feats.npz')), serializer='bad')


def test_serializer_registry():
    assert set(supported_extensions().keys()) == {
        '.npz', '.mat', '.pkl', '.h5f', '.ark', ''}
    assert set(supported_serializers().keys()) == {
        'numpy', 'matlab', 'pickle', 'h5features', 'kaldi', 'csv'}


def test_get_serializer_wrong_class():
    with pytest.raises(ValueError, match='must be'):
        get_serializer(dict, 'file.npz', None)


def test_ark_scp(collection, tmpdir):
    path = str(tmpdir.join('feats.ark'))
    collection.save(path, scp=True)
    scp_lines = open(str(tmpdir.join('feats.scp'))).read().splitlines()
    assert len(scp_lines) == len(collection)
    # scp offsets point at the binary marker of each record
    for line in scp_lines:
        key, location = line.split(' ')
        ark_path, offset = location.rsplit(':', 1)
        with open(ark_path, 'rb') as fp:
            fp.seek(int(offset))
            assert fp.read(2) == b'\0B'


def test_ark_codec_dtypes(tmpdir):
    """The ark codec handles both float and double matrices."""
    from shennong_tpu_torch.serializers import write_ark_matrix
    path = str(tmpdir.join('raw.ark'))
    mat32 = np.arange(6, dtype=np.float32).reshape(2, 3)
    mat64 = np.arange(8, dtype=np.float64).reshape(4, 2) / 3
    with open(path, 'wb') as fp:
        write_ark_matrix(fp, 'a', mat32)
        write_ark_matrix(fp, 'b', mat64)
    loaded = dict(read_ark(path))
    assert loaded['a'].dtype == np.float32
    assert np.array_equal(loaded['a'], mat32)
    assert loaded['b'].dtype == np.float64
    assert np.array_equal(loaded['b'], mat64)


def test_ark_rejects_whitespace_keys(tmpdir, mfcc):
    """Ark keys are space-delimited: names with whitespace must be
    rejected instead of corrupting the archive."""
    from shennong_tpu_torch import FeaturesCollection
    collection = FeaturesCollection({'utt 1': mfcc})
    with pytest.raises(ValueError, match='no whitespace'):
        collection.save(str(tmpdir.join('bad.ark')))


def test_ark_unicode_keys(tmpdir, mfcc):
    """Non-ASCII (whitespace-free) utterance names round-trip."""
    from shennong_tpu_torch import FeaturesCollection
    collection = FeaturesCollection({'utté_1': mfcc})
    path = str(tmpdir.join('uni.ark'))
    collection.save(path)
    back = FeaturesCollection.load(path)
    assert np.allclose(back['utté_1'].data, mfcc.data)


def test_h5f_layout_is_h5features(tmpdir):
    """The written .h5f carries the h5features 1.1 dense layout:
    flat items/features/labels/index datasets under one group."""
    import h5py
    rng = np.random.RandomState(7)
    features_collection = FeaturesCollection({
        'a': Features(rng.randn(9, 3), np.arange(9, dtype=float)),
        'b': Features(rng.randn(5, 3), np.arange(5, dtype=float))})
    path = str(tmpdir.join('layout.h5f'))
    features_collection.save(path)

    with h5py.File(path, 'r') as fh:
        group = fh['features']
        assert group.attrs['version'] == '1.1'
        assert group.attrs['format'] == 'dense'
        items = [i.decode() if isinstance(i, bytes) else i
                 for i in group['items'][...]]
        assert items == list(features_collection.keys())
        total = sum(f.nframes for f in features_collection.values())
        assert group['features'].shape[0] == total
        assert group['labels'].shape[0] == total
        # inclusive last-row index per item
        sizes = [f.nframes for f in features_collection.values()]
        assert list(group['index'][...]) == list(
            np.cumsum(sizes) - 1)


def test_h5f_legacy_layout_still_loads(collection, tmpdir):
    """Files written with the round-1 private one-group-per-item
    layout keep loading."""
    import h5py
    from shennong_tpu_torch.utils import json_dumps
    path = str(tmpdir.join('legacy.h5f'))
    with h5py.File(path, 'w') as fh:
        group = fh.create_group('features')
        for k, v in collection.items():
            sub = group.create_group(k)
            sub.create_dataset('data', data=v.data)
            sub.create_dataset('times', data=v.times)
            sub.attrs['properties'] = json_dumps(v.properties)

    loaded = FeaturesCollection.load(path)
    assert loaded.is_close(collection)


def test_h5f_cross_library():
    """Round-trip through the real h5features library (the reference's
    serializer backend); skipped when it is not installed."""
    h5features = pytest.importorskip('h5features')

    import tempfile, os
    rng = np.random.RandomState(0)
    collection = FeaturesCollection({
        'a': Features(rng.randn(10, 4),
                      np.arange(10, dtype=float)),
        'b': Features(rng.randn(7, 4), np.arange(7, dtype=float))})
    with tempfile.TemporaryDirectory() as tmp:
        ours = os.path.join(tmp, 'ours.h5f')
        collection.save(ours, with_properties=False)
        data = h5features.Reader(ours, groupname='features').read()
        assert sorted(data.items()) == ['a', 'b']
        idx = data.items().index('a')
        assert np.allclose(data.features()[idx], collection['a'].data)

        theirs = os.path.join(tmp, 'theirs.h5f')
        with h5features.Writer(theirs) as writer:
            writer.write(h5features.Data(
                list(collection.keys()),
                [f.times for f in collection.values()],
                [f.data for f in collection.values()]),
                groupname='features')
        loaded = FeaturesCollection.load(theirs)
        assert loaded.is_close(collection)


def test_ark_complex_input_writes_real_part(tmp_path):
    """Exotic (complex) matrices keep the historical astype(float64)
    semantics through the reused-scratch writer: the real part is
    written (advisor r3: np.copyto default casting would raise)."""
    import logging

    from shennong_tpu_torch.serializers import KaldiSerializer, read_ark

    path = str(tmp_path / 'complex.ark')
    serializer = KaldiSerializer(
        FeaturesCollection, str(tmp_path / 'f.ark'),
        log=logging.getLogger('test'))
    data = (np.arange(6, dtype=np.float64)
            + 1j * np.ones(6)).reshape(2, 3)
    serializer._save_one_ark(
        path, [('a', data), ('b', np.ones((2, 2), np.float32))],
        scp=False)
    loaded = dict(read_ark(path))
    np.testing.assert_array_equal(loaded['a'], data.real)
    np.testing.assert_array_equal(loaded['b'], np.ones((2, 2)))


def test_ark_compact_float32_roundtrip(tmp_path):
    """compact=True writes float32 data as native FM records: near
    half the archive bytes of the double layout (times stay double),
    bit-exact round trip through the dtype sidecar."""
    import os

    rng = np.random.RandomState(3)
    fc = FeaturesCollection({
        f'u{i}': Features(
            rng.randn(200, 13).astype(np.float32),
            np.arange(200, dtype=float))
        for i in range(4)})
    double = str(tmp_path / 'double.ark')
    compact = str(tmp_path / 'compact.ark')
    fc.save(double)
    fc.save(compact, compact=True)

    assert os.path.getsize(compact) < 0.6 * os.path.getsize(double)
    loaded = FeaturesCollection.load(compact)
    assert sorted(loaded) == sorted(fc)
    for name in fc:
        assert loaded[name].dtype == fc[name].dtype
        np.testing.assert_array_equal(loaded[name].data, fc[name].data)
        np.testing.assert_array_equal(
            loaded[name].times, fc[name].times)
