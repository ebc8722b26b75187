"""File serializers for :class:`FeaturesCollection`.

The port's own copy of ``shennong_tpu/serializers.py``: numpy
``.npz``, matlab ``.mat``, pickle ``.pkl``, HDF5 ``.h5f``, kaldi
``.ark`` and a CSV folder, in the same file layouts, so a file written
by either package loads in the other.

Implementation notes:

- the kaldi ark reader/writer is a self-contained pure-Python codec of
  the Kaldi binary table format (``<key> \\0B FM/DM <dims> <data>``),
  no pykaldi needed, byte-compatible with Kaldi tools;
- the ``.h5f`` serializer is built directly on :mod:`h5py` with a
  simple one-group-per-item layout (the h5features library is not a
  dependency here);
- JSON sidecars use the numpy-aware codec from
  :mod:`shennong_tpu_torch.utils` instead of json_tricks.
"""

import abc
import copy
import copyreg
import os
import pickle
import struct

import numpy as np
import scipy.io

from shennong_tpu_torch.features import Features
from shennong_tpu_torch.utils import (
    array2list, json_dumps, json_loads, list_files_with_extension)


def supported_extensions():
    """Map file extensions to serializer classes"""
    return {
        '.npz': NumpySerializer,
        '.mat': MatlabSerializer,
        '.pkl': PickleSerializer,
        '.h5f': H5featuresSerializer,
        '.ark': KaldiSerializer,
        '': CsvSerializer,
    }


def supported_serializers():
    """Map serializer names to serializer classes"""
    return {
        'numpy': NumpySerializer,
        'matlab': MatlabSerializer,
        'pickle': PickleSerializer,
        'h5features': H5featuresSerializer,
        'kaldi': KaldiSerializer,
        'csv': CsvSerializer,
    }


def get_serializer(cls, filename, log, serializer=None):
    """Instanciate the right serializer for ``filename``.

    ``cls`` must be FeaturesCollection (passed in to avoid a circular
    import). When ``serializer`` is None it is guessed from the file
    extension.
    """
    if cls.__name__ != 'FeaturesCollection':
        raise ValueError(
            'The `cls` parameter must be '
            'shennong_tpu_torch.features_collection.FeaturesCollection')

    if serializer is None:
        ext = os.path.splitext(filename)[1]
        try:
            serializer = supported_extensions()[ext]
        except KeyError:
            raise ValueError(
                'invalid extension {}, must be in {}'.format(
                    ext, list(supported_extensions().keys()))) from None
    else:
        try:
            serializer = supported_serializers()[serializer]
        except KeyError:
            raise ValueError(
                'invalid serializer {}, must be in {}'.format(
                    serializer,
                    list(supported_serializers().keys()))) from None

    return serializer(cls, filename, log)


class FeaturesSerializer(metaclass=abc.ABCMeta):
    """Base class for all the file serializers."""

    def __init__(self, cls, filename, log):
        self._features_collection = cls
        self._filename = filename
        self._log = log

    @property
    def filename(self):
        """Path of the file being read or written"""
        return self._filename

    @abc.abstractmethod
    def _save(self, features, with_properties):  # pragma: nocover
        pass

    @abc.abstractmethod
    def _load(self):  # pragma: nocover
        pass

    def _check_save(self):
        if os.path.isfile(self.filename):
            raise IOError(f'file already exists: {self.filename}')

    def _check_load(self):
        if not os.path.isfile(self.filename):
            raise IOError(f'file not found: {self.filename}')
        if not os.access(self.filename, os.R_OK):
            raise IOError(f'file not readable: {self.filename}')

    def save(self, features, with_properties=True, **kwargs):
        """Write the collection to disk (file must not exist)."""
        self._check_save()

        if not isinstance(features, self._features_collection):
            raise ValueError(
                'features must be {} but are {}'.format(
                    self._features_collection.__name__,
                    features.__class__.__name__))
        if not features.is_valid():
            raise ValueError('features are not valid')

        self._save(features, with_properties, **kwargs)

    def load(self, **kwargs):
        """Read a collection from disk."""
        self._check_load()
        features = self._load(**kwargs)
        if not features.is_valid():  # pragma: nocover
            raise ValueError(f'features not valid in "{self.filename}"')
        return features


class NumpySerializer(FeaturesSerializer):
    """numpy ``.npz`` format"""

    def _save(self, features, with_properties, compress=True):
        self._log.info('writing %s', self.filename)
        data = {
            k: v._to_dict(with_properties=with_properties)
            for k, v in features.items()}
        if compress:
            try:
                return self._save_compressed(data)
            except Exception:
                self._log.debug(
                    'parallel npz writer unavailable, using numpy')
        save = np.savez_compressed if compress else np.savez
        with open(self.filename, 'wb') as fp:
            save(fp, features=data, allow_pickle=True)

    def _save_compressed(self, data):
        """Compressed ``.npz`` write with the deflate parallelized.

        ``np.savez_compressed`` deflates its single ``features.npy``
        zip member serially at level 6. A DEFLATE stream may be built
        from independently compressed chunks joined at full-flush
        points (the pigz construction), so the payload deflates here
        as 1 MB chunks on a thread pool at level 1 and the zip
        container is written by hand. ``np.load`` reads the result
        back unchanged (it is a standard zip with one npy member).
        """
        import concurrent.futures
        import io
        import struct
        import zlib

        buffer = io.BytesIO()
        np.lib.format.write_array(
            buffer, np.asanyarray(data), allow_pickle=True)
        payload = buffer.getbuffer()
        if len(payload) >= (1 << 31):  # keep far away from zip64
            raise ValueError('payload too large for the fast writer')

        chunk = 1 << 20
        views = [payload[i:i + chunk]
                 for i in range(0, len(payload), chunk)] or [b'']

        def deflate(view, last):
            comp = zlib.compressobj(1, zlib.DEFLATED, -15)
            out = comp.compress(view)
            out += comp.flush(zlib.Z_FINISH if last else zlib.Z_FULL_FLUSH)
            return out

        with concurrent.futures.ThreadPoolExecutor(
                max_workers=4) as pool:
            jobs = [
                pool.submit(deflate, view, i == len(views) - 1)
                for i, view in enumerate(views)]
            blocks = [job.result() for job in jobs]

        crc = 0
        for view in views:
            crc = zlib.crc32(view, crc)
        usize = len(payload)
        csize = sum(len(b) for b in blocks)
        name = b'features.npy'

        with open(self.filename, 'wb') as stream:
            # local file header: version 2.0, no flags, DEFLATE,
            # zeroed DOS time/date (np.load never looks at it)
            local = struct.pack(
                '<4s5H3I2H', b'PK\x03\x04', 20, 0, 8, 0, 0,
                crc, csize, usize, len(name), 0)
            stream.write(local)
            stream.write(name)
            for block in blocks:
                stream.write(block)
            central_offset = stream.tell()
            central = struct.pack(
                '<4s6H3I5H2I', b'PK\x01\x02', 20, 20, 0, 8, 0, 0,
                crc, csize, usize, len(name), 0, 0, 0, 0, 0, 0)
            stream.write(central)
            stream.write(name)
            end = struct.pack(
                '<4s4H2IH', b'PK\x05\x06', 0, 0, 1, 1,
                stream.tell() - central_offset, central_offset, 0)
            stream.write(end)

    def _load(self):
        self._log.info('loading %s', self.filename)
        with open(self.filename, 'rb') as fp:
            data = np.load(fp, allow_pickle=True)['features'].tolist()
        collection = self._features_collection()
        for k, v in data.items():
            collection[k] = Features._from_dict(v, validate=False)
        return collection


class MatlabSerializer(FeaturesSerializer):
    """matlab ``.mat`` format"""

    def _save(self, features, with_properties, compress=True):
        self._log.info('writing %s', self.filename)
        data = {
            k: v._to_dict(with_properties=with_properties)
            for k, v in features.items()}
        if compress:
            try:
                return self._save_compressed(data)
            except Exception:  # scipy private-API drift
                self._log.debug(
                    'fast MAT5 writer unavailable, using scipy')
        scipy.io.savemat(
            self.filename, data, long_field_names=True,
            appendmat=False, do_compression=compress)

    def _save_compressed(self, data):
        """Compressed MAT5 write with the deflate work off-loaded.

        ``scipy.io.savemat`` serializes AND zlib-compresses each
        variable sequentially at level 6; per-variable compression is
        independent and ``zlib.compress`` releases the GIL, so the
        deflate (the dominant cost) runs level-1 on a thread pool
        here while the main thread keeps serializing. Output is a
        standard compressed MAT5 file ``scipy.io.loadmat`` reads
        back unchanged.
        """
        import concurrent.futures
        import io
        import zlib

        from scipy.io.matlab import _mio5

        with open(self.filename, 'wb') as stream, \
                concurrent.futures.ThreadPoolExecutor(
                    max_workers=4) as pool:
            writer = _mio5.MatFile5Writer(
                stream, do_compression=False, long_field_names=True)
            writer.write_file_header()

            def serialize(name, var):
                buffer = io.BytesIO()
                matrix_writer = _mio5.VarWriter5(writer)
                matrix_writer.file_stream = buffer
                matrix_writer.write_top(
                    var, name.encode('latin1'), False)
                return buffer.getvalue()

            jobs = [
                pool.submit(zlib.compress, serialize(name, var), 1)
                for name, var in data.items()]
            for job in jobs:
                compressed = job.result()
                tag = np.empty((), _mio5.NDT_TAG_FULL)
                tag['mdtype'] = _mio5.miCOMPRESSED
                tag['byte_count'] = len(compressed)
                stream.write(tag.tobytes())
                stream.write(compressed)

    def _load(self):
        self._log.info('loading %s', self.filename)
        data = self._unpack(scipy.io.loadmat(
            self.filename, appendmat=False, squeeze_me=True,
            mat_dtype=True, struct_as_record=False))

        collection = self._features_collection()
        for k, v in data.items():
            if k in ('__header__', '__version__', '__globals__'):
                continue
            if 'properties' in v:
                collection[k] = Features(
                    v['data'], v['times'],
                    self._fix_pipeline(self._unpack(v['properties'])),
                    validate=False)
            else:
                collection[k] = Features(
                    v['data'], v['times'], validate=False)
        return collection

    @classmethod
    def _unpack(cls, data):
        """Recursively turn matlab structs into plain dictionaries"""
        for key in data:
            if isinstance(data[key], scipy.io.matlab.mat_struct):
                data[key] = cls._struct2dict(data[key])
            elif isinstance(data[key], (list, np.ndarray)):
                data[key] = [cls._struct2dict(item) for item in data[key]]
        return data

    @staticmethod
    def _struct2dict(matobj):
        if not isinstance(matobj, scipy.io.matlab.mat_struct):
            return matobj
        out = {}
        for field in matobj._fieldnames:
            elem = matobj.__dict__[field]
            out[field] = MatlabSerializer._struct2dict(elem)
        return out

    @staticmethod
    def _fix_pipeline(properties):
        # matlab collapses single-element lists, rebuild the pipeline list
        if 'pipeline' in properties:
            pipeline = properties['pipeline']
            if isinstance(pipeline, list):
                properties['pipeline'] = [array2list(p) for p in pipeline]
            else:
                properties['pipeline'] = [array2list(pipeline)]
        return properties


class _NoPropertiesPickler(pickle.Pickler):
    """Pickler dropping the properties of Features instances."""
    dispatch_table = copyreg.dispatch_table.copy()
    dispatch_table[Features] = lambda obj: (
        obj.__class__, (obj.data, obj.times, None, False))


class PickleSerializer(FeaturesSerializer):
    """Python pickle ``.pkl`` format (a pickle names the classes of the
    package that wrote it, and loads wherever that package imports)"""

    def _save(self, features, with_properties):
        self._log.info('writing %s', self.filename)
        pickler = pickle.Pickler if with_properties else _NoPropertiesPickler
        with open(self.filename, 'wb') as stream:
            # protocol 5 serializes numpy arrays without the extra
            # in-band bytes copy of protocol 4 (~2x faster dumps)
            pickler(stream, protocol=5).dump(features)

    def _load(self):
        self._log.info('loading %s', self.filename)
        with open(self.filename, 'rb') as stream:
            return pickle.load(stream)


class H5featuresSerializer(FeaturesSerializer):
    """HDF5 ``.h5f`` format, h5features-1.x compatible layout.

    Writes the dense format-1.1 layout of the h5features library the
    reference uses (``shennong/serializers.py:354-389``): one root
    group (default 'features') with attrs ``version='1.1'`` and
    ``format='dense'`` holding four flat datasets — ``items`` (vlen
    UTF-8 names), ``features`` (row-concatenated [total, dim]),
    ``labels`` (row-concatenated times) and ``index`` (int64 inclusive
    last-row index per item) — so files interoperate with the
    reference ecosystem's ABX/ZRC tooling. Properties are stored as a
    JSON vlen-str dataset ``properties`` (a shennong-side extension;
    h5features itself added properties only in 1.3.2). The older
    one-group-per-item layout is still read.
    """

    GROUP = 'features'

    def _save(self, features, with_properties, compress=True):
        import h5py
        self._log.info('writing %s', self.filename)
        comp = dict(compression='lzf') if compress else {}

        names = list(features.keys())
        label_dims = set(features[n].times.ndim for n in names)
        if len(label_dims) > 1:
            # h5features cannot represent mixed 1-D/2-D labels in one
            # group; keep such collections loadable via the private
            # per-item layout
            self._log.warning(
                'mixed times dimensions in the collection: writing '
                'the private (non h5features-compatible) layout')
            return self._save_legacy(features, with_properties, comp)

        sizes = np.array(
            [features[n].nframes for n in names], dtype=np.int64)
        index = np.cumsum(sizes) - 1  # inclusive last-row per item
        total = int(sizes.sum())
        data_dtype = np.result_type(
            *(features[n].data.dtype for n in names))
        labels_dtype = np.result_type(
            *(features[n].times.dtype for n in names))
        label_shape = (
            (total,) if features[names[0]].times.ndim == 1
            else (total, features[names[0]].times.shape[1]))

        with h5py.File(self.filename, 'a') as fh:
            group = fh.create_group(self.GROUP)
            group.attrs['version'] = '1.1'
            group.attrs['format'] = 'dense'
            # per-item dtypes (our extension, transparent to
            # h5features readers): the flat layout stores one
            # concatenated array, this restores exact dtypes on load
            group.attrs['item_dtypes'] = json_dumps(
                [str(features[n].dtype) for n in names])
            str_dtype = h5py.string_dtype(encoding='utf-8')
            group.create_dataset(
                'items', data=np.array(names, dtype=object),
                dtype=str_dtype, **comp)
            # preallocate and write one slice per item: concatenating
            # the collection first would fault in a second full copy
            dset = group.create_dataset(
                'features', shape=(total, features[names[0]].ndims),
                dtype=data_dtype, **comp)
            labels = group.create_dataset(
                'labels', shape=label_shape, dtype=labels_dtype, **comp)
            start = 0
            for name in names:
                stop = start + features[name].nframes
                dset[start:stop] = features[name].data
                labels[start:stop] = features[name].times
                start = stop
            group.create_dataset('index', data=index, **comp)
            if with_properties:
                group.create_dataset(
                    'properties',
                    data=np.array(
                        [json_dumps(features[n].properties)
                         for n in names], dtype=object),
                    dtype=str_dtype, **comp)

    def _save_legacy(self, features, with_properties, comp):
        import h5py
        with h5py.File(self.filename, 'a') as fh:
            group = fh.create_group(self.GROUP)
            for k, v in features.items():
                sub = group.create_group(k)
                sub.create_dataset('data', data=v.data, **comp)
                sub.create_dataset('times', data=v.times, **comp)
                if with_properties:
                    sub.attrs['properties'] = json_dumps(v.properties)

    def _load(self):
        import h5py
        self._log.info('loading %s', self.filename)
        collection = self._features_collection()
        with h5py.File(self.filename, 'r') as fh:
            group = fh[self.GROUP]
            if 'items' not in group:
                return self._load_legacy(group, collection)

            names = [
                item.decode('utf-8') if isinstance(item, bytes)
                else item for item in group['items'][...]]
            data = group['features'][...]
            labels = group['labels'][...]
            index = group['index'][...]
            if 'item_dtypes' in group.attrs:
                dtypes = [
                    np.dtype(d)
                    for d in json_loads(group.attrs['item_dtypes'])]
            else:
                dtypes = [data.dtype] * len(names)
            if 'properties' in group:
                raw = group['properties'][...]
                properties = [
                    json_loads(p.decode('utf-8')
                               if isinstance(p, bytes) else p)
                    for p in raw]
            else:
                properties = [{}] * len(names)

            start = 0
            for n, name in enumerate(names):
                stop = int(index[n]) + 1
                collection[name] = Features(
                    data[start:stop].astype(dtypes[n], copy=False),
                    labels[start:stop],
                    properties=properties[n], validate=False)
                start = stop
        return collection

    def _load_legacy(self, group, collection):
        """The older private layout: one sub-group per item."""
        for k, sub in group.items():
            properties = (
                json_loads(sub.attrs['properties'])
                if 'properties' in sub.attrs else {})
            collection[k] = Features(
                sub['data'][...], sub['times'][...],
                properties=properties, validate=False)
        return collection


# ---------------------------------------------------------------------------
# Kaldi binary ark codec (pure Python)
# ---------------------------------------------------------------------------

_KALDI_DTYPES = {b'FM': np.float32, b'DM': np.float64}
_KALDI_TOKENS = {np.dtype(np.float32): b'FM', np.dtype(np.float64): b'DM'}


def read_htk(filename):
    """Read an HTK binary feature file (e.g. ``.fea``).

    HTK files carry a 12-byte big-endian header (number of samples,
    sample period in 100 ns units, bytes per sample, parameter kind)
    followed by the big-endian float32 feature matrix.

    Returns
    -------
    data : np.ndarray [nsamples, ndims] float32 (native byte order)
    period : float, the sample period in seconds
    """
    with open(filename, 'rb') as fp:
        nsamples, period, sampsize, _parmkind = struct.unpack(
            '>IIHH', fp.read(12))
        raw = fp.read(nsamples * sampsize)
    data = np.frombuffer(raw, dtype='>f4').reshape(nsamples, sampsize // 4)
    return data.astype(np.float32), period * 1e-7


def write_htk(filename, data, frame_shift=0.01, parmkind=9):
    """Write a feature matrix as an HTK binary file.

    The inverse of :func:`read_htk`; ``parmkind=9`` is the HTK USER
    (arbitrary features) parameter kind.
    """
    data = np.asarray(data, dtype=np.float32)
    with open(filename, 'wb') as fp:
        fp.write(struct.pack(
            '>IIHH', data.shape[0], int(round(frame_shift * 1e7)),
            4 * data.shape[1], parmkind))
        fp.write(data.astype('>f4').tobytes())


def write_ark_matrix(fp, key, matrix):
    """Append one Kaldi binary matrix record to an open file.

    Record layout: ``<key> ' ' \\0B <FM|DM> ' ' \\4 <int32 rows> \\4
    <int32 cols> <row-major data>``. Returns the byte offset of the
    binary marker (for scp files).
    """
    if not key or any(c.isspace() for c in key):
        # ark keys are space-delimited: a key with whitespace would
        # silently corrupt the archive
        raise ValueError(
            f'invalid ark key "{key}": keys must be non-empty and '
            'contain no whitespace')

    matrix = np.ascontiguousarray(matrix)
    if matrix.dtype not in _KALDI_TOKENS:
        matrix = matrix.astype(np.float64)
    token = _KALDI_TOKENS[matrix.dtype]

    fp.write(key.encode() + b' ')
    offset = fp.tell()
    fp.write(b'\0B' + token + b' ')
    rows, cols = matrix.shape
    fp.write(b'\x04' + struct.pack('<i', rows))
    fp.write(b'\x04' + struct.pack('<i', cols))
    # zero-copy: hand the array's own buffer to the writer instead of
    # materializing a bytes duplicate of the whole matrix. This
    # assumes fp copies synchronously (regular buffered files do):
    # callers like _save_one_ark reuse the buffer for the next
    # record, so a file-like object that RETAINS the memoryview would
    # see later records' data
    fp.write(memoryview(matrix).cast('B'))
    return offset


def read_ark(filename, dtypes=None):
    """Iterate over (key, matrix) pairs of a Kaldi binary ark file.

    Uses the native C++ indexer/bulk reader when available
    (:mod:`shennong_tpu_torch.native`), falling back to the pure-Python
    codec. ``dtypes`` optionally maps keys to a target dtype name:
    double records destined for float32 convert during the native
    read (one pass over the destination pages instead of read +
    astype).
    """
    from shennong_tpu_torch import native
    dtypes = dtypes or {}
    yielded = set()
    if native.available():
        index = native.ark_index(filename)
        if index is not None:
            done = True
            for key, offset, rows, cols, is_double in index:
                matrix = native.ark_read_matrix(
                    filename, offset, rows, cols, is_double,
                    as_float32=(
                        is_double and dtypes.get(key) == 'float32'))
                if matrix is None:  # pragma: nocover
                    done = False
                    break
                yielded.add(key)
                yield key, matrix
            if done:
                return

    with open(filename, 'rb') as fp:
        while True:
            key = _read_token(fp)
            if key is None:
                return
            marker = fp.read(2)
            if marker != b'\0B':
                raise ValueError(
                    f'{filename}: text-mode ark not supported '
                    f'(marker {marker!r})')
            token = fp.read(3).strip()
            if token not in _KALDI_DTYPES:
                raise ValueError(f'{filename}: unsupported token {token!r}')
            dtype = _KALDI_DTYPES[token]
            rows = _read_basic_int(fp)
            cols = _read_basic_int(fp)
            data = np.frombuffer(
                fp.read(rows * cols * np.dtype(dtype).itemsize), dtype=dtype)
            if key in yielded:
                # the native bulk reader already produced this record
                # before failing mid-iteration; skip the duplicate
                continue
            yield key, data.reshape(rows, cols).copy()


def _read_token(fp):
    """Read a whitespace-terminated key, None at end of file."""
    chars = []
    while True:
        char = fp.read(1)
        if not char:
            return None if not chars else bytes(chars).decode()
        if char == b' ':
            return bytes(chars).decode()
        chars.append(char[0])


def _read_basic_int(fp):
    size = fp.read(1)[0]
    if size != 4:
        raise ValueError(f'unsupported kaldi integer size {size}')
    return struct.unpack('<i', fp.read(4))[0]


class KaldiSerializer(FeaturesSerializer):
    """Kaldi ``.ark`` format (+ ``.times.ark`` and ``.properties.json``).

    Data and times are stored as double matrices for exact round-trips
    (matching the reference which uses DoubleMatrixWriter); original
    dtypes are recorded in the properties sidecar.
    """

    def __init__(self, cls, filename, log):
        super().__init__(cls, filename, log=log)
        root, ext = os.path.splitext(self.filename)
        if ext != '.ark':
            raise ValueError(
                'when saving to Kaldi ark format, the file extension must be '
                '".ark", it is "{}"'.format(ext))
        self._fileroot = root

    def _save_one_ark(self, path, items, scp, compact=False):
        items = list(items)
        for key, _ in items:
            if not key or any(c.isspace() for c in key):
                # checked before the file opens, so an invalid name
                # cannot leave a partial archive on disk
                raise ValueError(
                    f'invalid ark key "{key}": keys must be non-empty '
                    'and contain no whitespace')
        offsets = {}
        # convert non-double matrices into ONE reused scratch buffer:
        # allocate-per-record astype() pays a fresh-page fault for every
        # byte of the archive, the pooled pages are touched once. Sized
        # over the records that need conversion only (an all-double
        # collection allocates nothing), lazily on first use. With
        # ``compact`` float32 matrices write natively as Kaldi FM
        # records — half the bytes, and the round trip is still exact
        # (the properties sidecar restores the original dtype)
        items = [(key, np.ascontiguousarray(m)) for key, m in items]

        # a native bulk writer was measured against this path (stdio
        # streaming, mmap, mmap + MAP_POPULATE) and did not beat it:
        # write(2) into the page cache is the fastest way to touch the
        # output pages

        def needs_double(matrix):
            if compact:
                return matrix.dtype not in _KALDI_TOKENS
            return matrix.dtype != np.float64

        scratch_size = max(
            (m.size for _, m in items if needs_double(m)), default=0)
        scratch = None
        with open(path, 'wb') as fp:
            for key, matrix in items:
                if needs_double(matrix):
                    if scratch is None:
                        scratch = np.empty(scratch_size, np.float64)
                    view = scratch[:matrix.size].reshape(matrix.shape)
                    # casting='unsafe' preserves the historical
                    # astype(float64) semantics for exotic dtypes
                    # (complex input writes its real part, like the
                    # reference's DoubleMatrixWriter path)
                    np.copyto(view, matrix, casting='unsafe')
                    matrix = view
                offsets[key] = write_ark_matrix(fp, key, matrix)
        if scp:
            scp_path = os.path.splitext(path)[0] + '.scp'
            with open(scp_path, 'wt') as fp:
                for key, offset in offsets.items():
                    fp.write(f'{key} {path}:{offset}\n')

    def _save(self, features, with_properties, scp=False,
              compact=False):
        """``compact=True`` writes float32 data as native Kaldi FM
        records (half the archive bytes and write time of the
        reference-compatible double layout; still a valid ark any
        Kaldi tool reads, and the round trip through the dtype
        sidecar is bit-exact)."""
        ark = self._fileroot + '.ark'
        self._log.info('writing %s', ark)
        self._save_one_ark(
            ark, ((k, v.data) for k, v in features.items()), scp,
            compact=compact)

        times_ark = self._fileroot + '.times.ark'
        self._log.info('writing %s', times_ark)
        self._save_one_ark(
            times_ark,
            ((k, np.atleast_2d(v.times)) for k, v in features.items()),
            scp, compact=compact)

        # properties + original dtypes (everything is stored as double)
        filename = self._fileroot + '.properties.json'
        self._log.info('writing %s', filename)
        if with_properties:
            data = {
                k: copy.deepcopy(v.properties) for k, v in features.items()}
        else:
            data = {k: {} for k in features}
        for k in data:
            data[k]['__dtype_data__'] = str(features[k].dtype)
            data[k]['__dtype_times__'] = str(features[k].times.dtype)
        with open(filename, 'wt') as fp:
            fp.write(json_dumps(data, indent=4))

    def _load(self):
        filename = self._fileroot + '.properties.json'
        self._log.info('loading %s', filename)
        if not os.path.isfile(filename):
            raise IOError('file not found: {}'.format(filename))
        with open(filename, 'r') as fp:
            properties = json_loads(fp.read())

        times_ark = self._fileroot + '.times.ark'
        self._log.info('loading %s', times_ark)
        if not os.path.isfile(times_ark):
            raise IOError('file not found: {}'.format(times_ark))
        times = {k: v for k, v in read_ark(times_ark)}
        for key, value in times.items():
            if value.shape[0] == 1:
                times[key] = value.reshape((value.shape[1]))

        ark = self._fileroot + '.ark'
        self._log.info('loading %s', ark)
        data = {k: v for k, v in read_ark(
            ark, dtypes={
                k: str(v.get('__dtype_data__', ''))
                for k, v in properties.items()})}

        if properties.keys() != data.keys():
            raise ValueError(
                'invalid features: items differ in data and properties')
        if times.keys() != data.keys():
            raise ValueError(
                'invalid features: items differ in data and times')

        return self._features_collection(**{
            k: Features(
                # copy=False: the ark stores float32 matrices natively,
                # so the common case is already in the target dtype
                data[k].astype(properties[k]['__dtype_data__'], copy=False),
                times[k].astype(
                    properties[k]['__dtype_times__'], copy=False),
                properties={
                    key: p for key, p in properties[k].items()
                    if '__dtype_' not in key},
                validate=False)
            for k in data.keys()})


class CsvSerializer(FeaturesSerializer):
    """CSV folder format: one <item>.csv (+ optional .json) per item."""

    def _check_load(self):
        if not os.path.isdir(self.filename):
            raise IOError(f'directory not found: {self.filename}')

    def _check_save(self):
        if os.path.exists(self.filename):
            raise IOError(f'already exists: {self.filename}')

    def _save(self, features, with_properties):
        os.makedirs(self.filename)
        self._log.info('writing directory "%s"', self.filename)
        from shennong_tpu_torch import native
        for name, feat in features.items():
            csv_file = os.path.join(self.filename, name + '.csv')
            self._log.debug('writing %s', csv_file)
            times = (
                feat.times.reshape((feat.nframes, 1))
                if feat.times.ndim == 1 else feat.times)
            header = (
                f'data_dtype = {feat.dtype}, '
                f'times_dtype = {feat.times.dtype}, '
                f'features_ndims = {feat.ndims}')
            table = np.hstack((times, feat.data))
            # the threaded native writer renders shortest-round-trip
            # doubles (exact); numpy.savetxt is the fallback
            if not native.csv_write(csv_file, '# ' + header + '\n', table):
                np.savetxt(
                    csv_file, table, header=header, comments='# ')

            if with_properties and feat.properties:
                json_file = os.path.join(self.filename, name + '.json')
                self._log.debug('writing %s', json_file)
                with open(json_file, 'wt') as fp:
                    fp.write(json_dumps(feat.properties, indent=4))

    @staticmethod
    def _parse_header(csv_file):
        with open(csv_file, 'r') as fp:
            header = fp.readline().strip()
        if header[0] != '#':
            raise ValueError(f'failed to parse header from {csv_file}')
        header = header.split(', ')
        try:
            data_dtype = np.dtype(header[0].split('= ')[1])
            times_dtype = np.dtype(header[1].split('= ')[1])
            ndims = int(header[2].split('= ')[1])
        except (IndexError, TypeError):
            raise ValueError(
                f'failed to parse header from {csv_file}') from None
        return data_dtype, times_dtype, ndims

    def _load(self):
        self._log.info('loading directory "%s"', self.filename)
        csv_files = list_files_with_extension(
            self.filename, '.csv', recursive=False)
        json_files = list_files_with_extension(
            self.filename, '.json', recursive=False)

        collection = self._features_collection()
        for csv in csv_files:
            self._log.debug('loading %s', csv)
            data_dtype, times_dtype, ndims = self._parse_header(csv)

            # numpy.loadtxt: correctly-rounded parsing, so the
            # writer's shortest-round-trip rendering reads back exact
            # (pandas' fast parsers are not correctly rounded)
            raw = np.loadtxt(csv)
            times = raw[:, :raw.shape[1] - ndims].astype(times_dtype)
            if times.shape[1] == 1:
                times = times.flatten()
            data = raw[:, raw.shape[1] - ndims:].astype(data_dtype)

            properties = {}
            json_file = csv.replace('.csv', '.json')
            if json_file in json_files:
                self._log.debug('loading %s', json_file)
                with open(json_file, 'r') as fp:
                    properties = dict(json_loads(fp.read()))

            name = os.path.basename(csv).replace('.csv', '')
            collection[name] = Features(
                data, times, properties=properties, validate=False)

        return collection
