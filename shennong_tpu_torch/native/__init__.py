"""ctypes bindings to the port's native IO runtime.

The port's own copy of the loader of ``shennong_tpu/native``, with the
entry points the port calls: fast WAV header scans and a threaded
batched PCM16 WAV loader (``shennong_io.cpp``), the Kaldi ark indexer
and bulk reader (``shennong_io.cpp``), a FLAC decoder
(``shennong_flac.cpp``), a threaded CSV writer (``shennong_csv.cpp``),
the float64 banded Viterbi decoders of the CREPE pitch smoothing
(``shennong_viterbi.cpp``) and the compressed-audio codec through the system libav* libraries
(``shennong_codec.cpp``, its own library so a machine without
libavformat still gets the rest).

Each library is compiled with ``g++`` at first use into the package's
``_build/`` directory, under a name that carries a digest of its
sources and flags; nothing is built next to the sources. Every entry
point returns None (or False) when its library cannot be built or
loaded, and the callers then take their pure-Python path.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), '_build')

# -ffp-contract=off: no silent FMA fusion (the codecs are held
# bit-exact against their numpy paths)
_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17', '-pthread',
          '-ffp-contract=off']
_IO_SOURCES = ['shennong_io.cpp', 'shennong_flac.cpp', 'shennong_csv.cpp',
               'shennong_viterbi.cpp']
_CODEC_SOURCES = ['shennong_codec.cpp']
_CODEC_LIBS = ['-lavformat', '-lavcodec', '-lavutil', '-lswresample']

_lock = threading.Lock()
_libraries = {}

_P = ctypes.POINTER
_I32, _I64, _F64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double

#: name -> (restype, argtypes) of the entry points bound from each library
_IO_SIGNATURES = {
    'shennong_wav_scan2': (ctypes.c_int, [
        ctypes.c_char_p, _P(_I32), _P(_I32), _P(_I64), _P(_I32),
        _P(_I32)]),
    'shennong_load_wav_batch_i16': (ctypes.c_int, [
        ctypes.c_char_p, _I32, _P(_I64), _P(_I64), _I64,
        _P(ctypes.c_int16), _P(_I64), _I32]),
    'shennong_ark_index': (_I64, [
        ctypes.c_char_p, ctypes.c_char_p, _I64, _P(_I64), _I64]),
    'shennong_ark_read': (ctypes.c_int, [
        ctypes.c_char_p, _I64, _I64, ctypes.c_void_p]),
    'shennong_ark_read_f32': (ctypes.c_int, [
        ctypes.c_char_p, _I64, _I64, _P(ctypes.c_float)]),
    'shennong_flac_scan': (ctypes.c_int, [
        ctypes.c_char_p, _P(_I32), _P(_I32), _P(_I32), _P(_I64)]),
    'shennong_flac_decode': (_I64, [ctypes.c_char_p, _P(_I32), _I64]),
    'shennong_csv_write': (_I64, [
        ctypes.c_char_p, ctypes.c_char_p, _P(_F64), _I64, _I32, _I32]),
    'shennong_viterbi_banded': (_I64, [
        _P(_F64), _P(_F64), _P(_F64), _I64, _I64, _I64, _P(_I64)]),
    'shennong_viterbi_banded_two': (_I64, [
        _P(_F64), _P(_F64), _F64, _F64, _P(_I32), _I64, _I64, _I64,
        _P(_I64)]),
}
_CODEC_SIGNATURES = {
    'shennong_codec_scan': (ctypes.c_int, [
        ctypes.c_char_p, _P(_I32), _P(_I32), _P(_I64)]),
    'shennong_codec_decode': (_P(ctypes.c_int16), [
        ctypes.c_char_p, _P(_I64), _P(_I32), _P(_I32)]),
    'shennong_codec_free': (None, [_P(ctypes.c_int16)]),
    'shennong_codec_encode': (ctypes.c_int, [
        ctypes.c_char_p, _P(ctypes.c_int16), _I64, _I32, _I32]),
}


def _build(name, sources, libs):
    """Compile ``sources`` into ``_build/lib<name>-<digest>.so`` (once
    per content); returns the library path. Raises CalledProcessError
    when g++ fails."""
    paths = [os.path.join(_HERE, source) for source in sources]
    digest = hashlib.sha1(' '.join(_FLAGS + libs).encode())
    for path in paths:
        with open(path, 'rb') as fp:
            digest.update(fp.read())
    target = os.path.join(
        _BUILD_DIR, f'lib{name}-{digest.hexdigest()[:16]}.so')
    if os.path.isfile(target):
        return target
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build under a private name, then rename: concurrent builds never
    # load a half-written library
    handle, partial = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
    os.close(handle)
    try:
        subprocess.run(
            ['g++', *_FLAGS, '-o', partial, *paths, *libs],
            check=True, capture_output=True)
        os.replace(partial, target)
    finally:
        if os.path.exists(partial):
            os.unlink(partial)
    return target


def _load(name, sources, libs, signatures):
    """The ctypes handle of library ``name``, built at first use, or
    None when it cannot be built or loaded."""
    with _lock:
        if name not in _libraries:
            try:
                lib = ctypes.CDLL(_build(name, sources, libs))
                for symbol, (restype, argtypes) in signatures.items():
                    fn = getattr(lib, symbol)
                    fn.restype, fn.argtypes = restype, argtypes
            except (OSError, AttributeError,
                    subprocess.CalledProcessError):
                lib = None
            _libraries[name] = lib
    return _libraries[name]


def load_library():
    """The IO library (WAV, ark, FLAC, CSV), or None."""
    return _load('shennong_io', _IO_SOURCES, [], _IO_SIGNATURES)


def load_codec_library():
    """The libav*-backed codec library, or None on machines without
    the libav* system libraries."""
    return _load('shennong_codec', _CODEC_SOURCES, _CODEC_LIBS,
                 _CODEC_SIGNATURES)


def available():
    """True when the IO library could be built and loaded"""
    return load_library() is not None


def codec_available():
    """True when the libav*-backed codec library is usable"""
    return load_codec_library() is not None


def codec_scan(path):
    """(channels, sample_rate, nsamples_estimate) of a compressed
    audio file, or None. The sample count comes from the container
    duration."""
    lib = load_codec_library()
    if lib is None:
        return None
    channels, rate, nsamples = _I32(), _I32(), _I64()
    status = lib.shennong_codec_scan(
        str(path).encode(), ctypes.byref(channels), ctypes.byref(rate),
        ctypes.byref(nsamples))
    if status != 0:
        return None
    return channels.value, rate.value, nsamples.value


def codec_decode(path):
    """Decode a compressed audio file entirely: (samples int16
    [nframes] or [nframes, channels], sample_rate), or None."""
    lib = load_codec_library()
    if lib is None:
        return None
    nframes, channels, rate = _I64(), _I32(), _I32()
    buffer = lib.shennong_codec_decode(
        str(path).encode(), ctypes.byref(nframes),
        ctypes.byref(channels), ctypes.byref(rate))
    if not buffer:
        return None
    try:
        count = nframes.value * channels.value
        # astype (not copy): the canonical np.int16 dtype instance
        data = np.ctypeslib.as_array(
            buffer, shape=(count,)).astype(np.int16)
    finally:
        lib.shennong_codec_free(buffer)
    if channels.value > 1:
        data = data.reshape(nframes.value, channels.value)
    return data, rate.value


def codec_encode(path, data, sample_rate):
    """Encode interleaved int16 PCM to ``path`` (format from the
    extension: mp3, flac, ogg, ...). Returns True on success."""
    lib = load_codec_library()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, dtype=np.int16)
    channels = 1 if data.ndim == 1 else data.shape[1]
    status = lib.shennong_codec_encode(
        str(path).encode(), data.ctypes.data_as(_P(ctypes.c_int16)),
        data.shape[0], channels, sample_rate)
    return status == 0


def wav_scan2(path):
    """(channels, sample_rate, nsamples, format, bits) of a WAV file,
    or None; format 1 is PCM, 3 IEEE float."""
    lib = load_library()
    if lib is None:
        return None
    channels, rate, nsamples = _I32(), _I32(), _I64()
    fmt, bits = _I32(), _I32()
    status = lib.shennong_wav_scan2(
        str(path).encode(), ctypes.byref(channels), ctypes.byref(rate),
        ctypes.byref(nsamples), ctypes.byref(fmt), ctypes.byref(bits))
    if status != 0:
        return None
    return channels.value, rate.value, nsamples.value, \
        fmt.value, bits.value


def load_wav_batch_i16(paths, start_samples, max_counts, row_stride,
                       out=None, num_threads=8):
    """Load mono PCM16 WAV segments concurrently into an int16 batch.

    Writes straight into ``out`` ([len(paths), row_stride] int16,
    allocated when not given). Returns (out, counts [len(paths)]
    int64), or None when the library is unavailable or any file is not
    plain mono PCM16.
    """
    lib = load_library()
    if lib is None:
        return None
    batch = len(paths)
    packed = b''.join(str(p).encode() + b'\0' for p in paths)
    starts = np.asarray(start_samples, dtype=np.int64)
    counts = np.asarray(max_counts, dtype=np.int64)
    if out is None:
        out = np.empty((batch, row_stride), dtype=np.int16)
    assert (out.shape == (batch, row_stride)
            and out.dtype == np.int16 and out.flags['C_CONTIGUOUS'])
    out_counts = np.empty(batch, dtype=np.int64)
    failures = lib.shennong_load_wav_batch_i16(
        packed, batch, starts.ctypes.data_as(_P(_I64)),
        counts.ctypes.data_as(_P(_I64)), row_stride,
        out.ctypes.data_as(_P(ctypes.c_int16)),
        out_counts.ctypes.data_as(_P(_I64)), num_threads)
    if failures:
        return None
    return out, out_counts


def ark_index(path, max_records=1 << 20, keys_capacity=1 << 24):
    """Index a binary ark: list of (key, offset, rows, cols,
    is_double), or None."""
    lib = load_library()
    if lib is None:
        return None
    keys_buf = ctypes.create_string_buffer(keys_capacity)
    meta = np.empty((max_records, 4), dtype=np.int64)
    count = lib.shennong_ark_index(
        str(path).encode(), keys_buf, keys_capacity,
        meta.ctypes.data_as(_P(_I64)), max_records)
    if count < 0:
        return None
    # bound the split at `count` NULs: splitting the whole buffer would
    # shred megabytes of trailing zeros
    keys = keys_buf.raw.split(b'\0', count)[:count]
    return [
        (keys[i].decode(), int(meta[i, 0]), int(meta[i, 1]),
         int(meta[i, 2]), bool(meta[i, 3]))
        for i in range(count)]


def ark_read_matrix(path, offset, rows, cols, is_double,
                    as_float32=False):
    """Bulk-read one ark matrix record, or None. ``as_float32``
    converts a double record to float32 during the read."""
    lib = load_library()
    if lib is None:
        return None
    if is_double and as_float32:
        out = np.empty((rows, cols), dtype=np.float32)
        status = lib.shennong_ark_read_f32(
            str(path).encode(), offset, rows * cols,
            out.ctypes.data_as(_P(ctypes.c_float)))
        return out if status == 0 else None
    out = np.empty((rows, cols),
                   dtype=np.float64 if is_double else np.float32)
    status = lib.shennong_ark_read(
        str(path).encode(), offset, out.nbytes,
        out.ctypes.data_as(ctypes.c_void_p))
    return out if status == 0 else None


def flac_scan(path):
    """(channels, sample_rate, bits, nsamples) of a FLAC file, or
    None."""
    lib = load_library()
    if lib is None:
        return None
    channels, rate, bits, nsamples = _I32(), _I32(), _I32(), _I64()
    status = lib.shennong_flac_scan(
        str(path).encode(), ctypes.byref(channels), ctypes.byref(rate),
        ctypes.byref(bits), ctypes.byref(nsamples))
    if status != 0:
        return None
    return channels.value, rate.value, bits.value, nsamples.value


def flac_decode(path):
    """Decode a FLAC file: (samples [nframes, channels] or [nframes]
    int16/int32, sample_rate), or None."""
    lib = load_library()
    if lib is None:
        return None
    meta = flac_scan(path)
    if meta is None:
        return None
    channels, rate, bits, nsamples = meta
    if nsamples <= 0:
        # total unknown in STREAMINFO: bound by the file size (a FLAC
        # frame never expands past ~1 sample per coded bit)
        nsamples = os.path.getsize(path) * 8 // max(bits, 1) + 65536
    out = np.empty(nsamples * channels, dtype=np.int32)
    decoded = lib.shennong_flac_decode(
        str(path).encode(), out.ctypes.data_as(_P(_I32)), out.shape[0])
    if decoded < 0:
        return None
    data = out[:decoded * channels].reshape(decoded, channels)
    if channels == 1:
        data = data[:, 0]
    if bits <= 16:
        data = data.astype(np.int16)
    return data, rate


def csv_write(path, header, values, num_threads=8):
    """Write a 2-D float64 array as a space-separated CSV, ``header``
    first, values as shortest round-trip doubles. Returns False when
    the library is unavailable or the write failed."""
    lib = load_library()
    if lib is None:
        return False
    values = np.ascontiguousarray(values, dtype=np.float64)
    if values.ndim != 2:
        return False
    written = lib.shennong_csv_write(
        str(path).encode(), header.encode(),
        values.ctypes.data_as(_P(_F64)),
        values.shape[0], values.shape[1], num_threads)
    return written >= 0


def viterbi_banded(log_start, band, log_obs):
    """Banded Viterbi decode, or None when the library is unavailable
    or refuses the band (wider than 127).

    ``band[j, d]`` holds the transition weight from state
    ``j - halfwidth + d`` to state ``j`` (-inf outside the band and
    the state range); halfwidth is inferred from the band width.
    Bit-identical to the numpy decoder in ops/viterbi.py.
    """
    lib = load_library()
    if lib is None:
        return None
    log_start = np.ascontiguousarray(log_start, dtype=np.float64)
    band = np.ascontiguousarray(band, dtype=np.float64)
    log_obs = np.ascontiguousarray(log_obs, dtype=np.float64)
    nframes, nstates = log_obs.shape
    path = np.empty(nframes, dtype=np.int64)
    status = lib.shennong_viterbi_banded(
        log_start.ctypes.data_as(_P(_F64)), band.ctypes.data_as(_P(_F64)),
        log_obs.ctypes.data_as(_P(_F64)), nframes, nstates, band.shape[1],
        path.ctypes.data_as(_P(_I64)))
    return path if status == 0 else None


def viterbi_banded_two(log_start, band, uniform_weight, self_weight,
                       observations, nstates):
    """Banded Viterbi decode with a two-valued observation model, or
    None when the library is unavailable or refuses the band.

    State j at frame t weighs ``self_weight`` when
    ``j == observations[t]`` and ``uniform_weight`` otherwise (the
    CREPE smoothing prior), avoiding the dense [T, S] observation
    matrix.
    """
    lib = load_library()
    if lib is None:
        return None
    log_start = np.ascontiguousarray(log_start, dtype=np.float64)
    band = np.ascontiguousarray(band, dtype=np.float64)
    observations = np.ascontiguousarray(observations, dtype=np.int32)
    path = np.empty(observations.shape[0], dtype=np.int64)
    status = lib.shennong_viterbi_banded_two(
        log_start.ctypes.data_as(_P(_F64)), band.ctypes.data_as(_P(_F64)),
        float(uniform_weight), float(self_weight),
        observations.ctypes.data_as(_P(_I32)), observations.shape[0],
        nstates, band.shape[1], path.ctypes.data_as(_P(_I64)))
    return path if status == 0 else None
