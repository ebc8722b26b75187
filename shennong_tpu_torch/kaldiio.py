"""Kaldi binary model I/O: DiagGmm and LinearVtln streams.

The port's own copy of ``shennong_tpu/kaldiio.py`` (numpy and
``struct`` only), so models written by either package, by Kaldi tools
or by the reference load in the other.

The reference saves/loads its UBM and LVTLN models through pykaldi in
Kaldi's binary object format (``shennong/processor/ubm.py:235-263``,
``shennong/processor/vtln.py:211-244``). This module is a pure-Python
codec for those streams so models trained by Kaldi tools or by the
reference load directly into this package (and ours write back out for
Kaldi consumption) — no pykaldi needed.

Stream layout (Kaldi ``base/io-funcs.cc``):

- a binary file opens with the two-byte marker ``\\0B``;
- ``WriteToken`` emits the token text followed by one space;
- ``WriteBasicType<T>`` emits one size byte (4 for int32/float, 8 for
  double) followed by the little-endian value;
- ``Vector<float>::Write`` emits token ``FV`` + int32 size + raw data
  (``DV`` for double), ``Matrix`` emits ``FM``/``DM`` + rows + cols.

Object layouts: ``DiagGmm::Write`` (``gmm/diag-gmm.cc``) is
``<DiagGMM> <GCONSTS> v <WEIGHTS> v <MEANS_INVVARS> m <INV_VARS> m
</DiagGMM>``; ``LinearVtln::Write`` (``transform/lvtln.cc``) is
``<LinearVtln> <Dim> i <NumClasses> i <DefaultClass> i`` then per
class ``<Class> i A_i <Warp> f`` and ``</LinearVtln>``.
"""

import struct

import numpy as np

BINARY_MARKER = b'\x00B'

_DTYPES = {b'FV': '<f4', b'DV': '<f8', b'FM': '<f4', b'DM': '<f8'}


# ----------------------------------------------------------- primitives

def read_token(fp):
    """One whitespace-terminated token from a Kaldi binary stream."""
    token = b''
    while True:
        char = fp.read(1)
        if not char:
            raise ValueError('unexpected end of Kaldi stream')
        if char in b' \t\n':
            if token:
                return token
            continue
        token += char


def expect_token(fp, expected):
    token = read_token(fp)
    if token != expected:
        raise ValueError(
            f'expected Kaldi token {expected!r} but read {token!r}')


def read_basic(fp, fmt='<i'):
    """A WriteBasicType value: size byte + little-endian payload."""
    size = struct.calcsize(fmt)
    head = fp.read(1)
    if not head:
        raise ValueError('unexpected end of stream')
    actual = head[0]
    if actual != size:
        raise ValueError(
            f'basic type of size {actual}, expected {size}')
    return struct.unpack(fmt, fp.read(size))[0]


def write_token(fp, token):
    fp.write(token + b' ')


def write_basic(fp, value, fmt='<i'):
    fp.write(bytes([struct.calcsize(fmt)]))
    fp.write(struct.pack(fmt, value))


def read_vector(fp):
    token = read_token(fp)
    if token not in (b'FV', b'DV'):
        raise ValueError(f'expected a Kaldi vector, got {token!r}')
    size = read_basic(fp)
    return np.frombuffer(
        fp.read(size * (4 if token == b'FV' else 8)),
        dtype=_DTYPES[token]).astype(np.float64)


def read_matrix(fp):
    token = read_token(fp)
    if token not in (b'FM', b'DM'):
        raise ValueError(f'expected a Kaldi matrix, got {token!r}')
    rows = read_basic(fp)
    cols = read_basic(fp)
    itemsize = 4 if token == b'FM' else 8
    data = np.frombuffer(
        fp.read(rows * cols * itemsize), dtype=_DTYPES[token])
    return data.reshape(rows, cols).astype(np.float64)


def write_vector(fp, vector):
    vector = np.asarray(vector, dtype=np.float32)
    write_token(fp, b'FV')
    write_basic(fp, vector.shape[0])
    fp.write(vector.astype('<f4').tobytes())


def write_matrix(fp, matrix):
    matrix = np.asarray(matrix, dtype=np.float32)
    write_token(fp, b'FM')
    write_basic(fp, matrix.shape[0])
    write_basic(fp, matrix.shape[1])
    fp.write(matrix.astype('<f4').tobytes())


def _check_marker(fp):
    marker = fp.read(2)
    if marker != BINARY_MARKER:
        raise ValueError(
            'not a Kaldi binary stream (text-mode Kaldi files are not '
            'supported, convert with copy-gmm/copy-matrix --binary)')


def is_kaldi_binary(path):
    """True when the file opens with the Kaldi binary marker."""
    with open(path, 'rb') as fp:
        return fp.read(2) == BINARY_MARKER


# -------------------------------------------------------------- DiagGmm

def read_diag_gmm(path_or_fp):
    """Read a Kaldi binary DiagGmm from a path, or from an open binary
    file positioned past the binary marker.

    Returns (weights [G], means [G, D], inv_vars [G, D]) float64 (the
    stream stores means * inv_vars; gconsts are dropped and recomputed
    on demand).
    """
    if isinstance(path_or_fp, (str, bytes)):
        with open(path_or_fp, 'rb') as fp:
            _check_marker(fp)
            return _read_diag_gmm_stream(fp)
    return _read_diag_gmm_stream(path_or_fp)


def _read_diag_gmm_stream(fp):
    expect_token(fp, b'<DiagGMM>')
    token = read_token(fp)
    if token == b'<GCONSTS>':
        read_vector(fp)  # recomputed from the parameters
        expect_token(fp, b'<WEIGHTS>')
    elif token != b'<WEIGHTS>':
        raise ValueError(f'unexpected DiagGmm token {token!r}')
    weights = read_vector(fp)
    expect_token(fp, b'<MEANS_INVVARS>')
    means_invvars = read_matrix(fp)
    expect_token(fp, b'<INV_VARS>')
    inv_vars = read_matrix(fp)
    expect_token(fp, b'</DiagGMM>')
    return weights, means_invvars / inv_vars, inv_vars


def write_diag_gmm(path_or_fp, weights, means, inv_vars):
    """Write a Kaldi binary DiagGmm readable by Kaldi tools, to a path
    (marker included) or to an open binary file (no marker)."""
    if isinstance(path_or_fp, (str, bytes)):
        with open(path_or_fp, 'wb') as fp:
            fp.write(BINARY_MARKER)
            _write_diag_gmm_stream(fp, weights, means, inv_vars)
        return
    _write_diag_gmm_stream(path_or_fp, weights, means, inv_vars)


def _write_diag_gmm_stream(fp, weights, means, inv_vars):
    weights = np.asarray(weights, dtype=np.float64)
    means = np.asarray(means, dtype=np.float64)
    inv_vars = np.asarray(inv_vars, dtype=np.float64)
    dim = means.shape[1]
    gconsts = (
        np.log(weights)
        - 0.5 * (dim * np.log(2 * np.pi)
                 - np.sum(np.log(inv_vars), axis=1)
                 + np.sum(means * means * inv_vars, axis=1)))
    write_token(fp, b'<DiagGMM>')
    write_token(fp, b'<GCONSTS>')
    write_vector(fp, gconsts)
    write_token(fp, b'<WEIGHTS>')
    write_vector(fp, weights)
    write_token(fp, b'<MEANS_INVVARS>')
    write_matrix(fp, means * inv_vars)
    write_token(fp, b'<INV_VARS>')
    write_matrix(fp, inv_vars)
    write_token(fp, b'</DiagGMM>')


# ------------------------------------------------------------ LinearVtln

def read_lvtln(path_or_fp):
    """Read a Kaldi binary LinearVtln from a path, or from an open
    binary file positioned past the binary marker.

    Returns (transforms [C, D, D], warps [C], default_class).
    """
    if isinstance(path_or_fp, (str, bytes)):
        with open(path_or_fp, 'rb') as fp:
            _check_marker(fp)
            return _read_lvtln_stream(fp)
    return _read_lvtln_stream(path_or_fp)


def _read_lvtln_stream(fp):
    expect_token(fp, b'<LinearVtln>')
    expect_token(fp, b'<Dim>')
    dim = read_basic(fp)
    expect_token(fp, b'<NumClasses>')
    num_classes = read_basic(fp)
    expect_token(fp, b'<DefaultClass>')
    default_class = read_basic(fp)

    transforms = np.zeros((num_classes, dim, dim))
    warps = np.zeros(num_classes)
    for index in range(num_classes):
        expect_token(fp, b'<Class>')
        stored = read_basic(fp)
        if stored != index:
            raise ValueError(
                f'LinearVtln class {stored} out of order '
                f'(expected {index})')
        transforms[index] = read_matrix(fp)
        expect_token(fp, b'<Warp>')
        warps[index] = read_basic(fp, '<f')
    expect_token(fp, b'</LinearVtln>')
    return transforms, warps, default_class


def write_lvtln(path_or_fp, transforms, warps, default_class):
    """Write a Kaldi binary LinearVtln readable by Kaldi tools, to a
    path (marker included) or to an open binary file (no marker)."""
    if isinstance(path_or_fp, (str, bytes)):
        with open(path_or_fp, 'wb') as fp:
            fp.write(BINARY_MARKER)
            _write_lvtln_stream(fp, transforms, warps, default_class)
        return
    _write_lvtln_stream(path_or_fp, transforms, warps, default_class)


def _write_lvtln_stream(fp, transforms, warps, default_class):
    transforms = np.asarray(transforms)
    write_token(fp, b'<LinearVtln>')
    write_token(fp, b'<Dim>')
    write_basic(fp, transforms.shape[1])
    write_token(fp, b'<NumClasses>')
    write_basic(fp, transforms.shape[0])
    write_token(fp, b'<DefaultClass>')
    write_basic(fp, int(default_class))
    for index in range(transforms.shape[0]):
        write_token(fp, b'<Class>')
        write_basic(fp, index)
        write_matrix(fp, transforms[index])
        write_token(fp, b'<Warp>')
        write_basic(fp, float(warps[index]), '<f')
    write_token(fp, b'</LinearVtln>')
