"""Counterpart of ``tests/test_kaldiio.py``, case for case: the port's
Kaldi binary codec on hand-written streams (``io.BytesIO``, ROADMAP
C9), round trips and the processors' format sniffing, with the JAX
cases' bounds; and every stream, written by one package to an open
file, read back by the other."""

import io
import struct

import numpy as np
import pytest

from shennong_tpu_torch import kaldiio
from shennong_tpu_torch.ops.fmllr import LinearVtln
from shennong_tpu_torch.processor.ubm import DiagGmm, DiagUbmProcessor
from shennong_tpu_torch.processor.vtln import VtlnProcessor


def _tok(t):
    return t + b' '


def _i32(v):
    return b'\x04' + struct.pack('<i', v)


def _f32(v):
    return b'\x04' + struct.pack('<f', v)


def _fv(values):
    return (_tok(b'FV') + _i32(len(values))
            + np.asarray(values, '<f4').tobytes())


def _fm(matrix):
    matrix = np.asarray(matrix, '<f4')
    return (_tok(b'FM') + _i32(matrix.shape[0]) + _i32(matrix.shape[1])
            + matrix.tobytes())


def test_hand_written_diag_gmm():
    """A DiagGmm stream built byte-by-byte from the documented Kaldi
    layout parses into the expected parameters."""
    weights = np.array([0.25, 0.75])
    means = np.array([[1.0, -2.0], [0.5, 3.0]])
    inv_vars = np.array([[2.0, 1.0], [4.0, 0.5]])

    blob = (
        kaldiio.BINARY_MARKER
        + _tok(b'<DiagGMM>')
        + _tok(b'<GCONSTS>') + _fv([0.0, 0.0])  # ignored, recomputed
        + _tok(b'<WEIGHTS>') + _fv(weights)
        + _tok(b'<MEANS_INVVARS>') + _fm(means * inv_vars)
        + _tok(b'<INV_VARS>') + _fm(inv_vars)
        + _tok(b'</DiagGMM>'))

    fp = io.BytesIO(blob)
    assert fp.read(2) == kaldiio.BINARY_MARKER
    got_w, got_m, got_iv = kaldiio.read_diag_gmm(fp)
    assert got_w == pytest.approx(weights)
    assert got_m == pytest.approx(means, abs=1e-6)
    assert got_iv == pytest.approx(inv_vars)


def test_hand_written_lvtln():
    blob = (
        kaldiio.BINARY_MARKER
        + _tok(b'<LinearVtln>')
        + _tok(b'<Dim>') + _i32(2)
        + _tok(b'<NumClasses>') + _i32(2)
        + _tok(b'<DefaultClass>') + _i32(1)
        + _tok(b'<Class>') + _i32(0)
        + _fm([[0.9, 0.0], [0.0, 1.1]])
        + _tok(b'<Warp>') + _f32(0.95)
        + _tok(b'<Class>') + _i32(1)
        + _fm([[1.0, 0.0], [0.0, 1.0]])
        + _tok(b'<Warp>') + _f32(1.0)
        + _tok(b'</LinearVtln>'))

    fp = io.BytesIO(blob)
    assert fp.read(2) == kaldiio.BINARY_MARKER
    transforms, warps, default = kaldiio.read_lvtln(fp)
    assert default == 1
    assert warps == pytest.approx([0.95, 1.0])
    assert transforms[0] == pytest.approx(
        np.diag([0.9, 1.1]), abs=1e-7)
    assert transforms[1] == pytest.approx(np.eye(2))


def test_gmm_round_trip(tmpdir):
    rng = np.random.RandomState(0)
    weights = rng.dirichlet(np.ones(4))
    means = rng.randn(4, 7)
    inv_vars = 1.0 / (0.5 + rng.rand(4, 7))

    path = str(tmpdir.join('ubm.mdl'))
    kaldiio.write_diag_gmm(path, weights, means, inv_vars)
    assert kaldiio.is_kaldi_binary(path)
    got_w, got_m, got_iv = kaldiio.read_diag_gmm(path)
    assert got_w == pytest.approx(weights, rel=1e-6)
    assert got_m == pytest.approx(means, rel=1e-4, abs=1e-6)
    assert got_iv == pytest.approx(inv_vars, rel=1e-6)


def test_lvtln_round_trip(tmpdir):
    rng = np.random.RandomState(1)
    transforms = np.eye(5) + rng.randn(3, 5, 5) * 0.1
    warps = np.array([0.9, 1.0, 1.1])

    path = str(tmpdir.join('lvtln.mdl'))
    kaldiio.write_lvtln(path, transforms, warps, 1)
    got_t, got_w, got_d = kaldiio.read_lvtln(path)
    assert got_d == 1
    assert got_w == pytest.approx(warps)
    assert got_t == pytest.approx(transforms, rel=1e-6, abs=1e-7)


def test_ubm_processor_sniffs_format(tmpdir):
    ubm = DiagUbmProcessor(2)
    rng = np.random.RandomState(2)
    ubm.gmm = DiagGmm(
        np.array([0.4, 0.6]), rng.randn(2, 3),
        1.0 / (0.5 + rng.rand(2, 3)))

    kaldi_path = str(tmpdir.join('ubm.mdl'))
    ubm.save_kaldi(kaldi_path)
    npz_path = str(tmpdir.join('ubm.npz'))
    ubm.save(npz_path)

    from_kaldi = DiagUbmProcessor.load(kaldi_path)
    from_npz = DiagUbmProcessor.load(npz_path)
    assert from_kaldi.gmm.weights == pytest.approx(
        from_npz.gmm.weights, rel=1e-6)
    assert from_kaldi.gmm.means == pytest.approx(
        from_npz.gmm.means, rel=1e-4, abs=1e-6)
    assert from_kaldi.gmm.inv_vars == pytest.approx(
        from_npz.gmm.inv_vars, rel=1e-6)

    with pytest.raises(OSError, match='already exists'):
        ubm.save_kaldi(kaldi_path)


def test_vtln_processor_sniffs_format(tmpdir):
    vtln = VtlnProcessor()
    rng = np.random.RandomState(3)
    vtln.lvtln = LinearVtln(4, 3, 2)
    vtln.lvtln.transforms = np.eye(4) + rng.randn(3, 4, 4) * 0.05
    vtln.lvtln.warps = np.array([0.9, 1.0, 1.1])

    kaldi_path = str(tmpdir.join('lvtln.mdl'))
    vtln.save_kaldi(kaldi_path)
    loaded = VtlnProcessor.load(kaldi_path)
    assert loaded.lvtln.dim == 4
    assert loaded.lvtln.num_classes == 3
    assert loaded.lvtln.default_class == 2
    assert loaded.lvtln.transforms == pytest.approx(
        vtln.lvtln.transforms, rel=1e-5, abs=1e-6)
    assert loaded.lvtln.get_warp(0) == pytest.approx(0.9)


def test_not_kaldi_binary_error(tmpdir):
    path = str(tmpdir.join('text.mdl'))
    with open(path, 'w') as fp:
        fp.write('<DiagGMM> text mode')
    with pytest.raises(ValueError, match='not a Kaldi binary'):
        kaldiio.read_diag_gmm(path)


def _gmm_arrays(seed=4):
    rng = np.random.RandomState(seed)
    return (rng.dirichlet(np.ones(3)), rng.randn(3, 5),
            1.0 / (0.5 + rng.rand(3, 5)))


def _lvtln_arrays(seed=5):
    rng = np.random.RandomState(seed)
    return (np.eye(4) + rng.randn(3, 4, 4) * 0.1,
            np.array([0.9, 1.0, 1.1]), 1)


@pytest.mark.parametrize('model', ['gmm', 'lvtln'])
@pytest.mark.parametrize('direction', ['jax to port', 'port to jax'])
def test_open_files_interchange(model, direction):
    """A stream that one package writes to an ``io.BytesIO`` the other
    reads back from it: the same bytes, and the parameters of the
    path round trips' bounds."""
    from shennong_tpu import kaldiio as jkaldiio

    writer, reader = (jkaldiio, kaldiio) if direction == 'jax to port' \
        else (kaldiio, jkaldiio)
    arrays = _gmm_arrays() if model == 'gmm' else _lvtln_arrays()
    name = 'diag_gmm' if model == 'gmm' else 'lvtln'
    streams = []
    for package in (writer, reader):
        fp = io.BytesIO()
        getattr(package, 'write_' + name)(fp, *arrays)
        streams.append(fp.getvalue())
    assert streams[0] == streams[1]

    fp = io.BytesIO(streams[0])
    got = getattr(reader, 'read_' + name)(fp)
    assert fp.read() == b''
    if model == 'gmm':
        assert got[0] == pytest.approx(arrays[0], rel=1e-6)
        assert got[1] == pytest.approx(arrays[1], rel=1e-4, abs=1e-6)
        assert got[2] == pytest.approx(arrays[2], rel=1e-6)
    else:
        assert got[0] == pytest.approx(arrays[0], rel=1e-6, abs=1e-7)
        assert got[1] == pytest.approx(arrays[1])
        assert got[2] == arrays[2]
