"""Pass 2 of a packed group of utterances (CMVN, deltas, the pitch
concatenation): a hand-written CUDA kernel and its plain PyTorch
version.

Replaces no TPU kernel: pass 2 is host code in both packages. The
pipeline (``pipeline._pass_two``) hands :func:`pack` the CMVN groups of
a call, whole utterances without padding, and :func:`compute` returns
their final rows, the same bits as the per-utterance chain of
:class:`~shennong_tpu_torch.postprocessor.cmvn.CmvnPostProcessor`,
:func:`~shennong_tpu_torch.ops.postops.compute_deltas_host` and
:meth:`~shennong_tpu_torch.features.Features.concatenate`
(``csrc/pass_two.cu`` states the arithmetic).

Dispatch goes by the device given to :func:`pack`: the CPU takes
:func:`pass_two_plain`; a CUDA device gets one upload of the packed
input from page-locked memory and one launch of ``csrc/pass_two.cu``
(a :class:`~shennong_tpu_torch.native.Library`, built at first use),
on a stream of pass 2's own, so that its synchronising download never
waits for the batches pass 1 has in flight; it raises on a failed
launch. Any other device raises. Every
launch adds one to ``counters['launches.pass_two']``
(:mod:`shennong_tpu_torch.parallel.profiler`).
"""

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from shennong_tpu_torch import native
from shennong_tpu_torch.ops.postops import delta_scales
from shennong_tpu_torch.parallel.profiler import counters

_P, _INT = ctypes.c_void_p, ctypes.c_int

#: the kernel library, its entry point and its (restype, argtypes). It
#: keeps the interpreter lock over a call: a launch returns in
#: microseconds, and a released lock can take the switch interval (5 ms)
#: to come back while pass 1 runs Python on another thread
_KERNELS = native.Library(['csrc/pass_two.cu'], {
    'shennong_pass_two': (_INT, [
        _P, _INT, _P, _INT, _P, _P, _INT, _INT, _P, _P, _P, _INT, _INT, _INT,
        _INT, _INT, _P, _P, _P]),
}, errors='shennong_pass_two_error_string', hold_gil=True)

#: frames a tile (a block) of the kernel owns, at most
TILE_ROWS = 64

_lock = threading.Lock()
_streams = {}


#: the packed segments, in their order in the packed bytes: the
#: features [N, D] (float32 or float64), the pitch [R, P] in the
#: output's dtype (P may be 0), each utterance's (feat_off, frames,
#: out_off, rows, affine row) [U, 5] int64, the tiles' offsets [U + 1]
#: int32, the CMVN scale and offset [G, D] float64 and the delta scales
#: float32
SEGMENTS = ('feats', 'pitch', 'layout', 'tile_off', 'scale', 'offset',
            'coeffs')

#: the torch dtype of each numpy dtype of a packed segment
_TORCH = {np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64,
          np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}


@dataclasses.dataclass
class Packed:
    """A packed group on its device (:func:`pack`): one buffer of bytes
    holding :data:`SEGMENTS`, each on 16 bytes."""

    device: torch.device
    buffer: torch.Tensor       # the packed bytes on the device
    host: torch.Tensor         # the same bytes on the host
    segments: dict             # name -> (byte offset, shape, numpy dtype)
    cmvn: bool
    order: int                 # None without deltas
    window: int
    tiles: int                 # blocks of a launch

    def shape(self, name):
        return self.segments[name][1]

    def present(self, name):
        """Whether segment ``name`` takes part: the CMVN affine only with
        CMVN, the delta scales only with deltas."""
        return {'scale': self.cmvn, 'offset': self.cmvn,
                'coeffs': self.order is not None}.get(name, True)

    def tensor(self, name):
        """Segment ``name`` as a tensor on the device, or None where it
        takes no part."""
        if not self.present(name):
            return None
        start, shape, dtype = self.segments[name]
        size = int(np.prod(shape)) * dtype.itemsize
        return self.buffer[start:start + size].view(_TORCH[dtype]).view(
            shape)

    def pointer(self, name):
        """The device address of segment ``name``, or None where it takes
        no part."""
        if not self.present(name):
            return None
        return self.buffer.data_ptr() + self.segments[name][0]


def pack(features, pitches, rows, affine_rows, affine, delta, *, device):
    """Pack a group for :func:`compute` on ``device``.

    ``features``: [T_i, D] float32 or float64 arrays; ``pitches``: [T'_i,
    P] arrays with at least ``rows[i]`` frames, or None; ``rows``: each
    utterance's output rows (at most T_i); ``affine``: None, or the CMVN
    ``(scale, offset)`` [G, D] float64 and ``affine_rows`` each
    utterance's row of them; ``delta``: None, or ``(order, window)``.
    The output's dtype is the features' (widened to the pitch's). On a
    CUDA device the packed bytes are page-locked and uploaded at once,
    asynchronously, on pass 2's stream.
    """
    device = torch.device(device)
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no pass-2 kernel for device {device}')
    in_dtype = features[0].dtype
    if in_dtype not in (np.float32, np.float64):
        raise ValueError(
            f'pass 2 takes float32 or float64 features, not {in_dtype}')
    out_dtype = (in_dtype if pitches is None
                 else np.result_type(in_dtype, pitches[0].dtype))
    ndim = features[0].shape[1]
    npitch = 0 if pitches is None else pitches[0].shape[1]
    frames = np.array([len(data) for data in features], dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    order, window = delta if delta is not None else (None, None)
    arrays = {
        'layout': np.zeros((len(features), 5), dtype=np.int64),
        'tile_off': np.zeros(len(features) + 1, dtype=np.int32),
        'scale': affine[0] if affine is not None else np.zeros((0, ndim)),
        'offset': affine[1] if affine is not None else np.zeros((0, ndim)),
        'coeffs': (np.concatenate(delta_scales(order, window))
                   if delta is not None else np.zeros(0, np.float32))}
    layout = arrays['layout']
    layout[1:, 0] = np.cumsum(frames)[:-1]
    layout[:, 1] = frames
    layout[1:, 2] = np.cumsum(rows)[:-1]
    layout[:, 3] = rows
    if affine is not None:
        layout[:, 4] = affine_rows
    arrays['tile_off'][1:] = np.cumsum(-(-frames // TILE_ROWS))

    shapes = {'feats': ((int(frames.sum()), ndim), np.dtype(in_dtype)),
              'pitch': ((int(rows.sum()), npitch), np.dtype(out_dtype))}
    shapes.update((name, (array.shape, array.dtype))
                  for name, array in arrays.items())
    segments, total = {}, 0
    for name in SEGMENTS:
        shape, dtype = shapes[name]
        segments[name] = (total, shape, dtype)
        total += -(-int(np.prod(shape)) * dtype.itemsize // 16) * 16
    host = torch.empty(max(total, 16), dtype=torch.uint8,
                       pin_memory=device.type == 'cuda')
    raw = host.numpy()

    def view(name):
        start, shape, dtype = segments[name]
        return raw[start:start + int(np.prod(shape)) * dtype.itemsize].view(
            dtype).reshape(shape)

    np.concatenate(features, out=view('feats'))
    if pitches is not None:
        np.concatenate([pitch[:count] for pitch, count in zip(pitches, rows)],
                       out=view('pitch'))
    for name, array in arrays.items():
        view(name)[...] = array

    buffer = host
    if device.type == 'cuda':
        with torch.cuda.stream(_stream(device)):
            buffer = host.to(device, non_blocking=True)
    return Packed(
        device=device, buffer=buffer, host=host, segments=segments,
        cmvn=affine is not None, order=order, window=window,
        tiles=int(arrays['tile_off'][-1]))


def compute(packed):
    """The packed group's output rows [R, (order + 1) D + P] as a numpy
    array on the host, and the count of its non-finite CMVN values
    (0 without CMVN): :func:`pass_two_plain` on the CPU, one launch of
    the kernel on a CUDA device."""
    if packed.device.type == 'cpu':
        out, nonfinite = pass_two_plain(
            *[packed.tensor(name) for name in (
                'feats', 'pitch', 'layout', 'scale', 'offset')],
            packed.order, packed.window)
        return out.numpy(), nonfinite
    return _launch(packed)


def pass_two_plain(feats, pitch, layout, scale, offset, order, window):
    """The plain version of the kernel, on any device: ``feats`` [N, D],
    ``pitch`` [R, P] (the output's dtype, P may be 0), ``layout`` [U, 5]
    (feat_off, frames, out_off, rows, affine row; the utterances packed
    in order), the CMVN ``scale``, ``offset`` [G, D] float64 or None,
    the delta ``order`` and ``window`` or None. Returns (rows [R, C],
    the count of non-finite CMVN values)."""
    device = feats.device
    nfeats = feats.shape[0]
    feat_off, frames, _, rows, group = layout.unbind(1)
    utt = torch.repeat_interleave(
        torch.arange(layout.shape[0], device=device), frames)
    frame = torch.arange(nfeats, device=device) - feat_off[utt]
    cmvn = feats.to(torch.float64)
    nonfinite = 0
    if scale is not None:
        cmvn = cmvn * scale[group[utt]] + offset[group[utt]]
        nonfinite = int((~torch.isfinite(cmvn.to(feats.dtype))).sum())
    if order is None:
        blocks = [cmvn.to(feats.dtype)]
    else:
        values = cmvn.to(torch.float32)
        first, last = feat_off[utt], feat_off[utt] + frames[utt] - 1
        blocks = []
        for k, coeffs in enumerate(delta_scales(order, window)):
            acc = None
            for j, coeff in enumerate(coeffs):
                taps = torch.minimum(torch.maximum(
                    first + frame + (j - k * window), first), last)
                term = values[taps] * torch.tensor(coeff, device=device)
                acc = term if acc is None else acc + term
            blocks.append(acc)
    keep = frame < rows[utt]
    return torch.cat(
        [block[keep].to(pitch.dtype) for block in blocks] + [pitch],
        dim=1), nonfinite


def _stream(device):
    """Pass 2's own stream on a CUDA ``device``."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    with _lock:
        if index not in _streams:
            _streams[index] = torch.cuda.Stream(torch.device('cuda', index))
        return _streams[index]


def _launch(packed):
    """One launch of the kernel over ``packed`` on pass 2's stream, its
    output and count downloaded into pageable memory (the host waits
    for that stream alone)."""
    lib = _KERNELS.load()
    device = packed.device
    nrows, npitch = packed.shape('pitch')
    ndim = packed.shape('feats')[1]
    order = packed.order if packed.order is not None else 0
    ncols = (order + 1) * ndim + npitch
    dtype = packed.segments['pitch'][2]
    nbytes = -(-nrows * ncols * dtype.itemsize // 8) * 8
    stream = _stream(device)
    with torch.cuda.stream(stream):
        out = torch.empty(nbytes + 8, dtype=torch.uint8, device=device)
        code = lib.shennong_pass_two(
            packed.pointer('feats'),
            int(packed.segments['feats'][2] == np.float64),
            packed.pointer('pitch'), int(dtype == np.float64),
            packed.pointer('layout'), packed.pointer('tile_off'),
            packed.shape('layout')[0], packed.tiles, packed.pointer('scale'),
            packed.pointer('offset'), packed.pointer('coeffs'), ndim, npitch,
            order, packed.window or 0, TILE_ROWS, out.data_ptr(),
            out.data_ptr() + nbytes, stream.cuda_stream)
        _KERNELS.check(code, 'pass_two')
        if packed.tiles:
            counters.add('launches.pass_two')
        host = np.empty(nbytes + 8, dtype=np.uint8)
        torch.from_numpy(host).copy_(out)
    rows = host[:nrows * ncols * dtype.itemsize].view(dtype)
    return rows.reshape(nrows, ncols), int(host[nbytes:].view(np.uint64)[0])
