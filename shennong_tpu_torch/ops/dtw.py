"""DTW divergences normalized by the realized path length: a
hand-written CUDA kernel and its plain PyTorch version.

Counterpart of the recursion inside
:func:`shennong_tpu.eval.abx.dtw_divergences`, which is a ``lax.scan``
over rows with an ``associative_scan`` inside each row, not a Pallas
kernel. Given frame-to-frame costs [B, Ta, Tb] and the valid frame
counts of both sides, each pair's divergence is the cost of its best
DTW path (steps right, down, diagonal) from (0, 0) to (nx-1, ny-1)
divided by the number of cells on that path; of two paths of equal
cost the shorter wins (lexicographic ``(cost, length)`` minimum).

:func:`dtw_divergences` dispatches by the device of ``costs``: a CPU
tensor takes :func:`dtw_divergences_plain`, the JAX package's row
formulation written with PyTorch tensors; a CUDA tensor launches
``csrc/dtw.cu`` (built with ``nvcc`` at first use into ``_build/``,
bound through a plain C interface with ctypes) or raises. Every kernel
launch adds one to :data:`LAUNCHES`.

The two add in different orders (the plain version through row sums,
the kernel cell by cell), so on real-valued costs they differ by a few
float32 ulps; on integer-valued costs every sum is exact and they are
equal.
"""

import ctypes
import math
import os
import threading

import torch
import torch.nn.functional as F

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'csrc', 'dtw.cu')

#: rows of a pair one kernel strip covers (one warp, a row per lane):
#: pairs with more rows pass each strip's last row to the next through
#: a global scratch row
STRIP_ROWS = 32

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {'dtw': 0}

_lock = threading.Lock()
_library = None


def reset_launches():
    """Set every kernel launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lexmin(cost_a, len_a, cost_b, len_b):
    """Elementwise lexicographic ``(cost, length)`` minimum."""
    take_a = (cost_a < cost_b) | ((cost_a == cost_b) & (len_a <= len_b))
    return torch.where(take_a, cost_a, cost_b), torch.where(
        take_a, len_a, len_b)


def _shift_right(values, by, fill):
    """``values`` [B, C] moved ``by`` columns right, ``fill`` entering."""
    return F.pad(values[:, :-by], (by, 0), value=fill)


def _cumulative_lexmin(cost, length):
    """Inclusive running lexicographic minimum along dim 1, as a
    Hillis-Steele scan of ceil(log2 C) steps. A minimum selects and
    never rounds, so any scan order gives the same result."""
    shift = 1
    while shift < cost.shape[1]:
        cost, length = _lexmin(
            _shift_right(cost, shift, math.inf),
            _shift_right(length, shift, 0.0), cost, length)
        shift *= 2
    return cost, length


def _counts(nx, ny, rows, cols, batch, device):
    """Both sides' frame counts as int32 tensors on ``device``, checked
    to lie in [1, rows] and [1, cols] (one check for both: a CUDA
    tensor waits for the device once)."""
    nx = torch.as_tensor(nx, device=device).to(torch.int32).contiguous()
    ny = torch.as_tensor(ny, device=device).to(torch.int32).contiguous()
    for counts in (nx, ny):
        if counts.shape != (batch,):
            raise ValueError(
                f'frame counts have shape {tuple(counts.shape)}, expected '
                f'({batch},)')
    outside = ((nx < 1) | (nx > rows)).any() | ((ny < 1) | (ny > cols)).any()
    if bool(outside):
        raise ValueError(
            f'frame counts must lie in [1, {rows}] and [1, {cols}]')
    return nx, ny


def dtw_divergences_plain(costs, nx, ny):
    """:func:`dtw_divergences` as a Python loop over rows of tensor
    operations, the JAX package's formulation: row ``i`` enters from
    row ``i-1`` vertically or diagonally (the lexicographic minimum of
    the two), then runs right, which is a running sum of the row's
    costs plus a cumulative lexicographic minimum of ``entry - sum
    before``. Lengths are float32, as there."""
    bsz, rows, cols = costs.shape
    device = costs.device
    nx, ny = _counts(nx, ny, rows, cols, bsz, device)
    col = torch.arange(cols, device=device, dtype=torch.float32)[None, :]
    end_col = (ny - 1).to(torch.int64)[:, None]

    def at_end(values):
        return values.gather(1, end_col)[:, 0]

    prev = torch.cumsum(costs[:, 0, :], dim=1)
    prev_len = (col + 1.0).expand(bsz, cols)
    end = torch.where(nx == 1, at_end(prev), math.inf)
    end_len = torch.where(nx == 1, at_end(prev_len), 1.0)
    for i in range(1, rows):
        entry, entry_len = _lexmin(
            prev, prev_len, _shift_right(prev, 1, math.inf),
            _shift_right(prev_len, 1, 0.0))
        total = torch.cumsum(costs[:, i, :], dim=1)
        before = _shift_right(total, 1, 0.0)
        best, best_len = _cumulative_lexmin(entry - before, entry_len - col)
        prev = total + best
        prev_len = best_len + 1.0 + col
        last = nx == i + 1
        end = torch.where(last, at_end(prev), end)
        end_len = torch.where(last, at_end(prev_len), end_len)
    return end / end_len


def _load():
    """The ctypes handle of the kernel library, built at first use."""
    global _library
    with _lock:
        if _library is None:
            from shennong_tpu_torch.ops.cuda_viterbi import build
            path, _ = build(_SOURCE)
            lib = ctypes.CDLL(path)
            pointer, size = ctypes.c_void_p, ctypes.c_int
            lib.shennong_dtw.restype = ctypes.c_int
            lib.shennong_dtw.argtypes = [
                pointer, pointer, pointer, size, size, size, pointer,
                pointer, pointer, pointer]
            lib.shennong_dtw_error_string.restype = ctypes.c_char_p
            lib.shennong_dtw_error_string.argtypes = [ctypes.c_int]
            _library = lib
    return _library


def dtw_divergences(costs, nx, ny):
    """Batched DTW divergences from frame costs.

    Parameters
    ----------
    costs : float32 tensor [B, Ta, Tb]
        Frame-to-frame costs of each pair; cells past a pair's counts
        are never read on a path.
    nx, ny : int tensors (or arrays) [B]
        Valid frame counts of each side, in [1, Ta] and [1, Tb]
        (a count outside raises ``ValueError``).

    Returns
    -------
    div : float32 tensor [B] on the device of ``costs``: the best path
        cost over the realized path length, ties in cost to the
        shortest path.

    A CPU tensor takes :func:`dtw_divergences_plain`; a CUDA tensor
    launches ``csrc/dtw.cu`` or raises.
    """
    if costs.dtype != torch.float32 or costs.ndim != 3:
        raise ValueError(
            f'costs must be [B, Ta, Tb] float32, it is {costs.dtype} of '
            f'shape {tuple(costs.shape)}')
    bsz, rows, cols = costs.shape
    device = costs.device
    if bsz == 0:
        return torch.zeros(0, dtype=torch.float32, device=device)
    if rows == 0 or cols == 0:
        raise ValueError(
            f'costs of shape {tuple(costs.shape)} hold no frame')
    if device.type == 'cpu':
        return dtw_divergences_plain(costs, nx, ny)
    if device.type != 'cuda':
        raise ValueError(f'no DTW kernel for device {device}')
    nx, ny = _counts(nx, ny, rows, cols, bsz, device)
    lib = _load()
    costs = costs.contiguous()
    # the last row of each strip passes to the next through this
    # scratch, two rows a pair (strips alternate); one strip needs none
    edge_rows = bsz if rows > STRIP_ROWS else 0
    edge_cost = torch.empty((edge_rows, 2, cols), dtype=torch.float32,
                            device=device)
    edge_len = torch.empty((edge_rows, 2, cols), dtype=torch.int32,
                           device=device)
    div = torch.empty(bsz, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.shennong_dtw(
            costs.data_ptr(), nx.data_ptr(), ny.data_ptr(), bsz, rows, cols,
            edge_cost.data_ptr(), edge_len.data_ptr(), div.data_ptr(),
            stream)
    if code != 0:
        raise RuntimeError(
            f'dtw kernel launch failed: CUDA error {code} '
            f'({lib.shennong_dtw_error_string(code).decode()})')
    LAUNCHES['dtw'] += 1
    return div
