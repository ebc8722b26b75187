"""Pitch Viterbi lag selection: hand-written CUDA kernels and their
plain PyTorch versions.

Counterpart of :mod:`shennong_tpu.ops.pallas_viterbi`. The forward
min-plus recursion and the reverse argmin backtrace run as two CUDA
kernels (``csrc/viterbi.cu``, built for ``sm_90a`` with ``nvcc`` at
first use into ``_build/`` and bound through a plain C interface with
ctypes). The forward runs each batch row on a cluster of blocks
(:func:`cluster_size`), the backtrace walks each row with a ring of
prefetched history rows; both read the penalty from a mirrored table
that holds :func:`transition_penalty`'s values. Each kernel has a
plain PyTorch version here, with the same arithmetic and rounding.

Dispatch goes by the device of the input tensor: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (or raises), any
other device raises. Nothing falls back from the kernel to the plain
version. Every kernel launch adds one to :data:`LAUNCHES`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(os.path.dirname(_HERE), 'csrc', 'viterbi.cu')
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), '_build')

#: nvcc flags: Hopper (sm_90a) code, and no contraction of a multiply
#: and an add into an FMA (the kernels round like the reference)
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-fmad=false', '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC')

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {'viterbi_forward': 0, 'viterbi_backtrace': 0}

_lock = threading.Lock()
_library = None


def reset_launches():
    """Set every kernel launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    return os.path.join(home, 'bin', 'nvcc')


def library_path(source=_SOURCE):
    """``_build/lib<name>-<digest>.so``: where :func:`build` puts the
    library of a CUDA source of ``csrc/`` (the digest covers the source
    and the nvcc flags)."""
    with open(source, 'rb') as fp:
        digest = hashlib.sha1(
            fp.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(_BUILD_DIR, f'lib{name}-{digest}.so')


def build(source=_SOURCE, fresh=False):
    """Compile a CUDA source of ``csrc/`` (``csrc/viterbi.cu`` by
    default) into ``_build/lib<name>-<digest>.so``, once per source
    content, or again when ``fresh``.

    Returns ``(library_path, compiler_log)``; the log is empty when an
    up-to-date library was already there. Raises RuntimeError with
    nvcc's output when the build fails.
    """
    target = library_path(source)
    if os.path.isfile(target) and not fresh:
        return target, ''
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build under a private name, then rename: concurrent builds
    # never load a half-written library
    handle, partial = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
    os.close(handle)
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, '-o', partial, source],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(partial)
        raise RuntimeError(
            f'nvcc failed to build {source} (exit {proc.returncode}):\n'
            + log)
    os.replace(partial, target)
    return target, log


def _load():
    """The ctypes handle of the kernel library, built at first use."""
    global _library
    with _lock:
        if _library is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            pointers = [ctypes.c_void_p] * 3
            sizes = [ctypes.c_int] * 3
            lib.shennong_viterbi_forward.restype = ctypes.c_int
            lib.shennong_viterbi_forward.argtypes = [
                *pointers, *sizes, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p]
            lib.shennong_viterbi_backtrace.restype = ctypes.c_int
            lib.shennong_viterbi_backtrace.argtypes = [
                *pointers, *sizes, ctypes.c_float, ctypes.c_void_p]
            lib.shennong_viterbi_forward_plan.restype = None
            lib.shennong_viterbi_forward_plan.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.shennong_viterbi_forward_max_clusters.restype = ctypes.c_int
            lib.shennong_viterbi_forward_max_clusters.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.shennong_viterbi_backtrace_smem.restype = ctypes.c_size_t
            lib.shennong_viterbi_backtrace_smem.argtypes = [ctypes.c_int]
            lib.shennong_cuda_error_string.restype = ctypes.c_char_p
            lib.shennong_cuda_error_string.argtypes = [ctypes.c_int]
            _library = lib
    return _library


def _factor32(inter_frame_factor):
    """The transition factor rounded to the float32 the reference
    multiplies by (a weak-typed Python float meets float32 arrays in
    JAX), as a Python float that holds that value exactly."""
    return float(np.float32(inter_frame_factor))


def _check(name, tensor, dtype, ndim, device):
    if tensor.dtype != dtype:
        raise ValueError(f'{name} must be {dtype}, it is {tensor.dtype}')
    if tensor.ndim != ndim:
        raise ValueError(
            f'{name} must have {ndim} dimensions, it has {tensor.ndim}')
    if tensor.device != device:
        raise ValueError(
            f'{name} is on {tensor.device}, expected {device}')


def _raise_on_error(lib, code, what):
    if code != 0:
        raise RuntimeError(
            f'{what} kernel launch failed: CUDA error {code} '
            f'({lib.shennong_cuda_error_string(code).decode()})')


# ------------------------------------------------------------- penalty

def transition_penalty(nlags, inter_frame_factor, device='cpu'):
    """The plain versions' [L, L] float32 penalty of a step from lag i
    to lag j, ``(i - j)^2 * factor`` rounded as the reference rounds
    it."""
    idx = torch.arange(nlags, device=device)
    return ((idx[:, None] - idx[None, :]).to(torch.float32) ** 2
            * _factor32(inter_frame_factor))


# ------------------------------------------------------------- forward

#: largest cluster the forward kernel launches (non-portable past 8)
MAX_CLUSTER = 16


def cluster_size(batch, nlags, sm_count, max_clusters):
    """Blocks per row of the forward kernel (the size of its cluster).

    The largest C <= :data:`MAX_CLUSTER` with C <= nlags (every block
    owns a lag), batch * C <= sm_count (one wave, one block per SM),
    and room on the card for ``batch`` clusters of C at once
    (``max_clusters(C)``, from ``cudaOccupancyMaxActiveClusters``); 1
    when no larger size qualifies.
    """
    for size in range(min(MAX_CLUSTER, nlags), 1, -1):
        if batch * size <= sm_count and max_clusters(size) >= batch:
            return size
    return 1


def viterbi_forward_plain(local_cost, nframes, inter_frame_factor):
    """Forward min-plus recursion as a Python loop over frames.

    ``local_cost`` [B, F, L] float32, ``nframes`` [B] int32; returns
    the state after every frame, ``hist`` [F, B, L] float32 (rows pass
    their state through on frames at or past ``nframes``).
    """
    bsz, maxframes, nlags = local_cost.shape
    penalty = transition_penalty(
        nlags, inter_frame_factor, local_cost.device)
    hist = local_cost.new_empty((maxframes, bsz, nlags))
    if maxframes == 0:
        return hist

    fwd = local_cost[:, 0]
    fwd = fwd - fwd.min(dim=1, keepdim=True).values
    hist[0] = fwd
    for f in range(1, maxframes):
        total = fwd[:, None, :] + penalty[None, :, :]  # [B, Lc, Lp]
        new = local_cost[:, f] + total.min(dim=2).values
        new = new - new.min(dim=1, keepdim=True).values
        fwd = torch.where((f < nframes)[:, None], new, fwd)
        hist[f] = fwd
    return hist


def forward_plan(bsz, nlags, device):
    """How the forward kernel runs [bsz, F, nlags] on ``device``: a dict
    of the cluster size C, threads per block, lags per lane R and
    dynamic shared memory in bytes (cached)."""
    device = torch.device(device)
    key = (device.index, bsz, nlags)
    if key not in _plans:
        lib = _load()

        def max_clusters(size):
            count = ctypes.c_int()
            with torch.cuda.device(device):
                code = lib.shennong_viterbi_forward_max_clusters(
                    nlags, size, ctypes.byref(count))
            _raise_on_error(lib, code, 'viterbi_forward occupancy')
            return count.value

        sms = torch.cuda.get_device_properties(device).multi_processor_count
        clusters = cluster_size(bsz, nlags, sms, max_clusters)
        threads, lanes, smem = ctypes.c_int(), ctypes.c_int(), \
            ctypes.c_size_t()
        lib.shennong_viterbi_forward_plan(
            nlags, clusters, ctypes.byref(threads), ctypes.byref(lanes),
            ctypes.byref(smem))
        _plans[key] = {'clusters': clusters, 'threads': threads.value,
                       'lanes_lags': lanes.value, 'smem': smem.value}
    return _plans[key]


_plans = {}


def viterbi_forward(local_cost, nframes, inter_frame_factor):
    """Forward recursion: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Same contract as
    :func:`viterbi_forward_plain`."""
    device = local_cost.device
    _check('local_cost', local_cost, torch.float32, 3, device)
    _check('nframes', nframes, torch.int32, 1, device)
    bsz, maxframes, nlags = local_cost.shape
    if nframes.shape[0] != bsz:
        raise ValueError(
            f'nframes has {nframes.shape[0]} rows, local_cost {bsz}')
    if device.type == 'cpu':
        return viterbi_forward_plain(local_cost, nframes, inter_frame_factor)
    if device.type != 'cuda':
        raise ValueError(f'no Viterbi kernel for device {device}')
    if not (local_cost.is_contiguous() and nframes.is_contiguous()):
        raise ValueError('local_cost and nframes must be contiguous')
    if nlags < 1:
        raise ValueError('local_cost needs at least one lag')

    hist = torch.empty(
        (maxframes, bsz, nlags), dtype=torch.float32, device=device)
    if bsz == 0 or maxframes == 0:
        return hist
    plan = forward_plan(bsz, nlags, device)
    if plan['smem'] > 227 * 1024:
        raise ValueError(f'{nlags} lags exceed the shared memory of a block')
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.shennong_viterbi_forward(
            local_cost.data_ptr(), nframes.data_ptr(), hist.data_ptr(),
            bsz, maxframes, nlags, _factor32(inter_frame_factor),
            plan['clusters'], stream)
    _raise_on_error(lib, code, 'viterbi_forward')
    LAUNCHES['viterbi_forward'] += 1
    return hist


# ----------------------------------------------------------- backtrace

def viterbi_backtrace_plain(hist, nframes, inter_frame_factor):
    """Reverse argmin over the forward history as a Python loop.

    ``hist`` [F, B, L] float32, ``nframes`` [B] int32; returns the
    best lag index per frame [F, B] int32 (ties to the lowest index).
    """
    maxframes, bsz, nlags = hist.shape
    best = torch.empty((maxframes, bsz), dtype=torch.int32,
                       device=hist.device)
    if maxframes == 0:
        return best
    penalty = transition_penalty(nlags, inter_frame_factor, hist.device)
    current = hist[maxframes - 1].argmin(dim=1)
    best[maxframes - 1] = current
    for t in range(maxframes - 2, -1, -1):
        scores = hist[t] + penalty[current]
        current = torch.where(
            t + 1 < nframes, scores.argmin(dim=1), current)
        best[t] = current
    return best


def viterbi_backtrace(hist, nframes, inter_frame_factor):
    """Backtrace: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Same contract as :func:`viterbi_backtrace_plain`."""
    device = hist.device
    _check('hist', hist, torch.float32, 3, device)
    _check('nframes', nframes, torch.int32, 1, device)
    maxframes, bsz, nlags = hist.shape
    if nframes.shape[0] != bsz:
        raise ValueError(f'nframes has {nframes.shape[0]} rows, hist {bsz}')
    if device.type == 'cpu':
        return viterbi_backtrace_plain(hist, nframes, inter_frame_factor)
    if device.type != 'cuda':
        raise ValueError(f'no Viterbi kernel for device {device}')
    if not (hist.is_contiguous() and nframes.is_contiguous()):
        raise ValueError('hist and nframes must be contiguous')
    if nlags < 1:
        raise ValueError('hist needs at least one lag')

    best = torch.empty((maxframes, bsz), dtype=torch.int32, device=device)
    if bsz == 0 or maxframes == 0:
        return best
    lib = _load()
    if lib.shennong_viterbi_backtrace_smem(nlags) > 227 * 1024:
        raise ValueError(f'{nlags} lags exceed the shared memory of a block')
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.shennong_viterbi_backtrace(
            hist.data_ptr(), nframes.data_ptr(), best.data_ptr(),
            bsz, maxframes, nlags, _factor32(inter_frame_factor), stream)
    _raise_on_error(lib, code, 'viterbi_backtrace')
    LAUNCHES['viterbi_backtrace'] += 1
    return best


# ---------------------------------------------------------------- lags

def viterbi_lags_plain(local_cost, inter_frame_factor, nframes):
    """Best lag index per frame [B, F] int32 through the plain
    versions (the counterpart of ``shennong_tpu.ops.pitch._viterbi_lags``)."""
    hist = viterbi_forward_plain(local_cost, nframes, inter_frame_factor)
    return viterbi_backtrace_plain(
        hist, nframes, inter_frame_factor).T.contiguous()


def viterbi_lags(local_cost, inter_frame_factor, nframes):
    """Best lag index per frame [B, F] int32, dispatched by device:
    the forward and backtrace kernels on CUDA, the plain versions on
    the CPU (the counterpart of ``viterbi_lags_pallas``)."""
    local_cost = local_cost.contiguous()
    nframes = nframes.to(torch.int32).contiguous()
    hist = viterbi_forward(local_cost, nframes, inter_frame_factor)
    return viterbi_backtrace(
        hist, nframes, inter_frame_factor).T.contiguous()
