"""Log-domain Viterbi decoding: float64 host decoders, a dense generic
decoder, and the batched banded decoder of the CREPE device decode.

Counterpart of :mod:`shennong_tpu.ops.viterbi`. The host decoders
(:func:`viterbi_host`, :func:`viterbi_host_banded`,
:func:`viterbi_host_banded_obs`) run in float64 on the port's native
C++ kernel (``native/shennong_viterbi.cpp``) and fall back to numpy,
bit-equal either way. :func:`viterbi_banded_obs_batch` decodes a whole
slice of rows on the device in float32: a CPU tensor takes its plain
PyTorch version (a Python loop over frames), a CUDA tensor launches the
hand-written kernel ``csrc/banded_viterbi.cu`` (a
:class:`~shennong_tpu_torch.native.Library`, built at first use) or
raises. Every kernel launch adds one to
``counters['launches.banded_viterbi']``
(:mod:`shennong_tpu_torch.parallel.profiler`).
"""

import ctypes

import numpy as np
import torch

from shennong_tpu_torch import native
from shennong_tpu_torch.parallel.profiler import counters

#: the score outside the state range (the JAX package's padding value)
_PAD = -3e38

_P, _INT = ctypes.c_void_p, ctypes.c_int
_OUT_INT, _OUT_SIZE = ctypes.POINTER(_INT), ctypes.POINTER(ctypes.c_size_t)

#: the kernel library, its entry points and their (restype, argtypes)
_KERNELS = native.Library(['csrc/banded_viterbi.cu'], {
    'shennong_banded_viterbi': (_INT, [
        _P, _P, _P, _P, ctypes.c_float, ctypes.c_float, _INT, _INT, _INT,
        _INT, _INT, _P, _P, _INT, _P]),
    'shennong_banded_viterbi_plan': (_INT, [
        _INT, _INT, _INT, _INT, _INT, _OUT_INT, _OUT_INT, _OUT_INT,
        _OUT_SIZE, _OUT_SIZE]),
}, errors='shennong_banded_error_string')


# ------------------------------------------------------- host, float64

def viterbi_host(log_start, log_trans, log_obs):
    """Float64 host Viterbi, the dense decoder of the CREPE paths.

    ``log_start`` [S], ``log_trans`` [S, S] (from, to), ``log_obs``
    [T, S]; returns the [T] int64 most likely state path. Ties go to
    the first maximum, as hmmlearn's decoder breaks them.
    """
    log_trans = np.asarray(log_trans, dtype=np.float64)
    log_obs = np.asarray(log_obs, dtype=np.float64)
    nframes, nstates = log_obs.shape
    score = np.asarray(log_start, dtype=np.float64) + log_obs[0]
    backptr = np.zeros((nframes, nstates), dtype=np.int64)
    for t in range(1, nframes):
        total = score[:, None] + log_trans  # [from, to]
        backptr[t] = np.argmax(total, axis=0)
        score = total[backptr[t], np.arange(nstates)] + log_obs[t]
    path = np.zeros(nframes, dtype=np.int64)
    path[-1] = np.argmax(score)
    for t in range(nframes - 2, -1, -1):
        path[t] = backptr[t + 1][path[t + 1]]
    return path


def _band_matrix(log_trans, halfwidth):
    """[S, 2*halfwidth+1] band of ``log_trans``:
    band[j, d] = log_trans[j - halfwidth + d, j], -inf outside."""
    nstates = log_trans.shape[0]
    width = 2 * halfwidth + 1
    j = np.arange(nstates)
    src = j[:, None] - halfwidth + np.arange(width)[None, :]
    valid = (src >= 0) & (src < nstates)
    band = np.full((nstates, width), -np.inf)
    band[valid] = log_trans[
        src[valid], np.broadcast_to(j[:, None], src.shape)[valid]]
    return band


def viterbi_host_banded_obs(log_start, log_trans, observations,
                            uniform_weight, self_weight, halfwidth,
                            band=None):
    """:func:`viterbi_host_banded` for two-valued observation models.

    State j at frame t weighs ``self_weight`` when
    ``j == observations[t]`` and ``uniform_weight`` otherwise (the
    CREPE smoothing prior): the native kernel never builds the dense
    [T, S] observation matrix, the numpy fallback does. ``band``
    optionally passes a precomputed ``_band_matrix(log_trans,
    halfwidth)``.
    """
    from shennong_tpu_torch import native

    log_trans = np.asarray(log_trans, dtype=np.float64)
    nstates = log_trans.shape[0]
    observations = np.asarray(observations)
    if observations.shape[0] > 1:
        if band is None:
            band = _band_matrix(log_trans, halfwidth)
        path = native.viterbi_banded_two(
            np.asarray(log_start, dtype=np.float64), band,
            uniform_weight, self_weight, observations, nstates)
        if path is not None:
            return path
    log_obs = np.full((observations.shape[0], nstates), uniform_weight)
    log_obs[np.arange(observations.shape[0]), observations] = self_weight
    return viterbi_host_banded(log_start, log_trans, log_obs, halfwidth)


def viterbi_host_banded(log_start, log_trans, log_obs, halfwidth):
    """:func:`viterbi_host` for banded transition matrices.

    Bit-equal to the dense decoder when ``log_trans[i, j]`` is -inf
    for ``|i - j| > halfwidth``: the in-band candidates are scanned in
    the same ascending source order, so the tie-breaks agree.
    """
    from shennong_tpu_torch import native

    log_trans = np.asarray(log_trans, dtype=np.float64)
    log_obs = np.asarray(log_obs, dtype=np.float64)
    nframes, nstates = log_obs.shape
    band = _band_matrix(log_trans, halfwidth)

    if nframes > 1:
        # the native kernel performs the same float64 operations
        path = native.viterbi_banded(log_start, band, log_obs)
        if path is not None:
            return path

    j = np.arange(nstates)
    score = np.asarray(log_start, dtype=np.float64) + log_obs[0]
    # int16: the band-relative pointer spans [0, 2 * halfwidth], and
    # int8 would wrap for halfwidth >= 64 (the native kernel refuses
    # such widths and lands here)
    backptr = np.zeros((nframes, nstates), dtype=np.int16)
    padded = np.full(nstates + 2 * halfwidth, -np.inf)
    window = np.lib.stride_tricks.as_strided(
        padded, shape=(nstates, 2 * halfwidth + 1),
        strides=(padded.itemsize, padded.itemsize))
    for t in range(1, nframes):
        padded[halfwidth:halfwidth + nstates] = score
        total = window + band  # [to, width]
        rel = np.argmax(total, axis=1)
        backptr[t] = rel
        score = total[j, rel] + log_obs[t]
    path = np.zeros(nframes, dtype=np.int64)
    path[-1] = np.argmax(score)
    for t in range(nframes - 2, -1, -1):
        path[t] = path[t + 1] - halfwidth + backptr[t + 1][path[t + 1]]
    return path


# ------------------------------------------------ dense, on the device

def viterbi(log_start, log_trans, log_obs):
    """Most likely state path of an HMM, on the tensors' device.

    ``log_start`` [S], ``log_trans`` [S, S] (from, to), ``log_obs``
    [T, S] tensors; returns the [T] int32 path. The scores are
    renormalized to a maximum of 0 at every frame, as the JAX
    package's scan does.
    """
    def normalized(score):
        return score - score.max()

    score = normalized(log_start + log_obs[0])
    backptrs = []
    for t in range(1, log_obs.shape[0]):
        total = score[:, None] + log_trans  # [from, to]
        best, backptr = total.max(dim=0)
        backptrs.append(backptr)
        score = normalized(log_obs[t] + best)
    path = torch.empty(log_obs.shape[0], dtype=torch.int32,
                       device=log_obs.device)
    state = score.argmax()
    path[-1] = state
    for t in range(len(backptrs) - 1, -1, -1):
        state = backptrs[t][state]
        path[t] = state
    return path


# -------------------------------- banded two-valued, batched, float32

def _weights32(uniform_weight, self_weight):
    """The uniform weight and the self gain (self - uniform) rounded
    as the JAX package rounds them: each weight to float32, then one
    float32 subtraction."""
    uniform = np.float32(uniform_weight)
    return float(uniform), float(np.float32(self_weight) - uniform)


def viterbi_banded_obs_batch_plain(log_start, band, uniform_weight,
                                   self_weight, observations, nframes,
                                   halfwidth):
    """The batched banded two-valued decode as a Python loop of tensor
    operations over frames (see :func:`viterbi_banded_obs_batch`).

    ``log_start`` [S] and ``band`` [S, W] float32 tensors on the
    device of ``observations`` [B, T] int32; ``nframes`` [B] int32.
    """
    uniform, gain = _weights32(uniform_weight, self_weight)
    bsz, maxframes = observations.shape
    states = torch.arange(band.shape[0], device=observations.device)

    def emit(score, obs_t):
        # two-valued observation: uniform everywhere, self at obs_t
        return (score + uniform) + gain * (
            states[None, :] == obs_t[:, None]).to(torch.float32)

    score = emit(log_start[None, :].expand(bsz, -1), observations[:, 0])
    backptrs = []
    for t in range(1, maxframes):
        padded = torch.nn.functional.pad(
            score, (halfwidth, halfwidth), value=_PAD)
        total = padded.unfold(1, 2 * halfwidth + 1, 1) + band[None]
        best, rel = total.max(dim=-1)
        new = emit(best, observations[:, t])
        # a per-row shift keeps long rows in float32 range and changes
        # no argmax
        new = new - new.max(dim=-1, keepdim=True).values
        keep = (t < nframes)[:, None]
        score = torch.where(keep, new, score)
        backptrs.append(torch.where(keep, rel, halfwidth))

    paths = torch.empty((bsz, maxframes), dtype=torch.int32,
                        device=observations.device)
    state = score.argmax(dim=-1)
    paths[:, -1] = state
    for t in range(maxframes - 2, -1, -1):
        # frozen frames stored identity (rel = halfwidth): the
        # backtrace walks through the padding unchanged
        state = state - halfwidth + backptrs[t].gather(
            1, state[:, None])[:, 0]
        paths[:, t] = state
    return paths


def banded_plan(bsz, maxframes, nstates, width, states_per_thread=0):
    """The kernel's launch for ``bsz`` rows of ``maxframes`` frames,
    ``nstates`` states and a band of ``width``, with
    ``states_per_thread`` states a thread (0: the kernel's default): a
    dict of ``states`` (a thread's), ``threads`` (a block's), ``tile``
    (frames of a back-pointer tile in shared memory), ``smem`` (bytes)
    and ``spill`` (bytes of device scratch for the tiles a long row
    moves out of shared memory). Raises ValueError for a shape the
    kernel does not take."""
    lib = _KERNELS.load()
    states, threads, tile = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem, spill = ctypes.c_size_t(), ctypes.c_size_t()
    code = lib.shennong_banded_viterbi_plan(
        bsz, maxframes, nstates, width, states_per_thread,
        ctypes.byref(states), ctypes.byref(threads), ctypes.byref(tile),
        ctypes.byref(smem), ctypes.byref(spill))
    if code != 0:
        raise ValueError(
            f'the banded Viterbi kernel takes no launch of {nstates} states, '
            f'a band of {width} and {states_per_thread} states a thread')
    return {'states': states.value, 'threads': threads.value,
            'tile': tile.value, 'smem': smem.value, 'spill': spill.value}


def launch_banded(log_start, band, uniform, gain, observations, nframes,
                  paths, states_per_thread=0, forward_only=False):
    """One launch of the kernel on contiguous CUDA tensors (float32
    ``log_start`` and ``band``, int32 ``observations``, ``nframes`` and
    ``paths``) with the weights already rounded (:func:`_weights32`);
    ``forward_only`` stops before the argmax and the backtrace (for a
    timing split). Counts nothing: :func:`viterbi_banded_obs_batch`
    counts its launches."""
    lib = _KERNELS.load()
    bsz, maxframes = observations.shape
    nstates, width = band.shape
    plan = banded_plan(bsz, maxframes, nstates, width, states_per_thread)
    device = observations.device
    spill = torch.empty(plan['spill'], dtype=torch.int8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.shennong_banded_viterbi(
            observations.data_ptr(), nframes.data_ptr(),
            log_start.data_ptr(), band.data_ptr(), uniform, gain, bsz,
            maxframes, nstates, width, states_per_thread,
            spill.data_ptr() if plan['spill'] else None, paths.data_ptr(),
            int(forward_only), stream)
    _KERNELS.check(code, 'banded_viterbi')


def viterbi_banded_obs_batch(log_start, band, uniform_weight, self_weight,
                             observations, nframes, halfwidth):
    """Batched banded two-valued Viterbi on the device (float32).

    The device twin of :func:`viterbi_host_banded_obs` for a whole
    slice of rows: ``observations`` [B, T] int32 holds each row's
    per-frame argmax bin, ``nframes`` [B] its real length. Rows decode
    exactly their first ``nframes`` frames: past a row's length the
    scores freeze and the back-pointers are identity. ``log_start``
    [S] and ``band`` [S, 2*halfwidth+1] (numpy or tensors) and the two
    weights are rounded to float32. Returns the [B, T] int32 state
    paths, on the device of ``observations``, each row past its
    ``nframes`` holding its last state.

    A CPU tensor takes :func:`viterbi_banded_obs_batch_plain`; a CUDA
    tensor launches ``csrc/banded_viterbi.cu``, which computes the
    same float32 operations bit for bit, or raises. Float32 scores may
    resolve near-ties differently from the float64 host decode.
    """
    if not torch.is_tensor(observations):
        raise TypeError(
            'observations must be a [B, T] int32 torch.Tensor, it is a '
            f'{type(observations).__module__}.{type(observations).__name__}'
            f' of shape {tuple(np.shape(observations))}')
    device = observations.device
    if observations.dtype != torch.int32 or observations.ndim != 2:
        raise ValueError(
            f'observations must be [B, T] int32, it is {observations.dtype} '
            f'of shape {tuple(observations.shape)}')
    bsz, maxframes = observations.shape
    nframes = torch.as_tensor(nframes, device=device).to(torch.int32)
    if nframes.shape != (bsz,):
        raise ValueError(
            f'nframes has shape {tuple(nframes.shape)}, expected ({bsz},)')
    log_start = torch.as_tensor(
        np.asarray(log_start, dtype=np.float32) if not torch.is_tensor(
            log_start) else log_start, device=device).to(torch.float32)
    band = torch.as_tensor(
        np.asarray(band, dtype=np.float32) if not torch.is_tensor(band)
        else band, device=device).to(torch.float32)
    nstates, width = band.shape
    if width != 2 * halfwidth + 1 or log_start.shape != (nstates,):
        raise ValueError(
            f'band {tuple(band.shape)} and log_start '
            f'{tuple(log_start.shape)} do not match halfwidth {halfwidth}')
    if maxframes == 0 or bsz == 0:
        return torch.zeros((bsz, maxframes), dtype=torch.int32,
                           device=device)
    if device.type == 'cpu':
        return viterbi_banded_obs_batch_plain(
            log_start, band, uniform_weight, self_weight, observations,
            nframes, halfwidth)
    if device.type != 'cuda':
        raise ValueError(f'no banded Viterbi kernel for device {device}')
    if nstates > 1024 or width > 127:
        raise ValueError(
            f'the kernel takes at most 1024 states and a band of 127, '
            f'not {nstates} and {width}')

    uniform, gain = _weights32(uniform_weight, self_weight)
    paths = torch.empty((bsz, maxframes), dtype=torch.int32, device=device)
    launch_banded(log_start.contiguous(), band.contiguous(), uniform, gain,
                  observations.contiguous(), nframes.contiguous(), paths)
    counters.add('launches.banded_viterbi')
    return paths
