"""The CREPE pitch CNN as a PyTorch module, and the device functions of
the CREPE processor.

Counterpart of :mod:`shennong_tpu.models.crepe`: six Conv-BN-MaxPool
blocks over 1024-sample frames followed by a 360-way sigmoid
classifier (:class:`Crepe`). Each block runs through
:func:`shennong_tpu_torch.ops.crepe_conv.conv_block`: on the card one
launch of a hand-written float32 CUDA kernel (padding, convolution,
ReLU, batch norm and pooling fused; no cuDNN, no tensor cores), on the
CPU the plain tensor chain. The classifier is a float32 ``Linear``
(the package turns TF32 off). The weights are the npz files the
JAX package converts from the published keras checkpoints, in the same
keras layout (``conv{i}/kernel`` [W, Cin, Cout], ...), under this
package's ``share/crepe/`` or at a path the caller gives;
:func:`shennong_tpu_torch.weights.crepe_from_numpy` turns such a dict
into a :class:`Crepe`.

:func:`forward_audio_chunk` frames, normalizes and classifies whole
segments of audio on the device; :func:`decode_salience_chunk` decodes
a slice's salience on the device, its banded Viterbi through the
hand-written kernel of :mod:`shennong_tpu_torch.ops.viterbi`.
"""

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from shennong_tpu_torch.ops.crepe_conv import Block, conv_block

CAPACITY_MULTIPLIER = {
    'tiny': 4, 'small': 8, 'medium': 16, 'large': 24, 'full': 32}

LAYER_FILTERS = (32, 4, 4, 4, 8, 16)
LAYER_WIDTHS = (512, 64, 64, 64, 64, 64)
LAYER_STRIDES = (4, 1, 1, 1, 1, 1)

_BN_EPSILON = 1e-3  # keras BatchNormalization default

#: the CNN's input frame length and output bins
FRAME = 1024
BINS = 360

SHARE_DIR = os.path.join(os.path.dirname(__file__), '..', 'share', 'crepe')

#: bytes of the first conv layer's activation one forward call may hold
#: (frames beyond it run in pieces)
ACTIVATION_BYTES = 2 ** 31


class Crepe(torch.nn.Module):
    """The CREPE CNN: [N, 1024] normalized frames -> [N, 360]
    activations (sigmoid outputs).

    ``channels`` are the six conv layers' output channels (32, 4, 4, 4,
    8, 16 times the capacity multiplier). Batch norm runs in inference
    mode as ``(x - mean) * (gamma * rsqrt(var + 1e-3)) + beta``, the
    JAX package's order; the convolutions pad as TensorFlow's 'SAME'
    does (the odd sample on the right).
    """

    def __init__(self, channels):
        super().__init__()
        self.channels = tuple(int(c) for c in channels)
        inputs = (1,) + self.channels[:-1]
        self.convs = torch.nn.ModuleList(
            torch.nn.Conv1d(cin, cout, width, stride=stride)
            for cin, cout, width, stride in zip(
                inputs, self.channels, LAYER_WIDTHS, LAYER_STRIDES))
        for i, cout in enumerate(self.channels):
            for name in ('mean', 'scale', 'beta'):
                self.register_buffer(f'bn{i}_{name}', torch.zeros(cout))
        self.classifier = torch.nn.Linear(4 * self.channels[-1], BINS)

    def set_batch_norm(self, layer, gamma, beta, mean, var):
        """Load one inference batch norm from its keras parameters (the
        scale computed in float32, as the JAX package does)."""
        gamma, beta, mean, var = (torch.tensor(np.asarray(v, np.float32))
                                  for v in (gamma, beta, mean, var))
        getattr(self, f'bn{layer}_scale').copy_(
            gamma * torch.rsqrt(var + _BN_EPSILON))
        getattr(self, f'bn{layer}_beta').copy_(beta)
        getattr(self, f'bn{layer}_mean').copy_(mean)

    def block(self, layer):
        """The conv block ``layer`` (0-5) as :func:`conv_block` takes
        it."""
        return Block(self.convs[layer], getattr(self, f'bn{layer}_mean'),
                     getattr(self, f'bn{layer}_scale'),
                     getattr(self, f'bn{layer}_beta'))

    def _features(self, frames):
        x = frames.contiguous()[:, None, :]
        for i in range(len(self.convs)):
            x = conv_block(x, self.block(i))
        # flatten as [N, W, C], the keras layout the classifier expects
        return x.transpose(1, 2).reshape(x.shape[0], -1)

    def forward(self, frames):
        """[N, 1024] frames -> [N, 360] activations, in pieces that
        bound the first layer's activation to ACTIVATION_BYTES."""
        piece = max(1, ACTIVATION_BYTES // (
            4 * self.channels[0] * (FRAME // LAYER_STRIDES[0])))
        outputs = [
            torch.sigmoid(self.classifier(self._features(
                frames[start:start + piece])))
            for start in range(0, frames.shape[0], piece)]
        if not outputs:
            return frames.new_zeros((0, BINS))
        return outputs[0] if len(outputs) == 1 else torch.cat(outputs)


def convert_keras_h5(h5_path):
    """Convert a keras CREPE checkpoint to a flat parameter dict.

    Keys: conv{i}/kernel [W, Cin, Cout], conv{i}/bias, conv{i}/{gamma,
    beta, mean, var}, classifier/kernel [4 * C6, 360],
    classifier/bias. Needs h5py.
    """
    import h5py
    params = {}
    with h5py.File(h5_path, 'r') as fh:
        for i in range(1, 7):
            conv = fh[f'conv{i}']
            sub = conv[list(conv.keys())[0]]
            # keras kernel is [H, W=1, Cin, Cout]; squeeze the W axis
            params[f'conv{i}/kernel'] = np.asarray(
                sub['kernel:0'])[:, 0, :, :]
            params[f'conv{i}/bias'] = np.asarray(sub['bias:0'])

            bn = fh[f'conv{i}-BN']
            sub = bn[list(bn.keys())[0]]
            params[f'conv{i}/gamma'] = np.asarray(sub['gamma:0'])
            params[f'conv{i}/beta'] = np.asarray(sub['beta:0'])
            params[f'conv{i}/mean'] = np.asarray(sub['moving_mean:0'])
            params[f'conv{i}/var'] = np.asarray(sub['moving_variance:0'])

        clf = fh['classifier']
        sub = clf[list(clf.keys())[0]]
        params['classifier/kernel'] = np.asarray(sub['kernel:0'])
        params['classifier/bias'] = np.asarray(sub['bias:0'])
    return params


def capacity_of(params):
    """Infer the capacity name from converted parameters."""
    cout = params['conv1/kernel'].shape[-1]
    for name, mult in CAPACITY_MULTIPLIER.items():
        if cout == 32 * mult:
            return name
    raise ValueError(
        f'cannot infer CREPE capacity from conv1 with {cout} filters')


def available_capacities():
    """Capacity names whose converted weights are installed."""
    return tuple(
        name for name in CAPACITY_MULTIPLIER
        if os.path.isfile(os.path.join(
            os.path.abspath(SHARE_DIR), f'model-{name}.npz')))


def weights_path(model_capacity, weights=None):
    """The absolute path of the npz parameters of a capacity.

    ``weights``, when given, is the path of an npz in the converted
    keras layout (:func:`convert_keras_h5`); otherwise the file is
    ``shennong_tpu_torch/share/crepe/model-<capacity>.npz``. Raises
    RuntimeError when that file is missing (only 'tiny' weights ship
    with the repository, the other capacities are converted from the
    published CREPE checkpoints), FileNotFoundError when ``weights``
    names no file.
    """
    if model_capacity not in CAPACITY_MULTIPLIER:
        raise ValueError(
            f'Model capacity {model_capacity} is not recognized.')
    if weights is not None:
        path = os.path.abspath(os.fspath(weights))
        if not os.path.isfile(path):
            raise FileNotFoundError(f'CREPE weights {path} not found')
        return path
    path = os.path.join(
        os.path.abspath(SHARE_DIR), f'model-{model_capacity}.npz')
    if not os.path.isfile(path):
        installed = ', '.join(available_capacities()) or 'none'
        raise RuntimeError(
            f"CREPE '{model_capacity}' weights are not installed "
            f'(found: {installed}). Convert the published keras '
            f'checkpoint with: speech-features-torch convert-crepe '
            f'model-{model_capacity}.h5 --install '
            f'(checkpoints at github.com/marl/crepe), pass '
            f'weights=<converted npz>, or pass '
            f'model_capacity=<installed capacity>.')
    return path


def _version(path):
    """A weights file's path with its modification time and size: a
    file rewritten in place is another version."""
    stat = os.stat(path)
    return path, stat.st_mtime_ns, stat.st_size


@functools.lru_cache(maxsize=None)
def _read_params(version):
    with np.load(version[0]) as data:
        return {k: v for k, v in data.items()}


def load_params(model_capacity, weights=None):
    """The converted npz parameters (numpy arrays) of a capacity, from
    :func:`weights_path` (read once per version of the file). Raises
    ValueError when the file holds another capacity."""
    path = weights_path(model_capacity, weights)
    params = _read_params(_version(path))
    found = capacity_of(params)
    if found != model_capacity:
        raise ValueError(f"CREPE weights {path} are of capacity "
                         f"'{found}', not '{model_capacity}'")
    return params


_models = {}


def load_model(model_capacity, device, weights=None):
    """The :class:`Crepe` of a capacity on ``device``, from the weights
    of :func:`load_params` (built once per version of the weights file
    and device)."""
    from shennong_tpu_torch.weights import crepe_from_numpy

    key = (_version(weights_path(model_capacity, weights)),
           str(torch.device(device)))
    if key not in _models:
        _models[key] = crepe_from_numpy(
            load_params(model_capacity, weights)).to(device)
    return _models[key]


def cents_mapping():
    """Bin index -> cents mapping used by CREPE"""
    return np.linspace(0, 7180, 360) + 1997.3794084376191


def frame_count(nsamples_padded, hop):
    """Model frames of a (center-padded) signal at the given hop.

    The reference formula, with its truncation toward zero: signals
    within one hop below 1024 samples count one (zero-padded) frame.
    """
    return max(0, 1 + int((nsamples_padded - 1024) / hop))


def required_halo(hop):
    """Minimum frame halo for :func:`forward_audio_chunk`.

    Samples of frame f are normalized by statistics of frames up to
    f + K with K = floor(1023 / hop), and those statistics depend on
    samples whose own owners reach f + 2K: the halo covers 2K (+1).
    """
    return 2 * (1023 // hop) + 1


def segment_geometry(hop, chunk_frames, halo):
    """(segment_length, left_pad) for :func:`forward_audio_chunk`.

    A segment holds the samples of ``chunk_frames + 2 * halo``
    frames; ``left_pad`` is the sample offset of the chunk's first
    kept frame within the segment.
    """
    npieces, rem = divmod(1024, hop)
    seg_len = (
        chunk_frames + 2 * halo - 1 + npieces) * hop + (rem or hop)
    return seg_len, halo * hop


def _strided_frames(segments, nframes, hop):
    """[B, L] samples -> [B, nframes, 1024] windows at ``hop`` (a view,
    zeros past the end of the segments)."""
    needed = (nframes - 1) * hop + FRAME
    if segments.shape[-1] < needed:
        segments = F.pad(segments, (0, needed - segments.shape[-1]))
    return segments.unfold(-1, FRAME, hop)[:, :nframes]


def _real_frame_index(counts, rows, chunk_frames, device):
    """[2, n] (row, frame) indices of the frames ``t < counts[row]``,
    built on the host and uploaded without waiting for the device (from
    page-locked memory on CUDA); None when every frame is real."""
    counts = np.asarray(counts, np.int64)
    if counts.shape != (rows,) or (
            (counts < 0) | (counts > chunk_frames)).any():
        raise ValueError(
            f'counts must hold {rows} counts in [0, {chunk_frames}]')
    if (counts == chunk_frames).all():
        return None
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    index = torch.from_numpy(np.stack([
        np.repeat(np.arange(counts.shape[0]), counts),
        np.arange(starts.shape[0]) - starts]))
    if torch.device(device).type == 'cuda':
        return index.pin_memory().to(device, non_blocking=True)
    return index.to(device)


def forward_audio_chunk(model, segments, last_owner, hop, chunk_frames,
                        halo, counts=None):
    """Framing, the reference normalization and the CNN, on the device
    of ``segments``, batched.

    Each row of ``segments`` [B, L] (int16 or float32) holds the
    center-padded samples covering frames [f0 - halo, f0 + chunk_frames
    + halo) of one signal, zeros outside the signal; ``last_owner`` [B]
    is the local index of the last real frame (n_global - 1 - f0 +
    halo, may exceed the local range). Sample ``s`` is normalized by
    the statistics of frame ``min(last_owner, s // hop)``, the last
    frame covering it, as the reference's in-place normalization
    through an overlapping view leaves it; the halo (at least
    :func:`required_halo` frames) makes the kept frames match the
    whole-signal computation.

    ``counts``, when given, holds each row's real frames on the host
    (B ints in [0, chunk_frames]): the CNN then runs on frames ``t <
    counts[row]`` alone, gathered from the framing's view, and the
    other frames' salience is zero. Building and uploading their index
    never waits for the device.

    Returns (salience [B, chunk_frames, 360], stats [B, chunk_frames,
    2] float32 packing each frame's argmax bin and maximum).
    """
    segments = segments.to(torch.float32)
    nlocal = chunk_frames + 2 * halo
    positions = torch.arange(segments.shape[-1], device=segments.device)
    owner = torch.clamp(
        torch.minimum(positions[None, :] // hop, last_owner[:, None].long()),
        0, nlocal - 1)

    mean = _strided_frames(segments, nlocal, hop).mean(dim=-1)
    audio1 = segments - torch.gather(mean, 1, owner)

    frames1 = _strided_frames(audio1, nlocal, hop)
    center = frames1.mean(dim=-1)
    std = torch.sqrt(((frames1 - center[..., None]) ** 2).mean(dim=-1))
    audio2 = audio1 / torch.clamp(torch.gather(std, 1, owner), min=1e-38)

    frames = _strided_frames(audio2, nlocal, hop)[:, halo:halo + chunk_frames]
    index = None if counts is None else _real_frame_index(
        counts, frames.shape[0], chunk_frames, segments.device)
    if index is None:
        salience = model(frames.reshape(-1, FRAME)).reshape(
            frames.shape[0], chunk_frames, -1)
    else:
        rows, cols = index
        salience = segments.new_zeros((frames.shape[0], chunk_frames, BINS))
        salience[rows, cols] = model(frames[rows, cols])
    best, argmax = salience.max(dim=-1)
    return salience, torch.stack([argmax.to(torch.float32), best], dim=-1)


def gather_neighborhood(salience, centers):
    """salience [n, S], centers [n] -> [n, 9] values at bins
    centers-4 .. centers+4, zeros outside the bin range."""
    idx = centers[:, None].long() + torch.arange(-4, 5, device=centers.device)
    valid = (idx >= 0) & (idx < salience.shape[1])
    values = torch.gather(salience, 1, idx.clamp(0, salience.shape[1] - 1))
    return torch.where(valid, values, torch.zeros_like(values))


def decode_salience_chunk(salience, nframes, log_start, band,
                          uniform_weight, self_weight, mapping,
                          viterbi=True, halfwidth=11):
    """The whole CREPE decode of one slice on the device.

    salience [B, T, S] + per-row real lengths [B] -> [B, T, 2] float32
    packing (cents, confidence): the banded Viterbi smoothing
    (:func:`shennong_tpu_torch.ops.viterbi.viterbi_banded_obs_batch`,
    the CUDA kernel on a CUDA tensor) or the plain argmax when
    ``viterbi`` is False, the 9-bin weighted-average cents and the
    per-frame confidence.
    """
    from shennong_tpu_torch.ops.viterbi import viterbi_banded_obs_batch

    confidence, obs = salience.max(dim=-1)
    obs = obs.to(torch.int32)
    if viterbi:
        centers = viterbi_banded_obs_batch(
            log_start, band, uniform_weight, self_weight, obs, nframes,
            halfwidth)
    else:
        centers = obs
    bins = salience.shape[-1]
    idx = centers[..., None].long() + torch.arange(
        -4, 5, device=salience.device)
    valid = (idx >= 0) & (idx < bins)
    cidx = idx.clamp(0, bins - 1)
    zero = torch.zeros((), dtype=torch.float32, device=salience.device)
    neigh = torch.where(valid, torch.gather(salience, -1, cidx), zero)
    mapping = torch.as_tensor(
        np.asarray(mapping, np.float32), device=salience.device)
    map_n = torch.where(valid, mapping[cidx], zero)
    cents = (neigh * map_n).sum(-1) / neigh.sum(-1)
    return torch.stack([cents, confidence], dim=-1)
