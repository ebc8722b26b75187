"""Frame extraction and windowing, Kaldi ``feature-window`` semantics.

Counterpart of :mod:`shennong_tpu.ops.framing`: frame boundary math,
the five window functions, dithering, DC removal, pre-emphasis and
raw-energy computation over ``[batch, num_frames, window]`` tensors.
Dither noise comes from an explicit :class:`torch.Generator` where the
reference takes a ``jax.random`` key.
"""

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

# float32 machine epsilon, the energy floor used throughout Kaldi
FLT_EPSILON = float(np.finfo(np.float32).eps)

WINDOW_TYPES = ('hamming', 'hanning', 'povey', 'rectangular', 'blackman')


@dataclasses.dataclass(frozen=True)
class FrameOptions:
    """Static framing parameters (Kaldi FrameExtractionOptions)."""
    sample_rate: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = 'povey'
    round_to_power_of_two: bool = True
    blackman_coeff: float = 0.42
    snip_edges: bool = True

    @property
    def window_size(self):
        """Samples per frame (truncating, like Kaldi)"""
        return int(self.sample_rate * 0.001 * self.frame_length_ms)

    @property
    def window_shift(self):
        """Samples between frame starts"""
        return int(self.sample_rate * 0.001 * self.frame_shift_ms)

    @property
    def padded_window_size(self):
        """Frame size after optional zero-padding to a power of two"""
        if self.round_to_power_of_two:
            return next_power_of_two(self.window_size)
        return self.window_size


def next_power_of_two(n):
    """Smallest power of two >= n"""
    return 1 << (int(n) - 1).bit_length()


def num_frames(nsamples, opts, flush=True):
    """Number of frames extractable from ``nsamples`` samples (Kaldi
    NumFrames, both ``snip_edges`` settings).

    Without ``flush`` (and ``snip_edges`` off) the frames that would
    run past the end of the signal are not counted.
    """
    shift, length = opts.window_shift, opts.window_size
    if opts.snip_edges:
        if nsamples < length:
            return 0
        return 1 + (nsamples - length) // shift

    nframes = (nsamples + shift // 2) // shift
    if flush:
        return nframes
    end = first_sample_of_frame(nframes - 1, opts) + length
    while nframes > 0 and end > nsamples:
        nframes -= 1
        end -= shift
    return nframes


def frame_counts(nsamples, opts):
    """:func:`num_frames` on the device: per-utterance frame counts
    [B] from the sample counts ``nsamples`` [B]."""
    shift, length = opts.window_shift, opts.window_size
    if opts.snip_edges:
        return torch.clamp_min(
            torch.div(nsamples - length, shift, rounding_mode='floor') + 1,
            0)
    return torch.div(nsamples + shift // 2, shift, rounding_mode='floor')


def first_sample_of_frame(frame, opts):
    """Index of the first sample of ``frame`` (may be negative when
    ``snip_edges`` is False)."""
    shift = opts.window_shift
    if opts.snip_edges:
        return frame * shift
    midpoint = shift * frame + shift // 2
    return midpoint - opts.window_size // 2


@functools.lru_cache(maxsize=None)
def window_function(window_type, window_size, blackman_coeff=0.42):
    """The window vector (float32 numpy), one of the five Kaldi types
    (:func:`window_function64` rounded)."""
    return window_function64(
        window_type, window_size, blackman_coeff).astype(np.float32)


@functools.lru_cache(maxsize=None)
def window_function64(window_type, window_size, blackman_coeff=0.42):
    """The window vector (float64 numpy), one of the five Kaldi types.

    Formulas (N = window_size, a = 2*pi/(N-1)):
      hanning     0.5 - 0.5 cos(a n)
      hamming     0.54 - 0.46 cos(a n)
      povey       (0.5 - 0.5 cos(a n)) ** 0.85
      rectangular 1
      blackman    c - 0.5 cos(a n) + (0.5 - c) cos(2 a n)
    """
    if window_type not in WINDOW_TYPES:
        raise ValueError(
            'window type must be in {}, it is {}'.format(
                WINDOW_TYPES, window_type))

    n = np.arange(window_size, dtype=np.float64)
    a = 2 * math.pi / max(window_size - 1, 1)
    if window_type == 'hanning':
        win = 0.5 - 0.5 * np.cos(a * n)
    elif window_type == 'hamming':
        win = 0.54 - 0.46 * np.cos(a * n)
    elif window_type == 'povey':
        win = (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    elif window_type == 'rectangular':
        win = np.ones_like(n)
    else:  # blackman
        win = (blackman_coeff - 0.5 * np.cos(a * n)
               + (0.5 - blackman_coeff) * np.cos(2 * a * n))
    return win


def _reflect_indices(indices, nsamples):
    """Map sample indices into [0, nsamples) by boundary reflection.

    The closed form of Kaldi's reflection loop: the symmetric
    extension of period ``2 * nsamples``, exact for any index.
    """
    period = torch.clamp_min(2 * nsamples, 1)  # guard zero-length rows
    folded = torch.remainder(indices, period)
    reflected = torch.where(
        folded >= nsamples, 2 * nsamples - 1 - folded, folded)
    return torch.minimum(
        torch.clamp_min(reflected, 0), torch.clamp_min(nsamples - 1, 0))


def extract_frames(signals, nsamples, opts, nframes_max):
    """Extract raw (unprocessed) frames from a padded signal batch.

    Parameters
    ----------
    signals : [batch, time] tensor, samples in int16 range (int16 or
        float32, widened to float32; or float64, kept for the
        spectrogram's float64 chain)
    nsamples : [batch] int32 tensor, true per-utterance sample counts
    opts : FrameOptions
    nframes_max : int, frames to extract per utterance

    Returns
    -------
    frames : [batch, nframes_max, window_size] float32 (float64 from
        float64 signals)

    With ``snip_edges`` the frames are strided views of the (zero
    padded) signal; without it the edge frames reflect around each
    utterance's true boundaries through a gather.
    """
    size = opts.window_size
    shift = opts.window_shift
    if signals.dtype != torch.float64:
        signals = signals.to(torch.float32)
    bsz = signals.shape[0]

    if opts.snip_edges:
        if nframes_max == 0:
            return signals.new_zeros((bsz, 0, size))
        needed = (nframes_max - 1) * shift + size
        if signals.shape[1] < needed:
            signals = F.pad(signals, (0, needed - signals.shape[1]))
        return signals.unfold(1, size, shift)[:, :nframes_max]

    device = signals.device
    starts = (torch.arange(nframes_max, dtype=torch.int64, device=device)
              * shift + shift // 2 - size // 2)
    indices = starts[:, None] + torch.arange(
        size, dtype=torch.int64, device=device)[None, :]
    indices = _reflect_indices(
        indices[None, :, :], nsamples.to(torch.int64)[:, None, None])
    return torch.gather(
        signals, 1, indices.reshape(bsz, -1)).reshape(
            bsz, nframes_max, size)


def process_frames(frames, opts, generator=None):
    """Apply the Kaldi per-frame processing chain to raw frames.

    Order (matching Kaldi ProcessWindow): dither, DC-offset removal,
    raw energy, pre-emphasis, window multiplication, zero-padding to
    the padded window size.

    The chain runs in the frames' dtype (float32, or float64 for the
    spectrogram); the dither is drawn in float32 whatever the frames'
    dtype, so a seeded generator gives the same noise either way.

    Parameters
    ----------
    frames : [batch, nframes, window_size] float32 or float64
    opts : FrameOptions
    generator : torch.Generator on the frames' device, required when
        ``opts.dither`` is non-zero

    Returns
    -------
    padded : [batch, nframes, padded_window_size], the frames' dtype
    raw_log_energy : [batch, nframes], the frames' dtype, log energy
        measured after DC removal but before pre-emphasis and windowing
    """
    size = opts.window_size

    if opts.dither != 0.0:
        if generator is None:
            # never skip a configured dither silently: undithered
            # digital silence gives log(eps) energy spikes
            raise ValueError(
                'opts.dither is non-zero but no generator was provided')
        frames = frames + opts.dither * torch.randn(
            frames.shape, generator=generator, dtype=torch.float32,
            device=frames.device).to(frames.dtype)

    if opts.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)

    raw_log_energy = torch.log(torch.clamp_min(
        (frames * frames).sum(dim=-1), FLT_EPSILON))

    if opts.preemph_coeff != 0.0:
        previous = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - opts.preemph_coeff * previous

    window = (window_function64 if frames.dtype == torch.float64
              else window_function)
    win = torch.as_tensor(
        window(opts.window_type, size, opts.blackman_coeff),
        device=frames.device)
    frames = frames * win

    pad = opts.padded_window_size - size
    if pad > 0:
        frames = F.pad(frames, (0, pad))

    return frames, raw_log_energy


def windowed_log_energy(frames):
    """Log energy of already-processed (windowed) frames."""
    return torch.log(torch.clamp_min(
        (frames * frames).sum(dim=-1), FLT_EPSILON))


def bucket_size(n, minimum=4096, ratio=1.25):
    """Round ``n`` up to a geometric bucket (bounds the distinct batch
    shapes, and so the pinned buffers a corpus cycles through)."""
    size = minimum
    while size < n:
        size = int(math.ceil(size * ratio))
    return size
