"""The pipeline's pass 1, the GMM-training front-end and the fused
MFCC + pitch pipeline, each one program per padded utterance batch; the
training steps of the multi-process trainers.

Counterpart of :func:`shennong_tpu.parallel.fused.pass_one_program`:
everything pass 1 needs from a padded signal batch, computed on one
device without host round trips between stages -- the feature frames
(MFCC, filterbank, PLP or spectrogram), the energy-VAD decisions that
weight the CMVN statistics, and the post-processed Kaldi pitch.
:func:`pack_payload` packs a batch's outputs into one uint8 payload,
optionally in half precision, which the executor copies to pinned host
memory in one transfer.

The step makers (:func:`make_em_train_steps`, :func:`make_accumulate_step`,
:func:`make_lvtln_round_step`, :func:`make_lvtln_train_steps`) are the
counterparts of the JAX package's sharded steps: they take a
``torch.distributed`` process group (None for the default one) where
JAX takes a device mesh. Each process passes its own frames and the
same model; the float64 statistics accumulate on the process's device
and are summed over the group by
:func:`shennong_tpu_torch.parallel.distributed.allreduce_tensors`
(bit-identical on every process), and every process applies the same
update. In a group of one they are the single-process functions.
"""

import functools

import torch

from shennong_tpu_torch.ops import pitch as pitch_ops
from shennong_tpu_torch.ops import plp, postops, spectral
from shennong_tpu_torch.ops.framing import frame_counts


def pass_one_program(signals, nsamples, mel_weights, equal_loudness, kind,
                     feat_opts, nframes_max, device, energy_opts=None,
                     compression='log', vad_opts=None, pitch_opts=None,
                     post_opts=None, pitch_frames_max=None,
                     with_noise=False, generator=None):
    """The whole pipeline pass 1 for one utterance batch.

    Parameters
    ----------
    signals : [B, T] int16 or float32 tensor, int16-range samples
    nsamples : [B] int32 tensor, true per-utterance sample counts
    mel_weights : [M, P] or [B, M, P] mel filterbank (numpy or tensor),
        None for spectrograms
    equal_loudness : [M] or [B, M] equal-loudness weights (numpy or
        tensor) for PLP, else None
    kind : str, the features: 'mfcc', 'filterbank', 'plp' or
        'spectrogram'
    feat_opts : MfccOpts, FbankOpts, PlpOpts or SpectrogramOpts
    nframes_max : int, feature frames per row
    device : torch.device the program runs on; the inputs move there
    energy_opts, compression, vad_opts : the energy-VAD stage (its
        EnergyOpts, its compression, and the VAD's (threshold,
        mean_scale, context, proportion)), skipped when None
    pitch_opts, post_opts, pitch_frames_max : the Kaldi pitch stage
        and its post-processing, skipped when None
    with_noise : bool, add the post-processing's delta-pitch noise
    generator : torch.Generator on ``device``, the source of every
        random draw (the dithers and the pitch noise, in that order);
        required when any of them is on

    Returns a dict with ``feats`` [B, F, D] and, when configured,
    ``vad`` [B, F] uint8 and ``pitch`` [B, Fp, P], all on ``device``.
    """
    device = torch.device(device)
    signals = signals.to(device=device, dtype=torch.float32)
    nsamples = nsamples.to(device=device, dtype=torch.int32)

    if kind == 'mfcc':
        feats = spectral.mfcc_batch(
            signals, nsamples, mel_weights, feat_opts, nframes_max,
            generator=generator)
    elif kind == 'filterbank':
        feats = spectral.fbank_batch(
            signals, nsamples, mel_weights, feat_opts, nframes_max,
            generator=generator)
    elif kind == 'plp':
        feats = plp.plp_batch(
            signals, nsamples, mel_weights, equal_loudness, feat_opts,
            nframes_max, generator=generator)
    elif kind == 'spectrogram':
        feats = spectral.spectrogram_batch(
            signals, nsamples, feat_opts, nframes_max, generator=generator)
    else:
        raise ValueError(f'unsupported fused pass-1 features: {kind}')
    out = {'feats': feats}

    if energy_opts is not None:
        log_energy = spectral.energy_batch(
            signals, nsamples, energy_opts, nframes_max,
            compression=compression, generator=generator)
        threshold, mean_scale, context, proportion = vad_opts
        out['vad'] = postops.compute_vad_energy(
            log_energy, frame_counts(nsamples, energy_opts.frame),
            energy_threshold=threshold, energy_mean_scale=mean_scale,
            frames_context=context, proportion_threshold=proportion)

    if pitch_opts is not None:
        raw_pitch = pitch_ops.compute_pitch(
            signals, nsamples, pitch_opts, pitch_frames_max)
        pitch_frames = pitch_ops.pitch_num_frames_device(
            pitch_ops.resampled_lengths(nsamples, pitch_opts), pitch_opts)
        noise = None
        if with_noise:
            if generator is None:
                raise ValueError(
                    'the pitch noise is on but no generator was provided')
            noise = torch.randn(
                raw_pitch.shape[:2], generator=generator,
                dtype=torch.float32, device=device)
        out['pitch'] = pitch_ops.process_pitch(
            raw_pitch, pitch_frames, post_opts, noise=noise)

    return out


#: the float precisions of :func:`pack_payload`, by name
FETCH_DTYPES = {'float32': torch.float32, 'float16': torch.float16,
                'bfloat16': torch.bfloat16}


def pack_payload(parts, dtype='float32'):
    """Pack device tensors into one contiguous uint8 payload.

    Counterpart of :func:`shennong_tpu.parallel.fused.pack_payload`. The
    float parts are cast on their device to ``dtype`` ('float32', the
    default and bit-exact, 'float16' or 'bfloat16', which halve their
    bytes); uint8 parts (the VAD decisions) pass through. Each part is
    viewed as bytes (C order, the device's little-endian layout) and
    the parts are concatenated in the order given, so one copy brings a
    batch's outputs to the host, where the executor views them back.
    """
    target = FETCH_DTYPES[dtype]
    chunks = []
    for part in parts:
        if part.dtype != torch.uint8:
            part = part.to(target)
        chunks.append(part.contiguous().reshape(-1).view(torch.uint8))
    return torch.cat(chunks)


def mfcc_pitch_pipeline(signals, nsamples, mel_weights, mfcc_opts,
                        pitch_opts, post_opts, nframes_max,
                        pitch_frames_max, delta_order=2, delta_window=2, *,
                        device, generator=None):
    """MFCC + per-utterance CMVN + deltas + Kaldi pitch in one call.

    Counterpart of :func:`shennong_tpu.parallel.fused.mfcc_pitch_pipeline`:
    [B, T] padded int16-range signals -> ([B, F, 13 * (delta_order + 1)
    + pitch dims] features, [B] int32 frame counts) on ``device``. CMVN
    normalizes each utterance's mean and variance over its own valid
    frames; the frame count of a row is the smaller of its MFCC and
    pitch counts. A non-zero dither needs ``generator`` (on ``device``).
    """
    device = torch.device(device)
    signals = signals.to(device=device, dtype=torch.float32)
    nsamples = nsamples.to(device=device, dtype=torch.int32)
    feats = spectral.mfcc_batch(
        signals, nsamples, mel_weights, mfcc_opts, nframes_max,
        generator=generator)
    nframes = frame_counts(nsamples, mfcc_opts.frame)

    t = torch.arange(feats.shape[1], device=device)[None, :, None]
    valid = t < nframes[:, None, None]
    count = torch.clamp_min(nframes.to(torch.float32), 1.0)[:, None, None]
    masked = torch.where(valid, feats, 0.0)
    mean = masked.sum(dim=1, keepdim=True) / count
    var = (masked * masked).sum(dim=1, keepdim=True) / count - mean * mean
    feats = torch.where(
        valid, (feats - mean) * torch.rsqrt(torch.clamp_min(var, 1e-20)),
        0.0)
    feats = postops.compute_deltas(
        feats, nframes, order=delta_order, window=delta_window)

    raw_pitch = pitch_ops.compute_pitch(
        signals, nsamples, pitch_opts, pitch_frames_max)
    pitch_frames = pitch_ops.pitch_num_frames_device(
        pitch_ops.resampled_lengths(nsamples, pitch_opts), pitch_opts)
    pitch_feats = pitch_ops.process_pitch(raw_pitch, pitch_frames, post_opts)

    common = min(feats.shape[1], pitch_feats.shape[1])
    out = torch.cat([feats[:, :common], pitch_feats[:, :common]], dim=-1)
    out_frames = torch.clamp_max(torch.minimum(nframes, pitch_frames), common)
    return out, out_frames.to(torch.int32)


def ubm_frontend_program(signals, nsamples, mel_weights, mfcc_opts,
                         nframes_max, delta_order, delta_window, vad_opts,
                         cmvn_opts, subsample, generator=None):
    """The UBM-GMM training front-end of one signal batch, on its
    device.

    Counterpart of :func:`shennong_tpu.parallel.fused.ubm_frontend_program`:
    MFCC, the appended deltas, the energy-VAD decisions on the energy
    column, sliding-window CMVN, and the two frame-selection weights
    (voiced frames for the initialization, voiced-and-subsampled frames
    for the main EM, Kaldi's trim-then-every-Nth-row), with no host
    round trip.

    ``vad_opts`` is (threshold, mean_scale, context, proportion),
    ``cmvn_opts`` (center, window, min_window, normalize_variance) or
    None, ``delta_order`` None for no deltas.

    Returns (normalized feats [B, F, D'], w_init [B, F] float32, w_em
    [B, F] float32, voiced [] float32 -- the batch's voiced count).
    """
    signals = signals.to(torch.float32)
    feats = spectral.mfcc_batch(
        signals, nsamples, mel_weights, mfcc_opts, nframes_max,
        generator=generator)
    nframes = frame_counts(nsamples, mfcc_opts.frame)

    log_energy = feats[..., 0]
    if delta_order is not None:
        feats = postops.compute_deltas(
            feats, nframes, order=delta_order, window=delta_window)

    threshold, mean_scale, context, proportion = vad_opts
    vad = postops.compute_vad_energy(
        log_energy, nframes, energy_threshold=threshold,
        energy_mean_scale=mean_scale, frames_context=context,
        proportion_threshold=proportion)

    if cmvn_opts is not None:
        center, window, min_window, normalize_variance = cmvn_opts
        feats = postops.sliding_window_cmvn(
            feats, nframes, center=center, cmn_window=window,
            min_window=min_window, normalize_variance=normalize_variance)

    t = torch.arange(feats.shape[1], device=feats.device)[None, :]
    voiced = (t < nframes[:, None]) & (vad > 0)
    w_init = voiced.to(torch.float32)
    # per-utterance voiced rank: trim(vad) then copy(subsample=N) keeps
    # every Nth row of each trimmed utterance
    rank = torch.cumsum(w_init, dim=1) - 1.0
    w_em = w_init * (torch.remainder(rank, float(subsample)) == 0)
    return feats, w_init, w_em, w_init.sum()


def _reducer(group):
    from shennong_tpu_torch.parallel.distributed import allreduce_tensors
    return functools.partial(allreduce_tensors, group=group)


def make_em_train_steps(group, num_iters, min_gaussian_weight=1e-4,
                        min_gaussian_occupancy=10.0, min_variance=0.001):
    """``num_iters`` EM iterations over the frames of every process of
    ``group``.

    Returns (flat [N, D], fweights [N], weights, means, inv_vars) ->
    (tot_like, weights, means, inv_vars), the process's own frames and
    their 0/1 weights (zero on padding): each iteration sums the
    statistics over the group before the floored update of
    :func:`shennong_tpu_torch.ops.gmm.em_step`.
    """
    from shennong_tpu_torch.ops import gmm as gmm_ops

    return functools.partial(
        gmm_ops.em_steps, num_iters=num_iters,
        min_gaussian_weight=min_gaussian_weight,
        min_gaussian_occupancy=min_gaussian_occupancy,
        min_variance=min_variance, reduce=_reducer(group))


def make_accumulate_step(group):
    """The EM statistics over the frames of every process of ``group``:
    (flat, fweights, weights, means, inv_vars) -> (tot_like, occupancy,
    mean_acc, var_acc), summed over the group, for the updates that run
    on the host (the component-removing one changes the model's
    shape)."""
    from shennong_tpu_torch.ops import gmm as gmm_ops

    reduce = _reducer(group)

    def accumulate(flat, fweights, weights, means, inv_vars):
        return reduce(gmm_ops.accumulate_stats(
            flat, fweights, weights, means, inv_vars))
    return accumulate


def make_lvtln_round_step(group, num_groups, num_gselect=15,
                          norm_type='offset', logdet_scale=0.0,
                          default_class=0):
    """One LVTLN estimation round over the frames of every process of
    ``group``.

    Returns (feats [N, D], fweights [N], gid [N], base [C, D, D], warps
    [C], gmm_weights, gmm_means, gmm_inv_vars) -> (transforms [S, D,
    D+1], warps_out [S], best_class [S], objf_impr [S], beta [S]): each
    process selects the ``num_gselect`` best components of its frames,
    the per-group fMLLR statistics are summed over the group and every
    process solves the same per-(group, warp-class) objective; the first
    round of :func:`shennong_tpu_torch.ops.fmllr.lvtln_rounds`.
    """
    from shennong_tpu_torch.ops import fmllr as fmllr_ops
    from shennong_tpu_torch.ops import gmm as gmm_ops

    reduce = _reducer(group)

    def round_step(feats, fweights, gid, base, warps, weights, means,
                   inv_vars):
        _, gsel = gmm_ops.gaussian_selection(
            feats, weights, means, inv_vars, num_gselect)
        return fmllr_ops.lvtln_rounds(
            feats, fweights, gid, gsel, base, warps, weights, means,
            inv_vars, num_groups=num_groups, num_iters=0,
            norm_type=norm_type, logdet_scale=logdet_scale,
            default_class=default_class, reduce=reduce)[3:]
    return round_step


def make_lvtln_train_steps(group, num_groups, num_iters,
                           norm_type='offset', logdet_scale=0.0,
                           default_class=0, min_gaussian_weight=1e-4):
    """The whole LVTLN estimation loop over the frames of every process
    of ``group``: (feats, fweights, gid, gsel, base, warps, gmm_weights,
    gmm_means, gmm_inv_vars) -> the outputs of
    :func:`shennong_tpu_torch.ops.fmllr.lvtln_rounds`, whose every
    round sums its fMLLR statistics and EM accumulators over the
    group."""
    from shennong_tpu_torch.ops import fmllr as fmllr_ops

    return functools.partial(
        fmllr_ops.lvtln_rounds, num_groups=num_groups, num_iters=num_iters,
        norm_type=norm_type, logdet_scale=logdet_scale,
        default_class=default_class,
        min_gaussian_weight=min_gaussian_weight, reduce=_reducer(group))
