"""The pipeline's pass 1 as one program per padded utterance batch.

Counterpart of :func:`shennong_tpu.parallel.fused.pass_one_program`:
everything pass 1 needs from a padded signal batch, computed on one
device without host round trips between stages -- the feature frames
(MFCC, filterbank, PLP or spectrogram), the energy-VAD decisions that
weight the CMVN statistics, and the post-processed Kaldi pitch. The
reference's ``pack_payload`` (one fetch per batch through a relay) has
no counterpart: the executor copies each output to pinned host memory.
"""

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
