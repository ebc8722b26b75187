"""Counterpart of ``tests/test_fused.py``: the port's fused serving
pipeline (``parallel.fused.mfcc_pitch_pipeline``) against the
composable processors it shortcuts, on the conftest's signal, with the
JAX case's bound (2e-3).

``test_fused_sharded_over_mesh`` and
``test_gmm_training_step_with_dither_takes_key`` have no counterpart:
the port has no device mesh and no ``make_gmm_training_step``
(``tests/test_torch_api.py:EXEMPT``).
"""

import numpy as np
import torch

from shennong_tpu_torch import Features
from shennong_tpu_torch.ops import mel as melmod
from shennong_tpu_torch.ops.framing import num_frames
from shennong_tpu_torch.ops.pitch import (
    PitchOpts, ProcessPitchOpts, num_pitch_frames)
from shennong_tpu_torch.ops.spectral import MfccOpts
from shennong_tpu_torch.parallel.fused import mfcc_pitch_pipeline
from shennong_tpu_torch.postprocessor import DeltaPostProcessor
from shennong_tpu_torch.processor import KaldiPitchProcessor, MfccProcessor
from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchPostProcessor

from tests.torch_ref import audio  # noqa: F401 (fixture)


def test_fused_matches_processors(audio):
    """Fused MFCC+CMVN+delta+pitch equals the step-by-step path."""
    data = audio.data.astype(np.float32)
    nsamples = data.shape[0]
    signals = data[None, :]
    lengths = np.array([nsamples], dtype=np.int32)

    mfcc_opts = MfccOpts(frame=MfccOpts().frame.__class__(dither=0.0))
    pitch_opts = PitchOpts()
    post_opts = ProcessPitchOpts(delta_pitch_noise_stddev=0.0)
    mel_weights = melmod.mel_banks(
        23, 512, 16000.0, 20.0, 0.0, 100.0, -500.0, 1.0)[0]
    nframes_max = num_frames(nsamples, mfcc_opts.frame)
    pitch_frames_max = num_pitch_frames(nsamples, pitch_opts)

    fused, out_frames = mfcc_pitch_pipeline(
        torch.from_numpy(signals), torch.from_numpy(lengths),
        mel_weights, mfcc_opts, pitch_opts, post_opts, nframes_max,
        pitch_frames_max, device='cpu')
    fused = fused[0, :int(out_frames[0])].numpy()

    # reference path: processors chained on the host
    mfcc = MfccProcessor(dither=0).process(audio, device='cpu')
    normalized = (mfcc.data - mfcc.data.mean(axis=0)) / np.sqrt(
        np.maximum(mfcc.data.var(axis=0), 1e-20))
    delta = DeltaPostProcessor().process(
        Features(normalized, mfcc.times), device='cpu')

    pitch = KaldiPitchProcessor().process(audio, device='cpu')
    pitch_post = KaldiPitchPostProcessor(
        delta_pitch_noise_stddev=0).process(pitch, device='cpu')

    common = min(delta.nframes, pitch_post.nframes, fused.shape[0])
    expected = np.hstack(
        [delta.data[:common], pitch_post.data[:common]])

    assert fused.shape[1] == expected.shape[1] == 42
    assert np.max(np.abs(fused[:common] - expected)) < 2e-3
