"""The port on less-travelled code paths.

Counterpart of ``tests/test_robustness.py``, case for case, on the CPU:
the 44.1 kHz -> 4 kHz resampler against the float64 oracle (1e-4
relative), Kaldi pitch at 44.1 kHz, batched ``snip_edges=False`` equal
to the single-utterance path, 60 s through MFCC and pitch, a sub-frame
signal and odd frame geometries. Each case also holds the port against
the JAX package's output on the same input: the resample within 1e-5
of the signal's scale, MFCC within 1e-3 (the processors' bound of
``tests/test_torch_frontends.py``: float32 sums and FFTs in another
order, up to 5.3e-4 on cepstra of magnitude 30 here), pitch lags equal or
proven ties (the float64 oracle up to a few seconds,
``tests/lag_ties.py``'s path costs over the 60 s) and the NCCF within
1e-3 where the lags agree.

``test_bucket_policy_bounds_compiles`` has no counterpart: it counts
the XLA programs the JAX package compiles, and the port compiles none.
"""

import numpy as np
import torch

import jax.numpy as jnp

from shennong_tpu import Audio as JAudio, Utterances as JUtterances
from shennong_tpu.ops import resample as jresample
from shennong_tpu.processor import (
    KaldiPitchProcessor as JKaldiPitchProcessor,
    MfccProcessor as JMfccProcessor)
from shennong_tpu_torch import Audio, Utterances
from shennong_tpu_torch.ops import resample
from shennong_tpu_torch.processor import KaldiPitchProcessor, MfccProcessor

from tests import pitch_oracle
from tests.conftest import make_speech_like_signal
from tests.lag_ties import assert_ties

torch.set_num_threads(2)

MFCC_TOL = 1e-3     # the port's MFCC against the JAX package's


def test_noninteger_resample_ratio():
    """44.1 kHz -> 4 kHz exercises the general gather resampler."""
    sig = make_speech_like_signal(44100, 44100).astype(np.float64)
    ours = resample.linear_resample(
        torch.from_numpy(sig[None].astype(np.float32)), 44100,
        44100.0, 4000.0, 1000.0, 1)[0].numpy()
    ref = pitch_oracle.linear_resample(sig, 44100, 4000, 1000.0, 1)
    assert ours.shape[0] == len(ref)
    scale = np.abs(ref).max()
    assert np.max(np.abs(ours - ref)) / scale < 1e-4
    jax_out = np.asarray(jresample.linear_resample(
        jnp.asarray(sig[None].astype(np.float32)), 44100,
        44100.0, 4000.0, 1000.0, 1))[0]
    assert np.max(np.abs(ours - jax_out)) / scale < 1e-5


def test_pitch_at_44100():
    """The pitch tracker works at non-integer decimation ratios."""
    sig = make_speech_like_signal(44100, 44100)
    pitch = KaldiPitchProcessor(sample_rate=44100).process(
        Audio(sig, 44100), device='cpu')
    assert pitch.nframes > 90
    # the synthetic F0 stays trackable
    times = pitch.times.mean(axis=1)
    expected = 120 + 30 * np.sin(2 * np.pi * 0.7 * times)
    voiced = pitch.data[:, 0] > 0.8
    assert voiced.sum() > 20
    err = np.abs(pitch.data[voiced, 1] - expected[voiced])
    assert np.median(err) < 5.0

    ref = JKaldiPitchProcessor(sample_rate=44100).process(
        JAudio(sig, 44100)).data
    pitch_oracle.assert_lag_decisions(
        sig.astype(np.float64), pitch.data, ref, rate=44100)


def test_batched_snip_edges_false(wav_file):
    """The reflection (gather) framing path in batched mode."""
    utterances = Utterances([
        ('u1', wav_file, 0.0, 0.6), ('u2', wav_file, 0.6, 1.4)])
    proc = MfccProcessor(dither=0, snip_edges=False)
    batched = proc.process_all(utterances, device='cpu')
    ref = JMfccProcessor(dither=0, snip_edges=False).process_all(
        JUtterances([('u1', wav_file, 0.0, 0.6),
                     ('u2', wav_file, 0.6, 1.4)]))
    for utt in utterances:
        single = proc.process(utt.load_audio(), device='cpu')
        assert batched[utt.name].shape == single.shape
        assert np.allclose(
            batched[utt.name].data, single.data, atol=2e-4)
        assert batched[utt.name].shape == ref[utt.name].shape
        assert np.abs(batched[utt.name].data
                      - ref[utt.name].data).max() < MFCC_TOL


def test_long_utterance():
    """A 60 s utterance runs through MFCC and pitch."""
    sig = make_speech_like_signal(16000 * 60, 16000)
    audio = Audio(sig, 16000)
    mfcc = MfccProcessor(dither=0).process(audio, device='cpu')
    assert mfcc.nframes == 1 + (16000 * 60 - 400) // 160
    pitch_proc = KaldiPitchProcessor()
    pitch = pitch_proc.process(audio, device='cpu')
    assert abs(pitch.nframes - mfcc.nframes) <= 2
    assert np.all(np.isfinite(mfcc.data))
    assert np.all(np.isfinite(pitch.data))

    jaudio = JAudio(sig, 16000)
    ref = JMfccProcessor(dither=0).process(jaudio).data
    assert np.abs(mfcc.data - ref).max() < MFCC_TOL
    ref = JKaldiPitchProcessor().process(jaudio).data
    assert_ties(sig, pitch_proc.options(), pitch.data, ref, 'cpu')


def test_short_utterance():
    """A signal shorter than one frame yields empty features."""
    audio = Audio(np.zeros(100, dtype=np.int16), 16000)
    mfcc = MfccProcessor(dither=0).process(audio, device='cpu')
    assert mfcc.shape == (0, 13)
    pitch = KaldiPitchProcessor().process(audio, device='cpu')
    assert pitch.shape == (0, 2)

    jaudio = JAudio(np.zeros(100, dtype=np.int16), 16000)
    assert JMfccProcessor(dither=0).process(jaudio).shape == mfcc.shape
    assert JKaldiPitchProcessor().process(jaudio).shape == pitch.shape


def test_odd_frame_geometry(wav_file):
    """Window not an integer multiple of the shift, shift > window."""
    audio = Audio.load(wav_file)
    jaudio = JAudio.load(wav_file)
    for shift, length in ((0.007, 0.031), (0.05, 0.02)):
        out = MfccProcessor(
            dither=0, frame_shift=shift, frame_length=length).process(
                audio, device='cpu')
        ref = JMfccProcessor(
            dither=0, frame_shift=shift, frame_length=length).process(jaudio)
        assert out.nframes > 0
        assert out.shape == ref.shape
        assert np.abs(out.data - ref.data).max() < MFCC_TOL
    assert out.nframes == 1 + (22713 - 320) // 800
