"""The port's chunked extraction of long signals against the JAX package.

Mirrors tests/test_chunked.py and the chunked cases of
tests/processor/test_pitch_kaldi.py on the CPU: the same signals, made
with numpy from a seed, through ``shennong_tpu`` and
``shennong_tpu_torch``, with the dither at 0. Tolerances (max-abs):

- ``linear_resample_chunked``: bit-equal to the port's whole-signal
  resample for 16k -> 4k (one filter phase), 1e-6 for 44.1k -> 4k;
  1e-5 against JAX;
- ``process_chunked`` of the five frame processors: 1e-4 against the
  port's whole-signal ``process`` (RASTA-PLP 1e-3: its IIR re-enters
  each chunk through a halo); 1e-4 against JAX's chunked output,
  relative to the largest magnitude of the output when it is over 1
  (cepstra and log energies of a loud signal reach 60, where the two
  frameworks' float32 FFTs differ by a few ulps; for the spectrogram,
  its energy column and its power relative to each frame's largest
  bin, as tests/test_torch_frontends.py holds it); times and
  properties equal;
- pitch ``process_chunked``: equal to the port's whole-signal
  ``process``; against JAX, lags exact or proven ties
  (``tests/pitch_oracle.py``) and NCCF 1e-4.

The chunk sizes are small (100 frames for the features, 700/200 and
300/150 for pitch) so that the plain Viterbi, a Python loop on the CPU,
stays short.
"""

import numpy as np
import pytest
import torch

from shennong_tpu.audio import Audio as JAudio
from shennong_tpu.ops import resample as jresample
from shennong_tpu.processor import energy as jenergy
from shennong_tpu.processor import filterbank as jfilterbank
from shennong_tpu.processor import mfcc as jmfcc
from shennong_tpu.processor import pitch_kaldi as jpitch
from shennong_tpu.processor import plp as jplp
from shennong_tpu.processor import spectrogram as jspectrogram
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.ops import resample
from shennong_tpu_torch.processor.energy import EnergyProcessor
from shennong_tpu_torch.processor.filterbank import FilterbankProcessor
from shennong_tpu_torch.processor.mfcc import MfccProcessor
from shennong_tpu_torch.processor.pitch_kaldi import KaldiPitchProcessor
from shennong_tpu_torch.processor.plp import PlpProcessor
from shennong_tpu_torch.processor.spectrogram import SpectrogramProcessor

from tests.conftest import make_speech_like_signal
from tests.pitch_oracle import assert_lag_decisions

torch.set_num_threads(2)

#: the five frame processors, as (port class, JAX class)
FRAME_PROCESSORS = {
    'mfcc': (MfccProcessor, jmfcc.MfccProcessor),
    'spectrogram': (SpectrogramProcessor, jspectrogram.SpectrogramProcessor),
    'filterbank': (FilterbankProcessor, jfilterbank.FilterbankProcessor),
    'energy': (EnergyProcessor, jenergy.EnergyProcessor),
    'plp': (PlpProcessor, jplp.PlpProcessor),
}


def jax_audio(audio):
    """The JAX package's Audio of the same samples."""
    return JAudio(audio.data, audio.sample_rate, validate=False)


@pytest.fixture(scope='module')
def audio(wav_file):
    """The generated test.wav, as the port's Audio."""
    return Audio.load(wav_file)


@pytest.fixture(scope='module')
def long_audio():
    # ~4.2 s: several chunks at chunk_frames=100
    return Audio(make_speech_like_signal(67000, 16000), 16000)


def against_jax(ours, ref):
    """Max-abs error, relative to the reference's largest magnitude
    when it is over 1."""
    return np.abs(ours - ref).max() / max(1.0, np.abs(ref).max())


def pitch_audio(seconds, rate=16000):
    """The long voiced signal of tests/processor/test_pitch_kaldi.py."""
    rng = np.random.RandomState(1)
    t = np.arange(int(rate * seconds)) / rate
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    sig = sum((0.6 ** k) * np.sin((k + 1) * phase) for k in range(5))
    sig = (sig * (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t) ** 2)
           + 0.02 * rng.randn(len(t)))
    return Audio((sig / np.abs(sig).max() * 0.7).astype(np.float32), rate)


# -------------------------------------------------------------- resample

@pytest.mark.parametrize('rate_in,rate_out,atol', [
    (16000, 4000, 0.0), (44100, 4000, 1e-6)])
def test_resample_chunked(rate_in, rate_out, atol):
    sig = np.random.RandomState(3).randn(rate_in * 4).astype(np.float32)
    whole = resample.linear_resample(
        torch.from_numpy(sig)[None], sig.shape[0], rate_in, rate_out,
        1000.0, 1)[0].numpy()
    chunked = resample.linear_resample_chunked(
        sig, rate_in, rate_out, 1000.0, 1, chunk_samples=rate_in // 3,
        device='cpu')
    assert chunked.dtype == np.float32
    assert chunked.shape == whole.shape
    if atol == 0.0:
        np.testing.assert_array_equal(chunked, whole)
    else:
        np.testing.assert_allclose(chunked, whole, atol=atol, rtol=0)

    ref = jresample.linear_resample_chunked(
        sig, rate_in, rate_out, 1000.0, 1, chunk_samples=rate_in // 3)
    assert np.abs(chunked - ref).max() < 1e-5


def test_resample_chunked_short_signal():
    """A signal under one chunk is one whole-signal resample."""
    sig = np.random.RandomState(4).randn(5000).astype(np.float32)
    whole = resample.linear_resample(
        torch.from_numpy(sig)[None], 5000, 16000, 4000, 1000.0, 1)[0]
    np.testing.assert_array_equal(
        resample.linear_resample_chunked(
            sig, 16000, 4000, 1000.0, 1, device='cpu'),
        whole.numpy())


# ------------------------------------------------------ frame processors

@pytest.mark.parametrize('snip', [True, False])
@pytest.mark.parametrize('name', sorted(FRAME_PROCESSORS))
def test_chunked_matches_whole(long_audio, name, snip):
    ours_cls, ref_cls = FRAME_PROCESSORS[name]
    proc = ours_cls(dither=0, snip_edges=snip)
    whole = proc.process(long_audio, device='cpu')
    chunked = proc.process_chunked(long_audio, chunk_frames=100, device='cpu')
    assert chunked.shape == whole.shape
    assert np.abs(chunked.data - whole.data).max() < 1e-4
    assert chunked.dtype == whole.dtype
    assert np.array_equal(chunked.times, whole.times)
    assert chunked.properties == whole.properties

    ref = ref_cls(dither=0, snip_edges=snip).process_chunked(
        jax_audio(long_audio), chunk_frames=100)
    assert chunked.shape == ref.shape
    assert chunked.properties == ref.properties
    if name != 'spectrogram':
        assert against_jax(chunked.data, ref.data) < 1e-4
        return
    # the reference's float32 FFT is not held in the log domain (the
    # log of a bin near the floor amplifies its rounding, see
    # tests/test_torch_frontends.py): the energy column, and the power
    # relative to each frame's largest bin
    assert against_jax(chunked.data[:, 0], ref.data[:, 0]) < 1e-4
    power, ref_power = np.exp(chunked.data[:, 1:]), np.exp(ref.data[:, 1:])
    assert (np.abs(power - ref_power)
            / ref_power.max(axis=1, keepdims=True)).max() < 1e-4


def test_chunked_rasta_halo(long_audio):
    proc = PlpProcessor(dither=0, rasta=True)
    whole = proc.process(long_audio, device='cpu')
    chunked = proc.process_chunked(long_audio, chunk_frames=100, device='cpu')
    assert chunked.shape == whole.shape
    # the IIR halo makes chunk boundaries converge, not exact
    assert np.abs(chunked.data - whole.data).max() < 1e-3

    ref = jplp.PlpProcessor(dither=0, rasta=True).process_chunked(
        jax_audio(long_audio), chunk_frames=100)
    assert against_jax(chunked.data, ref.data) < 1e-4


def test_chunked_vtln_warp(long_audio):
    proc = MfccProcessor(dither=0)
    whole = proc.process(long_audio, vtln_warp=1.1, device='cpu')
    chunked = proc.process_chunked(
        long_audio, chunk_frames=100, vtln_warp=1.1, device='cpu')
    assert np.abs(chunked.data - whole.data).max() < 1e-4
    assert chunked.properties == whole.properties
    assert chunked.properties['mfcc']['vtln_warp'] == 1.1

    ref = jmfcc.MfccProcessor(dither=0).process_chunked(
        jax_audio(long_audio), chunk_frames=100, vtln_warp=1.1)
    assert against_jax(chunked.data, ref.data) < 1e-4


def test_chunked_dither_draws_from_the_generator(long_audio):
    """With dither on, the chunks draw from the caller's generator in
    turn: the same seed gives the same output, another seed another."""
    proc = MfccProcessor()
    first, again, other = (
        proc.process_chunked(
            long_audio, chunk_frames=100, device='cpu',
            generator=torch.Generator().manual_seed(seed)).data
        for seed in (5, 5, 6))
    assert np.array_equal(first, again)
    assert not np.array_equal(first, other)


def test_auto_routing(long_audio, monkeypatch):
    """process() transparently chunks past AUTO_CHUNK_FRAMES."""
    proc = MfccProcessor(dither=0)
    whole = proc.process(long_audio, device='cpu')

    calls = []
    real = MfccProcessor.process_chunked

    def counting(self, *args, **kwargs):
        calls.append(1)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(MfccProcessor, 'process_chunked', counting)
    monkeypatch.setattr(MfccProcessor, 'AUTO_CHUNK_FRAMES', 200)
    routed = proc.process(long_audio, device='cpu')
    assert calls == [1]
    assert np.abs(routed.data - whole.data).max() < 1e-4
    assert routed.properties == whole.properties

    monkeypatch.setattr(MfccProcessor, 'AUTO_CHUNK_FRAMES', None)
    assert np.array_equal(proc.process(long_audio, device='cpu').data,
                          whole.data)
    assert calls == [1]


def test_short_signal_passthrough(audio):
    """Signals under one chunk go through the regular path."""
    proc = MfccProcessor(dither=0)
    out = proc.process_chunked(audio, chunk_frames=10 ** 6, device='cpu')
    assert np.array_equal(out.data, proc.process(audio, device='cpu').data)


def test_chunked_argument_errors(audio):
    for proc in (MfccProcessor(dither=0), KaldiPitchProcessor()):
        with pytest.raises(ValueError, match='chunk_frames'):
            proc.process_chunked(audio, chunk_frames=0, device='cpu')
        with pytest.raises(ValueError, match='halo_frames'):
            proc.process_chunked(audio, halo_frames=-1, device='cpu')
        with pytest.raises(ValueError, match='sample rates'):
            proc.process_chunked(
                Audio(audio.data[::2], 8000), device='cpu')


# ----------------------------------------------------------------- pitch

def check_pitch_against_jax(audio, ours, ref, **oracle_options):
    """Lags exact or proven ties, NCCF 1e-4 where the lags agree."""
    assert ours.shape == ref.shape
    same = assert_lag_decisions(
        audio.astype(np.int16).data.astype(np.float64), ours, ref,
        **oracle_options)
    assert np.abs(ours[same, 0] - ref[same, 0]).max() < 1e-4


def test_pitch_chunked_equals_whole():
    # 5 chunks with 200-frame halos: the Viterbi paths coalesce inside
    # the halo and the chunked resample is exact
    audio = pitch_audio(30)
    proc = KaldiPitchProcessor()
    whole = proc.process(audio, device='cpu')
    chunked = proc.process_chunked(
        audio, chunk_frames=700, halo_frames=200, device='cpu')
    assert chunked.shape == whole.shape
    np.testing.assert_array_equal(chunked.data, whole.data)
    np.testing.assert_array_equal(chunked.times, whole.times)
    assert chunked.properties == whole.properties

    ref = jpitch.KaldiPitchProcessor().process_chunked(
        jax_audio(audio), chunk_frames=700, halo_frames=200)
    check_pitch_against_jax(audio, chunked.data, ref.data)


@pytest.mark.parametrize('options,oracle_options', [
    (dict(min_f0=60, max_f0=300), dict(min_f0=60, max_f0=300)),
    (dict(resample_freq=3000, lowpass_cutoff=800),
     dict(resample_freq=3000, lowpass_cutoff=800)),
    (dict(frame_shift=0.02, frame_length=0.04),
     dict(shift_s=0.02, length_s=0.04)),
])
def test_pitch_chunked_equals_whole_options(options, oracle_options):
    # non-default geometries: other lag grids, analysis rates and frames
    audio = pitch_audio(12)
    proc = KaldiPitchProcessor(**options)
    whole = proc.process(audio, device='cpu')
    chunked = proc.process_chunked(
        audio, chunk_frames=300, halo_frames=150, device='cpu')
    assert chunked.shape == whole.shape
    np.testing.assert_array_equal(chunked.data, whole.data)

    ref = jpitch.KaldiPitchProcessor(**options).process_chunked(
        jax_audio(audio), chunk_frames=300, halo_frames=150)
    check_pitch_against_jax(audio, chunked.data, ref.data, **oracle_options)


def test_pitch_auto_routing(monkeypatch):
    audio = pitch_audio(12)
    proc = KaldiPitchProcessor()
    whole = proc.process(audio, device='cpu')
    # small chunks keep the CPU's plain Viterbi short
    monkeypatch.setattr(
        KaldiPitchProcessor.process_chunked, '__defaults__', (300, 150))
    monkeypatch.setattr(proc, 'AUTO_CHUNK_FRAMES', 400)
    routed = proc.process(audio, device='cpu')
    assert routed.shape == whole.shape
    np.testing.assert_array_equal(routed.data, whole.data)
