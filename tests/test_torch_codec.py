"""The port's compressed audio against the JAX package's.

Counterpart of ``tests/test_codec.py`` and of the FLAC cases of
``tests/test_real_audio.py``, on the same vendored recordings. The port
decodes FLAC with its own copy of the native decoder
(``shennong_tpu_torch/native/shennong_flac.cpp``) and mp3/ogg with its
own copy of the libav* codec runtime (``native/shennong_codec.cpp``):

- ``Audio.scan`` and ``Audio.load`` of ``test.flac`` equal the JAX
  package's and ``test.flac`` is sample-exact to ``test.wav``; the
  port's MFCC on it is bit-equal to its MFCC on ``test.wav``;
- ``scan`` and ``load`` of ``test.mp3`` equal the JAX package's (the
  same libav* decode), within the reference's own bounds of the WAV;
- a save round trip per format (FLAC bit-exact, mp3 and ogg correlated
  above 0.99), each file the port wrote read alike by the JAX package;
- the codec's scan bounds its decode, its FLAC decode equals the
  native decoder's, bad files return None as the JAX package's do, and
  the pipeline gives bit-equal features from ``test.flac`` and
  ``test.wav``.

The cases that need libav* skip where it is missing, under the
condition ``tests/test_codec.py`` uses: the same 10 cases.
"""

import os

import numpy as np
import pytest

from shennong_tpu import native as jnative
from shennong_tpu.audio import Audio as JAudio
from shennong_tpu_torch import native
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.processor import MfccProcessor

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
WAV = os.path.join(DATA, 'test.wav')
FLAC = os.path.join(DATA, 'test.flac')
MP3 = os.path.join(DATA, 'test.mp3')

needs_codec = pytest.mark.skipif(
    not jnative.codec_available(),
    reason='native codec library not built (libav* missing)')


def same_audio(ours, theirs):
    assert ours.sample_rate == theirs.sample_rate
    assert ours.dtype == theirs.dtype
    assert np.array_equal(ours.data, theirs.data)


# ---------------------------------------------------- FLAC, native decoder

def test_flac_scan_and_load():
    wav = Audio.load(WAV)
    meta = Audio.scan(FLAC)
    assert tuple(meta) == tuple(JAudio.scan(FLAC))
    assert (meta.nchannels, meta.sample_rate) == (1, 16000)
    assert meta.nsamples == wav.nsamples

    decoded = Audio.load(FLAC)
    assert decoded.dtype == np.int16
    # FLAC is lossless: sample-exact against the source WAV
    same_audio(decoded, wav)
    same_audio(decoded, JAudio.load(FLAC))


def test_mfcc_on_flac_equals_wav():
    proc = MfccProcessor(dither=0)
    from_flac = proc.process(Audio.load(FLAC), device='cpu')
    from_wav = proc.process(Audio.load(WAV), device='cpu')
    assert np.array_equal(from_flac.data, from_wav.data)
    assert np.array_equal(from_flac.times, from_wav.times)


# ------------------------------------------------------- libav* codec

@needs_codec
def test_scan_mp3():
    # the sample count is the container-duration estimate, as in the
    # reference (test/test_audio.py:23-24)
    wav = Audio.load(WAV)
    meta = Audio.scan(MP3)
    assert tuple(meta) == tuple(JAudio.scan(MP3))
    assert (meta.sample_rate, meta.nchannels) == (16000, 1)
    assert meta.nsamples >= wav.nsamples
    assert meta.duration == pytest.approx(wav.duration, abs=0.2)


@needs_codec
def test_load_mp3():
    wav = Audio.load(WAV)
    decoded = Audio.load(MP3)
    same_audio(decoded, JAudio.load(MP3))
    assert decoded.duration == pytest.approx(1.419, rel=1e-3)
    assert decoded.data.shape == wav.data.shape == (22713,)
    assert decoded.precision == 16
    corr = np.corrcoef(wav.data.astype(np.float64),
                       decoded.data.astype(np.float64))[0, 1]
    assert corr > 0.99


@needs_codec
@pytest.mark.parametrize('ext', ['mp3', 'flac', 'ogg'])
def test_save_roundtrip(tmp_path, ext):
    wav = Audio.load(WAV)
    path = str(tmp_path / ('copy.' + ext))
    wav.save(path)
    assert os.path.isfile(path)

    loaded = Audio.load(path)
    assert (loaded.sample_rate, loaded.shape, loaded.dtype) == (
        wav.sample_rate, wav.shape, wav.dtype)
    if ext == 'flac':
        assert np.array_equal(loaded.data, wav.data)
    else:
        corr = np.corrcoef(wav.data.astype(np.float64),
                           loaded.data.astype(np.float64))[0, 1]
        assert corr > 0.99
    # the JAX package reads the port's file alike
    assert tuple(Audio.scan(path)) == tuple(JAudio.scan(path))
    same_audio(loaded, JAudio.load(path))


@needs_codec
def test_save_stereo_flac(tmp_path):
    wav = Audio.load(WAV)
    stereo = Audio(np.stack([wav.data, -wav.data], axis=1), wav.sample_rate)
    path = str(tmp_path / 'stereo.flac')
    stereo.save(path)
    loaded = Audio.load(path)
    assert loaded.nchannels == 2
    assert np.array_equal(loaded.data, stereo.data)
    same_audio(loaded, JAudio.load(path))


@needs_codec
def test_codec_scan_decode_agree():
    channels, rate, estimate = native.codec_scan(MP3)
    data, rate2 = native.codec_decode(MP3)
    assert (channels, rate) == (1, 16000)
    assert rate2 == rate
    assert data.ndim == 1
    assert 0 < data.shape[0] <= estimate
    assert (channels, rate, estimate) == jnative.codec_scan(MP3)
    assert np.array_equal(data, jnative.codec_decode(MP3)[0])


@needs_codec
def test_codec_decode_flac_matches_native():
    # both decoders of the port (its FLAC and libav) agree bit for bit
    ours, rate_ours = native.flac_decode(FLAC)
    libav, rate_libav = native.codec_decode(FLAC)
    assert rate_ours == rate_libav
    assert np.array_equal(ours, libav)


@needs_codec
def test_codec_bad_files(tmp_path):
    for module in (native, jnative):
        assert module.codec_decode('/does/not/exist.mp3') is None
        assert module.codec_scan('/does/not/exist.mp3') is None
    garbage = str(tmp_path / 'garbage.mp3')
    with open(garbage, 'wb') as fp:
        fp.write(b'this is not audio at all' * 10)
    assert native.codec_scan(garbage) is None
    assert jnative.codec_scan(garbage) is None
    # an unwritable target fails cleanly
    assert not native.codec_encode(
        '/no/such/dir/out.mp3', np.zeros(100, dtype=np.int16), 16000)


@needs_codec
def test_flac_pipeline_equals_wav():
    """FLAC is lossless: the port's pipeline gives bit-identical
    features from test.flac and test.wav."""
    from shennong_tpu_torch import Utterances
    from shennong_tpu_torch.pipeline import (
        extract_features, get_default_config)

    utterances = Utterances([('as_wav', WAV), ('as_flac', FLAC)])
    config = get_default_config('mfcc')
    config['mfcc']['dither'] = 0
    features = extract_features(config, utterances, device='cpu')
    assert np.array_equal(features['as_wav'].data, features['as_flac'].data)
    assert np.array_equal(
        features['as_wav'].times, features['as_flac'].times)
