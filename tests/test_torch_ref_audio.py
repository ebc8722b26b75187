"""Counterpart of ``tests/test_audio.py``, case for case: the port's
``Audio`` on the conftest's WAVs, with the JAX cases' checks."""

import numpy as np
import pytest

from shennong_tpu_torch.audio import Audio

from tests.torch_ref import audio  # noqa: F401 (fixture)


def test_load(audio):
    assert audio.sample_rate == 16000
    assert audio.nchannels == 1
    assert audio.nsamples == 22713
    assert audio.dtype == np.int16
    assert audio.duration == pytest.approx(1.4195, abs=1e-3)
    assert audio.shape == (22713,)
    assert audio.precision == 16


def test_load_notwav(tmpdir):
    path = str(tmpdir.join('not_a_wav.wav'))
    with open(path, 'w') as fp:
        fp.write('this is not a wav file')
    with pytest.raises(ValueError):
        Audio.load(path)


def test_load_missing():
    with pytest.raises(ValueError, match='file not found'):
        Audio.load('/does/not/exist.wav')


def test_scan(wav_file, audio):
    meta = Audio.scan(wav_file)
    assert meta.nchannels == audio.nchannels
    assert meta.sample_rate == audio.sample_rate
    assert meta.nsamples == audio.nsamples
    assert meta.duration == audio.duration


def test_scan_float32(wav_file_float32):
    meta = Audio.scan(wav_file_float32)
    assert meta.sample_rate == 16000
    assert meta.nsamples == 22713


def test_save_load_roundtrip(tmpdir, audio):
    path = str(tmpdir.join('copy.wav'))
    audio.save(path)
    audio2 = Audio.load(path)
    assert audio == audio2
    with pytest.raises(ValueError, match='already exists'):
        audio.save(path)


def test_channels(data_path):
    stereo = Audio.load(str(data_path / 'test.stereo.wav'))
    assert stereo.nchannels == 2
    left = stereo.channel(0)
    right = stereo.channel(1)
    assert left.nchannels == right.nchannels == 1
    assert left.duration == stereo.duration
    with pytest.raises(ValueError):
        stereo.channel(2)


def test_astype_int16_float(audio):
    as_float = audio.astype(np.float32)
    assert as_float.dtype == np.float32
    assert np.max(np.abs(as_float.data)) <= 1.0
    back = as_float.astype(np.int16)
    assert np.array_equal(back.data, audio.data)


def test_astype_invalid(audio):
    with pytest.raises(ValueError):
        audio.astype(np.uint8)


def test_is_valid():
    good = Audio(np.zeros(10, dtype=np.float64), 16000)
    assert good.is_valid()
    with pytest.raises(ValueError):
        with pytest.warns(UserWarning):
            Audio(np.full(10, 2.0), 16000)  # out of [-1, 1] range


def test_resample(audio):
    for backend in ('sox', 'scipy'):
        resampled = audio.resample(8000, backend=backend)
        assert resampled.sample_rate == 8000
        assert abs(resampled.nsamples - audio.nsamples // 2) <= 1
        assert resampled.dtype == audio.dtype
    with pytest.raises(ValueError):
        audio.resample(8000, backend='bad')


def test_resample_identity(audio):
    assert audio.resample(16000) is audio


def test_segment(audio):
    chunks = audio.segment([(0.0, 0.5), (0.5, 1.0)])
    assert len(chunks) == 2
    assert chunks[0].nsamples == 8000
    assert chunks[0].sample_rate == audio.sample_rate
    with pytest.raises(ValueError, match='must be a list'):
        audio.segment((0, 1))
    with pytest.raises(ValueError, match='sorted'):
        audio.segment([(1.0, 0.5)])
    with pytest.raises(ValueError, match='pairs'):
        audio.segment([(0.0, 0.5, 1.0)])


def test_astype_int32_roundtrip():
    """int16 <-> int32 conversions must widen before scaling."""
    source = Audio(np.array([100, -200, 32767], dtype=np.int16), 16000)
    as32 = source.astype(np.int32)
    assert as32.dtype == np.int32
    assert as32.data.tolist() == [
        100 * 2 ** 15, -200 * 2 ** 15, 32767 * 2 ** 15]
    back = as32.astype(np.int16)
    assert back.data.tolist() == [100, -200, 32767]
    floats = as32.astype(np.float64)
    assert np.max(np.abs(floats.data)) <= 1.0


def test_astype_string_dtype(audio):
    """dtype may arrive as a string or dtype instance; scaling rules
    must not silently change (regression: `is` comparisons matched
    only the type classes)."""
    for spec in ('int32', np.dtype(np.int32), np.int32):
        as32 = audio.astype(spec)
        assert as32.dtype == np.int32
        assert np.array_equal(
            as32.data, audio.data.astype(np.int64) * 2 ** 15)
    as_float = audio.astype('float32')
    assert np.max(np.abs(as_float.data)) <= 1.0
    assert np.array_equal(
        as_float.astype('int16').data, audio.data)


def test_save_lossless_never_truncates(tmpdir, audio):
    """Saving non-int16 samples to a lossless format must preserve
    them (through ffmpeg) or fail loudly - never silently truncate
    through the int16 codec path."""
    from shennong_tpu_torch.audio import _ffmpeg_binary
    as32 = audio.astype(np.int32)
    path = str(tmpdir.join('wide.flac'))
    if _ffmpeg_binary() is None:
        with pytest.raises(ValueError, match='cannot encode'):
            as32.save(path)
    else:  # pragma: nocover - no ffmpeg in this environment
        as32.save(path)
