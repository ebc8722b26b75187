"""The :class:`Audio` container for waveform signals.

The port's own copy of ``shennong_tpu/audio.py``: load, scan and save
audio files, dtype conversions with range validation, channel
extraction, resampling and time segmentation.

Decoding relies on :mod:`scipy.io.wavfile` for WAV and on the port's
native runtime for compressed formats: FLAC through its own decoder
(``native/shennong_flac.cpp``) and mp3/ogg/... through the system
libav* libraries (``native/shennong_codec.cpp``); an ``ffmpeg``
binary, when present, remains a last-resort fallback.
"""

import collections
import functools
import os
import shutil
import subprocess
import warnings
import wave

import numpy as np
import scipy.io.wavfile
import scipy.signal


def _ffmpeg_binary():
    return shutil.which('ffmpeg')


def _is_flac(filename):
    try:
        with open(filename, 'rb') as fp:
            return fp.read(4) == b'fLaC'
    except OSError:
        return False


def _flac_scan_native(filename):
    if not _is_flac(filename):
        return None
    from shennong_tpu_torch import native
    return native.flac_scan(filename)


def _flac_decode_native(filename):
    if not _is_flac(filename):
        return None
    from shennong_tpu_torch import native
    return native.flac_decode(filename)


class Audio:
    """A multichannel audio signal: ``data [nsamples, nchannels]`` + rate.

    Valid sample dtypes and ranges follow the reference convention:
    int16 in [-2^15, 2^15-1], int32 in [-2^31, 2^31-1], float32/float64
    in [-1, 1].
    """

    _metadata = collections.namedtuple(
        '_metadata', 'nchannels sample_rate nsamples duration')

    def __init__(self, data, sample_rate, validate=True):
        self._sample_rate = int(sample_rate)
        # collapse single-channel 2D arrays into 1D
        self._data = (
            data[:, 0] if data.ndim > 1 and data.shape[1] == 1 else data)

        if validate and not self.is_valid():
            raise ValueError(f'invalid audio data for type {self.dtype}')

    def __eq__(self, other):
        if not isinstance(other, Audio):
            return NotImplemented
        return (
            self.sample_rate == other.sample_rate
            and np.array_equal(self.data, other.data))

    @property
    def data(self):
        """The samples as a numpy array"""
        return self._data

    @property
    def sample_rate(self):
        """Sampling frequency in Hertz"""
        return self._sample_rate

    @property
    def duration(self):
        """Signal duration in seconds"""
        return self.nsamples / self.sample_rate

    @property
    def nchannels(self):
        """Number of audio channels"""
        return 1 if self.data.ndim == 1 else self.data.shape[1]

    @property
    def nsamples(self):
        """Number of samples per channel"""
        return self.data.shape[0]

    @property
    def shape(self):
        """Shape of the underlying data array"""
        return self.data.shape

    @property
    def dtype(self):
        """Numeric type of the samples"""
        return self.data.dtype

    @property
    def precision(self):
        """Number of bits per sample"""
        return self.dtype.itemsize * 8

    @classmethod
    def scan(cls, filename):
        """Read audio metadata without loading samples in memory.

        Returns a namedtuple with fields nchannels, sample_rate,
        nsamples and duration. Raises ValueError on unreadable files.
        Cached on (filename, mtime, size) so repeated collection
        sweeps (batch planning, front-end eligibility, streamed
        ordering) never re-read a header, while a file rewritten on
        disk is re-scanned instead of served stale metadata.
        """
        filename = str(filename)
        try:
            stat = os.stat(filename)
        except OSError:
            raise ValueError(f'{filename}: file not found')
        return cls._scan_cached(filename, stat.st_mtime_ns, stat.st_size)

    @classmethod
    # unbounded: entries are ~100-byte metadata tuples, and corpora
    # beyond the default 128 entries would otherwise re-read every
    # header on each of the several full-collection scan sweeps
    @functools.lru_cache(maxsize=None)
    def _scan_cached(cls, filename, _mtime_ns, _size):
        if not os.path.isfile(filename):
            raise ValueError(f'{filename}: file not found')

        # fast path for WAV files
        try:
            with wave.open(filename, 'r') as fwav:
                return cls._metadata(
                    fwav.getnchannels(),
                    fwav.getframerate(),
                    fwav.getnframes(),
                    fwav.getnframes() / fwav.getframerate())
        except (wave.Error, EOFError):
            pass

        # float32 WAVs are rejected by the wave module, retry with scipy
        try:
            rate, data = scipy.io.wavfile.read(filename)
            nchannels = 1 if data.ndim == 1 else data.shape[1]
            return cls._metadata(
                nchannels, rate, data.shape[0], data.shape[0] / rate)
        except ValueError:
            pass

        # FLAC through the native decoder (no ffmpeg needed)
        meta = _flac_scan_native(filename)
        if meta is not None:
            nchannels, rate, _bits, nsamples = meta
            return cls._metadata(
                nchannels, rate, nsamples, nsamples / rate)

        # mp3/ogg/... through the in-process libav* codec runtime;
        # the sample count is the container-duration estimate, as
        # with the reference's ffmpeg probe. A container without a
        # duration field reports 0 samples: decode to count instead of
        # returning zero-length metadata for a decodable file.
        from shennong_tpu_torch import native
        meta = native.codec_scan(filename)
        if meta is not None:
            nchannels, rate, nsamples = meta
            if nsamples <= 0:
                decoded = native.codec_decode(filename)
                nsamples = 0 if decoded is None else decoded[0].shape[0]
            if nsamples > 0:
                return cls._metadata(
                    nchannels, rate, nsamples, nsamples / rate)
            # duration-less container the codec cannot decode either:
            # fall through to the ffmpeg probe, mirroring load()

        # other formats: probe with ffmpeg if available
        if _ffmpeg_binary():
            try:
                out = subprocess.run(
                    [_ffmpeg_binary(), '-hide_banner', '-i', filename,
                     '-f', 'null', '-map', '0:a:0', '-c', 'copy', '-'],
                    capture_output=True, text=True, check=False).stderr
                import re
                chan = 1 if ' mono' in out else (2 if ' stereo' in out else 1)
                rate = int(re.search(r'(\d+) Hz', out).group(1))
                hms = re.search(
                    r'Duration: (\d+):(\d+):([\d.]+)', out).groups()
                duration = (
                    3600 * int(hms[0]) + 60 * int(hms[1]) + float(hms[2]))
                return cls._metadata(
                    chan, rate, int(rate * duration), duration)
            except Exception:
                pass

        raise ValueError(f'cannot scan audio file {filename}')

    # a small cache amortizes repeated loads when extracting many
    # segments from the same file (utterances are sorted by file)
    @classmethod
    @functools.lru_cache(maxsize=2)
    def load(cls, filename):
        """Load an audio file into an :class:`Audio` instance."""
        filename = str(filename)
        if not os.path.isfile(filename):
            raise ValueError(f'{filename}: file not found')

        try:
            rate, data = scipy.io.wavfile.read(filename)
            return cls(data, rate, validate=False)
        except ValueError:
            pass

        # FLAC through the native decoder (sample-exact, no ffmpeg)
        decoded = _flac_decode_native(filename)
        if decoded is not None:
            data, rate = decoded
            return cls(data, rate, validate=False)

        # mp3/ogg/... through the in-process libav* codec runtime
        from shennong_tpu_torch import native
        decoded = native.codec_decode(filename)
        if decoded is not None:
            data, rate = decoded
            return cls(data, rate, validate=False)

        # non-WAV formats decoded through the ffmpeg binary
        if _ffmpeg_binary():
            try:
                proc = subprocess.run(
                    [_ffmpeg_binary(), '-hide_banner', '-i', filename,
                     '-f', 'wav', '-'],
                    capture_output=True, check=True)
                import io
                rate, data = scipy.io.wavfile.read(io.BytesIO(proc.stdout))
                return cls(data, rate, validate=False)
            except Exception as err:
                raise ValueError(
                    f'{filename}: cannot read file, {err}') from None

        raise ValueError(
            f'{filename}: cannot read file (not a WAV, and neither the '
            f'native codec runtime nor an ffmpeg binary could decode it)')

    def save(self, filename):
        """Write the signal to ``filename`` (format from extension)."""
        filename = str(filename)
        if os.path.isfile(filename):
            raise ValueError(f'{filename}: file already exists')
        if '.' not in filename:
            raise ValueError(
                f'{filename}: cannot write audio file without extension')

        extension = filename.split('.')[-1].lower()
        if extension == 'wav':
            scipy.io.wavfile.write(filename, self.sample_rate, self.data)
            return

        # compressed formats through the in-process libav* codec
        # runtime, which takes int16 PCM: int16 sources (and, for the
        # lossy codecs, any dtype through astype) go through it; other
        # sources of lossless formats go to ffmpeg so a FLAC round trip
        # never truncates 24/32-bit or float samples
        from shennong_tpu_torch import native
        lossy = extension in ('mp3', 'ogg', 'oga', 'opus', 'aac', 'm4a')
        if self.dtype == np.dtype(np.int16) or lossy:
            if native.codec_available() and native.codec_encode(
                    filename, self.astype(np.int16).data,
                    self.sample_rate):
                return

        if _ffmpeg_binary():
            import io
            buf = io.BytesIO()
            scipy.io.wavfile.write(buf, self.sample_rate, self.data)
            subprocess.run(
                [_ffmpeg_binary(), '-hide_banner', '-i', '-', filename],
                input=buf.getvalue(), capture_output=True, check=True)
        else:
            raise ValueError(
                f'{filename}: cannot encode .{extension} (neither the '
                f'native codec runtime nor an ffmpeg binary is available)')

    def channel(self, index):
        """Extract channel ``index`` as a mono :class:`Audio`."""
        if index == 0 and self.nchannels == 1:
            return self
        if index >= self.nchannels:
            raise ValueError(
                f'not enough channels ({self.nchannels}) to extract '
                f'the index {index} (indices count starts at 0)')
        return Audio(self.data[:, index], self.sample_rate)

    @staticmethod
    def _is_valid_dtype(dtype):
        return np.dtype(dtype) in (
            np.dtype(np.int16), np.dtype(np.int32),
            np.dtype(np.float32), np.dtype(np.float64))

    def is_valid(self):
        """Check dtype and amplitude range validity of the samples."""
        if not self._is_valid_dtype(self.dtype):
            warnings.warn(f'unsupported audio data type: {self.dtype}')
            return False

        if self.dtype == np.dtype(np.int16):
            emin, emax = -2**15, 2**15 - 1
        elif self.dtype == np.dtype(np.int32):
            emin, emax = -2**31, 2**31 - 1
        else:
            emin, emax = -1, 1

        dmin, dmax = np.amin(self.data), np.amax(self.data)
        if dmin < emin or dmax > emax:
            warnings.warn(
                f'invalid audio for type {self.dtype}: '
                f'boundaries must be in ({emin}, {emax}) '
                f'but are ({dmin}, {dmax})')
            return False
        return True

    def astype(self, dtype):
        """Convert samples to another supported dtype with rescaling.

        Follows the reference scaling rules exactly (int16<->int32 via
        2^15, floats normalized to [-1, 1] via 2^15 or 2^30).
        """
        # normalize and compare with == (not `is`): callers may pass
        # dtype strings or non-interned dtype instances (e.g. arrays
        # born from ctypes buffers)
        dtype = np.dtype(dtype)
        if self.dtype == dtype:
            return self
        if not self._is_valid_dtype(dtype):
            raise ValueError(f'unsupported audio data type: {dtype}')

        if self.dtype == np.dtype(np.int16):
            # widen before scaling: numpy 2 would otherwise wrap the
            # int16 multiplication
            data = (
                self.data.astype(np.int64) * 2**15
                if dtype == np.dtype(np.int32)
                else self.data / 2**15)
        elif self.dtype == np.dtype(np.int32):
            data = (
                self.data / 2**15 if dtype == np.dtype(np.int16)
                else self.data / 2**30)
        else:  # float32 / float64 source
            if dtype == np.dtype(np.int16):
                data = self.data * 2**15
            elif dtype == np.dtype(np.int32):
                data = self.data * 2**30
            else:
                data = self.data

        return Audio(data.astype(dtype), self.sample_rate, validate=False)

    def resample(self, sample_rate, backend='sox'):
        """Return the signal resampled at ``sample_rate``.

        ``backend`` selects the resampling engine: 'sox' (alias of
        'poly', a bandlimited polyphase resampler) or 'scipy' (FFT
        resampling via ``scipy.signal.resample``). Integer signals are
        rounded to the nearest integer and clipped to their type's
        range.
        """
        if backend not in ('sox', 'poly', 'scipy'):
            raise ValueError(
                f'backend must be sox, poly or scipy, it is {backend}')

        if sample_rate == self.sample_rate:
            return self

        if backend == 'scipy':
            nsamples = int(self.nsamples * sample_rate / self.sample_rate)
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                data = scipy.signal.resample(self.data, nsamples)
        else:
            from fractions import Fraction
            frac = Fraction(
                int(sample_rate), int(self.sample_rate)).limit_denominator()
            data = scipy.signal.resample_poly(
                self.data.astype(np.float64), frac.numerator,
                frac.denominator, axis=0)

        if np.issubdtype(self.dtype, np.integer):
            info = np.iinfo(self.dtype)
            data = np.clip(np.rint(data), info.min, info.max)
        return Audio(data.astype(self.dtype), sample_rate, validate=False)

    def segment(self, segments):
        """Slice the signal into chunks given (tstart, tstop) pairs."""
        if not isinstance(segments, list):
            raise ValueError('segments must be a list')
        for seg in segments:
            try:
                if not len(seg) == 2:
                    raise ValueError('segments elements must be pairs')
            except TypeError:
                raise ValueError(
                    'segments elements must be pairs') from None
            if seg[0] >= seg[1]:
                raise ValueError('time indices in segments must be sorted')

        return [
            Audio(
                self.data[
                    int(seg[0] * self.sample_rate):
                    int(seg[1] * self.sample_rate)],
                self.sample_rate, validate=False)
            for seg in segments]
