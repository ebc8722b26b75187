"""Mel filterbank construction with VTLN warping, DCT and lifters.

Replaces ``kaldi.feat.mel`` (``MelBanks``, ``compute_lifter_coeffs``,
``get_equal_loudness_vector``, ``init_idft_bases``; call sites in the
reference at ``shennong/processor/base.py:308`` and
``shennong/processor/plp.py:468-601``). The port's own copy of
``shennong_tpu/ops/mel.py``: every matrix is made once on the host
(numpy, cached), dense, and the port's processors upload it as a plain
matmul operand, one matrix per (options, warp) pair.
"""

import functools
import math

import numpy as np


def mel_scale(freq):
    """Hertz -> mel, Kaldi convention 1127 ln(1 + f/700)"""
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def inverse_mel_scale(mel):
    """mel -> Hertz"""
    return 700.0 * (np.exp(np.asarray(mel, dtype=np.float64) / 1127.0) - 1.0)


def vtln_warp_freq(
        vtln_low_cutoff, vtln_high_cutoff, low_freq, high_freq,
        vtln_warp_factor, freq):
    """Kaldi's piecewise-linear VTLN frequency warping function.

    The map is linear with slope 1/warp in the central band and linear
    segments pinned to (low_freq, high_freq) outside the inflection
    points. Operates elementwise on ``freq`` (numpy array).
    """
    freq = np.asarray(freq, dtype=np.float64)
    if vtln_low_cutoff <= low_freq:
        raise ValueError('be sure to set the vtln_low option higher than '
                         'low_freq')
    if vtln_high_cutoff >= high_freq:
        raise ValueError('be sure to set the vtln_high option lower than '
                         'high_freq (or negative)')

    one = 1.0
    low = vtln_low_cutoff * max(one, vtln_warp_factor)
    high = vtln_high_cutoff * min(one, vtln_warp_factor)
    scale = 1.0 / vtln_warp_factor
    f_low = scale * low
    f_high = scale * high
    scale_left = (f_low - low_freq) / (low - low_freq)
    scale_right = (high_freq - f_high) / (high_freq - high)

    warped = np.where(
        freq < low,
        low_freq + scale_left * (freq - low_freq),
        np.where(
            freq < high,
            scale * freq,
            high_freq + scale_right * (freq - high_freq)))
    # frequencies outside [low_freq, high_freq] pass through unwarped
    return np.where((freq < low_freq) | (freq > high_freq), freq, warped)


def vtln_warp_mel_freq(
        vtln_low_cutoff, vtln_high_cutoff, low_freq, high_freq,
        vtln_warp_factor, mel_freq):
    """VTLN warp expressed on the mel axis"""
    return mel_scale(vtln_warp_freq(
        vtln_low_cutoff, vtln_high_cutoff, low_freq, high_freq,
        vtln_warp_factor, inverse_mel_scale(mel_freq)))


@functools.lru_cache(maxsize=None)
def mel_banks(num_bins, padded_window_size, sample_rate,
              low_freq=20.0, high_freq=0.0,
              vtln_low=100.0, vtln_high=-500.0, vtln_warp=1.0):
    """Dense mel filterbank matrix plus per-bin center frequencies.

    Returns ``(weights, center_freqs)`` where ``weights`` has shape
    ``[num_bins, padded_window_size // 2 + 1]`` — the power spectrum
    (including the Nyquist bin, which always has zero weight like in
    Kaldi) is mapped to mel energies by a single matmul.
    """
    if num_bins < 3:
        raise ValueError('Must have at least 3 mel bins')

    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    if not (0.0 <= low_freq < nyquist
            and 0.0 < high_freq <= nyquist and low_freq < high_freq):
        raise ValueError(
            f'Bad values in options: low-freq {low_freq} and high-freq '
            f'{high_freq} vs. nyquist {nyquist}')

    num_fft_bins = padded_window_size // 2
    fft_bin_width = sample_rate / padded_window_size
    mel_low = float(mel_scale(low_freq))
    mel_high = float(mel_scale(high_freq))
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    if vtln_high < 0.0:
        vtln_high += nyquist
    if vtln_warp != 1.0 and (
            vtln_low < low_freq or vtln_low <= 0.0
            or vtln_high >= high_freq):
        raise ValueError(
            f'Bad values in options: vtln-low {vtln_low} and vtln-high '
            f'{vtln_high}, versus low-freq {low_freq} and high-freq '
            f'{high_freq}')

    def warp(mel):
        if vtln_warp == 1.0:
            return mel
        return vtln_warp_mel_freq(
            vtln_low, vtln_high, low_freq, high_freq, vtln_warp,
            np.asarray(mel))

    fft_freqs = fft_bin_width * np.arange(num_fft_bins)
    fft_mels = mel_scale(fft_freqs)  # [num_fft_bins]

    weights = np.zeros(
        (num_bins, padded_window_size // 2 + 1), dtype=np.float32)
    center_freqs = np.zeros(num_bins, dtype=np.float64)

    for i in range(num_bins):
        left = float(warp(mel_low + i * mel_delta))
        center = float(warp(mel_low + (i + 1) * mel_delta))
        right = float(warp(mel_low + (i + 2) * mel_delta))
        center_freqs[i] = inverse_mel_scale(center)

        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        tri = np.minimum(up, down)
        weights[i, :num_fft_bins] = np.where(tri > 0, tri, 0.0)

    return weights, center_freqs


@functools.lru_cache(maxsize=None)
def dct_matrix(num_ceps, num_bins):
    """Normalized DCT-II matrix, rows 0..num_ceps-1 (Kaldi layout).

    Row 0 is sqrt(1/N); row k>0 is sqrt(2/N) cos(pi/N (n+0.5) k).
    """
    n = np.arange(num_bins, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)[:, None]
    mat = np.sqrt(2.0 / num_bins) * np.cos(
        math.pi / num_bins * (n[None, :] + 0.5) * k)
    mat[0, :] = math.sqrt(1.0 / num_bins)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def lifter_coeffs(cepstral_lifter, num_ceps):
    """Cepstral liftering coefficients: 1 + 0.5 Q sin(pi i / Q)"""
    if cepstral_lifter == 0:
        return np.ones(num_ceps, dtype=np.float32)
    i = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * cepstral_lifter * np.sin(
        math.pi * i / cepstral_lifter)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def idft_bases(n_bases, dimension):
    """Inverse-DFT basis matrix used by PLP to turn mel spectra into
    autocorrelations (Kaldi InitIdftBases)."""
    angle = math.pi / (dimension - 1)
    scale = 1.0 / (2.0 * (dimension - 1))
    i = np.arange(n_bases, dtype=np.float64)[:, None]
    j = np.arange(dimension, dtype=np.float64)[None, :]
    mat = 2.0 * scale * np.cos(angle * i * j)
    mat[:, 0] = scale
    mat[:, dimension - 1] = scale * np.cos(
        angle * i[:, 0] * (dimension - 1))
    return mat.astype(np.float32)


def equal_loudness_vector(center_freqs):
    """Equal-loudness weighting evaluated at the mel center
    frequencies (Kaldi GetEqualLoudnessVector)."""
    f = np.asarray(center_freqs, dtype=np.float64)
    fsq = f * f
    fsub = fsq / (fsq + 1.6e5)
    return (fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))).astype(
        np.float32)
