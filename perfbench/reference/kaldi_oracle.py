"""A literal, per-frame numpy implementation of the Kaldi feature
algorithms.

A frozen copy of ``tests/kaldi_oracle.py``: the benchmark holds its
vectorised reference (:mod:`perfbench.reference.frontend`) against it
at small sizes, and a later change to the test suite cannot move it.

It is written in the most direct style possible (explicit per-frame
loops) and shares no code with the packages it checks.
"""

import numpy as np

FLT_EPS = np.finfo(np.float32).eps


def window_vector(window_type, size, blackman_coeff=0.42):
    out = np.zeros(size, dtype=np.float64)
    a = 2 * np.pi / (size - 1)
    for i in range(size):
        if window_type == 'hanning':
            out[i] = 0.5 - 0.5 * np.cos(a * i)
        elif window_type == 'hamming':
            out[i] = 0.54 - 0.46 * np.cos(a * i)
        elif window_type == 'povey':
            out[i] = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
        elif window_type == 'rectangular':
            out[i] = 1.0
        elif window_type == 'blackman':
            out[i] = (blackman_coeff - 0.5 * np.cos(a * i)
                      + (0.5 - blackman_coeff) * np.cos(2 * a * i))
    return out


def num_frames(nsamples, shift, length, snip_edges):
    if snip_edges:
        if nsamples < length:
            return 0
        return 1 + (nsamples - length) // shift
    return (nsamples + shift // 2) // shift


def extract_window(signal, frame, shift, length, snip_edges):
    if snip_edges:
        start = frame * shift
    else:
        start = shift * frame + shift // 2 - length // 2
    n = len(signal)
    out = np.zeros(length, dtype=np.float64)
    for i in range(length):
        s = start + i
        while s < 0 or s >= n:
            if s < 0:
                s = -s - 1
            else:
                s = 2 * n - 1 - s
        out[i] = signal[s]
    return out


def process_window(window, preemph, remove_dc, win_vec):
    if remove_dc:
        window = window - window.mean()
    raw_energy = np.log(max(np.dot(window, window), FLT_EPS))
    if preemph != 0:
        processed = window.copy()
        for i in range(len(window) - 1, 0, -1):
            processed[i] -= preemph * processed[i - 1]
        processed[0] -= preemph * processed[0]
        window = processed
    window = window * win_vec
    return window, raw_energy


def mel_scale(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def inv_mel_scale(m):
    return 700.0 * (np.exp(m / 1127.0) - 1.0)


def vtln_warp(vlow, vhigh, low, high, factor, freq):
    if freq < low or freq > high:
        return freq
    l_infl = vlow * max(1.0, factor)
    h_infl = vhigh * min(1.0, factor)
    scale = 1.0 / factor
    f_low, f_high = scale * l_infl, scale * h_infl
    if freq < l_infl:
        return low + (f_low - low) / (l_infl - low) * (freq - low)
    if freq < h_infl:
        return scale * freq
    return high + (high - f_high) / (high - h_infl) * (freq - high)


def mel_bank_matrix(num_bins, padded, rate, low, high, vlow, vhigh, warp):
    nyquist = rate / 2
    if high <= 0:
        high += nyquist
    if vhigh < 0:
        vhigh += nyquist
    nbins_fft = padded // 2
    width = rate / padded
    mlow, mhigh = mel_scale(low), mel_scale(high)
    delta = (mhigh - mlow) / (num_bins + 1)

    def warped_mel(mel):
        if warp == 1.0:
            return mel
        return mel_scale(
            vtln_warp(vlow, vhigh, low, high, warp, inv_mel_scale(mel)))

    mat = np.zeros((num_bins, padded // 2 + 1))
    centers = np.zeros(num_bins)
    for b in range(num_bins):
        left = warped_mel(mlow + b * delta)
        center = warped_mel(mlow + (b + 1) * delta)
        right = warped_mel(mlow + (b + 2) * delta)
        centers[b] = inv_mel_scale(center)
        for k in range(nbins_fft):
            mel = mel_scale(width * k)
            if left < mel < right:
                if mel <= center:
                    mat[b, k] = (mel - left) / (center - left)
                else:
                    mat[b, k] = (right - mel) / (right - center)
    return mat, centers


def dct_matrix(num_ceps, num_bins):
    mat = np.zeros((num_ceps, num_bins))
    mat[0, :] = np.sqrt(1.0 / num_bins)
    for k in range(1, num_ceps):
        for n in range(num_bins):
            mat[k, n] = np.sqrt(2.0 / num_bins) * np.cos(
                np.pi / num_bins * (n + 0.5) * k)
    return mat


def lifter(q, num_ceps):
    return np.array(
        [1.0 + 0.5 * q * np.sin(np.pi * i / q) for i in range(num_ceps)])


def mfcc(signal, rate=16000, shift_s=0.01, length_s=0.025,
         preemph=0.97, remove_dc=True, window_type='povey',
         num_bins=23, low=20.0, high=0.0, num_ceps=13,
         use_energy=True, raw_energy=True, cepstral_lifter=22.0,
         htk_compat=False, energy_floor=0.0, vtln=1.0,
         vtln_low=100.0, vtln_high=-500.0, snip_edges=True):
    """Literal Kaldi MfccComputer (dither must be 0)."""
    signal = np.asarray(signal, dtype=np.float64)
    shift = int(rate * shift_s)
    length = int(rate * length_s)
    padded = 1
    while padded < length:
        padded *= 2
    nf = num_frames(len(signal), shift, length, snip_edges)
    win_vec = window_vector(window_type, length)
    mel_mat, _ = mel_bank_matrix(
        num_bins, padded, rate, low, high, vtln_low, vtln_high, vtln)
    dct = dct_matrix(num_ceps, num_bins)
    lif = lifter(cepstral_lifter, num_ceps) if cepstral_lifter else None

    out = np.zeros((nf, num_ceps))
    for f in range(nf):
        window = extract_window(signal, f, shift, length, snip_edges)
        window, raw_e = process_window(window, preemph, remove_dc, win_vec)
        if use_energy and not raw_energy:
            raw_e = np.log(max(np.dot(window, window), FLT_EPS))
        spec = np.fft.rfft(window, n=padded)
        power = spec.real ** 2 + spec.imag ** 2
        mels = np.maximum(mel_mat @ power, FLT_EPS)
        feat = dct @ np.log(mels)
        if lif is not None:
            feat = feat * lif
        if use_energy:
            if energy_floor > 0:
                raw_e = max(raw_e, np.log(energy_floor))
            feat[0] = raw_e
        if htk_compat:
            first = feat[0] * (1.0 if use_energy else np.sqrt(2.0))
            feat = np.concatenate([feat[1:], [first]])
        out[f] = feat
    return out


def fbank(signal, rate=16000, shift_s=0.01, length_s=0.025,
          preemph=0.97, remove_dc=True, window_type='povey',
          num_bins=23, low=20.0, high=0.0, use_energy=False,
          raw_energy=True, use_log=True, use_power=True,
          htk_compat=False, vtln=1.0, snip_edges=True):
    """Literal Kaldi FbankComputer (dither must be 0)."""
    signal = np.asarray(signal, dtype=np.float64)
    shift, length = int(rate * shift_s), int(rate * length_s)
    padded = 1
    while padded < length:
        padded *= 2
    nf = num_frames(len(signal), shift, length, snip_edges)
    win_vec = window_vector(window_type, length)
    mel_mat, _ = mel_bank_matrix(
        num_bins, padded, rate, low, high, 100.0, -500.0, vtln)

    dim = num_bins + (1 if use_energy else 0)
    out = np.zeros((nf, dim))
    for f in range(nf):
        window = extract_window(signal, f, shift, length, snip_edges)
        window, raw_e = process_window(window, preemph, remove_dc, win_vec)
        if use_energy and not raw_energy:
            raw_e = np.log(max(np.dot(window, window), FLT_EPS))
        spec = np.fft.rfft(window, n=padded)
        power = spec.real ** 2 + spec.imag ** 2
        if not use_power:
            power = np.sqrt(power)
        mels = mel_mat @ power
        if use_log:
            mels = np.log(np.maximum(mels, FLT_EPS))
        if use_energy:
            row = (np.concatenate([mels, [raw_e]]) if htk_compat
                   else np.concatenate([[raw_e], mels]))
        else:
            row = mels
        out[f] = row
    return out


def spectrogram(signal, rate=16000, shift_s=0.01, length_s=0.025,
                preemph=0.97, remove_dc=True, window_type='povey',
                raw_energy=True, energy_floor=0.0, snip_edges=True):
    """Literal Kaldi SpectrogramComputer (dither must be 0)."""
    signal = np.asarray(signal, dtype=np.float64)
    shift, length = int(rate * shift_s), int(rate * length_s)
    padded = 1
    while padded < length:
        padded *= 2
    nf = num_frames(len(signal), shift, length, snip_edges)
    win_vec = window_vector(window_type, length)

    out = np.zeros((nf, padded // 2 + 1))
    for f in range(nf):
        window = extract_window(signal, f, shift, length, snip_edges)
        window, raw_e = process_window(window, preemph, remove_dc, win_vec)
        if not raw_energy:
            raw_e = np.log(max(np.dot(window, window), FLT_EPS))
        spec = np.fft.rfft(window, n=padded)
        power = spec.real ** 2 + spec.imag ** 2
        row = np.log(np.maximum(power, FLT_EPS))
        if energy_floor > 0:
            raw_e = max(raw_e, np.log(energy_floor))
        row[0] = raw_e
        out[f] = row
    return out


# ---------------------------------------------------------------------------
# post-processing oracles
# ---------------------------------------------------------------------------

def compute_deltas(feats, order=2, window=2):
    """Literal Kaldi DeltaFeatures::Process"""
    scales = [np.array([1.0])]
    for i in range(1, order + 1):
        prev = scales[i - 1]
        prev_offset = (len(prev) - 1) // 2
        cur_offset = prev_offset + window
        cur = np.zeros(len(prev) + 2 * window)
        normalizer = 0.0
        for j in range(-window, window + 1):
            normalizer += j * j
            for k in range(-prev_offset, prev_offset + 1):
                cur[j + k + cur_offset] += j * prev[k + prev_offset]
        scales.append(cur / normalizer)

    nframes, dim = feats.shape
    out = np.zeros((nframes, (order + 1) * dim))
    for t in range(nframes):
        for i, scale in enumerate(scales):
            offset = (len(scale) - 1) // 2
            acc = np.zeros(dim)
            for j in range(-offset, offset + 1):
                tt = min(max(t + j, 0), nframes - 1)
                acc += scale[j + offset] * feats[tt]
            out[t, i * dim:(i + 1) * dim] = acc
    return out


def sliding_window_cmn(feats, center=True, cmn_window=600,
                       min_window=100, normalize_variance=False):
    """Literal Kaldi SlidingWindowCmn"""
    num_frames, dim = feats.shape
    out = np.zeros_like(feats, dtype=np.float64)
    for t in range(num_frames):
        if center:
            ws = t - cmn_window // 2
            we = ws + cmn_window
        else:
            ws = t - cmn_window
            we = t + 1
        if ws < 0:
            we -= ws
            ws = 0
        if not center and we > t:
            we = max(t + 1, min_window)
        if we > num_frames:
            ws -= we - num_frames
            we = num_frames
            if ws < 0:
                ws = 0
        window = feats[ws:we].astype(np.float64)
        mean = window.mean(axis=0)
        out[t] = feats[t] - mean
        if normalize_variance:
            if we == ws + 1:
                out[t] = 0.0
            else:
                var = (window ** 2).mean(axis=0) - mean ** 2
                var = np.maximum(var, 1.0e-10)
                out[t] *= var ** -0.5
    return out


def vad_energy(feats, energy_threshold=5.0, energy_mean_scale=0.5,
               frames_context=0, proportion_threshold=0.6):
    """Literal Kaldi ComputeVadEnergy"""
    log_energy = feats[:, 0]
    T = len(log_energy)
    cutoff = energy_threshold
    if energy_mean_scale != 0.0:
        cutoff += energy_mean_scale * log_energy.sum() / T
    out = np.zeros(T, dtype=np.uint8)
    for t in range(T):
        num, den = 0, 0
        for t2 in range(t - frames_context, t + frames_context + 1):
            if 0 <= t2 < T:
                den += 1
                if log_energy[t2] > cutoff:
                    num += 1
        out[t] = 1 if num >= den * proportion_threshold else 0
    return out


# ---------------------------------------------------------------------------
# PLP oracle
# ---------------------------------------------------------------------------

def idft_bases(n_bases, dimension):
    angle = np.pi / (dimension - 1)
    scale = 1.0 / (2.0 * (dimension - 1))
    mat = np.zeros((n_bases, dimension))
    for i in range(n_bases):
        mat[i, 0] = scale
        for j in range(1, dimension - 1):
            mat[i, j] = 2.0 * scale * np.cos(angle * i * j)
        mat[i, dimension - 1] = scale * np.cos(angle * i * (dimension - 1))
    return mat


def equal_loudness(centers):
    fsq = centers ** 2
    fsub = fsq / (fsq + 1.6e5)
    return fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))


def durbin(autocorr, order):
    lpc = np.zeros(order)
    tmp = np.zeros(order)
    energy = autocorr[0]
    for i in range(order):
        ki = autocorr[i + 1]
        for j in range(i):
            ki += lpc[j] * autocorr[i - j]
        ki = ki / energy
        c = 1 - ki * ki
        if c < 1.0e-5:
            c = 1.0e-5
        energy *= c
        tmp[i] = -ki
        for j in range(i):
            tmp[j] = lpc[j] - ki * lpc[i - j - 1]
        lpc[:i + 1] = tmp[:i + 1]
    return lpc, energy


def lpc2cepstrum(order, lpc):
    cepstrum = np.zeros(order)
    for i in range(order):
        s = 0.0
        for j in range(i):
            s += (i - j) * lpc[j] * cepstrum[i - j - 1]
        cepstrum[i] = -lpc[i] - s / (i + 1)
    return cepstrum


def plp(signal, rate=16000, shift_s=0.01, length_s=0.025, rasta=False,
        preemph=0.97, remove_dc=True, window_type='povey', num_bins=23,
        low=20.0, high=0.0, lpc_order=12, num_ceps=13, use_energy=True,
        energy_floor=0.0, raw_energy=True, compress=1.0 / 3.0,
        cepstral_lifter=22.0, cepstral_scale=1.0, htk_compat=False,
        vtln=1.0, snip_edges=True):
    """Literal reference PLP recipe (dither must be 0), RASTA via
    scipy.signal.lfilter exactly as shennong/processor/plp.py."""
    import scipy.signal

    signal = np.asarray(signal, dtype=np.float64)
    shift, length = int(rate * shift_s), int(rate * length_s)
    padded = 1
    while padded < length:
        padded *= 2
    nf = num_frames(len(signal), shift, length, snip_edges)
    win_vec = window_vector(window_type, length)
    mel_mat, centers = mel_bank_matrix(
        num_bins, padded, rate, low, high, 100.0, -500.0, vtln)
    eql = equal_loudness(centers)
    idft = idft_bases(lpc_order + 1, num_bins + 2)
    lif = lifter(cepstral_lifter, num_ceps) if cepstral_lifter else None

    # stateful rasta filter (frame by frame, like the reference class)
    rnum = -np.arange(-2, 3) / np.sum(np.arange(-2, 3) ** 2)
    rden = np.array([1, -0.94])
    rasta_count = 0
    rasta_first = []
    rasta_delay = np.dstack(
        (scipy.signal.lfilter_zi(rnum, 1),) * num_bins).squeeze()

    out = np.zeros((nf, num_ceps))
    for f in range(nf):
        window = extract_window(signal, f, shift, length, snip_edges)
        window, raw_e = process_window(window, preemph, remove_dc, win_vec)
        if use_energy and not raw_energy:
            raw_e = np.log(max(np.dot(window, window), FLT_EPS))
        spec = np.fft.rfft(window, n=padded)
        power = spec.real ** 2 + spec.imag ** 2
        mels = mel_mat @ power

        if rasta:
            x = np.log(mels + np.finfo(mels.dtype).eps)
            if rasta_count < 4:
                rasta_first.append(x)
                y = np.zeros(x.shape)
            if rasta_count == 3:
                _, rasta_delay = scipy.signal.lfilter(
                    rnum, 1, np.asarray(rasta_first),
                    zi=rasta_delay * rasta_first[0], axis=0)
            if rasta_count >= 4:
                y, rasta_delay = scipy.signal.lfilter(
                    rnum, rden, [x], zi=rasta_delay, axis=0)
            rasta_count += 1
            mels = np.exp(np.atleast_2d(y)[0, :])

        mels = (mels * eql) ** compress
        dup = np.concatenate([mels[:1], mels, mels[-1:]])
        autocorr = idft @ dup
        lpc, res_energy = durbin(autocorr, lpc_order)
        # Kaldi ComputeLpc returns -log(1/E)/2 = 0.5 * log(E); the
        # reference floors that log-domain value with DBL epsilon
        res_log_e = max(
            0.5 * np.log(res_energy), np.finfo(np.float64).eps)
        cep = lpc2cepstrum(lpc_order, lpc)

        feat = np.concatenate([[res_log_e], cep[:num_ceps - 1]])
        if lif is not None:
            feat *= lif
        if cepstral_scale != 1.0:
            feat *= cepstral_scale
        if use_energy:
            if energy_floor > 0 and raw_e < np.log(energy_floor):
                raw_e = np.log(energy_floor)
            feat[0] = raw_e
        if htk_compat:
            feat = np.concatenate([feat[1:], feat[:1]])
        out[f] = feat
    return out
