"""Literal numpy implementation of the Kaldi pitch tracker (per-frame
loops, direct O(T L^2) Viterbi).

A frozen copy of ``tests/pitch_oracle.py``: the benchmark holds its
vectorised reference (:mod:`perfbench.reference.pitch`) against it at
small sizes, and a later change to the test suite cannot move it."""

import math

import numpy as np


def filter_func(t, cutoff, num_zeros):
    width = num_zeros / (2.0 * cutoff)
    if abs(t) >= width:
        return 0.0
    window = 0.5 * (1 + math.cos(2 * math.pi * cutoff / num_zeros * t))
    if t == 0:
        return 2 * cutoff * window
    return window * math.sin(2 * math.pi * cutoff * t) / (math.pi * t)


def linear_resample(signal, rate_in, rate_out, cutoff, num_zeros):
    n_in = len(signal)
    rate_in, rate_out = int(rate_in), int(rate_out)
    tick = rate_in * rate_out // math.gcd(rate_in, rate_out)
    interval = n_in * (tick // rate_in)
    per_out = tick // rate_out
    last = interval // per_out
    if last * per_out == interval:
        last -= 1
    n_out = last + 1

    width = num_zeros / (2.0 * cutoff)
    out = np.zeros(n_out)
    for j in range(n_out):
        t = j / rate_out
        first = int(math.ceil((t - width) * rate_in))
        last_i = int(math.floor((t + width) * rate_in))
        acc = 0.0
        for n in range(max(first, 0), min(last_i, n_in - 1) + 1):
            acc += filter_func(n / rate_in - t, cutoff, num_zeros) * \
                signal[n]
        out[j] = acc / rate_in
    return out


def viterbi_terms(signal, **kwargs):
    """The oracle's Viterbi ingredients for one signal.

    Returns ``(local, trans, lags, nccf_pov_rs)`` — the per-frame
    local costs, the inter-lag transition cost matrix, the geometric
    lag grid and the ballast-free NCCF — so tests can compute exact
    float64 path costs (e.g. tie margins on lag decisions).
    """
    return compute_pitch(signal, _return_terms=True, **kwargs)


def compute_pitch(signal, rate=16000, shift_s=0.01, length_s=0.025,
                  min_f0=50.0, max_f0=400.0, soft_min_f0=10.0,
                  penalty_factor=0.1, lowpass_cutoff=1000.0,
                  resample_freq=4000.0, delta_pitch=0.005,
                  nccf_ballast=7000.0, lowpass_filter_width=1,
                  upsample_filter_width=5, _return_terms=False):
    rs = linear_resample(
        signal, rate, resample_freq, lowpass_cutoff,
        lowpass_filter_width)
    n_rs = len(rs)

    shift = int(resample_freq * shift_s)
    wsize = int(resample_freq * length_s)
    first_lag = int(math.ceil(resample_freq / max_f0))
    last_lag = int(math.floor(resample_freq / min_f0))
    full = wsize + last_lag

    if n_rs < wsize:
        return np.zeros((0, 2))
    nframes = (n_rs - wsize) // shift + 1

    mean_square = (rs ** 2).mean() - rs.mean() ** 2
    ballast = (mean_square * wsize) ** 2 * nccf_ballast

    # geometric lag grid
    lags = []
    lag = 1.0 / max_f0
    while lag <= 1.0 / min_f0:
        lags.append(lag)
        lag *= 1 + delta_pitch
    lags = np.array(lags)
    nlags_rs = len(lags)

    # upsampling matrix (ArbitraryResample)
    n_meas = last_lag + 1 - first_lag
    up_cutoff = resample_freq * 0.5
    up = np.zeros((nlags_rs, n_meas))
    for g in range(nlags_rs):
        t = lags[g] - first_lag / resample_freq
        for n in range(n_meas):
            up[g, n] = filter_func(
                n / resample_freq - t, up_cutoff,
                upsample_filter_width) / resample_freq

    nccf_pitch = np.zeros((nframes, n_meas))
    nccf_pov = np.zeros((nframes, n_meas))
    for f in range(nframes):
        start = f * shift
        window = np.zeros(full)
        avail = min(full, n_rs - start)
        window[:avail] = rs[start:start + avail]
        window = window - window[:wsize].mean()
        w1 = window[:wsize]
        e1 = np.dot(w1, w1)
        for li, lag_i in enumerate(range(first_lag, last_lag + 1)):
            w2 = window[lag_i:lag_i + wsize]
            e2 = np.dot(w2, w2)
            inner = np.dot(w1, w2)
            denom = math.sqrt(e1 * e2 + ballast)
            nccf_pitch[f, li] = inner / denom if denom != 0 else 0.0
            denom_pov = math.sqrt(e1 * e2)
            nccf_pov[f, li] = inner / denom_pov if denom_pov != 0 else 0.0

    nccf_pitch_rs = nccf_pitch @ up.T
    nccf_pov_rs = nccf_pov @ up.T

    # Viterbi over lag states
    local = 1.0 - nccf_pitch_rs * (1.0 - soft_min_f0 * lags[None, :])
    factor = penalty_factor * math.log(1 + delta_pitch) ** 2
    idx = np.arange(nlags_rs)
    trans = (idx[:, None] - idx[None, :]) ** 2 * factor

    if _return_terms:
        return local, trans, lags, nccf_pov_rs

    forward = local[0].copy()
    back = np.zeros((nframes, nlags_rs), dtype=int)
    for f in range(1, nframes):
        total = forward[:, None] + trans
        back[f] = total.argmin(axis=0)
        forward = local[f] + total.min(axis=0)
        forward -= forward.min()

    best = np.zeros(nframes, dtype=int)
    best[-1] = forward.argmin()
    for f in range(nframes - 1, 0, -1):
        best[f - 1] = back[f, best[f]]

    out = np.zeros((nframes, 2))
    out[:, 0] = nccf_pov_rs[np.arange(nframes), best]
    out[:, 1] = 1.0 / lags[best]
    return out


def nccf_to_pov(n):
    ndash = min(abs(n), 1.0)
    r = (-5.2 + 5.4 * math.exp(7.5 * (ndash - 1)) + 4.8 * ndash
         - 2.0 * math.exp(-10 * ndash) + 4.2 * math.exp(20 * (ndash - 1)))
    return 1.0 / (1 + math.exp(-r))


def process_pitch(raw, pitch_scale=2.0, pov_scale=2.0, pov_offset=0.0,
                  delta_pitch_scale=10.0, delta_pitch_noise_stddev=0.0,
                  left=75, right=75, delta_window=2, delay=0,
                  add_pov=True, add_norm=True, add_delta=True,
                  add_raw=False):
    """Literal Kaldi ProcessPitch (noise stddev must be 0 to compare)."""
    from perfbench.reference.kaldi_oracle import compute_deltas

    T = raw.shape[0]
    nccf = raw[:, 0].copy()
    pitch = raw[:, 1].copy()
    if delay:
        idx = np.maximum(np.arange(T) - delay, 0)
        nccf, pitch = nccf[idx], pitch[idx]

    log_pitch = np.log(pitch)
    cols = []
    if add_pov:
        n = np.clip(nccf, -1, 1)
        cols.append(pov_scale * ((1.0001 - n) ** 0.15 - 1.0) + pov_offset)
    if add_norm:
        pov = np.array([nccf_to_pov(x) for x in nccf])
        out = np.zeros(T)
        for t in range(T):
            lo, hi = max(0, t - left), min(t + right + 1, T)
            avg = np.sum(pov[lo:hi] * log_pitch[lo:hi]) / \
                np.sum(pov[lo:hi])
            out[t] = (log_pitch[t] - avg) * pitch_scale
        cols.append(out)
    if add_delta:
        delta = compute_deltas(
            log_pitch[:, None], order=1, window=delta_window)[:, 1]
        cols.append(delta * delta_pitch_scale)
    if add_raw:
        cols.append(log_pitch)
    return np.stack(cols, axis=1)


def assert_lag_decisions(signal, ours, ref, margin=1e-4, **kwargs):
    """Assert every lag decision matches the oracle or is a proven tie.

    ``ours`` and ``ref`` are [F, 2] (nccf, pitch) matrices. Frames
    whose pitch disagrees beyond 1e-4 relative must be numerical ties:
    the best complete float64 Viterbi path forced through our lag must
    cost within ``margin`` of the optimum. No unexplained disagreement
    is accepted (the contract of ``tests/test_fuzz_parity.py``).
    """
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    same = np.isclose(ours[:, 1], ref[:, 1], rtol=1e-4)
    if not same.all():
        local, trans, lags, _ = viterbi_terms(signal, **kwargs)
        nframes = local.shape[0]
        fwd = np.zeros_like(local)
        fwd[0] = local[0]
        for f in range(1, nframes):
            fwd[f] = local[f] + (fwd[f - 1][:, None] + trans).min(0)
        bwd = np.zeros_like(local)
        for f in range(nframes - 2, -1, -1):
            bwd[f] = (trans + local[f + 1] + bwd[f + 1]).min(1)
        path_cost = fwd + bwd
        best_cost = path_cost.min(axis=1)
        our_idx = np.abs(
            lags[None, :] - 1.0 / ours[:, 1][:, None]).argmin(1)
        margins = (path_cost[np.arange(nframes), our_idx]
                   - best_cost)[~same]
        assert np.max(margins) < margin, (kwargs, same.mean(), margins)
    # NCCF column agrees wherever the lag decision agrees
    assert np.abs(ours[same, 0] - ref[same, 0]).max() < 1e-3, kwargs
    return same
