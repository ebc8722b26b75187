"""Vectorised float64 Kaldi front ends and post-processing in plain torch.

The same arithmetic as the frozen per-frame oracle
(:mod:`perfbench.reference.kaldi_oracle`), over all frames of a signal
at once: framing with snipped edges, DC removal, the raw log energy,
pre-emphasis, the povey window, the power spectrum, the mel bank, MFCC
(DCT and lifter) and PLP (optionally RASTA-filtered, equal loudness,
cube-root compression, Levinson-Durbin and cepstra); the energy VAD,
CMVN and deltas. Every function takes and returns float64 tensors on
the caller's device. Dither (Gaussian noise added to each frame before
DC removal, as Kaldi does) is drawn only from a generator passed in.
"""

import numpy as np
import scipy.signal
import torch

FLT_EPS = float(np.finfo(np.float32).eps)
DBL_EPS = float(np.finfo(np.float64).eps)
DTYPE = torch.float64


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def _inv_mel(m):
    return 700.0 * (np.exp(m / 1127.0) - 1.0)


class FrontEnd:
    """Kaldi framing and spectral analysis at one sample rate.

    ``options`` is the features section of a pipeline configuration
    (``mfcc`` or ``plp``). Options this reference does not implement
    raise ValueError rather than being ignored.
    """

    def __init__(self, kind, options, sample_rate, device):
        self.kind = kind
        self.device = device
        opts = dict(options)
        required = {
            'window_type': 'povey', 'snip_edges': True,
            'remove_dc_offset': True, 'round_to_power_of_two': True,
            'raw_energy': True, 'use_energy': True, 'energy_floor': 0.0,
            'cepstral_lifter': 22.0}
        for key, value in required.items():
            if opts.get(key, value) != value:
                raise ValueError(f'reference: {key}={opts[key]!r} is not '
                                 f'implemented (only {value!r})')
        if kind == 'plp' and float(opts.get('cepstral_scale', 1.0)) != 1.0:
            raise ValueError('reference: cepstral_scale must be 1.0')
        self.rate = float(sample_rate)
        self.shift = int(self.rate * float(opts['frame_shift']))
        self.length = int(self.rate * float(opts['frame_length']))
        self.padded = 1 << (self.length - 1).bit_length()
        self.preemph = float(opts['preemph_coeff'])
        self.num_ceps = int(opts['num_ceps'])
        num_bins = int(opts['num_bins'])

        i = np.arange(self.length)
        a = 2 * np.pi / (self.length - 1)
        window = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
        self.window = torch.tensor(window, dtype=DTYPE, device=device)

        bank, centers = self._mel_bank(
            num_bins, float(opts['low_freq']), float(opts['high_freq']))
        self.bank = torch.tensor(bank, dtype=DTYPE, device=device)
        q = float(opts['cepstral_lifter'])
        lifter = 1.0 + 0.5 * q * np.sin(np.pi * np.arange(self.num_ceps) / q)
        self.lifter = torch.tensor(lifter, dtype=DTYPE, device=device)

        if kind == 'mfcc':
            k = np.arange(self.num_ceps)[:, None]
            n = np.arange(num_bins)[None, :]
            dct = np.sqrt(2.0 / num_bins) * np.cos(
                np.pi / num_bins * (n + 0.5) * k)
            dct[0, :] = np.sqrt(1.0 / num_bins)
            self.dct = torch.tensor(dct, dtype=DTYPE, device=device)
        elif kind == 'plp':
            self.rasta = bool(opts['rasta'])
            self.lpc_order = int(opts['lpc_order'])
            self.compress = float(opts['compress_factor'])
            fsq = centers ** 2
            fsub = fsq / (fsq + 1.6e5)
            loudness = fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))
            self.loudness = torch.tensor(loudness, dtype=DTYPE, device=device)
            dim = num_bins + 2
            angle, scale = np.pi / (dim - 1), 1.0 / (2.0 * (dim - 1))
            ii = np.arange(self.lpc_order + 1)[:, None]
            jj = np.arange(dim)[None, :]
            idft = 2.0 * scale * np.cos(angle * ii * jj)
            idft[:, 0] = scale
            idft[:, -1] = scale * np.cos(angle * ii[:, 0] * (dim - 1))
            self.idft = torch.tensor(idft, dtype=DTYPE, device=device)
        else:
            raise ValueError(f'reference: no front end {kind!r}')

    def _mel_bank(self, num_bins, low, high):
        if high <= 0:
            high += self.rate / 2
        width = self.rate / self.padded
        mlow, mhigh = _mel(low), _mel(high)
        delta = (mhigh - mlow) / (num_bins + 1)
        b = np.arange(num_bins)[:, None]
        left = mlow + b * delta
        center = mlow + (b + 1) * delta
        right = mlow + (b + 2) * delta
        mel = _mel(width * np.arange(self.padded // 2))[None, :]
        up = (mel - left) / (center - left)
        down = (right - mel) / (right - center)
        weights = np.where(mel <= center, up, down)
        weights = np.where((mel > left) & (mel < right), weights, 0.0)
        bank = np.zeros((num_bins, self.padded // 2 + 1))
        bank[:, :self.padded // 2] = weights
        return bank, _inv_mel(center[:, 0])

    def num_frames(self, nsamples):
        if nsamples < self.length:
            return 0
        return 1 + (nsamples - self.length) // self.shift

    def frames(self, signal, dither=None):
        """[F, length] windows of a 1-D float64 signal, DC removed, and
        their raw log energies [F]. ``dither`` is (std, generator) or
        None."""
        frames = signal.unfold(0, self.length, self.shift)
        if dither is not None:
            std, generator = dither
            frames = frames + std * torch.randn(
                frames.shape, generator=generator, dtype=DTYPE,
                device=frames.device)
        frames = frames - frames.mean(dim=1, keepdim=True)
        energy = torch.log(torch.clamp_min(
            (frames * frames).sum(dim=1), FLT_EPS))
        return frames, energy

    def power(self, frames):
        emph = torch.cat([
            frames[:, :1] * (1.0 - self.preemph),
            frames[:, 1:] - self.preemph * frames[:, :-1]], dim=1)
        spec = torch.fft.rfft(emph * self.window, n=self.padded, dim=1)
        return spec.real ** 2 + spec.imag ** 2

    def __call__(self, signal, dither=None):
        """Features [F, num_ceps] and raw log energies [F] of a 1-D
        float64 signal (``dither`` as in :meth:`frames`)."""
        frames, energy = self.frames(signal, dither)
        mels = self.power(frames) @ self.bank.T
        if self.kind == 'mfcc':
            feats = (torch.log(torch.clamp_min(mels, FLT_EPS))
                     @ self.dct.T) * self.lifter
        else:
            feats = self._plp(mels)
        feats[:, 0] = energy
        return feats, energy

    def _plp(self, mels):
        if self.rasta:
            mels = torch.exp(rasta(torch.log(mels + DBL_EPS)))
        mels = (mels * self.loudness) ** self.compress
        dup = torch.cat([mels[:, :1], mels, mels[:, -1:]], dim=1)
        autocorr = dup @ self.idft.T
        lpc, residual = durbin(autocorr, self.lpc_order)
        res_log = torch.clamp_min(0.5 * torch.log(residual), DBL_EPS)
        cep = lpc_to_cepstrum(lpc, self.lpc_order)
        feats = torch.cat(
            [res_log[:, None], cep[:, :self.num_ceps - 1]], dim=1)
        return feats * self.lifter


_RASTA_NUM = -np.arange(-2, 3) / np.sum(np.arange(-2, 3) ** 2)
_RASTA_DEN = np.array([1.0, -0.94])


def rasta(log_mel):
    """The reference's stateful RASTA filter over [F, bins]: the first
    four frames give 0 and prime the FIR state, the rest go through
    the IIR filter from that state (scipy's lfilter, as the per-frame
    oracle calls it, in one call over the frames)."""
    x = log_mel.cpu().numpy()
    y = np.zeros_like(x)
    if x.shape[0] >= 4:
        zi = np.repeat(
            scipy.signal.lfilter_zi(_RASTA_NUM, 1)[:, None], x.shape[1],
            axis=1)
        _, state = scipy.signal.lfilter(
            _RASTA_NUM, 1, x[:4], zi=zi * x[0], axis=0)
        if x.shape[0] > 4:
            y[4:], _ = scipy.signal.lfilter(
                _RASTA_NUM, _RASTA_DEN, x[4:], zi=state, axis=0)
    return torch.as_tensor(y, dtype=DTYPE, device=log_mel.device)


def durbin(autocorr, order):
    """Levinson-Durbin over rows of [F, order + 1]: LPC [F, order] and
    the residual energy [F] (Kaldi's Durbin, floor 1e-5)."""
    lpc = torch.zeros(autocorr.shape[0], order, dtype=DTYPE,
                      device=autocorr.device)
    energy = autocorr[:, 0].clone()
    for i in range(order):
        ki = autocorr[:, i + 1].clone()
        for j in range(i):
            ki = ki + lpc[:, j] * autocorr[:, i - j]
        ki = ki / energy
        energy = energy * torch.clamp_min(1 - ki * ki, 1.0e-5)
        new = lpc.clone()
        new[:, i] = -ki
        for j in range(i):
            new[:, j] = lpc[:, j] - ki * lpc[:, i - j - 1]
        lpc = new
    return lpc, energy


def lpc_to_cepstrum(lpc, order):
    cep = []
    for i in range(order):
        acc = torch.zeros_like(lpc[:, 0])
        for j in range(i):
            acc = acc + (i - j) * lpc[:, j] * cep[i - j - 1]
        cep.append(-lpc[:, i] - acc / (i + 1))
    return torch.stack(cep, dim=1)


def vad(energy, options):
    """Kaldi's energy VAD of one utterance's log energies [F] (0 or 1
    per frame, float64)."""
    context = int(options['frames_context'])
    cutoff = float(options['energy_threshold'])
    scale = float(options['energy_mean_scale'])
    if scale != 0.0:
        cutoff += scale * float(energy.mean())
    above = (energy > cutoff).to(DTYPE)
    frames = torch.ones_like(above)
    if context:
        # frames above the cutoff, and frames, within the context
        kernel = torch.ones(1, 1, 2 * context + 1, dtype=DTYPE,
                            device=energy.device)
        above, frames = (
            torch.nn.functional.conv1d(v[None, None], kernel,
                                       padding=context)[0, 0]
            for v in (above, frames))
    return (above >= frames * float(options['proportion_threshold'])).to(
        DTYPE)


def cmvn_stats(feats, weights):
    """(weighted sums, weighted sums of squares, weight) of [F, D]."""
    return (weights @ feats, weights @ (feats * feats), weights.sum())


def apply_cmvn(feats, stats):
    """Mean and variance normalization with summed statistics."""
    total, squares, count = stats
    mean = total / count
    var = torch.clamp_min(squares / count - mean * mean, 1.0e-20)
    return (feats - mean) / torch.sqrt(var)


def delta_filters(order, window):
    scales = [np.array([1.0])]
    for _ in range(order):
        prev = scales[-1]
        cur = np.zeros(len(prev) + 2 * window)
        for j in range(-window, window + 1):
            cur[j + window:j + window + len(prev)] += j * prev
        scales.append(cur / sum(j * j for j in range(-window, window + 1)))
    return scales


def deltas(feats, order, window):
    """Kaldi's DeltaFeatures of [F, D] with replicated edges:
    [F, (order + 1) D]."""
    nframes = feats.shape[0]
    pad = order * window
    idx = torch.clamp(torch.arange(-pad, nframes + pad, device=feats.device),
                      0, nframes - 1)
    padded = feats[idx]
    out = []
    for scale in delta_filters(order, window):
        half = (len(scale) - 1) // 2
        acc = torch.zeros_like(feats)
        for j, coeff in enumerate(scale):
            start = pad - half + j
            acc = acc + float(coeff) * padded[start:start + nframes]
        out.append(acc)
    return torch.cat(out, dim=1)
