"""BUT/Phonexia stacked-bottleneck network and its HTK-style front end.

Counterpart of :mod:`shennong_tpu.models.bottleneck`: HTK mel
filterbank (24 channels, 64-3800 Hz on 8 kHz audio, hamming 200/80
frames, NFFT 256), GMM-based energy VAD (3-component EM on normalized
frame energies, on the host in float64), context windowing with
hamming-weighted DCT compression (host), and the two-stage MLP with
5-offset stagger stacking between the stages. The filterbank
(:func:`fbank_htk`) and the MLP (:func:`stacked_bn_forward`) run on
the device of their input tensors.
"""

import functools

import numpy as np
import scipy.fftpack
import scipy.special
import torch


# ------------------------------------------------------------ HTK fbank

def mel_htk(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=float) / 700.0)


def mel_htk_inverse(mel):
    return (np.exp(np.asarray(mel, dtype=float) / 1127.0) - 1.0) * 700.0


@functools.lru_cache(maxsize=None)
def mel_filterbank_htk(window_length, sample_rate, num_chans=20,
                       low_freq=0.0, high_freq=None):
    """HTK-compatible mel filterbank matrix [nfft // 2 + 1, num_chans].

    Bin edges are placed on floor-rounded FFT indices (the HTK
    convention used by the BUT extractor), unlike Kaldi's continuous
    triangles.
    """
    if not high_freq:
        high_freq = 0.5 * sample_rate
    nfft = 2 ** int(np.ceil(np.log2(window_length)))

    fft_mels = mel_htk(np.arange(nfft // 2 + 1, dtype=float)
                       * sample_rate / nfft)
    edges_mel = np.linspace(
        mel_htk(low_freq), mel_htk(high_freq), num_chans + 2)
    edge_bins = np.floor(
        mel_htk_inverse(edges_mel) / sample_rate * nfft).astype(int) + 1

    bank = np.zeros((len(fft_mels), num_chans))
    for chan in range(num_chans):
        lo, mid, hi = edge_bins[chan:chan + 3]
        bank[lo:mid, chan] = (
            (edges_mel[chan] - fft_mels[lo:mid])
            / (edges_mel[chan] - edges_mel[chan + 1]))
        bank[mid:hi, chan] = (
            (edges_mel[chan + 2] - fft_mels[mid:hi])
            / (edges_mel[chan + 2] - edges_mel[chan + 1]))
    if low_freq > 0.0 and low_freq / sample_rate * nfft + 0.5 > \
            edge_bins[0]:
        bank[edge_bins[0], :] = 0.0  # HTK compatibility
    return bank.astype(np.float32)


def frame_signal(signal, window, shift):
    """[T] -> [nframes, window] strided framing (HTK convention), numpy
    or tensor."""
    nframes = (len(signal) - window) // shift + 1
    if torch.is_tensor(signal):
        return signal[:(nframes - 1) * shift + window].unfold(
            0, window, shift)
    idx = (np.arange(nframes)[:, None] * shift
           + np.arange(window)[None, :])
    return signal[idx]


def fbank_htk(frames, window_vec, bank, nfft):
    """Log mel-filterbank outputs of hamming-windowed frames.

    ``frames`` [N, window], ``window_vec`` [window] and ``bank``
    [nfft // 2 + 1, C] float32 tensors on one device. Matches the BUT
    extractor: power spectrum, filterbank product, log with an absolute
    floor of 1.0.
    """
    spectrum = torch.fft.rfft(frames * window_vec, n=nfft, dim=-1)
    power = spectrum.real ** 2 + spectrum.imag ** 2
    return torch.log(torch.clamp(power @ bank, min=1.0))


# ------------------------------------------------------------- GMM VAD

def _gmm_posteriors_1d(x, weights, means, variances):
    """Log-likelihood per (frame, component) of a 1-D diagonal GMM."""
    log_norm = -0.5 * (np.log(2 * np.pi * variances)
                       + (x[:, None] - means[None, :]) ** 2
                       / variances[None, :])
    return log_norm + np.log(weights)[None, :]


def compute_vad(signal, log, win_length=200, win_overlap=120,
                n_realignment=5, threshold=0.3, bugfix=False):
    """Energy GMM voice activity detection (BUT algorithm), on the host
    in float64.

    A 3-component GMM (initial means -1, 0, 1) is EM-fitted on the
    normalized frame energies; frames whose posterior of the
    lowest-energy component falls under ``threshold`` are voiced.

    ``bugfix=False`` (the reference default) squares the int16 samples
    in int16 arithmetic, wrapping on overflow, as the published BUT
    networks were used; ``bugfix=True`` squares in float64.
    """
    if bugfix:
        squared = signal.astype(np.float64) ** 2
    else:
        # squaring in the input dtype: int16 samples wrap modulo 2**16
        squared = signal ** 2
    frames = frame_signal(squared, win_length, win_length - win_overlap)
    energy = frames.sum(axis=1).astype(np.float64)

    std = energy.std()
    if std == 0:
        log.warning('signal contains only silence')
        return np.zeros(len(energy), dtype=bool)
    energy = (energy - energy.mean()) / std

    weights = np.array([1 / 3, 1 / 3, 1 / 3])
    means = np.array([-1.0, 0.0, 1.0])
    variances = np.array([1.0, 1.0, 1.0])

    for _ in range(n_realignment):
        log_like = _gmm_posteriors_1d(energy, weights, means, variances)
        log_norm = scipy.special.logsumexp(log_like, axis=1)
        gamma = np.exp(log_like - log_norm[:, None])
        counts = gamma.sum(axis=0)
        weights = counts / counts.sum()
        means = (gamma * energy[:, None]).sum(axis=0) / counts
        variances = (
            (gamma * energy[:, None] ** 2).sum(axis=0) / counts
            - means ** 2)

    log_like = _gmm_posteriors_1d(energy, weights, means, variances)
    log_norm = scipy.special.logsumexp(log_like, axis=1)
    posterior = np.exp(log_like - log_norm[:, None])
    return posterior[:, 0] < threshold


# ------------------------------------------------- context preprocessing

@functools.lru_cache(maxsize=None)
def context_compression_matrix(context):
    """Hamming-weighted DCT basis compressing a (2*context+1)-frame
    window of one filterbank channel into 6 coefficients."""
    window = 2 * context + 1
    dct = scipy.fftpack.idct(np.eye(6, window), norm='ortho')
    dct[0] = np.sqrt(2.0 / window)
    return (dct * np.hamming(window)).T.astype(np.float32)  # [win, 6]


def preprocess_nn_input(features, context):
    """[T, C] filterbank -> [T - 2*context, C*6] network input (host)."""
    window = 2 * context + 1
    nframes = features.shape[0] - window + 1
    idx = np.arange(nframes)[:, None] + np.arange(window)[None, :]
    framed = features[idx].transpose(0, 2, 1)  # [T', C, win]
    compress = context_compression_matrix(context)
    out = framed.reshape(-1, window) @ compress
    return out.reshape(nframes, -1)


# ---------------------------------------------------------- the network

def stacked_bn_forward(params, nn_input):
    """Two-stage stacked-bottleneck MLP forward.

    ``params`` holds tensors in the BUT npz layout (see
    :func:`shennong_tpu_torch.weights.bottleneck_from_numpy`):
    ``input_mean``/``input_std`` whitening, the first stage W1..W3 (two
    sigmoid layers and a linear bottleneck), the stagger stacking of 5
    offsets, ``bn_mean``/``bn_std`` whitening and the second stage
    W5.. (sigmoids and a linear output). ``nn_input`` [..., T, D]
    (leading dimensions are a batch of utterances); returns the
    second-stage output [..., T - 20, 80].
    """
    x = (nn_input + params['input_mean']) * params['input_std']

    stage1 = sorted(int(k[1:]) for k in params
                    if k.startswith('W') and int(k[1:]) <= 3)
    for i, idx in enumerate(stage1):
        x = x @ params[f'W{idx}'] + params[f'b{idx}']
        if i < len(stage1) - 1:
            x = torch.sigmoid(x)

    # stagger stacking: the bottleneck at 5 offsets, along time
    steps = x.shape[-2]
    stacked = torch.cat(
        [x[..., offset:steps - 20 + offset, :]
         for offset in range(0, 21, 5)], dim=-1)
    y = (stacked + params['bn_mean']) * params['bn_std']

    stage2 = sorted(int(k[1:]) for k in params
                    if k.startswith('W') and int(k[1:]) >= 5)
    for i, idx in enumerate(stage2):
        y = y @ params[f'W{idx}'] + params[f'b{idx}']
        if i < len(stage2) - 1:
            y = torch.sigmoid(y)
    return y
