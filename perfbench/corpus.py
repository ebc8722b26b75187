"""The one traffic generator: a corpus of speech-like WAV files drawn
from a mix's parameters and a seed.

A mix (``perfbench/traffic/<name>.json``) gives the number of
utterances and speakers, a duration law (``lognormal`` with ``ln_mean``
and ``ln_sd``, or ``uniform``) and its clip, ``clip_s``, which is the
uniform law's range. The durations are the law's quantiles at
(i + 0.5) / n, so every seed extracts the same set of lengths; the seed
orders them, assigns the speakers (whose counts differ by at most one)
and draws each signal: voiced harmonics with a wandering F0 under a
syllabic envelope, a little noise, 50 ms of leading envelope silence
(the waveform of ``chip_smoke.speech_like``, vectorised in torch on the
device).

A mix with the key ``"vocal_tract": [low, high]`` gives each speaker a
vocal-tract factor from that range (:func:`vocal_tracts`) and a voice
whose formants it scales (:func:`vocal_tract_like`), so that the
speakers differ as vocal-tract length normalisation assumes.
"""

import math
import os
import statistics
import wave

import torch

#: the mixes' sample rate
RATE = 16000
#: added to the seed for the vocal tracts' own generator, so that
#: neither the plan's draws nor the signals' move
TRACT_SEED = 7919
#: F1-F4 (Hz) of the vowel targets /a/, /i/, /u/: Peterson & Barney's
#: (1952) male means of F1-F3, and F4 at 3.5 kHz
VOWELS = ((730.0, 1090.0, 2440.0, 3500.0),
          (270.0, 2290.0, 3010.0, 3500.0),
          (300.0, 870.0, 2240.0, 3500.0))
#: the formants' bandwidths (Hz) at a vocal-tract factor of 1
BANDWIDTHS = (80.0, 100.0, 140.0, 200.0)
#: the harmonics fade out between these frequencies (Hz)
TOP_HZ = (6500.0, 7500.0)
#: samples between two of the harmonics' amplitudes, which the signal
#: interpolates (5 ms: the formants glide at the syllabic rate)
HOP = 80
#: amplitude intervals synthesised at once
PIECE = 2048
#: the RMS of speech_like's voiced part, which vocal_tract_like keeps
VOICED_RMS = math.sqrt(sum(0.36 ** k for k in range(8)) / 2)


def durations(mix):
    """The mix's utterance durations in seconds, shortest first."""
    count = int(mix['utterances'])
    low, high = (float(x) for x in mix['clip_s'])
    quantiles = [(i + 0.5) / count for i in range(count)]
    if mix['law'] == 'uniform':
        return [low + (high - low) * q for q in quantiles]
    if mix['law'] != 'lognormal':
        raise ValueError(f'unknown duration law {mix["law"]!r}')
    normal = statistics.NormalDist(float(mix['ln_mean']),
                                   float(mix['ln_sd']))
    values = [math.exp(normal.inv_cdf(q)) for q in quantiles]
    return [min(max(v, low), high) for v in values]


def speaker_name(index):
    return f'spk{index:03d}'


def plan(mix, seed):
    """[(name, samples, speaker, f0 base, envelope rate)] of a mix in the
    seed's order."""
    rng = torch.Generator().manual_seed(int(seed))
    lengths = [int(round(d * RATE)) for d in durations(mix)]
    order = torch.randperm(len(lengths), generator=rng).tolist()
    speakers = int(mix['speakers'])
    draws = torch.rand(len(lengths), 2, generator=rng, dtype=torch.float64)
    return [
        (f'utt{i:05d}', lengths[j], speaker_name(i % speakers),
         100.0 + 80.0 * float(draws[i, 0]), 2.5 + float(draws[i, 1]))
        for i, j in enumerate(order)]


def speech_like(nsamples, f0_base, envelope_rate, generator, device):
    """An int16 speech-like waveform on ``device``."""
    t = torch.arange(nsamples, dtype=torch.float64, device=device) / RATE
    f0 = f0_base + 30.0 * torch.sin(2 * math.pi * 0.7 * t)
    phase = 2 * math.pi * torch.cumsum(f0, 0) / RATE
    voiced = torch.zeros_like(t)
    for k in range(8):
        voiced += (0.6 ** k) * torch.sin((k + 1) * phase)
    envelope = (0.5 * (1 + torch.sin(2 * math.pi * envelope_rate * t))) ** 2
    envelope[:int(0.05 * RATE)] = 0
    noise = torch.randn(nsamples, generator=generator, dtype=torch.float64,
                        device=device)
    signal = voiced * envelope * 0.4 + noise * 0.02
    signal = signal / signal.abs().max() * 0.7
    return (signal * 2 ** 15 * 0.8).to(torch.int16)


def vocal_tracts(mix, seed):
    """{speaker: vocal-tract factor} of a mix with the key
    ``vocal_tract``, [low, high]: the range evenly spaced over the
    speakers, in an order drawn from the seed; empty without the key."""
    if 'vocal_tract' not in mix:
        return {}
    low, high = (float(x) for x in mix['vocal_tract'])
    count = int(mix['speakers'])
    rng = torch.Generator().manual_seed(int(seed) + TRACT_SEED)
    order = torch.randperm(count, generator=rng).tolist()
    step = (high - low) / max(count - 1, 1)
    return {speaker_name(s): low + step * order[s] for s in range(count)}


def vocal_tract_like(nsamples, f0_base, envelope_rate, alpha, generator,
                     device):
    """An int16 speech-like waveform on ``device`` from a vocal tract
    scaled by ``alpha``: :func:`speech_like`'s F0, envelope, silence,
    noise floor and scaling, with a broadband voiced source.

    Additive synthesis: harmonic k of the F0, up to about 7 kHz, has a
    glottal source's 1 / k times the formant envelope at its
    instantaneous frequency, the sum of four resonances (F1-F4) whose
    frequencies and bandwidths are ``alpha`` times :data:`VOWELS`'
    targets and :data:`BANDWIDTHS`. Each syllable of the envelope peaks
    on a vowel drawn from ``generator``, and the formants glide from one
    syllable's target to the next. The amplitudes are worked out every
    :data:`HOP` samples and interpolated."""
    f64 = dict(dtype=torch.float64, device=device)
    n = torch.arange(nsamples, **f64)
    t = n / RATE
    # speech_like's phase, the running sum of its F0, in closed form: a
    # scan on CUDA adds in an order that varies from run to run, and the
    # same seed has to give the same bytes
    a = 2 * math.pi * 0.7 / RATE
    cycles = (f0_base * (n + 1) + 30.0 * torch.sin(a * n / 2)
              * torch.sin(a * (n + 1) / 2) / math.sin(a / 2)) / RATE
    cycles = (cycles - torch.floor(cycles)).float()

    # the amplitudes at the samples 0, HOP, 2 HOP, ... past the last
    steps = (nsamples - 1) // HOP + 2
    tc = torch.arange(steps, **f64) * (HOP / RATE)
    f0c = f0_base + 30.0 * torch.sin(2 * math.pi * 0.7 * tc)
    # syllable n peaks at u = n, where the envelope's sine is 1; u starts
    # at -0.25, in syllable -1, and the vowels are counted on the host
    u = envelope_rate * tc - 0.25
    first = torch.floor(u)
    index = (first + 1).long()
    count = int(envelope_rate * (steps - 1) * HOP / RATE) + 3
    vowels = torch.randint(len(VOWELS), (count,), generator=generator,
                           device=device)
    targets = torch.tensor(VOWELS, **f64)[vowels]
    glide = (0.5 * (1 - torch.cos(math.pi * (u - first))))[:, None]
    formants = alpha * torch.lerp(targets[index], targets[index + 1], glide)
    widths = alpha * torch.tensor(BANDWIDTHS, **f64)
    harmonics = int(TOP_HZ[1] // (f0_base - 30.0))
    k = torch.arange(1, harmonics + 1, **f64)[:, None]
    freq = (k * f0c)[:, :, None]
    amplitude = (freq * widths / torch.sqrt(
        (formants ** 2 - freq ** 2) ** 2 + (freq * widths) ** 2)).sum(2)
    fade = ((TOP_HZ[1] - freq[:, :, 0]) / (TOP_HZ[1] - TOP_HZ[0])).clamp(0, 1)
    amplitude *= 0.5 * (1 - torch.cos(math.pi * fade)) / k
    amplitude = amplitude.float()

    turns = (2 * math.pi * k).float()
    voiced = torch.empty(nsamples, **f64)
    for start in range(0, steps - 1, PIECE):
        stop = min(start + PIECE, steps - 1)
        begin, end = start * HOP, min(stop * HOP, nsamples)
        between = torch.nn.functional.interpolate(
            amplitude[None, :, start:stop + 1], size=(stop - start) * HOP + 1,
            mode='linear', align_corners=True)[0, :, :end - begin]
        voiced[begin:end] = (between * torch.sin(
            turns * cycles[begin:end])).sum(0)
    voiced *= VOICED_RMS / voiced.square().mean().sqrt()
    envelope = (0.5 * (1 + torch.sin(2 * math.pi * envelope_rate * t))) ** 2
    envelope[:int(0.05 * RATE)] = 0
    noise = torch.randn(nsamples, generator=generator, dtype=torch.float64,
                        device=device)
    signal = voiced * envelope * 0.4 + noise * 0.02
    signal = signal / signal.abs().max() * 0.7
    return (signal * 2 ** 15 * 0.8).to(torch.int16)


def write_wav(path, samples):
    with wave.open(path, 'wb') as out:
        out.setnchannels(1)
        out.setsampwidth(2)
        out.setframerate(RATE)
        out.writeframes(samples.numpy().astype('<i2').tobytes())


def write_corpus(mix, seed, directory, device):
    """Write the mix's corpus for ``seed`` under ``directory``; returns
    its entries (name, wav path, speaker) and sample counts."""
    generator = torch.Generator(device=device).manual_seed(int(seed))
    tracts = vocal_tracts(mix, seed)
    entries, samples = [], {}
    for name, count, speaker, f0, rate in plan(mix, seed):
        path = os.path.join(directory, f'{name}.wav')
        if tracts:
            signal = vocal_tract_like(count, f0, rate, tracts[speaker],
                                      generator, device)
        else:
            signal = speech_like(count, f0, rate, generator, device)
        write_wav(path, signal.cpu())
        entries.append((name, path, speaker))
        samples[name] = count
    return entries, samples
