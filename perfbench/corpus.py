"""The one traffic generator: a corpus of speech-like WAV files drawn
from a mix's parameters and a seed.

A mix (``perfbench/traffic/<name>.json``) gives the number of
utterances and speakers, a duration law and its clip. The durations
are the law's quantiles at (i + 0.5) / n, so every seed extracts the
same set of lengths; the seed orders them, assigns the speakers (whose
counts differ by at most one) and draws each signal: voiced harmonics
with a wandering F0 under a syllabic envelope, a little noise, 50 ms of
leading envelope silence (the waveform of ``chip_smoke.speech_like``,
vectorised in torch on the device).
"""

import math
import os
import statistics
import wave

import torch

#: the mixes' sample rate
RATE = 16000


def durations(mix):
    """The mix's utterance durations in seconds, shortest first."""
    count = int(mix['utterances'])
    low, high = (float(x) for x in mix['clip_s'])
    quantiles = [(i + 0.5) / count for i in range(count)]
    if mix['law'] != 'lognormal':
        raise ValueError(f'unknown duration law {mix["law"]!r}')
    normal = statistics.NormalDist(float(mix['ln_mean']),
                                   float(mix['ln_sd']))
    values = [math.exp(normal.inv_cdf(q)) for q in quantiles]
    return [min(max(v, low), high) for v in values]


def plan(mix, seed):
    """[(name, samples, speaker, f0 base, envelope rate)] of a mix in the
    seed's order."""
    rng = torch.Generator().manual_seed(int(seed))
    lengths = [int(round(d * RATE)) for d in durations(mix)]
    order = torch.randperm(len(lengths), generator=rng).tolist()
    speakers = int(mix['speakers'])
    draws = torch.rand(len(lengths), 2, generator=rng, dtype=torch.float64)
    return [
        (f'utt{i:05d}', lengths[j], f'spk{i % speakers:03d}',
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
    entries, samples = [], {}
    for name, count, speaker, f0, rate in plan(mix, seed):
        path = os.path.join(directory, f'{name}.wav')
        write_wav(path, speech_like(count, f0, rate, generator, device).cpu())
        entries.append((name, path, speaker))
        samples[name] = count
    return entries, samples
