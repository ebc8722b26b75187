"""The plain reference of the benchmark's pipeline configurations.

It works out, in float64 from the WAV files alone, what
``get_default_config(features, with_pitch='kaldi', with_cmvn=True,
with_delta=True)`` asks for: the front end (MFCC or RASTA-PLP), the
energy VAD, CMVN by speaker over the VAD's frames, deltas, Kaldi pitch
and its post-processing, and their concatenation (the longer block
trimmed by at most two frames). It reads nothing the measured program
made, and imports nothing of it.

With a ``generator``, the front end and the VAD's energy are dithered
as the configuration states (independent draws, as the program's two
processors draw theirs); without one, nothing is random.
"""

import wave

import numpy as np
import torch

from perfbench.reference.frontend import (
    FrontEnd, apply_cmvn, cmvn_stats, deltas, vad)
from perfbench.reference.pitch import Pitch, post

#: utterances whose pitch is decoded in one Viterbi batch
PITCH_BATCH = 64


def read_wav(path):
    """(int16 samples, sample rate) of a mono 16-bit PCM WAV file."""
    with wave.open(str(path), 'rb') as wav:
        if wav.getnchannels() != 1 or wav.getsampwidth() != 2:
            raise ValueError(f'{path}: not mono 16-bit PCM')
        rate = wav.getframerate()
        data = wav.readframes(wav.getnframes())
    return np.frombuffer(data, dtype='<i2'), rate


def features_section(config):
    kinds = [k for k in ('mfcc', 'plp') if k in config]
    if len(kinds) != 1 or set(config) - {kinds[0], 'pitch', 'cmvn',
                                          'delta'}:
        raise ValueError('reference: a configuration of mfcc or plp with '
                         'pitch, cmvn and delta sections only')
    return kinds[0]


class Reference:
    """The pipeline of ``config`` at ``sample_rate`` on ``device``."""

    def __init__(self, config, sample_rate, device, generator=None):
        self.kind = features_section(config)
        self.config = config
        if config['pitch']['processor'] != 'kaldi':
            raise ValueError('reference: Kaldi pitch only')
        if not (config['cmvn']['by_speaker'] and config['cmvn']['with_vad']):
            raise ValueError('reference: CMVN by speaker with the VAD only')
        self.front = FrontEnd(self.kind, config[self.kind], sample_rate,
                              device)
        self.pitch = Pitch(config['pitch'], sample_rate, device)
        self.rate = sample_rate
        self.device = device
        self.generator = generator
        #: the energy processor's dither, which the pipeline does not set
        self.energy_dither = 1.0

    def _signal(self, path):
        samples, rate = read_wav(path)
        if rate != self.rate:
            raise ValueError(f'{path}: {rate} Hz, not {self.rate}')
        return torch.as_tensor(samples.astype(np.float64), device=self.device)

    def extract(self, entries, names):
        """Final features [frames, columns] (float64 numpy) of the
        utterances ``names``, from ``entries`` of (name, wav, speaker):
        the CMVN statistics of a speaker are taken over all its
        entries, so pass every utterance of the speakers of ``names``.
        """
        blocks = self.front_end(entries, names)
        pitches = self._pitches({name: self._signal(path)
                                 for name, path, _ in entries
                                 if name in blocks})
        out = {}
        for name in names:
            first, second = blocks[name], pitches[name]
            if abs(first.shape[0] - second.shape[0]) > 2:
                raise ValueError(f'{name}: {first.shape[0]} feature frames '
                                 f'against {second.shape[0]} pitch frames')
            rows = min(first.shape[0], second.shape[0])
            out[name] = torch.cat(
                [first[:rows], second[:rows]], dim=1).cpu().numpy()
        return out

    def front_end(self, entries, names):
        """The front end's features of ``names`` after CMVN and deltas,
        [feature frames, (order + 1) ceps] float64 tensors by name."""
        by_speaker = {}
        for name, path, speaker in entries:
            by_speaker.setdefault(speaker, []).append((name, path))
        wanted = set(names)
        delta = self.config['delta']
        blocks = {}
        for members in by_speaker.values():
            if not any(name in wanted for name, _ in members):
                continue
            feats, stats = {}, None
            for name, path in members:
                signal = self._signal(path)
                if self.generator is None:
                    raw, energy = self.front(signal)
                else:
                    raw, _ = self.front(signal, (float(
                        self.config[self.kind]['dither']), self.generator))
                    _, energy = self.front.frames(
                        signal, (self.energy_dither, self.generator))
                weights = vad(energy, self.config['cmvn']['vad'])
                part = cmvn_stats(raw, weights)
                stats = part if stats is None else tuple(
                    a + b for a, b in zip(stats, part))
                if name in wanted:
                    feats[name] = raw
            for name, raw in feats.items():
                blocks[name] = deltas(apply_cmvn(raw, stats),
                                      int(delta['order']),
                                      int(delta['window']))
        return blocks

    def _pitches(self, signals):
        """Post-processed pitch of each signal, decoded in batches of
        similar length."""
        names = sorted(signals, key=lambda n: signals[n].shape[0])
        options = self.config['pitch']['postprocessing']
        out = {}
        for start in range(0, len(names), PITCH_BATCH):
            batch = names[start:start + PITCH_BATCH]
            raws = self.pitch.raw([signals[n] for n in batch])
            for name, raw in zip(batch, raws):
                out[name] = post(raw, options)
        return out
