"""The one traffic generator: deterministic per seed, the mix's counts,
clip and one set of lengths for every seed; the same bytes as before
for a mix without a vocal tract, and speakers whose formants scale with
their factor for a mix with one."""

import hashlib
import json
import math
import os
import statistics

import numpy as np
import pytest
import torch

from perfbench import corpus
from perfbench.manifest import HERE
from perfbench.reference.pipeline import read_wav
from perfbench.tests.helpers import TINY

SEEDS = (3, 2 ** 31 + 11)
#: the default range of vocal-tract factors: adult speakers' warp
#: searches span about 0.88-1.12 (Lee & Rose, 1998)
TRACTS = [0.88, 1.14]
#: sha256 of the WAV files of a corpus written on the CPU, in the order
#: of its entries, frozen before the vocal tracts were added
DIGESTS = {
    ('tiny', SEEDS[0]):
        '95b7549ce68767b0d48f364baaadc926910dcf44b0b08b2116de7848c0de8e79',
    ('tiny', SEEDS[1]):
        '2443bbda378f3eaad8bffcfa52eb4197efb31e879015318b04e6493356e5209f',
    ('test_clean_2spk', SEEDS[0]):
        '103ab249d99acf84e2d5ed32da4e2e1b37011770d68f9c3d24d1fdb95f27b7a0',
}


def mix(name):
    with open(os.path.join(HERE, 'traffic', f'{name}.json')) as handle:
        return json.load(handle)


@pytest.mark.parametrize('name', ['test_clean', 'tiny'])
def test_the_mix_s_counts_and_clip(name):
    traffic = TINY if name == 'tiny' else mix(name)
    low, high = traffic['clip_s']
    plans = [corpus.plan(traffic, seed) for seed in SEEDS]
    for plan in plans:
        assert len(plan) == traffic['utterances']
        lengths = [count for _, count, _, _, _ in plan]
        assert low * corpus.RATE - 1 <= min(lengths)
        assert max(lengths) <= high * corpus.RATE + 1
        counts = statistics.multimode([s for _, _, s, _, _ in plan])
        per = {}
        for _, _, speaker, _, _ in plan:
            per[speaker] = per.get(speaker, 0) + 1
        assert len(per) == traffic['speakers']
        assert max(per.values()) - min(per.values()) <= 1
        assert counts
    # every seed extracts the same lengths, in another order
    assert sorted(c for _, c, _, _, _ in plans[0]) == sorted(
        c for _, c, _, _, _ in plans[1])
    assert [c for _, c, _, _, _ in plans[0]] != [
        c for _, c, _, _, _ in plans[1]]


def test_test_clean_totals_the_published_hours():
    durations = corpus.durations(mix('test_clean'))
    assert math.isclose(sum(durations) / 3600, 5.4, abs_tol=0.05)
    assert math.isclose(statistics.median(durations), 6.4, abs_tol=0.1)


def test_the_corpus_is_deterministic_per_seed(tmp_path):
    written = []
    for index, seed in enumerate((SEEDS[1], SEEDS[1], SEEDS[0])):
        directory = tmp_path / str(index)
        directory.mkdir()
        entries, samples = corpus.write_corpus(TINY, seed, str(directory),
                                               'cpu')
        assert len(entries) == TINY['utterances']
        audio = [read_wav(path) for _, path, _ in entries]
        assert all(rate == corpus.RATE for _, rate in audio)
        assert [len(a) for a, _ in audio] == [samples[n] for n, _, _ in
                                              entries]
        written.append((entries, [a for a, _ in audio]))
    (first, a), (second, b), (_, c) = written
    assert [e[0] for e in first] == [e[0] for e in second]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(len(x) == len(y) and np.array_equal(x, y)
                   for x, y in zip(a, c))


def test_speech_like_is_int16_with_a_silent_start():
    x = corpus.speech_like(16000, 150.0, 3.0, torch.Generator(), 'cpu')
    assert x.dtype == torch.int16
    lead = x[:800].float().abs().mean()
    body = x[4000:].float().abs().mean()
    assert lead < body / 5


def digest(entries):
    sha = hashlib.sha256()
    for _, path, _ in entries:
        with open(path, 'rb') as handle:
            sha.update(handle.read())
    return sha.hexdigest()


@pytest.mark.parametrize('name, seed', sorted(DIGESTS))
def test_a_mix_without_vocal_tracts_writes_the_same_bytes(name, seed,
                                                          tmp_path):
    traffic = TINY if name == 'tiny' else mix(name)
    entries, _ = corpus.write_corpus(traffic, seed, str(tmp_path), 'cpu')
    assert digest(entries) == DIGESTS[name, seed]


def test_the_uniform_law_spreads_the_clip_evenly():
    # meeting recordings: 6 of 1,200-2,700 s
    meetings = {'law': 'uniform', 'utterances': 6, 'speakers': 6,
                'clip_s': [1200, 2700]}
    assert corpus.durations(meetings) == pytest.approx(
        [1325.0, 1575.0, 1825.0, 2075.0, 2325.0, 2575.0])
    lengths = sorted(count for _, count, _, _, _ in corpus.plan(meetings, 5))
    assert lengths == [d * corpus.RATE for d in corpus.durations(meetings)]


def test_vocal_tracts_spread_the_range_over_the_speakers(monkeypatch,
                                                         tmp_path):
    traffic = dict(TINY, speakers=4, vocal_tract=TRACTS)
    tracts = corpus.vocal_tracts(traffic, SEEDS[1])
    assert tracts == corpus.vocal_tracts(traffic, SEEDS[1])
    assert sorted(tracts) == sorted(
        {s for _, _, s, _, _ in corpus.plan(traffic, SEEDS[1])})
    assert sorted(tracts.values()) == pytest.approx(
        [0.88, 0.88 + 0.26 / 3, 0.88 + 0.52 / 3, 1.14])
    orders = {tuple(sorted(corpus.vocal_tracts(traffic, seed),
                           key=corpus.vocal_tracts(traffic, seed).get))
              for seed in range(6)}
    assert len(orders) > 1
    assert corpus.vocal_tracts(TINY, SEEDS[1]) == {}
    # the plan is the same with and without the key
    assert corpus.plan(traffic, SEEDS[1]) == corpus.plan(
        dict(TINY, speakers=4), SEEDS[1])

    # every utterance of a speaker is voiced with the speaker's factor
    voiced = []
    synthesis = corpus.vocal_tract_like

    def recorded(nsamples, f0, rate, alpha, generator, device):
        voiced.append(alpha)
        return synthesis(nsamples, f0, rate, alpha, generator, device)

    monkeypatch.setattr(corpus, 'vocal_tract_like', recorded)
    written = []
    for index in range(2):
        directory = tmp_path / str(index)
        directory.mkdir()
        entries, _ = corpus.write_corpus(traffic, SEEDS[1], str(directory),
                                         'cpu')
        written.append(digest(entries))
    assert written[0] == written[1]
    speakers = [speaker for _, _, speaker in entries]
    assert voiced[len(speakers):] == [tracts[s] for s in speakers]


def long_term_spectrum(signals):
    """The mean power spectrum (512-point frames, 10 ms apart) of the
    signals, and its frequencies."""
    window = torch.hann_window(512, dtype=torch.float64)
    power = torch.cat([
        torch.stft(torch.tensor(x, dtype=torch.float64), 512, 160,
                   window=window, return_complex=True).abs().square().T
        for x in signals]).mean(0)
    return power, torch.arange(power.numel()) * corpus.RATE / 512


def test_a_speaker_s_second_formant_scales_with_the_vocal_tract(tmp_path):
    # 6 utterances of 3-4 s a speaker, about 70 syllables, so that each
    # speaker's vowels come in about the same shares
    traffic = {'law': 'uniform', 'utterances': 24, 'speakers': 4,
               'clip_s': [3.0, 4.0], 'vocal_tract': TRACTS}
    entries, _ = corpus.write_corpus(traffic, SEEDS[0], str(tmp_path),
                                     'cpu')
    tracts = corpus.vocal_tracts(traffic, SEEDS[0])
    ratios = {}
    for speaker, alpha in tracts.items():
        power, freq = long_term_spectrum(
            read_wav(path)[0] for _, path, s in entries if s == speaker)
        # F2 of /i/ and F3 of /a/ and /u/, 2,240-2,440 Hz at a factor 1
        region = (freq > 1500) & (freq < 3200)
        ratios[speaker] = float(freq[region][power[region].argmax()]) / alpha
    middle = statistics.median(ratios.values())
    assert 2100 < middle < 2500
    assert all(abs(r / middle - 1) <= 0.05 for r in ratios.values()), ratios
