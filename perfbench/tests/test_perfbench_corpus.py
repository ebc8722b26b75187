"""The one traffic generator: deterministic per seed, the mix's counts,
clip and one set of lengths for every seed."""

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
