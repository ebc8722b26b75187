"""The port's seeded ABX benchmark against the JAX package, on the CPU.

The synthesizer's signals are equal to the JAX package's (the same
numpy and scipy code from the same seed). ``benchmark('ci')`` on the
CPU lands inside the magnitude locks and directions of
``tests/test_abx_bench.py`` (0.03 around the recorded values), its
warps are equal to the JAX run's for every speaker, and its errors are
within 0.005 of the JAX run's. The two runs differ only by float32
rounding in the features and the DTW divergences, which can flip a
comparison of two nearly equal divergences; on a CPU the errors have
come out equal.
"""

import warnings

import numpy as np
import pytest

from shennong_tpu.eval import abx_bench as jbench
from shennong_tpu_torch.eval import abx_bench

#: the recorded 'ci' values (tests/test_abx_bench.py)
RECORDED = {
    'across': {
        'mfcc': {'raw': 0.339, '+cmvn': 0.207, 'vtln+cmvn': 0.171},
        'rastaplp': {'raw': 0.200, '+cmvn': 0.172, 'vtln+cmvn': 0.135}},
    'within': {
        'mfcc': {'raw': 0.308, '+cmvn': 0.259, 'vtln+cmvn': 0.252},
        'rastaplp': {'raw': 0.160, '+cmvn': 0.139}},
}
BAND = 0.030
JAX_TOL = 0.005


@pytest.fixture(scope='module')
def ours():
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return abx_bench.benchmark(
            'ci', seed=0, features=('mfcc', 'rastaplp'), device='cpu')


@pytest.fixture(scope='module')
def theirs():
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return jbench.benchmark(
            'ci', seed=0, features=('mfcc', 'rastaplp'))


def test_corpus_definition_matches_jax():
    assert abx_bench.CONFIGS == jbench.CONFIGS
    assert abx_bench.FEATURES == jbench.FEATURES
    for nphones in (4, 10):
        assert abx_bench.phone_formants(nphones) == jbench.phone_formants(
            nphones)
    for nspeakers in (8, 20):
        ours, theirs = (abx_bench.speaker_profiles(nspeakers),
                        jbench.speaker_profiles(nspeakers))
        assert ours.keys() == theirs.keys()
        for speaker, (alpha, fir, depth) in ours.items():
            assert (alpha, depth) == (theirs[speaker][0], theirs[speaker][2])
            np.testing.assert_array_equal(fir, theirs[speaker][1])
    for token in range(10):
        assert abx_bench.segment_slice(token) == jbench.segment_slice(token)
    phones = sorted(abx_bench.phone_formants(4))
    assert abx_bench._utterance_order('s01-eval-2', 0, phones * 3) == \
        jbench._utterance_order('s01-eval-2', 0, phones * 3)


@pytest.mark.parametrize('tag,speaker,seed', [
    ('s00-eval-0', 's00', 0), ('s07-train-1', 's07', 0),
    ('s03-eval-2', 's03', 5)])
def test_signals_equal_jax(tag, speaker, seed):
    phones = abx_bench.phone_formants(4)
    profile = abx_bench.speaker_profiles(8)[speaker]
    order = abx_bench._utterance_order(tag, seed, sorted(phones))
    ours = abx_bench.synthesize_utterance(order, phones, profile, tag, seed)
    theirs = jbench.synthesize_utterance(
        order, phones, jbench.speaker_profiles(8)[speaker], tag, seed)
    assert ours.dtype == np.int16
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize('feature', ['mfcc', 'rastaplp'])
def test_ci_magnitudes_and_directions(ours, feature):
    across = ours['errors']['across'][feature]
    within = ours['errors']['within'][feature]
    for task, values in RECORDED.items():
        for label, recorded in values[feature].items():
            got = ours['errors'][task][feature][label]
            assert abs(got - recorded) < BAND, (task, feature, label, got)
    assert across['raw'] > across['+cmvn'] > across['vtln+cmvn']
    assert within['raw'] > within['+cmvn']


def test_ci_errors_match_jax(ours, theirs):
    for task in ('across', 'within'):
        for feature in ('mfcc', 'rastaplp'):
            assert ours['errors'][task][feature].keys() == \
                theirs['errors'][task][feature].keys()
            for label, got in ours['errors'][task][feature].items():
                want = theirs['errors'][task][feature][label]
                assert abs(got - want) < JAX_TOL, (task, feature, label)


def test_ci_warps_equal_jax_and_track_vocal_tract(ours, theirs):
    assert ours['warps'] == theirs['warps']
    assert ours['alphas'] == theirs['alphas']
    assert ours['nsegments'] == theirs['nsegments'] == 96
    # warp ~ 1/alpha: decreasing in alpha, away from the grid's edges
    alphas = ours['alphas']
    ordered = [ours['warps'][s] for s in sorted(alphas, key=alphas.get)]
    assert all(a >= b for a, b in zip(ordered, ordered[1:])), ordered
    assert ordered[0] - ordered[-1] >= 0.15, ordered
    assert 0.85 < min(ordered) and max(ordered) < 1.25


def test_benchmark_reports_its_stages(ours):
    assert set(ours['seconds']) == {
        'synthesis', 'vtln', 'extraction', 'dtw', 'abx_error'}
    assert all(seconds > 0 for seconds in ours['seconds'].values())
