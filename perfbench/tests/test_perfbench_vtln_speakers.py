"""The port's VTLN training on a mix of vocal-tract speakers: the warps
lie off the grid's edges and follow the speakers' factors, which they
cannot on speakers that differ only in F0.

The settings are the small ones of the ABX benchmark's warp training
(``shennong_tpu_torch/eval/abx_bench.py:train_warps``): a UBM of 16
Gaussians, warps 0.85-1.25 by 0.025, 3 LVTLN iterations, no dither."""

import pytest
import scipy.stats

from perfbench import corpus

#: 8 speakers, 2 utterances of 2-4 s each
MIX = {'source': 'a test size', 'law': 'uniform', 'utterances': 16,
       'speakers': 8, 'clip_s': [2.0, 4.0], 'vocal_tract': [0.88, 1.14]}
GRID = (0.85, 1.25, 0.025)


def train_warps(mix, seed, directory):
    """{speaker: warp} of the port's VTLN over the mix's corpus."""
    from shennong_tpu_torch.processor.ubm import DiagUbmProcessor
    from shennong_tpu_torch.processor.vtln import VtlnProcessor
    from shennong_tpu_torch.utterances import Utterances

    entries, _ = corpus.write_corpus(mix, seed, directory, 'cpu')
    ubm = DiagUbmProcessor(num_gauss=16, num_iters=2, num_iters_init=3,
                           num_frames=100000, seed=0).get_params()
    ubm['features']['mfcc']['dither'] = 0
    low, high, step = GRID
    vtln = VtlnProcessor(num_iters=3, min_warp=low, max_warp=high,
                         warp_step=step, subsample=2, ubm=ubm)
    vtln.features['mfcc']['dither'] = 0
    return vtln.process(Utterances(entries), group_by='speaker',
                        device='cpu')


@pytest.mark.parametrize('seed', [3, 2 ** 31 + 11])
def test_the_warps_follow_the_vocal_tracts(seed, tmp_path):
    warps = train_warps(MIX, seed, str(tmp_path))
    tracts = corpus.vocal_tracts(MIX, seed)
    speakers = sorted(tracts)
    found = [warps[s] for s in speakers]
    low, high, _ = GRID
    assert sum(w == pytest.approx(low) for w in found) <= 1, warps
    assert sum(w == pytest.approx(high) for w in found) <= 1, warps
    # a tract of factor alpha warps to about 1 / alpha: the sign is
    # negative (-1.0 on six seeds)
    rho = scipy.stats.spearmanr(found, [tracts[s] for s in speakers])[0]
    assert rho <= -0.8, (warps, tracts)
