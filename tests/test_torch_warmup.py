"""``pipeline.warmup`` of the port against the JAX package's.

The geometries (rows x signal bucket, from the audio headers) equal
the JAX package's for the same corpus, a warmed extraction equals an
unwarmed one, and a ``vtln`` section warms the warped path with unit
warps and trains nothing (after tests/test_pipeline_extra.py).
"""

import copy

import numpy as np
import pytest
import scipy.io.wavfile

from shennong_tpu import pipeline as jpipeline
from shennong_tpu import utils as jutils
from shennong_tpu.utterances import Utterances as JUtterances
from shennong_tpu_torch import pipeline
from shennong_tpu_torch.parallel import executor as executor_module
from shennong_tpu_torch.utterances import Utterances


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """70 short utterances: two batches of 64 and 6, of two buckets."""
    path = tmp_path_factory.mktemp('warmup')
    rng = np.random.RandomState(1)
    entries = []
    for index in range(70):
        nsamples = 3000 + 40 * index
        wav = str(path / f'u{index:02d}.wav')
        scipy.io.wavfile.write(
            wav, 16000, (rng.randn(nsamples) * 2000).astype(np.int16))
        entries.append((f'u{index:02d}', wav, f'spk{index % 3}'))
    return entries


def mfcc_config():
    config = pipeline.get_default_config('mfcc', with_delta=True)
    config['mfcc']['dither'] = 0
    return config


def test_geometries_match_jax(corpus, monkeypatch):
    """The same (rows, bucket) geometries as the JAX package's warmup,
    whose own extraction and compile cache are stubbed out here."""
    monkeypatch.setattr(jpipeline, 'extract_features', lambda *a, **k: None)
    monkeypatch.setattr(jutils, 'enable_compilation_cache', lambda: None)
    theirs = jpipeline.warmup(mfcc_config(), JUtterances(corpus))
    ours = pipeline.warmup(mfcc_config(), Utterances(corpus), device='cpu')
    assert ours['geometries'] == theirs['geometries']
    assert ours['programs'] == theirs['programs'] == 2
    assert [rows for rows, _ in ours['geometries']] == [6, 64]
    assert ours['seconds'] > 0


def test_warmup_preserves_outputs(corpus):
    """Warm-up is a start-up effect, never a semantic one."""
    config = mfcc_config()
    utterances = Utterances(corpus[:8])
    out = pipeline.warmup(copy.deepcopy(config), utterances, device='cpu',
                          njobs=2)
    assert out['programs'] == 1
    assert all(rows >= 1 and bucket >= 1
               for rows, bucket in out['geometries'])
    warmed = pipeline.extract_features(
        copy.deepcopy(config), utterances, device='cpu')
    plain = pipeline.extract_features(
        copy.deepcopy(config), utterances, device='cpu')
    assert sorted(warmed) == sorted(plain)
    for name in plain:
        np.testing.assert_array_equal(warmed[name].data, plain[name].data)


def test_warmup_vtln_config_warms_warped_path(corpus, monkeypatch):
    """A vtln section warms the warped extraction (per-utterance mel
    inputs, unit warps) without training anything."""
    from shennong_tpu_torch.processor.vtln import VtlnProcessor

    seen = []
    real_init = executor_module.FusedPipelineExecutor.__init__

    def spy(self, *args, **kwargs):
        seen.append(kwargs.get('warps'))
        real_init(self, *args, **kwargs)

    def no_training(*_, **__):
        raise AssertionError('warmup trained VTLN')

    monkeypatch.setattr(executor_module.FusedPipelineExecutor, '__init__',
                        spy)
    monkeypatch.setattr(VtlnProcessor, 'process', no_training)
    config = pipeline.get_default_config('mfcc', with_vtln='simple')
    config['mfcc']['dither'] = 0
    out = pipeline.warmup(config, Utterances(corpus[:8]), device='cpu')
    assert out['programs'] == 1
    assert len(seen) == 1 and seen[0]
    assert set(seen[0].values()) == {1.0}
