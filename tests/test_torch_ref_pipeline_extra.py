"""Counterpart of ``tests/test_pipeline_extra.py``, case for case: the
port's pipeline with CREPE pitch, a VTLN section, bottleneck features,
pass 2, the fused pass 1 against the stage-wise one and
``pipeline.warmup``, on the CPU, with the JAX cases' inputs and bounds.

The port's pass 2 is per utterance on the host, with no batched delta
program: ``test_batched_pass_two_matches_sequential`` holds
``ops.postops.compute_deltas_host`` (what pass 2 calls) on the ragged
batch against ``DeltaPostProcessor.process``, and
``test_pipeline_pass_two_end_to_end`` rebuilds the features from the
stage-wise pass 1 (``pipeline._stagewise_pass_one``) and
``pipeline._pass_two``. The fused path is switched off through
``pipeline._fits_fused``, and pass 2 fails through ``pipeline._pass_two``.
"""

import numpy as np
import pytest
import torch

from shennong_tpu_torch import Utterances
from shennong_tpu_torch.pipeline import extract_features, get_default_config


@pytest.fixture(scope='module')
def utterances(wav_file):
    return Utterances([
        ('utt1', wav_file, 'spk1', 0.0, 0.7),
        ('utt2', wav_file, 'spk2', 0.7, 1.4)])


def test_crepe_pitch_pipeline(utterances):
    config = get_default_config('mfcc', with_pitch='crepe')
    config['mfcc']['dither'] = 0
    config['model_capacity'] = None  # not a valid key
    del config['model_capacity']
    # the default config mirrors the reference default ('full'); only
    # tiny weights ship in-repo, so the test selects them explicitly
    assert config['pitch']['model_capacity'] == 'full'
    config['pitch']['model_capacity'] = 'tiny'
    features = extract_features(config, utterances, device='cpu')
    # 13 mfcc + 3 crepe pitch features
    assert features['utt1'].ndims == 16
    assert np.all(np.isfinite(features['utt1'].data))


def test_crepe_cmvn_pipeline_single_decode(utterances, monkeypatch):
    """The stage-wise pass 1 (crepe pitch forces it) sweeps the corpus
    for features then energy/VAD: the signal cache must make that one
    decode+upload, and the outputs stay correct."""
    from shennong_tpu_torch.parallel import stream as streaming

    decodes = []
    real_decode = streaming.decode_batch

    def counting(chunk, rows, njobs=4):
        decodes.append(len(chunk))
        return real_decode(chunk, rows, njobs)

    monkeypatch.setattr(streaming, 'decode_batch', counting)

    config = get_default_config(
        'mfcc', with_pitch='crepe', with_cmvn=True)
    config['mfcc']['dither'] = 0
    config['pitch']['model_capacity'] = 'tiny'
    features = extract_features(config, utterances, device='cpu')
    assert features['utt1'].ndims == 16
    assert np.all(np.isfinite(features['utt1'].data))
    # the features and energy sweeps share one decode (crepe loads
    # audio through its own chunked framing path, not decode_batch)
    assert sum(decodes) == len(list(utterances))


def test_vtln_in_pipeline(utterances):
    config = get_default_config('mfcc', with_vtln='full')
    config['mfcc']['dither'] = 0
    # shrink the VTLN training for test speed
    config['vtln']['num_iters'] = 1
    config['vtln']['min_warp'] = 0.95
    config['vtln']['max_warp'] = 1.05
    config['vtln']['warp_step'] = 0.05
    config['vtln']['subsample'] = 3
    config['vtln']['ubm'] = {
        'num_gauss': 4, 'num_iters': 1, 'num_iters_init': 2,
        'num_frames': 1000}

    features = extract_features(config, utterances, device='cpu')
    assert features['utt1'].ndims == 13
    warp = features['utt1'].properties['mfcc']['vtln_warp']
    assert 0.95 <= warp <= 1.05


def test_bottleneck_pipeline(utterances, tmp_path_factory):
    # synthetic bottleneck weights (see test_bottleneck)
    import shennong_tpu_torch.processor.bottleneck as bn_module
    from shennong_tpu_torch.processor.bottleneck import BottleneckProcessor

    rng = np.random.RandomState(0)
    hidden = 60
    params = {
        'context': np.int64(5),
        'input_mean': rng.randn(144) * 0.1,
        'input_std': np.abs(rng.randn(144)) * 0.5 + 0.5,
        'bn_mean': rng.randn(400) * 0.1,
        'bn_std': np.abs(rng.randn(400)) * 0.5 + 0.5,
    }
    for name, (nin, nout) in {
            'W1': (144, hidden), 'W2': (hidden, hidden),
            'W3': (hidden, 80), 'W5': (400, hidden),
            'W6': (hidden, hidden), 'W7': (hidden, hidden),
            'W8': (hidden, 80)}.items():
        params[name] = (
            rng.randn(nin, nout) / np.sqrt(nin)).astype(np.float32)
        params['b' + name[1:]] = (
            rng.randn(nout) * 0.1).astype(np.float32)

    directory = tmp_path_factory.mktemp('bn_weights')
    np.savez(str(directory / (
        'Babel-ML17_FBANK_HL1500_SBN80_PhnStates3096.npz')), **params)

    old = bn_module._SHARE_DIR
    bn_module._SHARE_DIR = str(directory)
    BottleneckProcessor._loaded_weights.clear()
    try:
        config = get_default_config('bottleneck')
        features = extract_features(config, utterances, device='cpu')
        assert features['utt1'].ndims == 80
        assert np.all(np.isfinite(features['utt1'].data))
    finally:
        bn_module._SHARE_DIR = old
        BottleneckProcessor._loaded_weights.clear()


def test_batched_pass_two_matches_sequential(wav_file):
    """The deltas of pass 2 over many ragged utterances equal the
    per-utterance post-processor's."""
    from shennong_tpu_torch.ops.postops import compute_deltas_host
    from shennong_tpu_torch.postprocessor.delta import DeltaPostProcessor

    rng = np.random.RandomState(0)
    proc = DeltaPostProcessor()
    arrays = [
        rng.randn(int(n), 13).astype(np.float32)
        for n in rng.randint(5, 400, size=40)]
    batched = compute_deltas_host(
        arrays, order=proc.order, window=proc.window)
    from shennong_tpu_torch import Features
    for data, out in zip(arrays, batched):
        single = proc.process(
            Features(data, np.arange(data.shape[0], dtype=float)),
            device='cpu')
        assert out.shape == single.data.shape
        assert np.allclose(out, single.data, atol=1e-6)


def test_pipeline_pass_two_end_to_end(wav_file):
    """Full pipeline with cmvn+delta+pitch equals pass 2 applied by
    hand to the stage-wise pass 1."""
    import warnings
    from shennong_tpu_torch import pipeline

    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        utts = Utterances([
            ('u%d' % i, wav_file, 'spk%d' % (i % 2), 0.0, 0.3 + 0.1 * i)
            for i in range(8)])
    config = get_default_config(
        'mfcc', with_cmvn=True, with_delta=True, with_pitch='kaldi')
    config['mfcc']['dither'] = 0
    config['cmvn']['with_vad'] = False
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0

    feats = extract_features(config, utts, device='cpu')

    # rebuild one utterance by hand from the same pass-1 state
    manager = pipeline.PipelineManager(
        pipeline.init_config(config), utts,
        log=pipeline.get_logger('t', 'warning'), device='cpu')
    log = pipeline.get_logger('t', 'warning')
    triplets = pipeline._stagewise_pass_one(
        manager, list(utts), 'cpu', torch.Generator(), log, None, 1)
    by_hand = pipeline._pass_two(manager, triplets, log)
    for name in feats:
        assert feats[name].shape == by_hand[name].shape
        assert np.allclose(
            feats[name].data, by_hand[name].data, atol=1e-6), name


@pytest.mark.parametrize('features', ['mfcc', 'plp'])
def test_fused_pass_one_matches_stagewise(wav_file, features,
                                          monkeypatch):
    """The single-program-per-batch pass 1 (FusedPipelineExecutor)
    equals the stage-wise batched sweeps for features + VAD-CMVN +
    pitch, across ragged utterances and two speakers."""
    import warnings
    from shennong_tpu_torch import pipeline

    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        utts = Utterances([
            ('u%d' % i, wav_file, 'spk%d' % (i % 2), 0.0, 0.3 + 0.1 * i)
            for i in range(6)])
    config = get_default_config(
        features, with_cmvn=True, with_delta=True, with_pitch='kaldi')
    config[features]['dither'] = 0
    config['cmvn']['with_vad'] = True
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0

    fused = extract_features(config, utts, device='cpu')

    monkeypatch.setattr(pipeline, '_fits_fused', lambda *a, **k: False)
    stagewise = extract_features(config, utts, device='cpu')

    assert fused.keys() == stagewise.keys()
    for name in fused:
        assert fused[name].shape == stagewise[name].shape, name
        np.testing.assert_allclose(
            fused[name].data, stagewise[name].data, atol=2e-5,
            err_msg=name)
        assert (sorted(fused[name].properties)
                == sorted(stagewise[name].properties))
        assert (fused[name].properties['pipeline']
                == stagewise[name].properties['pipeline'])


def test_overlapped_pass_two_failure_propagates(wav_file, monkeypatch):
    """A pass-2 error raised on the overlapped worker thread surfaces
    on the caller (and the worker shuts down instead of hanging)."""
    import warnings
    from shennong_tpu_torch import pipeline

    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        utts = Utterances([
            ('u%d' % i, wav_file, 'spk%d' % (i % 2), 0.0, 0.3)
            for i in range(4)])
    config = get_default_config('mfcc', with_cmvn=True, with_delta=True)
    config['mfcc']['dither'] = 0
    config['cmvn']['with_vad'] = False

    def boom(*args, **kwargs):
        raise RuntimeError('pass-2 exploded')

    monkeypatch.setattr(pipeline, '_pass_two', boom)
    with pytest.raises(RuntimeError, match='pass-2 exploded'):
        extract_features(config, utts, device='cpu')


def test_warmup_precompiles_and_preserves_outputs(utterances):
    """pipeline.warmup derives the corpus geometries from headers,
    runs the pipeline over a synthetic stand-in, and a following real
    extraction equals an unwarmed one (warmup never changes a
    result)."""
    from shennong_tpu_torch import pipeline

    config = get_default_config('mfcc', with_delta=True)
    config['mfcc']['dither'] = 0

    out = pipeline.warmup(config, utterances, device='cpu')
    assert out['programs'] >= 1
    assert out['seconds'] > 0
    assert all(
        rows >= 1 and bucket >= 1 for rows, bucket in out['geometries'])

    warmed = extract_features(config, utterances, device='cpu')
    plain = extract_features(config, utterances, device='cpu')
    assert sorted(warmed.keys()) == sorted(plain.keys())
    for name in plain:
        np.testing.assert_array_equal(
            warmed[name].data, plain[name].data)


def test_warmup_vtln_config_warms_warped_path(utterances):
    """A vtln section warms the warped extraction path (per-utterance
    mel inputs) without training anything on the synthetic corpus."""
    from shennong_tpu_torch import pipeline

    config = get_default_config('mfcc', with_vtln='simple')
    config['mfcc']['dither'] = 0
    out = pipeline.warmup(config, utterances, device='cpu')
    assert out['programs'] >= 1
