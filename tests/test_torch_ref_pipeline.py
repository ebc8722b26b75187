"""Counterpart of ``tests/test_pipeline.py``, case for case: the port's
extraction pipeline on the CPU, with the JAX cases' inputs, checks and
bounds."""

import numpy as np
import pytest

from shennong_tpu_torch import Utterances
from shennong_tpu_torch.pipeline import (
    extract_features, get_default_config, valid_features)


@pytest.fixture(scope='module')
def utterances(wav_file):
    return Utterances([
        ('utt1', wav_file, 'spk1', 0.0, 1.0),
        ('utt2', wav_file, 'spk1', 1.0, 1.4),
        ('utt3', wav_file, 'spk2', 0.2, 1.3)])


def test_valid_features():
    assert valid_features() == [
        'spectrogram', 'filterbank', 'mfcc', 'plp', 'bottleneck']


def test_default_config_keys():
    config = get_default_config('mfcc')
    assert set(config.keys()) == {'mfcc'}
    assert 'sample_rate' not in config['mfcc']
    assert 'htk_compat' not in config['mfcc']

    config = get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
    assert set(config.keys()) == {'mfcc', 'pitch', 'cmvn', 'delta'}
    assert config['pitch']['processor'] == 'kaldi'
    assert 'postprocessing' in config['pitch']

    with pytest.raises(ValueError, match='invalid features'):
        get_default_config('nope')
    with pytest.raises(ValueError, match='with_pitch'):
        get_default_config('mfcc', with_pitch='yes')
    with pytest.raises(ValueError, match='with_vtln'):
        get_default_config('mfcc', with_vtln='yes')
    with pytest.raises(ValueError, match='not compatible'):
        get_default_config('spectrogram', with_vtln='simple')


def test_config_to_yaml():
    yaml_str = get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True,
        to_yaml=True)
    assert 'mfcc:' in yaml_str
    assert '# ' in yaml_str  # commented

    plain = get_default_config('mfcc', to_yaml=True, yaml_commented=False)
    assert '#' not in plain

    # the yaml string parses back into an equivalent config
    import yaml as yaml_mod
    parsed = yaml_mod.load(yaml_str, Loader=yaml_mod.FullLoader)
    assert set(parsed.keys()) == {'mfcc', 'pitch', 'cmvn', 'delta'}


def test_extract_mfcc(utterances):
    config = get_default_config('mfcc')
    config['mfcc']['dither'] = 0
    features = extract_features(config, utterances, device='cpu')
    assert sorted(features.keys()) == ['utt1', 'utt2', 'utt3']
    assert features['utt1'].shape == (98, 13)
    assert features['utt1'].properties['speaker'] == 'spk1'
    assert features['utt1'].properties['audio']['tstart'] == 0.0


def test_extract_mfcc_pitch(utterances):
    config = get_default_config('mfcc', with_pitch='kaldi')
    config['mfcc']['dither'] = 0
    features = extract_features(config, utterances, device='cpu')
    # 13 mfcc + 3 pitch
    assert features['utt1'].shape == (98, 16)
    pipeline_meta = features['utt1'].properties['pipeline']
    assert pipeline_meta[0]['columns'] == [0, 12]
    assert pipeline_meta[1]['columns'] == [13, 15]


def test_extract_full(utterances):
    config = get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
    config['mfcc']['dither'] = 0
    features = extract_features(config, utterances, device='cpu')
    # 13 mfcc * 3 (delta order 2) + 3 pitch
    assert features['utt1'].ndims == 42

    # cmvn by speaker: spk1 features (utt1+utt2 voiced frames) are
    # approximately normalized
    spk1 = np.vstack([
        features['utt1'].data[:, :13], features['utt2'].data[:, :13]])
    assert np.abs(spk1.mean(axis=0)).max() < 1.5


def test_extract_fetch_dtype(utterances):
    # float16 fetch: same shapes, float32 host dtype, values within
    # half-precision rounding of the bit-exact default payload
    config = get_default_config('mfcc', with_pitch='kaldi')
    config['mfcc']['dither'] = 0
    # the delta-pitch noise draws a fresh key per run: zero it so the
    # two runs differ by fetch precision only
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0.0
    exact = extract_features(config, utterances, device='cpu')
    half = extract_features(
        config, utterances, fetch_dtype='float16', device='cpu')
    for name in exact.keys():
        assert half[name].dtype == exact[name].dtype
        assert half[name].shape == exact[name].shape
        scale = np.maximum(np.abs(exact[name].data), 1.0)
        err = np.abs(half[name].data - exact[name].data) / scale
        assert err.max() < 2e-3, err.max()

    with pytest.raises(ValueError, match='fetch_dtype'):
        extract_features(config, utterances, fetch_dtype='int8', device='cpu')


def test_extract_cmvn_by_utterance(utterances):
    config = get_default_config('mfcc', with_cmvn=True)
    config['mfcc']['dither'] = 0
    config['cmvn']['by_speaker'] = False
    config['cmvn']['with_vad'] = False
    features = extract_features(config, utterances, device='cpu')
    for feats in features.values():
        assert np.allclose(feats.data.mean(axis=0), 0, atol=1e-4)


def test_extract_other_features(utterances):
    for name, ndims in (
            ('filterbank', 23), ('plp', 13), ('spectrogram', 257)):
        config = get_default_config(name)
        config[name]['dither'] = 0
        features = extract_features(config, utterances, device='cpu')
        assert features['utt2'].ndims == ndims


def test_extract_from_yaml_string(utterances):
    yaml_config = get_default_config('mfcc', to_yaml=True)
    features = extract_features(yaml_config, utterances, device='cpu')
    assert features['utt1'].ndims == 13


def test_config_validation(utterances):
    with pytest.raises(ValueError, match='invalid keys'):
        extract_features({'mfcc': {}, 'bad_key': {}}, utterances, device='cpu')
    with pytest.raises(ValueError, match='does not define any features'):
        extract_features({'delta': {}}, utterances, device='cpu')
    with pytest.raises(ValueError, match='more than one features'):
        extract_features({'mfcc': {}, 'plp': {}}, utterances, device='cpu')


def test_warps_validation(utterances):
    config = get_default_config('mfcc')
    # by speaker
    features = extract_features(
        config, utterances, warps={'spk1': 1.1, 'spk2': 0.9}, device='cpu')
    assert features['utt1'].properties['mfcc']['vtln_warp'] == 1.1

    # by utterance
    features = extract_features(
        config, utterances,
        warps={'utt1': 1.0, 'utt2': 1.2, 'utt3': 0.95}, device='cpu')
    assert features['utt2'].properties['mfcc']['vtln_warp'] == 1.2

    with pytest.raises(ValueError, match='do not match utterances'):
        extract_features(config, utterances, warps={'who': 1.0}, device='cpu')

    config_vtln = get_default_config('mfcc', with_vtln='simple')
    with pytest.raises(ValueError, match='already defined'):
        extract_features(
            config_vtln, utterances, warps={'spk1': 1.0, 'spk2': 1.0},
            device='cpu')


def test_cmvn_needs_speakers(wav_file):
    no_speaker = Utterances([('u1', wav_file)])
    config = get_default_config('mfcc', with_cmvn=True)
    with pytest.raises(ValueError, match='no speaker information'):
        extract_features(config, no_speaker, device='cpu')
