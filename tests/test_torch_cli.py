"""The port's ``speech-features-torch`` command line, on the CPU.

A ``config`` -> ``extract --device cpu`` round trip to ``.npz`` equals
the port's own pipeline result exactly (every random source at 0), the
generated configuration equals the JAX CLI's, and the command refuses
a CUDA device that is not there instead of picking the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io.wavfile
import torch
import yaml

from shennong_tpu import pipeline as jpipeline
from shennong_tpu_torch import pipeline
from shennong_tpu_torch.cli import main
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.processor import energy
from shennong_tpu_torch.utterances import Utterances

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_WAV = os.path.join(REPO, 'tests', 'data', 'test.wav')


def run_cli(monkeypatch, *argv):
    monkeypatch.setattr(sys, 'argv', ['speech-features-torch'] + list(argv))
    main()


@pytest.fixture
def corpus(tmp_path):
    """An utterances index of 3 utterances, 2 speakers."""
    rng = np.random.RandomState(0)
    lines = [f'real {REAL_WAV} spk1']
    for index, nsamples in enumerate([24000, 17000]):
        wav = str(tmp_path / f'u{index}.wav')
        t = np.arange(nsamples) / 16000
        signal = (np.sin(2 * np.pi * (130 + 25 * index) * t)
                  * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
                  + 0.05 * rng.randn(nsamples))
        scipy.io.wavfile.write(wav, 16000, (
            signal / np.abs(signal).max() * 20000).astype(np.int16))
        lines.append(f'u{index} {wav} spk{2 - index % 2}')
    path = tmp_path / 'utterances.txt'
    path.write_text('\n'.join(lines) + '\n')
    return str(path)


def test_config_equals_reference(monkeypatch, capsys):
    """What ``speech-features config`` writes for the same arguments."""
    run_cli(monkeypatch, 'config', 'plp', '--pitch', 'kaldi', '--cmvn',
            '--delta')
    ours = capsys.readouterr().out
    assert ours == jpipeline.get_default_config(
        'plp', to_yaml=True, with_pitch='kaldi', with_cmvn=True,
        with_delta=True)
    assert 'rasta' in ours


def test_extract_roundtrip(monkeypatch, tmp_path, corpus):
    """config -> edit -> extract --device cpu -> .npz, equal to the
    pipeline run in-process on the same configuration."""
    defaults = list(energy.EnergyProcessor.__init__.__defaults__)
    defaults[3] = 0.0  # the energy VAD's dither
    monkeypatch.setattr(
        energy.EnergyProcessor.__init__, '__defaults__', tuple(defaults))
    config_file = str(tmp_path / 'config.yaml')
    run_cli(monkeypatch, 'config', 'plp', '--pitch', 'kaldi', '--cmvn',
            '--delta', '-o', config_file)
    with open(config_file) as stream:
        config = yaml.safe_load(stream)
    config['plp']['rasta'] = True
    config['plp']['dither'] = 0
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    with open(config_file, 'w') as stream:
        yaml.safe_dump(config, stream)

    output = str(tmp_path / 'features.npz')
    run_cli(monkeypatch, 'extract', '-q', '--device', 'cpu', config_file,
            corpus, output)
    saved = FeaturesCollection.load(output)
    ref = pipeline.extract_features(
        config_file, Utterances.load(corpus), device='cpu')
    assert sorted(saved.keys()) == sorted(ref.keys()) == ['real', 'u0', 'u1']
    for name in ref:
        assert saved[name].shape == ref[name].shape
        assert saved[name].shape[1] == 42
        assert np.array_equal(saved[name].data, ref[name].data)
        assert np.array_equal(saved[name].times, ref[name].times)


def test_extract_refuses_missing_cuda(monkeypatch, tmp_path, corpus,
                                      capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    config_file = str(tmp_path / 'config.yaml')
    run_cli(monkeypatch, 'config', 'filterbank', '-o', config_file)
    output = tmp_path / 'features.npz'
    with pytest.raises(SystemExit) as error:
        run_cli(monkeypatch, 'extract', config_file, corpus, str(output))
    assert error.value.code == 1
    assert 'no CUDA device' in capsys.readouterr().err
    assert not output.exists()


@pytest.mark.parametrize('output,message', [
    ('features.xyz', 'unsupported extension'),
    ('config.yaml', 'already exists')])
def test_extract_bad_output(monkeypatch, tmp_path, corpus, capsys, output,
                            message):
    config_file = str(tmp_path / 'config.yaml')
    run_cli(monkeypatch, 'config', 'spectrogram', '-o', config_file)
    with pytest.raises(SystemExit) as error:
        run_cli(monkeypatch, 'extract', '--device', 'cpu', config_file,
                corpus, str(tmp_path / output))
    assert error.value.code == 1
    assert message in capsys.readouterr().err


def test_module_runs_without_jax(tmp_path):
    """``python -m shennong_tpu_torch.cli`` works and imports no jax."""
    config_file = str(tmp_path / 'config.yaml')
    script = (
        'import runpy, sys\n'
        f'sys.argv = ["speech-features-torch", "config", "spectrogram", '
        f'"--cmvn", "-o", {config_file!r}]\n'
        'runpy.run_module("shennong_tpu_torch.cli", run_name="__main__")\n'
        'assert "jax" not in sys.modules, "jax was imported"\n')
    proc = subprocess.run(
        [sys.executable, '-c', script], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(config_file) as stream:
        assert sorted(yaml.safe_load(stream)) == ['cmvn', 'spectrogram']


@pytest.mark.parametrize('vtln', ['simple', 'full'])
def test_config_vtln(monkeypatch, capsys, vtln):
    """``config mfcc --vtln``: the vtln section and its ubm, as the JAX
    package writes them."""
    run_cli(monkeypatch, 'config', 'mfcc', '--pitch', 'kaldi', '--cmvn',
            '--delta', '--vtln', vtln)
    ours = capsys.readouterr().out
    assert ours == jpipeline.get_default_config(
        'mfcc', to_yaml=True, with_pitch='kaldi', with_cmvn=True,
        with_delta=True, with_vtln=vtln)
    config = yaml.safe_load(ours)
    assert config['vtln']['ubm']['num_gauss'] == 64
    if vtln == 'simple':
        assert config['vtln']['features'] == 'default'
        assert config['vtln']['ubm']['features'] == 'default'
    else:
        assert config['vtln']['features']['delta']['window'] == 3


def test_extract_vtln(monkeypatch, tmp_path, corpus):
    """``extract --device cpu`` of a vtln configuration with a tiny UBM,
    equal to the pipeline run in-process."""
    defaults = list(energy.EnergyProcessor.__init__.__defaults__)
    defaults[3] = 0.0  # the energy VAD's dither
    monkeypatch.setattr(
        energy.EnergyProcessor.__init__, '__defaults__', tuple(defaults))
    config_file = str(tmp_path / 'config.yaml')
    run_cli(monkeypatch, 'config', 'mfcc', '--cmvn', '--delta', '--vtln',
            'full', '-o', config_file)
    with open(config_file) as stream:
        config = yaml.safe_load(stream)
    config['mfcc']['dither'] = 0
    vtln = config['vtln']
    vtln['features']['mfcc']['dither'] = 0
    vtln['num_iters'] = 2
    vtln['ubm'].update(num_gauss=4, num_iters=1, num_iters_init=2,
                       num_frames=2000)
    vtln['ubm']['features']['mfcc']['dither'] = 0
    with open(config_file, 'w') as stream:
        yaml.safe_dump(config, stream)

    output = str(tmp_path / 'features.npz')
    run_cli(monkeypatch, 'extract', '-q', '--device', 'cpu', config_file,
            corpus, output)
    saved = FeaturesCollection.load(output)
    ref = pipeline.extract_features(
        config_file, Utterances.load(corpus), device='cpu')
    assert sorted(saved.keys()) == sorted(ref.keys()) == ['real', 'u0', 'u1']
    for name in ref:
        assert saved[name].shape == ref[name].shape
        assert saved[name].shape[1] == 39
        assert np.array_equal(saved[name].data, ref[name].data)
        warp = ref[name].properties['mfcc']['vtln_warp']
        assert saved[name].properties['mfcc']['vtln_warp'] == warp
        assert 0.85 <= warp <= 1.25


@pytest.mark.parametrize('args', [
    ('bottleneck',), ('bottleneck', '--cmvn', '--delta'),
    ('mfcc', '--pitch', 'crepe'),
    ('mfcc', '--pitch', 'crepe', '--cmvn', '--delta')])
@pytest.mark.parametrize('comments', [True, False])
def test_config_bottleneck_and_crepe(monkeypatch, capsys, args, comments):
    """``config bottleneck`` and ``config ... --pitch crepe``: the same
    YAML as the JAX CLI's. Without comments the text is equal; with
    them every value is, and so is every comment but those of the
    CREPE capacity and decode parameters, whose docstrings name this
    package's ``convert-crepe`` command and its CUDA decode."""
    flags = () if comments else ('--no-comments',)
    run_cli(monkeypatch, 'config', *args, *flags)
    ours = capsys.readouterr().out
    features = args[0]
    kwargs = dict(
        with_pitch='crepe' if 'crepe' in args else False,
        with_cmvn='--cmvn' in args, with_delta='--delta' in args)
    ref = jpipeline.get_default_config(
        features, to_yaml=True, yaml_commented=comments, **kwargs)
    assert yaml.safe_load(ours) == yaml.safe_load(ref)
    if not comments or 'crepe' not in args:
        assert ours == ref
    else:
        def without_capacity_and_decode(text):
            kept, skip = [], False
            for line in text.splitlines():
                if line.strip().startswith('#'):
                    skip = skip or any(word in line for word in (
                        'capacity to use', 'bin decode runs'))
                    if skip:
                        continue
                else:
                    skip = False
                kept.append(line)
            return kept

        assert without_capacity_and_decode(ours) == \
            without_capacity_and_decode(ref)
        assert 'speech-features-torch convert-crepe' in ours


def keras_checkpoint(path, capacity='small', seed=0):
    """A keras-layout CREPE checkpoint with seeded tensors, as
    tests/processor/test_crepe_conversion.py builds it."""
    import h5py
    from shennong_tpu_torch.models import crepe

    mult = crepe.CAPACITY_MULTIPLIER[capacity]
    filters = [f * mult for f in crepe.LAYER_FILTERS]
    rng = np.random.RandomState(seed)
    with h5py.File(path, 'w') as fh:
        cin = 1
        for i in range(1, 7):
            cout = filters[i - 1]
            conv = fh.create_group(f'conv{i}').create_group('layer')
            conv['kernel:0'] = (
                rng.randn(crepe.LAYER_WIDTHS[i - 1], 1, cin, cout) * 0.05)
            conv['bias:0'] = rng.randn(cout) * 0.01
            bn = fh.create_group(f'conv{i}-BN').create_group('layer')
            bn['gamma:0'] = np.ones(cout)
            bn['beta:0'] = np.zeros(cout)
            bn['moving_mean:0'] = rng.randn(cout) * 0.01
            bn['moving_variance:0'] = np.ones(cout)
            cin = cout
        clf = fh.create_group('classifier').create_group('layer')
        clf['kernel:0'] = rng.randn(4 * filters[-1], 360) * 0.01
        clf['bias:0'] = np.zeros(360)


@pytest.mark.parametrize('install', [False, True])
def test_convert_crepe(monkeypatch, capsys, tmp_path, install):
    """``convert-crepe`` writes what the JAX package's converter reads
    from the same checkpoint, next to it or (``--install``) into the
    port's share directory."""
    pytest.importorskip('h5py')
    from shennong_tpu.models import crepe as jcrepe
    from shennong_tpu_torch.models import crepe

    checkpoint = str(tmp_path / 'model-small.h5')
    keras_checkpoint(checkpoint)
    share = tmp_path / 'share'
    share.mkdir()
    monkeypatch.setattr(crepe, 'SHARE_DIR', str(share))
    run_cli(monkeypatch, 'convert-crepe', checkpoint,
            *(('--install',) if install else ()))
    output = (share if install else tmp_path) / 'model-small.npz'
    assert str(output) in capsys.readouterr().out
    ref = jcrepe.convert_keras_h5(checkpoint)
    with np.load(str(output)) as ours:
        assert sorted(ours.keys()) == sorted(ref.keys())
        for key in ref:
            assert ours[key].dtype == ref[key].dtype
            assert np.array_equal(ours[key], ref[key]), key
    assert crepe.available_capacities() == (('small',) if install else ())

    explicit = str(tmp_path / 'elsewhere.npz')
    run_cli(monkeypatch, 'convert-crepe', checkpoint, '-o', explicit)
    with np.load(explicit) as ours:
        assert np.array_equal(ours['conv1/kernel'], ref['conv1/kernel'])


def test_extract_njobs(monkeypatch, tmp_path, corpus):
    """``extract -j 2`` writes the features of ``-j 1`` (every random
    source at 0); ``-j 0`` is refused."""
    defaults = list(energy.EnergyProcessor.__init__.__defaults__)
    defaults[3] = 0.0  # the energy VAD's dither
    monkeypatch.setattr(
        energy.EnergyProcessor.__init__, '__defaults__', tuple(defaults))
    config = yaml.safe_load(pipeline.get_default_config(
        'mfcc', to_yaml=True, with_pitch='kaldi', with_cmvn=True,
        with_delta=True))
    config['mfcc']['dither'] = 0
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    config_file = tmp_path / 'config.yaml'
    config_file.write_text(yaml.safe_dump(config))
    outputs = {}
    for njobs in ('1', '2'):
        output = str(tmp_path / f'j{njobs}.npz')
        run_cli(monkeypatch, 'extract', '--device', 'cpu', '-j', njobs,
                str(config_file), corpus, output)
        outputs[njobs] = FeaturesCollection.load(output)
    assert sorted(outputs['1']) == sorted(outputs['2'])
    for name in outputs['1']:
        np.testing.assert_array_equal(
            outputs['1'][name].data, outputs['2'][name].data)
    with pytest.raises(SystemExit):
        run_cli(monkeypatch, 'extract', '--device', 'cpu', '-j', '0',
                str(config_file), corpus, str(tmp_path / 'j0.npz'))


def test_warmup_command(monkeypatch, tmp_path, corpus, capsys):
    """``warmup --device cpu -j 2`` prints the JAX command's line;
    a missing CUDA device is an error."""
    config_file = str(tmp_path / 'config.yaml')
    run_cli(monkeypatch, 'config', 'mfcc', '--pitch', 'kaldi', '--cmvn',
            '--delta', '-o', config_file)
    capsys.readouterr()
    run_cli(monkeypatch, 'warmup', '--device', 'cpu', '-j', '2',
            config_file, corpus)
    line = capsys.readouterr().out.strip()
    assert line.startswith('warmed 1 pipeline geometries in ')
    assert line.endswith('s')
    float(line.split()[-1][:-1])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit):
        run_cli(monkeypatch, 'warmup', config_file, corpus)
    assert 'no CUDA device' in capsys.readouterr().err
