"""Counterpart of ``tests/test_cli.py``, case for case: the port's
``speech-features-torch`` CLI, in process and as ``python -m``, on the
conftest's WAV. Its ``extract`` and ``warmup`` default to ``--device
cuda``: the cases pass ``--device cpu``; ``--version`` names the
port's package. On a bad output path the port's ``extract`` reports the
error and exits 1 (``tests/test_torch_cli.py::test_extract_bad_output``)
where the JAX CLI logs it and returns: the ported case holds the same
error and the same absent output, and the exit code."""

import sys

import numpy as np
import pytest

from shennong_tpu_torch import FeaturesCollection
from shennong_tpu_torch.cli import main


def run_cli(monkeypatch, *argv):
    monkeypatch.setattr(
        sys, 'argv', ['speech-features-torch'] + list(argv))
    main()


def test_config_stdout(monkeypatch, capsys):
    run_cli(monkeypatch, 'config', 'mfcc', '--delta')
    out = capsys.readouterr().out
    assert 'mfcc:' in out
    assert 'delta:' in out


def test_config_to_file(monkeypatch, tmpdir):
    path = str(tmpdir.join('config.yaml'))
    run_cli(
        monkeypatch, 'config', 'mfcc', '--no-comments', '-o', path)
    content = open(path).read()
    assert 'mfcc:' in content
    assert '#' not in content


def test_extract(monkeypatch, tmpdir, wav_file):
    config = str(tmpdir.join('config.yaml'))
    run_cli(monkeypatch, 'config', 'mfcc', '--delta', '-o', config)

    utts = str(tmpdir.join('utterances.txt'))
    with open(utts, 'wt') as fp:
        fp.write(f'utt1 {wav_file} spk1 0 1\n')
        fp.write(f'utt2 {wav_file} spk1 1 1.4\n')

    output = str(tmpdir.join('features.npz'))
    run_cli(monkeypatch, 'extract', '-q', '--device', 'cpu', config,
            utts, output)

    features = FeaturesCollection.load(output)
    assert sorted(features.keys()) == ['utt1', 'utt2']
    # 13 mfcc x 3 delta orders
    assert features['utt1'].ndims == 39
    assert np.all(np.isfinite(features['utt1'].data))


def test_extract_bad_output_extension(monkeypatch, tmpdir, wav_file,
                                      capsys):
    config = str(tmpdir.join('config.yaml'))
    run_cli(monkeypatch, 'config', 'mfcc', '-o', config)
    utts = str(tmpdir.join('utterances.txt'))
    with open(utts, 'wt') as fp:
        fp.write(f'utt1 {wav_file}\n')

    # unsupported extension: reported error, no output written (the
    # port exits 1 where the JAX CLI logs and returns)
    with pytest.raises(SystemExit) as error:
        run_cli(
            monkeypatch, 'extract', '--device', 'cpu', config, utts,
            str(tmpdir.join('features.xyz')))
    assert error.value.code == 1
    assert 'unsupported extension ".xyz"' in capsys.readouterr().err
    assert not (tmpdir / 'features.xyz').exists()


def test_version(monkeypatch, capsys):
    with pytest.raises(SystemExit):
        run_cli(monkeypatch, '--version')
    assert 'shennong_tpu_torch' in capsys.readouterr().out


def test_cli_subprocess(tmpdir, wav_file):
    """The CLI also works as a subprocess (python -m)."""
    import subprocess
    import sys

    config = str(tmpdir.join('config.yaml'))
    result = subprocess.run(
        [sys.executable, '-m', 'shennong_tpu_torch.cli', 'config', 'mfcc',
         '-o', config],
        capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert 'mfcc:' in open(config).read()


@pytest.mark.parametrize('ext', ['.pkl', '.h5f', '.ark', '.mat'])
def test_extract_output_formats(monkeypatch, tmpdir, wav_file, ext):
    """Every serializer works through the CLI end to end."""
    config = str(tmpdir.join('config.yaml'))
    run_cli(monkeypatch, 'config', 'spectrogram', '-o', config)

    utts = str(tmpdir.join('utterances.txt'))
    with open(utts, 'wt') as fp:
        fp.write(f'utt1 {wav_file} spk1 0 0.6\n')

    output = str(tmpdir.join('features' + ext))
    run_cli(monkeypatch, 'extract', '-q', '--device', 'cpu', config,
            utts, output)

    features = FeaturesCollection.load(output)
    assert list(features.keys()) == ['utt1']
    assert features['utt1'].nframes > 0
    assert np.all(np.isfinite(features['utt1'].data))


def test_warmup_command(monkeypatch, tmpdir, wav_file, capsys):
    """'speech-features-torch warmup' warms the corpus geometry."""
    config = str(tmpdir.join('config.yaml'))
    run_cli(monkeypatch, 'config', 'mfcc', '-o', config)

    utts = str(tmpdir.join('utterances.txt'))
    with open(utts, 'wt') as fp:
        fp.write(f'utt1 {wav_file} spk1 0 0.6\n')
        fp.write(f'utt2 {wav_file} spk2 0.2 0.9\n')

    run_cli(monkeypatch, 'warmup', '--device', 'cpu', config, utts)
    assert 'warmed' in capsys.readouterr().out
