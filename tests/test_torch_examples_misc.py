"""The port's pitch, plotting and serializer examples against the JAX
package, on the CPU.

- ``pitch_comparison`` on ``tests/data/test.wav`` over the whole SNR
  grid (seeded noise): its printed table is the JAX example's text, its
  agreement statistics the JAX example's ``compare`` of the same tracks,
  and the tracks within 1e-3 of the JAX processors' (the F0 relative,
  the lags equal on the clean signal).
- ``plot_features`` writes its PNG here (matplotlib is installed); its
  features are the JAX processors' within 1e-3 (no dither); the
  bottleneck features are skipped for the one reason that is missing by
  nature, no weights file, and any other failure of a processor stops
  the script.
- ``serializer_bench`` at a scale of 0.002: the JAX example's collection,
  bit for bit, and the same file sizes in every format (HDF5 within 1%,
  the pickle longer by the module names of its classes).
"""

import io
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from tests.test_torch_examples_scripts import load

torch.set_num_threads(2)

REAL_WAV = os.path.join(os.path.dirname(__file__), 'data', 'test.wav')


def test_pitch_comparison(monkeypatch, tmp_path):
    from shennong_tpu.audio import Audio as JAudio
    from shennong_tpu.processor import CrepePitchProcessor, KaldiPitchProcessor

    jax_module = load('pitch_comparison', jax=True)
    monkeypatch.setattr(sys, 'argv', ['pitch_comparison.py', REAL_WAV])
    printed = io.StringIO()
    with redirect_stdout(printed):
        jax_module.main()
    plot = str(tmp_path / 'f0.png')
    report = load('pitch_comparison').run(REAL_WAV, plot, device='cpu')
    assert printed.getvalue().split('\n', 1)[1].rstrip('\n') == report['table']
    assert report['figure'] == plot and os.path.getsize(plot) > 10000

    clean = JAudio.load(REAL_WAV).channel(0)
    for snr, (kaldi, crepe) in report['tracks'].items():
        assert report['stats'][snr] == pytest.approx(
            jax_module.compare(kaldi, crepe), nan_ok=True)
        if snr == float('inf'):
            ref_kaldi = KaldiPitchProcessor().process(clean).data
            ref_crepe = CrepePitchProcessor(
                model_capacity='tiny').process(clean).data
            frames = len(kaldi)
            assert np.abs(kaldi[:, 0] - ref_kaldi[:frames, 0]).max() < 1e-3
            np.testing.assert_allclose(
                kaldi[:, 1], ref_kaldi[:frames, 1], rtol=1e-3)
            assert np.abs(crepe - ref_crepe[:frames]).max() < 1e-3


def test_plot_features(tmp_path):
    pytest.importorskip('matplotlib')
    from shennong_tpu.audio import Audio as JAudio
    from shennong_tpu.processor import (
        FilterbankProcessor, MfccProcessor, PlpProcessor,
        SpectrogramProcessor)

    output = str(tmp_path / 'features.png')
    report = load('plot_features').run(REAL_WAV, output, device='cpu',
                                       dither=0)
    assert report['figure'] == output and os.path.getsize(output) > 10000
    assert list(report['skipped']) == ['bottleneck']
    assert 'no weights file found' in report['skipped']['bottleneck']
    audio = JAudio.load(REAL_WAV).channel(0)
    refs = {'spectrogram': SpectrogramProcessor, 'filterbank':
            FilterbankProcessor, 'mfcc': MfccProcessor, 'plp': PlpProcessor}
    assert sorted(report['features']) == sorted(refs)
    for name, cls in refs.items():
        ref = cls(dither=0).process(audio).data
        ours = report['features'][name].data
        assert ours.shape == ref.shape
        scale = np.maximum(np.abs(ref), 1.0)
        assert (np.abs(ours - ref) / scale).max() < 1e-3, name


def test_plot_features_stops_on_a_failure(monkeypatch, tmp_path):
    """Only a missing weights file is skipped: another error stops the
    script, and no figure is written."""
    from shennong_tpu_torch.processor import PlpProcessor

    def broken(*args, **kwargs):
        raise ValueError('PLP is broken')

    monkeypatch.setattr(PlpProcessor, 'process', broken)
    output = str(tmp_path / 'features.png')
    with pytest.raises(ValueError, match='PLP is broken'):
        load('plot_features').main([REAL_WAV, '-o', output,
                                    '--device', 'cpu'])
    assert not os.path.exists(output)


def test_serializer_bench(monkeypatch, tmp_path):
    ours_module = load('serializer_bench')
    theirs_module = load('serializer_bench', jax=True)
    ours = ours_module.make_collection(2, 27360)
    theirs = theirs_module.make_collection(2, 27360)
    for name in theirs:
        np.testing.assert_array_equal(ours[name].data, theirs[name].data)
        np.testing.assert_array_equal(ours[name].times, theirs[name].times)

    pytest.importorskip('h5py')  # both examples write .h5f
    results = ours_module.bench(str(tmp_path / 'torch'), 0.002)
    monkeypatch.setattr(sys, 'argv', [
        'serializer_bench.py', str(tmp_path / 'jax'), '--scale', '0.002'])
    with redirect_stdout(io.StringIO()):
        theirs_module.main()
    assert [ext for ext, *_ in results] == [
        ext for ext, _ in ours_module.FORMATS]
    for ext, size, write_s, read_s in results:
        assert write_s > 0 and read_s > 0
        if ext == '.ark':
            continue  # '.ark compact' wrote over it in both runs
        target = str(tmp_path / 'jax' / (
            'features_csv' if ext == 'csv-folder'
            else 'features' + ext.split(' ')[0]))
        theirs = theirs_module.path_size(target)
        if ext == '.ark compact':
            theirs += sum(os.path.getsize(tmp_path / 'jax' / sidecar) for
                          sidecar in ('features.times.ark',
                                      'features.properties.json'))
        if ext == '.h5f':
            # HDF5 stamps metadata of its own: the sizes agree within 1%
            assert size == pytest.approx(theirs, rel=0.01)
        elif ext == '.pkl':
            # a pickle names the module of each class it holds
            with open(tmp_path / 'torch' / 'features.pkl', 'rb') as stream:
                names = stream.read().count(b'shennong_tpu_torch')
            assert names > 0
            assert size == theirs + names * len('_torch')
        else:
            assert size == theirs, ext
