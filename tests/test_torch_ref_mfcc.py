"""Counterpart of ``tests/processor/test_mfcc.py``, case for case: the
port's MFCC processor on the CPU, on the conftest's signals, against
``tests/kaldi_oracle.py`` with the JAX cases' bound (max-abs 1e-3).
"""

import numpy as np
import pytest

from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.processor.mfcc import MfccProcessor

from tests import kaldi_oracle
from tests.torch_ref import audio, audio_8k  # noqa: F401 (fixtures)


def test_params():
    params = MfccProcessor().get_params()
    assert len(params) == 21
    assert params['num_ceps'] == 13
    assert params['use_energy'] is True
    assert params['cepstral_lifter'] == 22.0
    assert params['window_type'] == 'povey'

    proc = MfccProcessor()
    proc.set_params(**{'num_ceps': 10, 'window_type': 'hanning'})
    assert proc.num_ceps == 10
    assert proc.window_type == 'hanning'


def test_shape_anchor(audio):
    """The standard 1.4 s test file yields exactly (140, 13)."""
    mfcc = MfccProcessor(dither=0).process(audio, device='cpu')
    assert mfcc.shape == (140, 13)
    assert mfcc.times.shape == (140, 2)
    assert mfcc.times[0, 0] == 0.0
    assert mfcc.times[1, 0] == pytest.approx(0.01)
    assert mfcc.properties['mfcc']['vtln_warp'] == 1.0
    assert mfcc.properties['pipeline'][0]['columns'] == [0, 12]


def test_oracle_parity_defaults(audio):
    ours = MfccProcessor(dither=0).process(audio, device='cpu').data
    ref = kaldi_oracle.mfcc(audio.data.astype(np.float64))
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 1e-3


@pytest.mark.parametrize('kwargs', [
    dict(use_energy=False),
    dict(raw_energy=False),
    dict(htk_compat=True),
    dict(htk_compat=True, use_energy=False),
    dict(cepstral_lifter=0.0),
    dict(window_type='hamming'),
    dict(window_type='hanning'),
    dict(window_type='blackman'),
    dict(window_type='rectangular'),
    dict(remove_dc_offset=False),
    dict(preemph_coeff=0.0),
    dict(snip_edges=False),
    dict(num_ceps=8, num_bins=15),
    dict(low_freq=60, high_freq=-200),
    dict(frame_shift=0.02, frame_length=0.05),
    dict(energy_floor=1e4),
])
def test_oracle_parity_options(audio, kwargs):
    ours = MfccProcessor(dither=0, **kwargs).process(audio, device='cpu').data
    ref = kaldi_oracle.mfcc(
        audio.data.astype(np.float64),
        preemph=kwargs.get('preemph_coeff', 0.97),
        remove_dc=kwargs.get('remove_dc_offset', True),
        window_type=kwargs.get('window_type', 'povey'),
        num_bins=kwargs.get('num_bins', 23),
        low=kwargs.get('low_freq', 20.0),
        high=kwargs.get('high_freq', 0.0),
        num_ceps=kwargs.get('num_ceps', 13),
        use_energy=kwargs.get('use_energy', True),
        raw_energy=kwargs.get('raw_energy', True),
        cepstral_lifter=kwargs.get('cepstral_lifter', 22.0),
        htk_compat=kwargs.get('htk_compat', False),
        energy_floor=kwargs.get('energy_floor', 0.0),
        snip_edges=kwargs.get('snip_edges', True),
        shift_s=kwargs.get('frame_shift', 0.01),
        length_s=kwargs.get('frame_length', 0.025))
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 1e-3


def test_vtln_parity(audio):
    plain = MfccProcessor(dither=0).process(audio, device='cpu').data
    for warp in (0.85, 0.94, 1.1, 1.25):
        ours = MfccProcessor(dither=0).process(
            audio, vtln_warp=warp, device='cpu').data
        ref = kaldi_oracle.mfcc(audio.data.astype(np.float64), vtln=warp)
        assert np.max(np.abs(ours - ref)) < 1e-3
        assert not np.allclose(ours, plain)


def test_determinism(audio):
    proc = MfccProcessor(dither=0)
    first = proc.process(audio, device='cpu')
    second = proc.process(audio, device='cpu')
    assert first == second
    # a fresh instance gives the same result too
    third = MfccProcessor(dither=0).process(audio, device='cpu')
    assert first == third


def test_dither_changes_output(audio):
    """With no generator each call draws a freshly seeded dither."""
    out1 = MfccProcessor(dither=1.0).process(audio, device='cpu')
    out2 = MfccProcessor(dither=1.0).process(audio, device='cpu')
    assert not np.array_equal(out1.data, out2.data)
    # dither only perturbs: outputs stay close on most frames
    assert np.median(np.abs(out1.data - out2.data)) < 0.5


def test_sample_rate_mismatch(audio):
    proc = MfccProcessor(sample_rate=8000)
    with pytest.raises(ValueError, match='mismatch in sample rates'):
        proc.process(audio, device='cpu')


def test_stereo_rejected(data_path):
    stereo = Audio.load(str(data_path / 'test.stereo.wav'))
    with pytest.raises(ValueError, match='one dimension'):
        MfccProcessor(dither=0).process(stereo, device='cpu')


def test_num_ceps_exceeds_bins(audio):
    proc = MfccProcessor(num_ceps=30, num_bins=23, dither=0)
    with pytest.raises(ValueError, match='num_ceps <= num_bins'):
        proc.process(audio, device='cpu')


def test_8k(audio_8k):
    mfcc = MfccProcessor(sample_rate=8000, dither=0).process(
        audio_8k, device='cpu')
    assert mfcc.ndims == 13
    ref = kaldi_oracle.mfcc(audio_8k.data.astype(np.float64), rate=8000)
    assert np.max(np.abs(mfcc.data - ref)) < 1e-3
