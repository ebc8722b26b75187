"""Counterpart of ``tests/processor/test_plp.py``, case for case: the
port's PLP and RASTA-PLP processor on the CPU, on the conftest's signal,
against ``tests/kaldi_oracle.py`` with the JAX cases' bounds (max-abs
1e-3; the streaming RASTA filter 1e-4 against the batched one).
"""

import numpy as np
import pytest
import torch

from shennong_tpu_torch.processor.plp import PlpProcessor

from tests import kaldi_oracle
from tests.torch_ref import audio  # noqa: F401 (fixture)


def test_params():
    params = PlpProcessor().get_params()
    assert len(params) == 25
    assert params['rasta'] is False
    assert params['lpc_order'] == 12
    assert params['num_ceps'] == 13
    assert params['compress_factor'] == pytest.approx(1 / 3)


def test_shape(audio):
    plp = PlpProcessor(dither=0).process(audio, device='cpu')
    assert plp.shape == (140, 13)
    assert plp.shape[1] == PlpProcessor().num_ceps


def test_num_ceps_validation():
    with pytest.raises(ValueError, match='num_ceps must be > 0'):
        PlpProcessor(num_ceps=0)
    with pytest.raises(ValueError, match='num_ceps <= lpc_order'):
        PlpProcessor(lpc_order=10, num_ceps=12)


def test_oracle_parity_defaults(audio):
    ours = PlpProcessor(dither=0).process(audio, device='cpu').data
    ref = kaldi_oracle.plp(audio.data.astype(np.float64))
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 1e-3


@pytest.mark.parametrize('kwargs', [
    dict(use_energy=False),
    dict(raw_energy=False),
    dict(htk_compat=True),
    dict(cepstral_lifter=0.0),
    dict(cepstral_scale=2.0),
    dict(compress_factor=0.5),
    dict(lpc_order=8, num_ceps=9),
    dict(num_ceps=5),
])
def test_oracle_parity_options(audio, kwargs):
    ours = PlpProcessor(dither=0, **kwargs).process(audio, device='cpu').data
    ref = kaldi_oracle.plp(
        audio.data.astype(np.float64),
        use_energy=kwargs.get('use_energy', True),
        raw_energy=kwargs.get('raw_energy', True),
        htk_compat=kwargs.get('htk_compat', False),
        cepstral_lifter=kwargs.get('cepstral_lifter', 22.0),
        cepstral_scale=kwargs.get('cepstral_scale', 1.0),
        compress=kwargs.get('compress_factor', 1 / 3),
        lpc_order=kwargs.get('lpc_order', 12),
        num_ceps=kwargs.get('num_ceps', 13))
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 1e-3


def test_rasta_oracle(audio):
    ours = PlpProcessor(dither=0, rasta=True).process(audio, device='cpu').data
    ref = kaldi_oracle.plp(audio.data.astype(np.float64), rasta=True)
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 1e-3
    # rasta changes the output (except the energy column)
    plain = PlpProcessor(dither=0).process(audio, device='cpu').data
    assert not np.allclose(ours[:, 1:], plain[:, 1:])
    assert np.allclose(ours[:, 0], plain[:, 0])


def test_vtln(audio):
    plain = PlpProcessor(dither=0).process(audio, device='cpu').data
    warped = PlpProcessor(dither=0).process(
        audio, vtln_warp=1.1, device='cpu').data
    assert not np.allclose(plain, warped)
    ref = kaldi_oracle.plp(audio.data.astype(np.float64), vtln=1.1)
    assert np.max(np.abs(warped - ref)) < 1e-3


def test_rasta_filter_streaming_matches_scan():
    """The streaming RastaFilter equals the batched filter frame by
    frame."""
    from shennong_tpu_torch.ops.plp import rasta_filter
    from shennong_tpu_torch.processor.plp import RastaFilter

    rng = np.random.RandomState(0)
    mel = np.abs(rng.randn(30, 23)) + 0.1

    log_mel = np.log(mel + np.finfo(np.float32).eps)
    batched = rasta_filter(
        torch.from_numpy(log_mel[None].astype(np.float32)))[0].numpy()

    filt = RastaFilter(23)
    streamed = np.stack([
        filt.filter(frame, do_log=True) for frame in mel])
    # batched output is log-domain; warm-up frames are zeros -> ones
    assert np.allclose(streamed, np.exp(batched), atol=1e-4)

    # reset gives the same sequence again
    filt.reset()
    again = np.stack([filt.filter(frame) for frame in mel])
    assert np.array_equal(streamed, again)

    # do_log=False path operates on already-log frames
    filt.reset()
    raw = np.stack([
        filt.filter(frame, do_log=False) for frame in log_mel])
    assert np.allclose(raw, batched, atol=1e-4)

    with pytest.raises(ValueError, match='shape'):
        RastaFilter(23).filter(np.zeros(7))
