"""Counterpart of ``tests/processor/test_pitch_crepe.py``, case for
case: the port's CREPE processor ('tiny' weights), post-processor and
host and device Viterbi decoders on the CPU, on the conftest's signals,
with the JAX cases' checks and bounds (batched 1e-5 against single,
device decode POV 1e-5 and pitch under 4 Hz on under 10% of frames,
the device-resident path 1e-4 relative and 1e-3 absolute against the
host reference path, the decoders bit-equal to the dense one).
``tests/test_torch_crepe.py`` holds the same functions against the JAX
package. On the CPU the device decode is the plain version of the
banded kernel (K1), ``chip_smoke.py`` holds the kernel on the card.
"""

import numpy as np
import pytest
import torch

from shennong_tpu_torch.processor.pitch_crepe import (
    CrepePitchProcessor, CrepePitchPostProcessor,
    _nccf_to_pov, _pov_to_nccf, predict_voicing)

from tests.torch_ref import audio, audio_8k, mfcc  # noqa: F401


@pytest.fixture(scope='module')
def crepe_pitch(audio):
    return CrepePitchProcessor(model_capacity='tiny').process(
        audio, device='cpu')


def test_params():
    proc = CrepePitchProcessor()
    params = proc.get_params()
    # the reference's 5 parameters plus the TPU-native 'decode'
    # extension (host-bit-exact default vs on-device decode)
    assert len(params) == 6
    # default is 'full', as in the reference (pitch_crepe.py:302)
    assert params['model_capacity'] == 'full'
    assert params['viterbi'] is True
    assert params['decode'] == 'host'
    assert proc.sample_rate == 16000
    with pytest.raises(ValueError, match='not recognized'):
        CrepePitchProcessor(model_capacity='huge')
    with pytest.raises(ValueError, match='decode'):
        CrepePitchProcessor(decode='gpu')


def test_missing_weights_error(audio):
    # only 'tiny' ships in the repo: the reference default capacity
    # must fail with an actionable message, not silently downgrade
    with pytest.raises(RuntimeError, match='convert-crepe'):
        CrepePitchProcessor(model_capacity='full').process(audio, device='cpu')


def test_shape_anchor(crepe_pitch):
    assert crepe_pitch.shape == (140, 2)
    assert np.all(crepe_pitch.data[:, 0] >= 0)
    assert np.all(crepe_pitch.data[:, 0] <= 1)
    assert np.all(crepe_pitch.data[:, 1] >= 0)


def test_tracks_f0(crepe_pitch):
    """CREPE tiny must roughly follow the synthetic F0 on confident
    frames."""
    times = crepe_pitch.times.mean(axis=1)
    expected = 120 + 30 * np.sin(2 * np.pi * 0.7 * times)
    confident = crepe_pitch.data[:, 0] > 0.5
    assert confident.sum() > 20
    err = np.abs(crepe_pitch.data[confident, 1] - expected[confident])
    # tiny model on synthetic audio: octave errors possible, check the
    # median only
    assert np.median(err) < 20.0


def test_no_viterbi(audio, crepe_pitch):
    out = CrepePitchProcessor(
        model_capacity='tiny', viterbi=False).process(audio, device='cpu')
    assert out.shape == crepe_pitch.shape
    assert not np.array_equal(out.data, crepe_pitch.data)


def test_no_center(audio, crepe_pitch):
    out = CrepePitchProcessor(
        model_capacity='tiny', center=False).process(audio, device='cpu')
    assert out.shape == crepe_pitch.shape


def test_stereo_rejected(data_path):
    from shennong_tpu_torch.audio import Audio
    stereo = Audio.load(str(data_path / 'test.stereo.wav'))
    with pytest.raises(ValueError, match='one channel'):
        CrepePitchProcessor(model_capacity='tiny').process(
            stereo, device='cpu')


def test_resamples_8k(audio_8k):
    out = CrepePitchProcessor(model_capacity='tiny').process(
        audio_8k, device='cpu')
    assert out.ndims == 2
    assert out.nframes > 0


def test_pov_nccf_inversion():
    nccf = np.linspace(0, 1, 100)
    pov = _nccf_to_pov(nccf)
    back = _pov_to_nccf(pov)
    assert np.max(np.abs(back - nccf)) < 1e-3


def test_predict_voicing():
    confidence = np.concatenate(
        [np.full(20, 0.9), np.full(20, 0.05), np.full(20, 0.95)])
    voicing = predict_voicing(confidence)
    assert np.array_equal(voicing[:20], np.ones(20))
    assert np.array_equal(voicing[20:40], np.zeros(20))
    assert np.array_equal(voicing[40:], np.ones(20))


def test_post(crepe_pitch):
    post = CrepePitchPostProcessor()
    out = post.process(crepe_pitch, device='cpu')
    assert out.shape == (crepe_pitch.nframes, 3)
    assert out.properties['crepe']['crepe postprocessing']

    post.add_raw_log_pitch = True
    assert post.process(crepe_pitch, device='cpu').shape == (
        crepe_pitch.nframes, 4)


def test_post_validation(crepe_pitch, mfcc):
    post = CrepePitchPostProcessor(
        add_pov_feature=False, add_normalized_log_pitch=False,
        add_delta_pitch=False, add_raw_log_pitch=False)
    with pytest.raises(ValueError, match='at least one'):
        post.process(crepe_pitch, device='cpu')
    with pytest.raises(ValueError, match='shape must be'):
        CrepePitchPostProcessor().process(mfcc, device='cpu')


def test_post_all_unvoiced(crepe_pitch):
    from shennong_tpu_torch import Features
    silent = Features(
        np.zeros_like(crepe_pitch.data), crepe_pitch.times,
        properties=crepe_pitch.properties)
    with pytest.raises(ValueError, match='No voiced frames'):
        CrepePitchPostProcessor().process(silent, device='cpu')


def test_process_all_batched(wav_file):
    """Batched process_all (one CNN pass over all utterances) matches
    per-utterance process()."""
    from shennong_tpu_torch import Utterances
    utterances = Utterances([
        ('u1', wav_file, 0.0, 0.7), ('u2', wav_file, 0.5, 1.4),
        ('u3', wav_file, 0.0, 1.4)])
    proc = CrepePitchProcessor(model_capacity='tiny')
    batched = proc.process_all(utterances, device='cpu')
    assert sorted(batched.keys()) == ['u1', 'u2', 'u3']
    for utt in utterances:
        single = proc.process(utt.load_audio(), device='cpu')
        assert batched[utt.name].shape == single.shape
        assert np.allclose(
            batched[utt.name].data, single.data, atol=1e-5), utt.name
        assert np.array_equal(batched[utt.name].times, single.times)


@pytest.mark.parametrize('viterbi', [True, False])
def test_process_all_device_decode(wav_file, viterbi):
    """The opt-in on-device decode (banded Viterbi + neighborhood
    cents + confidence) agrees with the
    bit-exact float64 host decode: confidences are the same float32
    maxima, and the decoded pitch track may differ only on near-tie
    bin flips — none on this real audio."""
    from shennong_tpu_torch import Utterances
    utterances = Utterances([
        ('u1', wav_file, 0.0, 0.7), ('u2', wav_file, 0.5, 1.4),
        ('u3', wav_file, 0.0, 1.4)])
    host = CrepePitchProcessor(
        model_capacity='tiny', viterbi=viterbi).process_all(
            utterances, device='cpu')
    device = CrepePitchProcessor(
        model_capacity='tiny', viterbi=viterbi,
        decode='device').process_all(utterances, device='cpu')
    for name in host.keys():
        h, d = host[name].data, device[name].data
        assert h.shape == d.shape, name
        # POV column: same confidence values (float32 maxima both
        # ways, resampled identically)
        assert np.allclose(h[:, 0], d[:, 0], atol=1e-5), name
        # pitch column: the float32 forward scores may resolve
        # near-tie plateaus differently from the float64 host decode
        # (measured on the TPU: 1-5% of frames shift by ONE 20-cent
        # bin, <= ~2 Hz); never more than one bin, most frames exact
        diff = np.abs(h[:, 1] - d[:, 1])
        assert diff.max() < 4.0, (name, diff.max())
        assert (diff > 0.1).mean() < 0.10, (name, (diff > 0.1).mean())


def test_process_all_threaded_decode(wav_file, monkeypatch):
    """Forcing the multi-core row-decode pool must not change any
    output (rows are independent; the native kernel is re-entrant)."""
    import os

    from shennong_tpu_torch import Utterances

    utterances = Utterances([
        ('u1', wav_file, 0.0, 0.7), ('u2', wav_file, 0.5, 1.4),
        ('u3', wav_file, 0.0, 1.4)])
    proc = CrepePitchProcessor(model_capacity='tiny')
    serial = proc.process_all(utterances, device='cpu')
    monkeypatch.setattr(os, 'cpu_count', lambda: 4)
    threaded = proc.process_all(utterances, device='cpu')
    for name in serial.keys():
        assert np.array_equal(
            serial[name].data, threaded[name].data), name
        assert np.array_equal(
            serial[name].times, threaded[name].times)


def test_banded_viterbi_matches_dense():
    # the banded decoder must reproduce the dense one bit-for-bit on
    # the CREPE smoothing prior, including argmax tie-breaks on the
    # two-valued emission rows
    from shennong_tpu_torch.ops.viterbi import (
        viterbi_host, viterbi_host_banded)

    nstates = 60
    grid = np.arange(nstates)
    transition = np.maximum(
        12 - np.abs(grid[:, None] - grid[None, :]), 0).astype(float)
    transition /= transition.sum(axis=1, keepdims=True)
    start = np.full(nstates, 1.0 / nstates)

    self_emission = 0.1
    emission = (np.eye(nstates) * self_emission
                + (1 - self_emission) / nstates)

    rng = np.random.RandomState(5)
    for trial in range(5):
        observations = rng.randint(0, nstates, size=300)
        # repeated observations create long tie plateaus
        observations[100:200] = observations[100]
        with np.errstate(divide='ignore'):
            log_obs = np.log(emission[:, observations].T)
            dense = viterbi_host(
                np.log(start), np.log(transition), log_obs)
            banded = viterbi_host_banded(
                np.log(start), np.log(transition), log_obs, 11)
        np.testing.assert_array_equal(banded, dense)


def test_device_decode_matches_host(audio):
    # the device-resident path (chunked device framing, stats-only
    # fetch, neighborhood decode) must match the host reference path
    # (_model_frames + _forward + _decode) on the same audio
    proc = CrepePitchProcessor(model_capacity='tiny')
    device = proc.process(audio, device='cpu')
    host = proc._decode(
        proc._forward(proc._model_frames(
            audio.data.astype(np.float32)), 'cpu'), audio.shape[0])
    assert device.shape == host.shape
    np.testing.assert_allclose(
        device.data, host.data, rtol=1e-4, atol=1e-3)


def test_two_valued_viterbi_matches_dense():
    # the sparse-observation decoder (native kernel) must match the
    # dense decoder on the CREPE smoothing prior
    from shennong_tpu_torch.ops.viterbi import (
        viterbi_host, viterbi_host_banded_obs)
    from shennong_tpu_torch.processor.pitch_crepe import _crepe_prior

    nstates = 90
    start, transition, emission = _crepe_prior(nstates)
    rng = np.random.RandomState(11)
    obs = rng.randint(0, nstates, size=400)
    obs[50:150] = obs[50]
    with np.errstate(divide='ignore'):
        log_obs = np.log(emission[:, obs].T)
        dense = viterbi_host(
            np.log(start), np.log(transition), log_obs)
        sparse = viterbi_host_banded_obs(
            np.log(start), np.log(transition), obs,
            np.log(emission[1, 0]), np.log(emission[0, 0]), 11)
    np.testing.assert_array_equal(sparse, dense)


def test_chunked_device_matches_host_small_hop(audio):
    # with a small hop the normalization owner dependency reaches
    # further than the default halo used to cover; shrink the chunk
    # cap so chunk boundaries appear on a short clip and compare to
    # the host reference path (regression for the halo sizing)
    proc = CrepePitchProcessor(
        model_capacity='tiny', frame_shift=0.005)
    proc.CHUNK_FRAMES = 64
    device = proc.process(audio, device='cpu')
    host = proc._decode(
        proc._forward(proc._model_frames(
            audio.data.astype(np.float32)), 'cpu'), audio.shape[0])
    assert device.shape == host.shape
    np.testing.assert_allclose(
        device.data, host.data, rtol=1e-4, atol=1e-3)


def test_banded_viterbi_numpy_fallback(monkeypatch):
    # the pure-python fallback (no g++ toolchain) must match the
    # native kernel; force it by making the native wrappers return None
    from shennong_tpu_torch import native
    from shennong_tpu_torch.ops.viterbi import (
        viterbi_host_banded, viterbi_host_banded_obs)
    from shennong_tpu_torch.processor.pitch_crepe import _crepe_prior

    nstates = 60
    start, transition, emission = _crepe_prior(nstates)
    rng = np.random.RandomState(2)
    obs = rng.randint(0, nstates, size=200)
    with np.errstate(divide='ignore'):
        log_obs = np.log(emission[:, obs].T)
        native_path = viterbi_host_banded(
            np.log(start), np.log(transition), log_obs, 11)

        monkeypatch.setattr(
            native, 'viterbi_banded', lambda *a, **k: None)
        monkeypatch.setattr(
            native, 'viterbi_banded_two', lambda *a, **k: None)
        numpy_path = viterbi_host_banded(
            np.log(start), np.log(transition), log_obs, 11)
        numpy_obs_path = viterbi_host_banded_obs(
            np.log(start), np.log(transition), obs,
            np.log(emission[1, 0]), np.log(emission[0, 0]), 11)
    np.testing.assert_array_equal(numpy_path, native_path)
    np.testing.assert_array_equal(numpy_obs_path, native_path)


def test_single_frame_decodes():
    # one-frame inputs take the numpy path (native gated on
    # nframes > 1) and must not crash
    from shennong_tpu_torch.processor.pitch_crepe import (
        _viterbi_bin_path, predict_voicing)
    assert _viterbi_bin_path(np.array([7]), 360).tolist() == [7]
    assert predict_voicing(np.array([0.9])).tolist() == [1]


def test_banded_viterbi_wide_halfwidth_matches_dense():
    """halfwidth >= 64 exceeds the native kernel's band limit (it
    refuses and the numpy fallback runs) and would wrap an int8
    band-relative backpointer — the wide band must still decode
    exactly like the dense reference."""
    from shennong_tpu_torch.ops.viterbi import (
        viterbi_host, viterbi_host_banded)

    nstates = 150
    halfwidth = 70
    grid = np.arange(nstates)
    transition = np.maximum(
        halfwidth + 1 - np.abs(grid[:, None] - grid[None, :]),
        0).astype(float)
    transition /= transition.sum(axis=1, keepdims=True)
    start = np.full(nstates, 1.0 / nstates)

    rng = np.random.RandomState(11)
    log_obs = np.log(rng.rand(120, nstates) + 1e-9)
    with np.errstate(divide='ignore'):
        dense = viterbi_host(
            np.log(start), np.log(transition), log_obs)
        banded = viterbi_host_banded(
            np.log(start), np.log(transition), log_obs, halfwidth)
    np.testing.assert_array_equal(banded, dense)


def test_batched_device_viterbi_matches_host_masked():
    """The batched banded Viterbi (float32, per-row length
    masking) decodes exactly like the float64 host kernel on smooth
    argmax tracks of heterogeneous lengths — the masking freezes
    scores and stores identity pointers past each row's length, so
    padded tails cannot leak into real frames."""
    from shennong_tpu_torch.ops.viterbi import (
        _band_matrix, viterbi_banded_obs_batch, viterbi_host_banded_obs)
    from shennong_tpu_torch.processor.pitch_crepe import _crepe_prior_logs

    log_start, log_trans, uniform_w, self_w, band = _crepe_prior_logs(360)
    rng = np.random.RandomState(0)
    batch, frames = 6, 500
    obs = np.cumsum(rng.randint(-3, 4, size=(batch, frames)), axis=1) + 180
    obs = np.clip(obs, 0, 359).astype(np.int32)
    nframes = np.array([500, 499, 371, 200, 64, 1], np.int32)

    device = viterbi_banded_obs_batch(
        log_start, band, uniform_w, self_w, torch.from_numpy(obs),
        nframes, 11).numpy()
    for row in range(batch):
        host = viterbi_host_banded_obs(
            log_start, log_trans, obs[row, :nframes[row]],
            uniform_w, self_w, 11, band=band)
        np.testing.assert_array_equal(
            device[row, :nframes[row]], host, err_msg=f'row {row}')
