"""The port's CREPE pitch against the JAX package, on the CPU.

Inputs are made with numpy from a seed, or are the generated WAVs of
``tests/conftest.py``; the JAX functions run on the CPU and the port's
on CPU tensors (the plain versions of its kernels).

- ``Audio.resample`` bit-equal, poly and scipy, int16 and float;
- the CNN (:class:`Crepe`) against ``shennong_tpu.models.crepe.forward``
  with the shipped 'tiny' weights and seeded 'small'-width weights,
  1e-5 (two float32 convolution stacks summing in different orders);
- ``forward_audio_chunk`` at hops 160 and 80 with three rows of
  different owners (salience 1e-5, argmax equal), ``gather_neighborhood``
  exact and ``decode_salience_chunk`` (cents 1e-4 relative, confidence
  1e-6);
- the decoders: the float64 host decoders' paths equal (native and
  numpy), the dense generic decoder's paths equal, and the plain
  batched banded decoder's paths equal on masked lengths;
- the processor (``process``, ``process_all`` with the host and the
  device decode, ``viterbi=False``, ``center=False``,
  ``frame_shift=0.005``, the chunked path) at the tolerance of
  ``tests/processor/test_pitch_crepe.py`` (rtol 1e-4, atol 1e-3), the
  post-processor at 1e-3 with the noise at 0, and ``extract_features``
  with CREPE pitch, CMVN and deltas at 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shennong_tpu import Utterances as JUtterances
from shennong_tpu import pipeline as jpipeline
from shennong_tpu.audio import Audio as JAudio
from shennong_tpu.models import crepe as jcrepe
from shennong_tpu.ops import viterbi as jviterbi
from shennong_tpu.processor import pitch_crepe as jpitch_crepe
from shennong_tpu_torch import Utterances, pipeline
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.models import crepe
from shennong_tpu_torch.ops import viterbi
from shennong_tpu_torch.processor import pitch_crepe
from shennong_tpu_torch.weights import crepe_from_numpy

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-3)


def small_params(seed=0):
    """Seeded keras-layout parameters at the 'small' widths."""
    rng = np.random.RandomState(seed)
    mult = crepe.CAPACITY_MULTIPLIER['small']
    params, cin = {}, 1
    for i, (filters, width) in enumerate(
            zip(crepe.LAYER_FILTERS, crepe.LAYER_WIDTHS), start=1):
        cout = filters * mult
        params[f'conv{i}/kernel'] = (
            rng.randn(width, cin, cout) / np.sqrt(width * cin)).astype(
                np.float32)
        params[f'conv{i}/bias'] = (rng.randn(cout) * 0.01).astype(np.float32)
        params[f'conv{i}/gamma'] = (1 + 0.1 * rng.randn(cout)).astype(
            np.float32)
        params[f'conv{i}/beta'] = (0.1 * rng.randn(cout)).astype(np.float32)
        params[f'conv{i}/mean'] = (0.1 * rng.rand(cout)).astype(np.float32)
        params[f'conv{i}/var'] = (0.5 + rng.rand(cout)).astype(np.float32)
        cin = cout
    params['classifier/kernel'] = (
        rng.randn(4 * cin, 360) / np.sqrt(4 * cin)).astype(np.float32)
    params['classifier/bias'] = np.zeros(360, np.float32)
    return params


def jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


# ------------------------------------------------------------ resample

@pytest.mark.parametrize('backend', ['sox', 'poly', 'scipy'])
@pytest.mark.parametrize('dtype', [np.int16, np.float32])
@pytest.mark.parametrize('rates', [(16000, 8000), (8000, 16000),
                                   (44100, 16000)])
def test_resample_bit_equal(backend, dtype, rates):
    rng = np.random.RandomState(0)
    data = np.clip(rng.randn(4000) * 0.3, -1, 1)
    data = (data * 2 ** 14).astype(np.int16) if dtype == np.int16 \
        else data.astype(np.float32)
    ours = Audio(data, rates[0]).resample(rates[1], backend=backend)
    ref = JAudio(data, rates[0]).resample(rates[1], backend=backend)
    assert ours.sample_rate == ref.sample_rate == rates[1]
    assert ours.dtype == ref.dtype
    assert ours.data.tobytes() == ref.data.tobytes()
    with pytest.raises(ValueError, match='backend'):
        Audio(data, rates[0]).resample(rates[1], backend='sinc')


# ------------------------------------------------------------ the model

@pytest.mark.parametrize('capacity', ['tiny', 'small'])
def test_forward_matches_jax(capacity):
    params = (crepe.load_params('tiny') if capacity == 'tiny'
              else small_params())
    frames = np.random.RandomState(1).randn(6, 1024).astype(np.float32)
    with torch.no_grad():
        ours = crepe_from_numpy(params)(torch.from_numpy(frames)).numpy()
    ref = np.asarray(jcrepe.forward(jparams(params), jnp.asarray(frames)))
    assert ours.shape == ref.shape == (6, 360)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_tiny_weights_equal_the_jax_package():
    import os
    ours = os.path.join(os.path.abspath(crepe.SHARE_DIR), 'model-tiny.npz')
    ref = os.path.join(os.path.abspath(jcrepe.SHARE_DIR), 'model-tiny.npz')
    with open(ours, 'rb') as a, open(ref, 'rb') as b:
        assert a.read() == b.read()
    assert crepe.available_capacities() == ('tiny',)
    assert crepe.capacity_of(crepe.load_params('tiny')) == 'tiny'


def test_geometry_matches_jax():
    for hop in (80, 160, 441):
        assert crepe.required_halo(hop) == jcrepe.required_halo(hop)
        for chunk in (64, 128, 8192):
            halo = crepe.required_halo(hop)
            assert crepe.segment_geometry(hop, chunk, halo) == \
                jcrepe.segment_geometry(hop, chunk, halo)
    for n in (0, 1000, 1024, 1100, 22713 + 1024):
        assert crepe.frame_count(n, 160) == jcrepe.frame_count(n, 160)
    assert np.array_equal(crepe.cents_mapping(), jcrepe.cents_mapping())


@pytest.mark.parametrize('hop', [160, 80])
def test_forward_audio_chunk_matches_jax(hop):
    chunk, halo = 24, crepe.required_halo(hop)
    seg_len, _ = crepe.segment_geometry(hop, chunk, halo)
    rng = np.random.RandomState(hop)
    t = np.arange(seg_len) / 16000
    segments = np.stack([
        np.round(8000 * np.sin(2 * np.pi * f0 * t)
                 + 300 * rng.randn(seg_len))
        for f0 in (110.0, 180.0, 260.0)]).astype(np.float32)
    nlocal = chunk + 2 * halo
    # one row owned past its end, two whose signal ends inside
    owners = np.array([nlocal + 5, nlocal // 2, halo + 3], np.int32)
    params = crepe.load_params('tiny')

    with torch.no_grad():
        sal, stats = crepe.forward_audio_chunk(
            crepe_from_numpy(params), torch.from_numpy(segments),
            torch.from_numpy(owners), hop, chunk, halo)
    ref_sal, ref_stats = jcrepe.forward_audio_chunk(
        jparams(params), jnp.asarray(segments), jnp.asarray(owners), hop,
        chunk, halo)
    np.testing.assert_allclose(sal.numpy(), np.asarray(ref_sal), atol=1e-5,
                               rtol=0)
    assert np.array_equal(stats[..., 0].numpy(), np.asarray(ref_stats)[..., 0])
    np.testing.assert_allclose(
        stats[..., 1].numpy(), np.asarray(ref_stats)[..., 1], atol=1e-5)

    # int16 segments convert on the device to the same values
    with torch.no_grad():
        sal16, _ = crepe.forward_audio_chunk(
            crepe_from_numpy(params),
            torch.from_numpy(segments.astype(np.int16)),
            torch.from_numpy(owners), hop, chunk, halo)
    assert torch.equal(sal16, sal)


def peaked_salience(shape, seed):
    """[B, T, 360] salience with a peak wandering along a smooth track,
    noise, and unvoiced stretches."""
    rng = np.random.RandomState(seed)
    rows, frames, bins = shape
    track = np.clip(np.cumsum(rng.randint(-2, 3, (rows, frames)), axis=1)
                    + 180, 10, bins - 10)
    grid = np.arange(bins)
    sal = np.exp(-0.5 * ((grid - track[..., None]) / 2.0) ** 2)
    sal *= rng.uniform(0.2, 1.0, (rows, frames, 1))
    sal += 0.05 * rng.rand(rows, frames, bins)
    return sal.astype(np.float32)


def test_gather_neighborhood_matches_jax():
    sal = peaked_salience((1, 50, 360), 0)[0]
    centers = np.array([0, 1, 3, 4, 180, 355, 356, 359] * 6 + [7, 200],
                       np.int32)
    ours = crepe.gather_neighborhood(
        torch.from_numpy(sal), torch.from_numpy(centers)).numpy()
    ref = np.asarray(jcrepe.gather_neighborhood(
        jnp.asarray(sal), jnp.asarray(centers)))
    assert ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize('smooth', [True, False])
def test_decode_salience_chunk_matches_jax(smooth):
    sal = peaked_salience((3, 120, 360), 1)
    nframes = np.array([120, 77, 1], np.int32)
    log_start, _, uniform, self_w, band = \
        pitch_crepe._crepe_prior_logs(360)
    mapping = crepe.cents_mapping()
    viterbi.reset_launches()
    ours = crepe.decode_salience_chunk(
        torch.from_numpy(sal), torch.from_numpy(nframes), log_start, band,
        uniform, self_w, mapping, viterbi=smooth).numpy()
    assert viterbi.LAUNCHES['banded_viterbi'] == 0
    ref = np.asarray(jcrepe.decode_salience_chunk(
        jnp.asarray(sal), jnp.asarray(nframes), log_start, band, uniform,
        self_w, mapping, viterbi=smooth))
    for row, n in enumerate(nframes):
        np.testing.assert_allclose(
            ours[row, :n, 0], ref[row, :n, 0], rtol=1e-4, atol=0)
        np.testing.assert_allclose(
            ours[row, :n, 1], ref[row, :n, 1], rtol=0, atol=1e-6)


# ------------------------------------------------------------ decoders

def crepe_prior(nstates):
    start, transition, emission = jpitch_crepe._crepe_prior(nstates)
    with np.errstate(divide='ignore'):
        return (np.log(start), np.log(transition),
                np.log(emission[1, 0]), np.log(emission[0, 0]), emission)


@pytest.mark.parametrize('use_native', [True, False])
def test_host_decoders_match_jax(monkeypatch, use_native):
    from shennong_tpu_torch import native

    if not use_native:
        monkeypatch.setattr(native, 'viterbi_banded', lambda *a: None)
        monkeypatch.setattr(native, 'viterbi_banded_two', lambda *a: None)
    log_start, log_trans, uniform, self_w, emission = crepe_prior(90)
    rng = np.random.RandomState(11)
    for trial in range(3):
        obs = rng.randint(0, 90, size=300)
        obs[50:150] = obs[50]  # a long tie plateau
        with np.errstate(divide='ignore'):
            log_obs = np.log(emission[:, obs].T)
        paths = [
            (viterbi.viterbi_host_banded(log_start, log_trans, log_obs, 11),
             jviterbi.viterbi_host_banded(log_start, log_trans, log_obs, 11)),
            (viterbi.viterbi_host_banded_obs(
                log_start, log_trans, obs, uniform, self_w, 11),
             jviterbi.viterbi_host_banded_obs(
                 log_start, log_trans, obs, uniform, self_w, 11)),
            (viterbi.viterbi_host(log_start, log_trans, log_obs),
             jviterbi.viterbi_host(log_start, log_trans, log_obs)),
        ]
        for ours, ref in paths:
            assert np.array_equal(ours, ref), trial
    assert np.array_equal(
        viterbi._band_matrix(log_trans, 11), jviterbi._band_matrix(
            log_trans, 11))
    # one frame takes the numpy path
    assert pitch_crepe._viterbi_bin_path(np.array([7]), 360).tolist() == [7]


def test_dense_viterbi_matches_jax():
    rng = np.random.RandomState(3)
    log_start = np.log(rng.dirichlet(np.ones(12))).astype(np.float32)
    log_trans = np.log(rng.dirichlet(np.ones(12), size=12)).astype(
        np.float32)
    log_obs = np.log(rng.rand(80, 12) + 1e-3).astype(np.float32)
    ours = viterbi.viterbi(*(torch.from_numpy(a) for a in (
        log_start, log_trans, log_obs))).numpy()
    ref = np.asarray(jviterbi.viterbi(
        jnp.asarray(log_start), jnp.asarray(log_trans),
        jnp.asarray(log_obs)))
    assert ours.dtype == np.int32
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize('seed', [0, 1])
def test_banded_obs_batch_plain_matches_jax(seed):
    log_start, log_trans, uniform, self_w, band = \
        pitch_crepe._crepe_prior_logs(360)
    rng = np.random.RandomState(seed)
    batch, frames = 6, 300
    obs = np.cumsum(rng.randint(-3, 4, size=(batch, frames)), axis=1) + 180
    obs[1] = rng.randint(0, 360, frames)  # jumps: the band edges
    obs[2, 40:200] = obs[2, 40]           # a plateau of ties
    obs = np.clip(obs, 0, 359).astype(np.int32)
    nframes = np.array([300, 299, 171, 2, 1, 0], np.int32)

    viterbi.reset_launches()
    ours = viterbi.viterbi_banded_obs_batch(
        log_start, band, uniform, self_w, torch.from_numpy(obs),
        torch.from_numpy(nframes), 11)
    assert viterbi.LAUNCHES['banded_viterbi'] == 0
    ref = np.asarray(jviterbi.viterbi_banded_obs_batch(
        log_start, band, uniform, self_w, jnp.asarray(obs),
        jnp.asarray(nframes), 11))
    assert ours.dtype == torch.int32
    # the whole rows, past each row's length too
    assert np.array_equal(ours.numpy(), ref)
    # and each row's prefix decodes like the float64 host kernel here
    for row in (0, 3, 4):
        host = viterbi.viterbi_host_banded_obs(
            log_start, log_trans, obs[row, :max(nframes[row], 1)], uniform,
            self_w, 11, band=band)
        assert np.array_equal(ours[row, :len(host)].numpy(), host)


def test_banded_obs_batch_refuses_bad_input():
    _, _, uniform, self_w, band = pitch_crepe._crepe_prior_logs(360)
    obs = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match='int32'):
        viterbi.viterbi_banded_obs_batch(
            np.zeros(360), band, uniform, self_w, obs.long(), [5, 5], 11)
    with pytest.raises(ValueError, match='halfwidth'):
        viterbi.viterbi_banded_obs_batch(
            np.zeros(360), band, uniform, self_w, obs, [5, 5], 10)
    with pytest.raises(ValueError, match='nframes'):
        viterbi.viterbi_banded_obs_batch(
            np.zeros(360), band, uniform, self_w, obs, [5], 11)


# ------------------------------------------------------------ processor

def both(path):
    return Audio.load(path), JAudio.load(path)


def test_params():
    proc = pitch_crepe.CrepePitchProcessor()
    assert proc.get_params() == jpitch_crepe.CrepePitchProcessor().get_params()
    with pytest.raises(ValueError, match='not recognized'):
        pitch_crepe.CrepePitchProcessor(model_capacity='huge')
    with pytest.raises(ValueError, match='decode'):
        pitch_crepe.CrepePitchProcessor(decode='gpu')
    post = pitch_crepe.CrepePitchPostProcessor()
    assert post.get_params() == \
        jpitch_crepe.CrepePitchPostProcessor().get_params()


def test_missing_weights_error(wav_file):
    audio, _ = both(wav_file)
    with pytest.raises(RuntimeError, match='speech-features-torch '
                       'convert-crepe'):
        pitch_crepe.CrepePitchProcessor(model_capacity='full').process(
            audio, device='cpu')


def test_stereo_rejected(data_path):
    stereo = Audio.load(str(data_path / 'test.stereo.wav'))
    with pytest.raises(ValueError, match='one channel'):
        pitch_crepe.CrepePitchProcessor(model_capacity='tiny').process(
            stereo, device='cpu')


OPTIONS = {
    'default': {},
    'no viterbi': {'viterbi': False},
    'no center': {'center': False},
    'hop 5 ms': {'frame_shift': 0.005},
}


@pytest.mark.parametrize('name', ['wav_file', 'wav_file_8k'])
@pytest.mark.parametrize('option', list(OPTIONS))
def test_process_matches_jax(request, name, option):
    audio, jaudio = both(request.getfixturevalue(name))
    kwargs = dict(model_capacity='tiny', **OPTIONS[option])
    ours = pitch_crepe.CrepePitchProcessor(**kwargs).process(
        audio, device='cpu')
    ref = jpitch_crepe.CrepePitchProcessor(**kwargs).process(jaudio)
    assert ours.shape == ref.shape
    assert np.array_equal(ours.times, ref.times)
    np.testing.assert_allclose(ours.data, ref.data, **TOL)
    assert ours.properties == ref.properties


def test_host_path_matches_device_path(wav_file):
    """The host reference path (host framing, CNN, host decode) and the
    device path of the same processor agree, as in the JAX package."""
    audio, _ = both(wav_file)
    proc = pitch_crepe.CrepePitchProcessor(model_capacity='tiny')
    device = proc.process(audio, device='cpu')
    host = proc._decode(proc._forward(proc._model_frames(
        audio.data.astype(np.float32)), 'cpu'), audio.shape[0])
    np.testing.assert_allclose(device.data, host.data, **TOL)


@pytest.mark.parametrize('frame_shift', [0.01, 0.005])
def test_chunked_matches_jax(wav_file, monkeypatch, frame_shift):
    """Chunk boundaries on a short clip: CHUNK_FRAMES lowered on both
    classes; the halo covers the owner dependency at both hops."""
    audio, jaudio = both(wav_file)
    monkeypatch.setattr(pitch_crepe.CrepePitchProcessor, 'CHUNK_FRAMES', 48)
    monkeypatch.setattr(jpitch_crepe.CrepePitchProcessor, 'CHUNK_FRAMES', 48)
    kwargs = dict(model_capacity='tiny', frame_shift=frame_shift)
    proc = pitch_crepe.CrepePitchProcessor(**kwargs)
    salience = proc._device_salience(audio.data, 'cpu')
    assert len(salience.chunks) > 2
    ours = proc.process(audio, device='cpu')
    ref = jpitch_crepe.CrepePitchProcessor(**kwargs).process(jaudio)
    np.testing.assert_allclose(ours.data, ref.data, **TOL)
    # and against the unchunked whole signal
    monkeypatch.setattr(
        pitch_crepe.CrepePitchProcessor, 'CHUNK_FRAMES', 8192)
    whole = pitch_crepe.CrepePitchProcessor(**kwargs).process(
        audio, device='cpu')
    np.testing.assert_allclose(ours.data, whole.data, **TOL)


def utterances_of(wav_file):
    items = [('u1', wav_file, 0.0, 0.7), ('u2', wav_file, 0.5, 1.4),
             ('u3', wav_file, 0.0, 1.4), ('u4', wav_file, 0.0, 0.01)]
    return Utterances(items), JUtterances(items)


@pytest.mark.parametrize('decode', ['host', 'device'])
@pytest.mark.parametrize('smooth', [True, False])
def test_process_all_matches_jax(wav_file, decode, smooth, monkeypatch):
    ours_utts, ref_utts = utterances_of(wav_file)
    kwargs = dict(model_capacity='tiny', decode=decode, viterbi=smooth)
    viterbi.reset_launches()
    ours = pitch_crepe.CrepePitchProcessor(**kwargs).process_all(
        ours_utts, device='cpu')
    assert viterbi.LAUNCHES['banded_viterbi'] == 0
    ref = jpitch_crepe.CrepePitchProcessor(**kwargs).process_all(ref_utts)
    assert list(ours.keys()) == list(ref.keys())
    for name in ref.keys():
        assert ours[name].shape == ref[name].shape, name
        np.testing.assert_allclose(ours[name].data, ref[name].data, **TOL)
    assert ours['u4'].shape == (0, 2)
    # with the host decode, process_all equals process
    if decode == 'host':
        proc = pitch_crepe.CrepePitchProcessor(**kwargs)
        for utt in ours_utts:
            single = proc.process(utt.load_audio(), device='cpu')
            np.testing.assert_allclose(
                ours[utt.name].data, single.data, atol=1e-5, rtol=0)


def test_process_all_chunked_and_threaded(wav_file, monkeypatch):
    """Utterances past CHUNK_FRAMES take the chunked path inside
    process_all; a multi-core decode pool changes no output."""
    import os
    ours_utts, ref_utts = utterances_of(wav_file)
    monkeypatch.setattr(pitch_crepe.CrepePitchProcessor, 'CHUNK_FRAMES', 100)
    monkeypatch.setattr(jpitch_crepe.CrepePitchProcessor, 'CHUNK_FRAMES', 100)
    proc = pitch_crepe.CrepePitchProcessor(model_capacity='tiny')
    monkeypatch.setattr(os, 'cpu_count', lambda: 1)
    serial = proc.process_all(ours_utts, device='cpu')
    monkeypatch.setattr(os, 'cpu_count', lambda: 4)
    threaded = proc.process_all(ours_utts, device='cpu')
    ref = jpitch_crepe.CrepePitchProcessor(
        model_capacity='tiny').process_all(ref_utts)
    for name in ref.keys():
        assert np.array_equal(serial[name].data, threaded[name].data)
        np.testing.assert_allclose(serial[name].data, ref[name].data, **TOL)


# ------------------------------------------------------- post-processor

def test_voicing_and_nccf_match_jax():
    rng = np.random.RandomState(0)
    confidence = np.concatenate(
        [np.full(20, 0.9), np.full(20, 0.05), rng.rand(40)])
    assert np.array_equal(pitch_crepe.predict_voicing(confidence),
                          jpitch_crepe.predict_voicing(confidence))
    pov = rng.rand(100)
    assert np.array_equal(pitch_crepe._pov_to_nccf(pov),
                          jpitch_crepe._pov_to_nccf(pov))


@pytest.mark.parametrize('raw_log_pitch', [False, True])
def test_post_matches_jax(wav_file, raw_log_pitch):
    from shennong_tpu_torch.features import Features

    _, jaudio = both(wav_file)
    raw = jpitch_crepe.CrepePitchProcessor(model_capacity='tiny').process(
        jaudio)
    kwargs = dict(delta_pitch_noise_stddev=0, add_raw_log_pitch=raw_log_pitch)
    ours = pitch_crepe.CrepePitchPostProcessor(**kwargs).process(
        Features(raw.data, raw.times, raw.properties), device='cpu')
    ref = jpitch_crepe.CrepePitchPostProcessor(**kwargs).process(raw)
    assert ours.shape == ref.shape == (raw.nframes, 3 + raw_log_pitch)
    np.testing.assert_allclose(ours.data, ref.data, atol=1e-3, rtol=0)
    assert ours.properties == ref.properties


def test_post_validation(wav_file):
    from shennong_tpu_torch.features import Features

    raw = pitch_crepe.CrepePitchProcessor(model_capacity='tiny').process(
        both(wav_file)[0], device='cpu')
    with pytest.raises(ValueError, match='at least one'):
        pitch_crepe.CrepePitchPostProcessor(
            add_pov_feature=False, add_normalized_log_pitch=False,
            add_delta_pitch=False, add_raw_log_pitch=False).process(
                raw, device='cpu')
    with pytest.raises(ValueError, match='shape must be'):
        pitch_crepe.CrepePitchPostProcessor().process(
            Features(np.zeros((5, 3)), raw.times[:5], raw.properties),
            device='cpu')
    with pytest.raises(ValueError, match='No voiced frames'):
        pitch_crepe.CrepePitchPostProcessor().process(
            Features(np.zeros_like(raw.data), raw.times, raw.properties),
            device='cpu')


# ------------------------------------------------------------ pipeline

def test_pipeline_matches_jax(wav_file, monkeypatch):
    """MFCC + CREPE pitch + CMVN + delta: the stage-wise pass 1 (CREPE
    forces it), its features and energy sweeps sharing one decode of
    the corpus, against the JAX pipeline with every random source at
    0 (the energy VAD's dither too)."""
    from shennong_tpu.processor import energy as jenergy
    from shennong_tpu_torch.parallel import stream
    from shennong_tpu_torch.processor import energy

    items = [('utt1', wav_file, 'spk1', 0.0, 0.7),
             ('utt2', wav_file, 'spk2', 0.7, 1.4),
             ('utt3', wav_file, 'spk1', 0.2, 1.4)]
    config = pipeline.get_default_config(
        'mfcc', with_pitch='crepe', with_cmvn=True, with_delta=True)
    assert config == jpipeline.get_default_config(
        'mfcc', with_pitch='crepe', with_cmvn=True, with_delta=True)
    config['mfcc']['dither'] = 0
    config['pitch']['model_capacity'] = 'tiny'
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    for module in (energy, jenergy):
        defaults = list(module.EnergyProcessor.__init__.__defaults__)
        defaults[3] = 0.0
        monkeypatch.setattr(module.EnergyProcessor.__init__, '__defaults__',
                            tuple(defaults))

    decodes = []
    real = stream.decode_batch

    def counting(chunk, *args):
        decodes.append(len(chunk))
        return real(chunk, *args)

    monkeypatch.setattr(stream, 'decode_batch', counting)
    ours = pipeline.extract_features(
        config, Utterances(items), device='cpu')
    # the features and energy sweeps share one decode of each utterance
    assert sum(decodes) == len(items)
    ref = jpipeline.extract_features(config, JUtterances(items))
    for name, _, _, _, _ in items:
        assert ours[name].shape == ref[name].shape
        assert ours[name].shape[1] == 13 * 3 + 3
        np.testing.assert_allclose(
            ours[name].data, ref[name].data, atol=1e-3, rtol=0)
