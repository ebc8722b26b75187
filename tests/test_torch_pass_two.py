"""Pass 2 of the pipeline over packed groups (``pipeline._pass_two``,
``ops/pass_two.py``) against the per-utterance chain of the public
post-processors: ``CmvnPostProcessor.process`` (through
``PipelineManager.apply_cmvn``), ``compute_deltas_host`` and
``Features.concatenate``, bit for bit in data, times and properties,
with the same warnings and errors.

The ``gpu`` test holds the kernel against the plain version on the
card, at the shape of a test_clean CMVN group and of a half-hour one
(it imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_pass_two.py
"""

import logging
import warnings

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from shennong_tpu_torch import pipeline
from shennong_tpu_torch.features import Features
from shennong_tpu_torch.ops import pass_two
from shennong_tpu_torch.ops.postops import compute_deltas_host
from shennong_tpu_torch.parallel.executor import _RawProps
from shennong_tpu_torch.parallel.profiler import counters
from shennong_tpu_torch.pipeline_manager import PipelineManager
from shennong_tpu_torch.processor.mfcc import MfccProcessor
from shennong_tpu_torch.processor.pitch_kaldi import (
    KaldiPitchPostProcessor, KaldiPitchProcessor)
from shennong_tpu_torch.utils import dict_equal
from shennong_tpu_torch.utterances import Utterances

#: frames of a group's utterances: empty, one frame, short and long
LENGTHS = (0, 1, 2, 7, 37, 150, 301, 64, 65, 129)


def chained(manager, triplets, log, tolerance=2):
    """The per-utterance chain of the public post-processors."""
    config = manager.config
    delta = manager.make('delta') if 'delta' in config else None
    out = {}
    for utterance, features, pitch in triplets:
        if 'cmvn' in config:
            features = manager.apply_cmvn(utterance, features)
        if delta is not None:
            data, = compute_deltas_host(
                [features.data], order=delta.order, window=delta.window)
            features = Features(
                data.astype(features.dtype, copy=False), features.times,
                delta.get_properties(features), validate=False)
        if pitch is not None:
            features = features.concatenate(
                pitch, tolerance=tolerance, log=log, validate=False)
        out[utterance.name] = features
    return out


def group(directory, lengths, speakers, *, cmvn=True, delta=(2, 2),
          pitch=True, shifts=None, dtype=np.float32, ndim=None, seed=0,
          prefix='u', device='cpu'):
    """(manager, triplets) of synthetic pass-1 outputs, one utterance of
    each of ``lengths`` frames, the speakers dealt in turn: MFCC-shaped
    features (``ndim`` columns, 13 by default, of ``dtype``) with
    pass 1's properties, Kaldi pitch ``shifts[i]`` frames longer, and
    the CMVN statistics accumulated under a random VAD mask; pass 2
    runs on ``device``."""
    rng = np.random.RandomState(seed)
    entries = []
    for index in range(len(lengths)):
        wav = str(directory / f'{prefix}{index}.wav')
        scipy.io.wavfile.write(wav, 16000, np.zeros(160, np.int16))
        entries.append((f'{prefix}{index}', wav, f'spk{index % speakers}'))
    config = pipeline.get_default_config(
        'mfcc', with_pitch='kaldi' if pitch else False, with_cmvn=cmvn,
        with_delta=delta is not None)
    if cmvn:
        config['cmvn']['by_speaker'] = True
    if delta is not None:
        config['delta']['order'], config['delta']['window'] = delta
    utterances = Utterances(entries)
    manager = PipelineManager(
        pipeline.init_config(config), utterances, device=device)

    mfcc = MfccProcessor()
    ndim = ndim or mfcc.ndims
    raw = KaldiPitchProcessor()
    post = KaldiPitchPostProcessor()
    means = rng.randn(ndim) * 10
    scales = np.exp(rng.randn(ndim))
    triplets = []
    for index, (utterance, nframes) in enumerate(zip(utterances, lengths)):
        data = (rng.randn(nframes, ndim) * scales + means).astype(dtype)
        properties = mfcc.get_properties(vtln_warp=1.0)
        properties['mfcc']['sample_weights'] = np.arange(3.0)
        features = Features(data, mfcc.times(nframes), properties)
        if cmvn:
            manager.accumulate_cmvn(
                utterance, features,
                weights=(rng.rand(nframes) > 0.3).astype(np.float32))
        pipeline._with_audio_properties(manager, utterance, features)
        pframes = max(0, nframes + (shifts[index] if shifts else 0))
        triplets.append((utterance, features, Features(
            rng.randn(pframes, post.ndims).astype(np.float32),
            raw.times(pframes),
            post.get_properties(_RawProps(raw.get_properties())))
            if pitch else None))
    return manager, triplets


def assert_same(ours, ref):
    assert list(ours) == list(ref)
    for name in ref:
        assert ours[name].dtype == ref[name].dtype, name
        assert ours[name].shape == ref[name].shape, name
        np.testing.assert_array_equal(ours[name].data, ref[name].data)
        np.testing.assert_array_equal(ours[name].times, ref[name].times)
        assert ours[name].times.shape == ref[name].times.shape
        assert dict_equal(ours[name].properties, ref[name].properties), name
        assert ours[name] == ref[name]


class Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def logger(name):
    log = logging.getLogger(f'test-pass-two-{name}')
    log.propagate = False
    log.handlers = [Records()]
    return log


@pytest.mark.parametrize('cmvn', [True, False])
@pytest.mark.parametrize('delta', [None] + [
    (order, window) for order in (1, 2, 3) for window in (1, 2, 3)])
@pytest.mark.parametrize('pitch', [True, False])
def test_packed_pass_two_is_the_chain(tmp_path, cmvn, delta, pitch):
    manager, triplets = group(tmp_path, LENGTHS, 3, cmvn=cmvn, delta=delta,
                              pitch=pitch)
    log = logger('chain')
    ours = pipeline._pass_two(manager, triplets, log)
    assert_same(ours, chained(manager, triplets, log))
    # each utterance holds its own properties
    first, second = list(ours.values())[:2]
    first.properties['mfcc']['sample_weights'][0] = -1.0
    first.properties['pipeline'].append({'name': 'extra'})
    assert second.properties['mfcc']['sample_weights'][0] == 0.0
    assert second.properties['pipeline'][-1] != {'name': 'extra'}


@pytest.mark.parametrize('shift', [-2, -1, 1, 2])
def test_pitch_off_by_frames_is_trimmed_with_a_warning(tmp_path, shift):
    shifts = [shift if index % 2 else 0 for index in range(len(LENGTHS))]
    manager, triplets = group(tmp_path, LENGTHS, 2, shifts=shifts)
    ours_log, ref_log = logger('ours'), logger('ref')
    ours = pipeline._pass_two(manager, triplets, ours_log)
    assert_same(ours, chained(manager, triplets, ref_log))
    messages = ours_log.handlers[0].messages
    assert messages == ref_log.handlers[0].messages
    assert len(messages) == sum(
        1 for (_, features, pitch) in triplets
        if features.nframes != pitch.nframes)
    assert all('trim the longest one' in message for message in messages)


@pytest.mark.parametrize('shift', [-3, 3])
@pytest.mark.parametrize('tolerance', [2, 0])
def test_pitch_past_the_tolerance_raises_as_the_chain(tmp_path, shift,
                                                       tolerance):
    lengths = (40, 50, 60)
    manager, triplets = group(tmp_path, lengths, 1,
                              shifts=[0, shift if tolerance else 1, 0])
    log = logger('raise')
    with pytest.raises(ValueError) as expected:
        chained(manager, triplets, log, tolerance)
    with pytest.raises(ValueError) as raised:
        pipeline._pass_two(manager, triplets, log, tolerance)
    assert str(raised.value) == str(expected.value)
    assert 'frames' in str(raised.value)


def test_times_that_disagree_raise_as_the_chain(tmp_path):
    manager, triplets = group(tmp_path, (30, 40), 1)
    utterance, features, pitch = triplets[1]
    times = pitch.times.copy()
    times[5:] += 0.003
    triplets[1] = (utterance, features,
                   Features(pitch.data, times, pitch.properties))
    log = logger('times')
    with pytest.raises(ValueError, match='times are not equal'):
        chained(manager, triplets, log)
    with pytest.raises(ValueError, match='times are not equal'):
        pipeline._pass_two(manager, triplets, log)


@pytest.mark.parametrize('lengths', [(0,), (1,), (212,)])
def test_a_group_of_one(tmp_path, lengths):
    manager, triplets = group(tmp_path, lengths, 1)
    if not sum(lengths):
        # no frame to accumulate: the chain and pass 2 refuse the group
        with pytest.raises(ValueError, match='insufficient accumulation'):
            chained(manager, triplets, logger('one'))
        with pytest.raises(ValueError, match='insufficient accumulation'):
            pipeline._pass_two(manager, triplets, logger('one'))
        return
    log = logger('one')
    assert_same(pipeline._pass_two(manager, triplets, log),
                chained(manager, triplets, log))


@pytest.mark.parametrize('bound', [None, 20000])
def test_many_groups_in_one_call(tmp_path, monkeypatch, bound):
    """The stage-wise and per-utterance paths hand every group at once,
    the speakers interleaved; a small byte bound splits them into many
    runs, and changes no bit."""
    if bound is not None:
        monkeypatch.setattr(pipeline, 'PASS_TWO_BYTES', bound)
    manager, triplets = group(
        tmp_path, [int(n) for n in np.random.RandomState(3).randint(
            0, 400, 60)], 7, seed=5)
    log = logger('many')
    runs = list(pipeline._pass_two_runs(
        triplets, [f.nframes for _, f, _ in triplets], (2, 2)))
    assert len(runs) == 1 if bound is None else len(runs) > 5
    assert_same(pipeline._pass_two(manager, triplets, log),
                chained(manager, triplets, log))


def test_count_below_one_raises_as_the_chain(tmp_path):
    manager, triplets = group(tmp_path, (30, 40, 50), 2)
    manager.cmvn_stats['spk1'][0, -1] = 0.5
    log = logger('count')
    with pytest.raises(ValueError) as expected:
        chained(manager, triplets, log)
    with pytest.raises(ValueError) as raised:
        pipeline._pass_two(manager, triplets, log)
    assert str(raised.value) == str(expected.value)
    assert 'must be >= 1.0 but is 0.5' in str(raised.value)


def test_features_of_other_dimensions_raise_as_the_chain(tmp_path):
    manager, triplets = group(tmp_path, (30, 40), 1)
    utterance, features, pitch = triplets[1]
    triplets[1] = (utterance, Features(
        features.data[:, :12], features.times, features.properties), pitch)
    log = logger('dims')
    with pytest.raises(ValueError) as expected:
        chained(manager, triplets, log)
    with pytest.raises(ValueError) as raised:
        pipeline._pass_two(manager, triplets, log)
    assert str(raised.value) == str(expected.value)


def test_a_zero_variance_column_warns(tmp_path):
    manager, triplets = group(tmp_path, (30, 40, 50), 1)
    for index, (utterance, features, pitch) in enumerate(triplets):
        features.data[:, 4] = 2.5
    manager.cmvn_stats['spk0'][...] = 0
    for utterance, features, _ in triplets:
        manager.accumulate_cmvn(utterance, features)
    log = logger('zero')
    with pytest.warns(UserWarning, match=r'flooring zero cepstral variance '
                      r'to 1e-20 in dims \[4\]'):
        ours = pipeline._pass_two(manager, triplets, log)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        assert_same(ours, chained(manager, triplets, log))


def test_a_non_finite_cmvn_raises_as_the_chain(tmp_path):
    manager, triplets = group(tmp_path, (30, 40), 1)
    triplets[1][1].data[7, 3] = 3e38
    manager.cmvn_stats['spk0'][1, 3] = (
        manager.cmvn_stats['spk0'][0, 3] ** 2 / manager.cmvn_stats['spk0'][0, -1]
        + 1e-4 * manager.cmvn_stats['spk0'][0, -1])
    log = logger('nonfinite')
    with pytest.raises(ValueError) as expected:
        chained(manager, triplets, log)
    with pytest.raises(ValueError) as raised:
        pipeline._pass_two(manager, triplets, log)
    assert str(raised.value) == str(expected.value)
    assert 'non-finite' in str(raised.value)


@pytest.mark.parametrize('delta', [None, (2, 2)])
@pytest.mark.parametrize('pitch', [True, False])
def test_float64_features_keep_their_precision(tmp_path, delta, pitch):
    """Bottleneck features are float64: without deltas CMVN keeps
    float64, with them the deltas round to float32 as the chain does."""
    manager, triplets = group(tmp_path, LENGTHS, 2, delta=delta, pitch=pitch,
                              dtype=np.float64)
    log = logger('float64')
    ours = pipeline._pass_two(manager, triplets, log)
    assert_same(ours, chained(manager, triplets, log))
    assert all(f.dtype == np.float64 for f in ours.values())


def test_features_of_several_widths_without_cmvn(tmp_path):
    """Spectrograms at several sample rates differ in width: no CMVN,
    one run for each width."""
    manager, first = group(tmp_path, (20, 30), 1, cmvn=False, ndim=9)
    _, second = group(tmp_path, (25, 1), 1, cmvn=False, ndim=5, seed=1,
                      prefix='w')
    triplets = first + second
    log = logger('widths')
    runs = list(pipeline._pass_two_runs(
        triplets, [f.nframes for _, f, _ in triplets], (2, 2)))
    assert runs == [[0, 1], [2, 3]]
    assert_same(pipeline._pass_two(manager, triplets, log),
                chained(manager, triplets, log))


def test_each_utterance_owns_its_tiles():
    """A kernel block (a tile) owns at most TILE_ROWS frames of one
    utterance: an empty utterance owns none."""
    lengths = (0, 1, 64, 65, 129, 0)
    packed = pass_two.pack(
        [np.zeros((n, 13), np.float32) for n in lengths], None, lengths,
        [0] * len(lengths), None, (2, 2), device='cpu')
    tiles = [-(-n // pass_two.TILE_ROWS) for n in lengths]
    assert pass_two.TILE_ROWS == 64 and tiles == [0, 1, 1, 2, 3, 0]
    np.testing.assert_array_equal(packed.tensor('tile_off').numpy(),
                                  np.cumsum([0] + tiles))
    assert packed.tiles == sum(tiles)


def test_the_cpu_counts_no_launch(tmp_path):
    manager, triplets = group(tmp_path, (30, 40), 1)
    counters.reset()
    pipeline._pass_two(manager, triplets, logger('cpu'))
    snap = counters.snapshot()
    assert snap['pass2_kernel_utts'] == 0
    assert not [key for key in snap if key.startswith('launches.')]
    manager.device = 'meta'
    with pytest.raises(ValueError, match='no pass-2 kernel'):
        pipeline._pass_two(manager, triplets, logger('meta'))


def test_pass_two_needs_the_device_of_its_call(tmp_path):
    """A manager built without the call's device raises in pass 2
    rather than choosing one."""
    manager, triplets = group(tmp_path, (30, 40), 1, device=None)
    with pytest.raises(ValueError, match='device of its call'):
        pipeline._pass_two(manager, triplets, logger('none'))


# --------------------------------------------------------------- the card

def lognormal_lengths(hours, seed):
    """Frame counts of LibriSpeech test-clean's shape (the benchmark's
    corpus: log-normal durations, 1.3-35 s) adding up to about
    ``hours``."""
    rng = np.random.RandomState(seed)
    lengths = []
    while sum(lengths) < hours * 360000:
        seconds = min(max(np.exp(rng.normal(1.85, 0.55)), 1.3), 35.0)
        lengths.append(int(seconds * 100) - 2)
    return lengths


@pytest.mark.gpu
@pytest.mark.parametrize('case', [
    # a test_clean CMVN group: 65 utterances, about 48,000 frames
    dict(hours=0.134),
    # the half hour of the longest utterance's speaker
    dict(hours=0.5),
    dict(hours=0.02, cmvn=False, shifts=True),
    dict(hours=0.02, pitch=False, delta=(3, 3)),
    dict(hours=0.02, delta=None, dtype=np.float64),
    dict(hours=0.02, dtype=np.float64),
    # a window wider than a tile: the taps reach tiles away
    dict(hours=0.02, delta=(2, 300)),
])
def test_kernel_is_the_plain_version_on_the_card(tmp_path, case):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    case = dict(case)
    lengths = lognormal_lengths(case.pop('hours'), seed=19)
    if case.pop('shifts', False):
        case['shifts'] = [(-2, -1, 0, 1, 2)[i % 5] for i in range(len(lengths))]
    manager, triplets = group(tmp_path, lengths, 1, **case)
    log = logger('card')
    plain = pipeline._pass_two(manager, triplets, log)
    manager.device = 'cuda'
    counters.reset()
    for _ in range(2):  # repeated launches give the same bits
        ours = pipeline._pass_two(manager, triplets, log)
        assert_same(ours, plain)
    snap = counters.snapshot()
    assert snap['launches.pass_two'] == 2  # one launch a group
    assert snap['pass2_kernel_utts'] == 2 * len(triplets)
