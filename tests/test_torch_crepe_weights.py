"""CREPE weights from a path, the CREPE stage's counters, and the
pipeline with CREPE pitch against the benchmark's plain reference, on
the CPU.

- ``CrepePitchProcessor(weights=...)``: the file's model is the one
  used, a file of another capacity raises, two files in one process keep
  two models, a file rewritten in place is read again, None keeps the
  installed ``share/crepe/`` lookup;
  ``get_default_config`` does not emit the key;
- the counters and spans of ``process_all`` and of the stage-wise pass
  1's CREPE post-processing, and the first conv block taking each frame
  the CNN ran once;
- ``extract_features`` with ``crepe_pitch``'s configuration (at the
  'tiny' widths) and a seeded weights file, held by the ``crepe_pitch``
  harness against the float64 reference under the cell's own limits
  (``perfbench/checks/crepe_pitch.test_clean_2spk.json``), and a
  program with its weights rounded to bfloat16 past ``pov_err``'s
  limit; the harness's shapes and trace inputs;
- the CREPE readers (``crepe_mfu``, ``crepe_pad_pct``, the three
  ``*_s_per_h``) on synthetic traced windows, None where nothing was
  read.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from perfbench import check, corpus
from perfbench.harness import merge
from perfbench.harness.crepe_pitch import (
    build, channels, draw_weights, operations)
from perfbench.manifest import Manifest
from perfbench.tracing import TracedRun
from shennong_tpu_torch import Utterances, pipeline
from shennong_tpu_torch.audio import Audio
from shennong_tpu_torch.logger import null_logger
from shennong_tpu_torch.models import crepe
from shennong_tpu_torch.parallel.profiler import counters
from shennong_tpu_torch.processor.pitch_crepe import CrepePitchProcessor
from shennong_tpu_torch.weights import crepe_from_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = 'crepe_pitch.test_clean_2spk'
SEED = 2 ** 31 + 21
#: eight utterances of 1.3-2.5 s from two speakers
MIX = {'source': 'a test size', 'law': 'lognormal', 'utterances': 8,
       'speakers': 2, 'ln_mean': 0.5, 'ln_sd': 0.3, 'clip_s': [1.3, 2.5],
       'compared_speakers': 1}


def load_json(relative):
    with open(os.path.join(REPO, relative)) as handle:
        return json.load(handle)


def tiny_config():
    """The cell's pipeline configuration at the 'tiny' widths."""
    config = load_json('perfbench/configs/crepe_pitch.json')['pipeline']
    config['pitch']['model_capacity'] = 'tiny'
    return config


def write_weights(path, seed, capacity='tiny'):
    np.savez(path, **draw_weights(seed, channels(capacity), 'cpu'))
    return str(path)


@pytest.fixture(scope='module')
def audio():
    return Audio(corpus.speech_like(
        int(1.7 * 16000), 140.0, 3.0, torch.Generator().manual_seed(4),
        'cpu').numpy(), 16000)


def test_weights_from_a_path_are_used(tmp_path, audio):
    path = write_weights(tmp_path / 'a.npz', 1)
    proc = CrepePitchProcessor(model_capacity='tiny', weights=path)
    assert proc.weights == path
    assert proc.get_params()['weights'] == path
    model = crepe.load_model('tiny', 'cpu', path)
    with np.load(path) as data:
        direct = crepe_from_numpy(dict(data))
    frames = torch.as_tensor(proc._model_frames(audio.data))
    with torch.no_grad():
        assert torch.equal(model(frames), direct(frames))
    installed = CrepePitchProcessor(model_capacity='tiny').process(
        audio, device='cpu')
    ours = proc.process(audio, device='cpu')
    assert ours.shape == installed.shape
    assert not np.allclose(ours.data, installed.data)


def test_a_capacity_mismatch_raises(tmp_path, audio):
    path = write_weights(tmp_path / 'small.npz', 2, 'small')
    with pytest.raises(ValueError, match="capacity 'small', not 'tiny'"):
        CrepePitchProcessor(model_capacity='tiny', weights=path).process(
            audio, device='cpu')
    with pytest.raises(FileNotFoundError, match='not found'):
        CrepePitchProcessor(model_capacity='tiny',
                            weights=tmp_path / 'none.npz').process(
            audio, device='cpu')


def test_two_files_keep_two_models(tmp_path, audio):
    first = write_weights(tmp_path / 'one.npz', 3)
    second = write_weights(tmp_path / 'two.npz', 4)
    one = CrepePitchProcessor(model_capacity='tiny', weights=first)
    two = CrepePitchProcessor(model_capacity='tiny', weights=second)
    a, b = (proc.process(audio, device='cpu') for proc in (one, two))
    assert not np.allclose(a.data, b.data)
    again = one.process(audio, device='cpu')
    assert np.array_equal(a.data, again.data)
    assert crepe.load_model('tiny', 'cpu', first) is not crepe.load_model(
        'tiny', 'cpu', second)


def test_a_file_rewritten_in_place_is_read_again(tmp_path, audio):
    path = write_weights(tmp_path / 'w.npz', 6)
    proc = CrepePitchProcessor(model_capacity='tiny', weights=path)
    first = proc.process(audio, device='cpu')
    write_weights(path, 7)
    os.utime(path, ns=(1, 1))
    second = proc.process(audio, device='cpu')
    assert not np.allclose(first.data, second.data)


def test_none_keeps_the_installed_weights(audio):
    proc = CrepePitchProcessor(model_capacity='tiny')
    assert proc.weights is None
    assert crepe.load_model('tiny', 'cpu') is crepe.load_model(
        'tiny', 'cpu', os.path.join(crepe.SHARE_DIR, 'model-tiny.npz'))
    with pytest.raises(RuntimeError, match='convert-crepe'):
        CrepePitchProcessor(model_capacity='full').process(
            audio, device='cpu')
    config = pipeline.get_default_config('mfcc', with_pitch='crepe')
    assert 'weights' not in config['pitch']
    assert 'weights:' not in pipeline.get_default_config(
        'mfcc', with_pitch='crepe', to_yaml=True, yaml_commented=False)


def test_the_counters_of_process_all(tmp_path):
    entries, samples = corpus.write_corpus(MIX, SEED, str(tmp_path), 'cpu')
    proc = CrepePitchProcessor(
        model_capacity='tiny', weights=write_weights(tmp_path / 'w.npz', 5))
    counters.reset()
    raw = proc.process_all(Utterances(entries), device='cpu')
    counts = counters.snapshot()
    assert set(raw) == set(samples)
    frames = sum(crepe.frame_count(n + 1024, 160) for n in samples.values())
    assert counts['crepe_frames'] == frames
    assert counts['crepe_cnn_frames'] == frames
    # the CPU runs the plain chain: no frame went through the conv kernel
    assert 'crepe_conv_kernel_frames' not in counts
    assert counts['crepe_slices'] >= 1
    for key in ('crepe_load_s', 'crepe_cnn_s', 'crepe_decode_s'):
        assert counts[key] > 0, key
    assert 'crepe_post_s' not in counts

    counters.reset()
    config = merge(tiny_config(), {'pitch': {'weights': proc.weights}})
    pipeline.extract_features(config, Utterances(entries), device='cpu',
                              log=null_logger())
    counts = counters.snapshot()
    assert counts['crepe_frames'] == frames
    assert counts['crepe_post_s'] > 0


@pytest.fixture(scope='module')
def cell_run(tmp_path_factory):
    """The harness, its corpus and the program's outputs of one call at
    the 'tiny' widths."""
    workdir = str(tmp_path_factory.mktemp('crepe_cell'))
    entries, samples = corpus.write_corpus(MIX, SEED, workdir, 'cpu')
    harness = build(tiny_config(), 16000)
    config = merge(harness.config, harness.prepare(SEED, workdir, 'cpu'))

    def outputs(weights=None):
        run = copy.deepcopy(config)
        if weights:
            run['pitch']['weights'] = weights
        collection = pipeline.extract_features(
            run, Utterances(entries), device='cpu', log=null_logger(),
            generator=torch.Generator().manual_seed(SEED + 7))
        return {name: collection[name].data for name in collection}

    return harness, entries, samples, outputs, workdir


@pytest.mark.parametrize('decode', ['host', 'device'])
def test_the_first_conv_block_takes_every_frame_the_cnn_ran(
        tmp_path, monkeypatch, decode):
    """On the card ``crepe_conv_kernel_frames`` is counted where the
    first conv block launches, and ``crepe_conv_kernel_pct`` holds it to
    ``crepe_cnn_frames``: over ``process_all`` the first block takes each
    frame the CNN ran once. The CPU's plain chain stands in for the
    kernel, the frames counted as the kernel's launch counts them."""
    taken = []
    plain = crepe.conv_block

    def counted(x, block):
        if block.conv.stride[0] == 4:
            taken.append(x.shape[0])
        return plain(x, block)

    monkeypatch.setattr(crepe, 'conv_block', counted)
    entries, _ = corpus.write_corpus(MIX, SEED, str(tmp_path), 'cpu')
    proc = CrepePitchProcessor(
        model_capacity='tiny', decode=decode,
        weights=write_weights(tmp_path / 'w.npz', 5))
    counters.reset()
    proc.process_all(Utterances(entries), device='cpu')
    assert taken and sum(taken) == counters.snapshot()['crepe_cnn_frames']



def test_the_pipeline_holds_the_cells_limits(cell_run):
    harness, entries, samples, outputs, _ = cell_run
    result = outputs()
    for name, count in samples.items():
        assert result[name].shape == harness.expected_shape(count)
    compared = check.compared_names(samples, entries, MIX, SEED)
    numbers, details = harness.compare(
        entries, compared, [{n: result[n] for n in compared}], 'cpu', SEED)
    limits = load_json(f'perfbench/checks/{CELL}.json')['limits']
    assert set(numbers) == set(limits)
    for name, value in numbers.items():
        assert value <= limits[name], (name, value, limits[name])
    assert details['saturated'] == 0
    assert details['logit_max'] < 15


def test_weights_in_bfloat16_fail_pov_err(cell_run):
    """The program's weights rounded to bfloat16 (8 bits of mantissa, a
    coarser rounding than TF32's 10): ``pov_err`` passes its limit."""
    harness, entries, samples, outputs, workdir = cell_run
    with np.load(harness.weights) as data:
        coarse = {key: torch.as_tensor(value).bfloat16().float().numpy()
                  for key, value in data.items()}
    path = os.path.join(workdir, 'coarse.npz')
    np.savez(path, **coarse)
    result = outputs(path)
    compared = check.compared_names(samples, entries, MIX, SEED)
    numbers, _ = harness.compare(
        entries, compared, [{n: result[n] for n in compared}], 'cpu', SEED)
    limit = load_json(f'perfbench/checks/{CELL}.json')['limits']['pov_err']
    assert numbers['pov_err'] > limit


def test_trace_inputs_count_the_model_frames(cell_run):
    harness, _, samples, _, _ = cell_run
    counts = list(samples.values())
    work = harness.trace_inputs(counts)['work']
    assert work['crepe_frames'] == [1 + n // 160 for n in counts]
    assert work['crepe_ops_per_frame'] == operations(channels('tiny'))
    full = build(load_json('perfbench/configs/crepe_pitch.json')['pipeline'],
                 16000)
    assert full.trace_inputs([16000])['work'] == {
        'crepe_frames': [101], 'crepe_ops_per_frame': 2_820_046_848}


def window(counters_=None, work=None, device=None):
    return TracedRun(
        audio_s=1800.0, calls=[(0.0, 10e6), (10e6, 20e6)],
        counters=counters_ or {}, spans=[], device=device or [],
        span_totals={}, work=work or {})


def read(name, run):
    return Manifest().reader(name)(run)


def test_crepe_mfu():
    work = {'crepe_frames': [1000, 3000], 'crepe_ops_per_frame': 2_820_046_848}
    kernels = [('cudnn_conv', 0.0, 0.3e6), ('cudnn_conv', 0.2e6, 0.5e6),
               ('Memcpy HtoD (Pinned -> Device)', 0.6e6, 0.9e6)]
    # 4000 frames' operations over 0.5 s of kernels (the copy left out)
    expected = 100.0 * 4000 * 2_820_046_848 / (0.5 * 67e12)
    assert read('crepe_mfu', window(work=work, device=kernels)) == (
        pytest.approx(expected))
    assert read('crepe_mfu', window(device=kernels)) is None
    assert read('crepe_mfu', window(work=work)) is None


def test_crepe_pad_pct():
    run = window({'crepe_frames': 750.0, 'crepe_cnn_frames': 1000.0})
    assert read('crepe_pad_pct', run) == pytest.approx(25.0)
    assert read('crepe_pad_pct', window({'crepe_frames': 10.0})) is None
    assert read('crepe_pad_pct', window({'crepe_cnn_frames': 9.0})) is None


@pytest.mark.parametrize('stage', ['load', 'decode', 'post'])
def test_crepe_stage_seconds_per_hour(stage):
    key = f'crepe_{stage}_s'
    assert read(f'{key}_per_h', window({key: 3.0})) == pytest.approx(6.0)
    assert read(f'{key}_per_h', window({'calls': 2.0})) is None


def test_the_cell_and_its_metrics_are_in_the_manifest():
    manifest = Manifest()
    cell = manifest.cell(CELL)
    assert cell.chips == 1 and cell.config_name == 'crepe_pitch'
    names = {m['name'] for m in cell.per_layer}
    assert {'crepe_mfu', 'crepe_pad_pct', 'crepe_load_s_per_h',
            'crepe_decode_s_per_h', 'crepe_post_s_per_h'} <= names
    config = manifest.config('crepe_pitch')
    assert config['reduced'] == []
    assert cell.config['pipeline']['pitch']['model_capacity'] == 'full'
    assert 'weights' not in cell.config['pipeline']['pitch']
