"""Multi-process extraction and training of the port, on the CPU.

Counterpart of ``tests/test_distributed_process.py`` and the
distributed cases of ``tests/test_multidevice.py``. Real OS processes
join a ``gloo`` group through a ``file://`` store (no port to race for
under xdist) and run :mod:`shennong_tpu_torch.parallel.distributed`;
this file is also their worker (``python test_torch_distributed.py
MODE RANK WORLD STORE WORKDIR``), so no helper module is added. A test
waits 240 s for its workers, and a group's rendezvous and collectives
wait as long for a peer (a process starved of CPU on a loaded machine
must not fail its group before the test gives up on it). A worker
prints the clock when it joins, has joined and is done, and a failure
reports every worker's output: it shows which wait gave way.

- Two processes, six short runs, each a module fixture that only its
  own tests read (:data:`TWO_PROCESS_RUNS`): extraction of MFCC + Kaldi
  pitch + CMVN by speaker + deltas, with speakers that span both
  shards; ``train_ubm`` and one ``estimate_vtln`` round;
  ``train_vtln``, then ``extract_features`` with a ``vtln`` section;
  ``train_ubm`` on a corpus whose name order is the reverse of its
  length order, without and with component removal; the step makers on
  random frames split between the processes; the generator that every
  process seeds alike. The models
  of both processes are equal byte for byte; each result equals the single-process run of the port
  (features 1e-5, pitch included; the float64 UBM 1e-9, where its
  statistics are summed in another order; warps equal; transforms
  1e-6 in their action on the training frames) and of the JAX package
  (features 1e-3; the UBM within the tolerances of the JAX package's
  own distributed test).
- Four processes on 5 utterances (uneven shards) equal the
  single-process run; four on 3 utterances raise the same
  ``ValueError`` on every process; a ``train_ubm`` whose second
  process holds only unvoiced utterances equals the single-process
  model; a process that exits before the first collective makes its
  peer exit non-zero within 60 s, long before the group timeout; a
  run that outlasts the test's wait is killed and reported.
- The step makers in a world of one equal the single-process functions
  bit for bit.

Every random source is at 0 (the dithers, the pitch noise, the energy
VAD's dither).
"""

import copy
import datetime
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.io.wavfile
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
REAL_WAV = os.path.join(HERE, 'data', 'test.wav')
WORKER_TIMEOUT = 240    # seconds, a test's wait on its workers
#: seconds, the process group's (its rendezvous too): no shorter than a
#: test's wait, so that the test, not a collective, gives up first
GROUP_TIMEOUT = WORKER_TIMEOUT
DEAD_PEER_SECONDS = 60  # a dead peer fails the survivor within this
FEATURES_TOL = 1e-5     # multi-process against the port's single process
JAX_TOL = 1e-3          # against the JAX package's single process
MODEL_TOL = 1e-9        # a UBM against the port's single process (float64)

#: the UBM of the training tests (the JAX package's distributed test)
UBM_PARAMS = dict(num_gauss=4, num_iters=2, num_iters_init=3,
                  num_frames=120, seed=0, vad={'energy_threshold': 5.0})
#: its changes for component removal (the host updates of the
#: multi-process statistics): the floor removes one of the 4 components
REMOVAL = dict(min_gaussian_weight=0.18, remove_low_count_gaussians=True)


# ---------------------------------------------------------------- corpora

def corpus_entries(kind, workdir):
    """The utterance entries of a corpus (WAVs written under
    ``workdir`` when needed)."""
    if kind == 'spanning':
        # round-robin on the sorted names sends u0, u2 to process 0 and
        # u1, u3 to process 1: both speakers span both processes
        return [('u0', REAL_WAV, 'spk0', 0.0, 0.5),
                ('u1', REAL_WAV, 'spk0', 0.3, 0.9),
                ('u2', REAL_WAV, 'spk1', 0.1, 0.7),
                ('u3', REAL_WAV, 'spk1', 0.4, 1.0)]
    if kind == 'reversed':
        # names sort opposite to lengths: the streaming order is not
        # the collection order
        return [(f'u{i}', REAL_WAV, f'spk{i % 2}', 0.02 * i, 1.32 - 0.1 * i)
                for i in range(6)]
    if kind == 'uneven':
        return [(f'u{i}', REAL_WAV, f'spk{i % 2}', 0.05 * i, 0.6 + 0.08 * i)
                for i in range(5)]
    if kind == 'few':
        return corpus_entries('uneven', workdir)[:3]
    if kind == 'unvoiced':
        # the files sort a0 < a1 < a2 < a3: process 1 owns a1 and a3,
        # low noise that the energy VAD rejects
        rate, speech = scipy.io.wavfile.read(REAL_WAV)
        rng = np.random.RandomState(0)
        entries = []
        for index in range(4):
            path = os.path.join(workdir, f'a{index}.wav')
            if index % 2:
                signal = np.round(rng.randn(12000) * 3).astype(np.int16)
            else:
                signal = speech[4000 * index:4000 * index + 16000]
            scipy.io.wavfile.write(path, rate, signal)
            entries.append((f'a{index}', path, f'spk{index // 2}'))
        return entries
    raise ValueError(kind)


def utterances(kind, workdir, package='torch'):
    if package == 'torch':
        from shennong_tpu_torch.utterances import Utterances
    else:
        from shennong_tpu.utterances import Utterances
    return Utterances(corpus_entries(kind, workdir))


# --------------------------------------------------------- configurations

def no_energy_dither():
    """The energy VAD's default dither of 1.0 set to 0 (the pipeline
    configuration has no knob for it)."""
    from shennong_tpu_torch.processor import energy

    defaults = list(energy.EnergyProcessor.__init__.__defaults__)
    defaults[3] = 0.0  # sample_rate, frame_shift, frame_length, dither
    energy.EnergyProcessor.__init__.__defaults__ = tuple(defaults)


def main_config():
    """The main path: MFCC + Kaldi pitch + CMVN by speaker + deltas."""
    from shennong_tpu_torch import pipeline

    config = pipeline.get_default_config(
        'mfcc', with_pitch='kaldi', with_cmvn=True, with_delta=True)
    config['mfcc']['dither'] = 0
    config['pitch']['postprocessing']['delta_pitch_noise_stddev'] = 0
    return config


def vtln_config(**ubm_changes):
    """MFCC + CMVN + deltas with a tiny ``vtln`` section."""
    from shennong_tpu_torch import pipeline

    config = pipeline.get_default_config(
        'mfcc', with_cmvn=True, with_delta=True, with_vtln='full')
    config['mfcc']['dither'] = 0
    config['vtln'].update(num_iters=1, subsample=2)
    config['vtln']['ubm'].update(
        num_gauss=4, num_iters=1, num_iters_init=2, num_frames=1000,
        **ubm_changes)
    config['vtln']['features']['mfcc']['dither'] = 0
    config['vtln']['ubm']['features']['mfcc']['dither'] = 0
    return config


def make_ubm(**changes):
    from shennong_tpu_torch.processor.ubm import DiagUbmProcessor

    ubm = DiagUbmProcessor(**dict(UBM_PARAMS, **changes))
    ubm.features['mfcc']['dither'] = 0
    return ubm


def make_vtln():
    from shennong_tpu_torch.processor.vtln import VtlnProcessor

    ubm_params = make_ubm(remove_low_count_gaussians=False).get_params()
    vtln = VtlnProcessor(num_iters=2, min_warp=0.9, max_warp=1.1,
                         warp_step=0.05, subsample=2, ubm=ubm_params)
    vtln.features['mfcc']['dither'] = 0
    return vtln


def make_lvtln(dim):
    """Warp-class base transforms shared by the estimate_vtln worker and
    its single-process reference."""
    from shennong_tpu_torch.ops.fmllr import LinearVtln

    num_classes, default_class = 9, 4
    lvtln = LinearVtln(dim, num_classes, default_class)
    rng = np.random.RandomState(123)
    for c in range(num_classes):
        lvtln.set_transform(c, np.eye(dim) * (1.0 + 0.02 * (c - default_class))
                            + 0.01 * rng.randn(dim, dim))
        lvtln.set_warp(c, 0.9 + 0.025 * c)
    return lvtln


def random_frames(seed=1, n=512, dim=6, num_gauss=4):
    """Frames, 0/1 weights and a float64 model for the step makers."""
    rng = np.random.RandomState(seed)
    frames = torch.as_tensor(rng.randn(n, dim) * 3)
    fweights = torch.as_tensor((rng.rand(n) > 0.2).astype(np.float64))
    model = (torch.full((num_gauss,), 1.0 / num_gauss, dtype=torch.float64),
             torch.as_tensor(rng.randn(num_gauss, dim)),
             torch.full((num_gauss, dim), 0.5, dtype=torch.float64))
    return frames, fweights, model


def features_arrays(collection, prefix):
    out = {}
    for name in collection:
        out[f'{prefix}/{name}'] = collection[name].data
        if 'mfcc' in collection[name].properties and 'vtln_warp' in \
                collection[name].properties['mfcc']:
            out[f'{prefix}.warp/{name}'] = np.float64(
                collection[name].properties['mfcc']['vtln_warp'])
    return out


def gmm_arrays(gmm, prefix):
    return {f'{prefix}.{field}': getattr(gmm, field)
            for field in ('weights', 'means', 'inv_vars')}


# ----------------------------------------------------------------- worker

def run_extraction(workdir, rank, world):
    """The main path over the corpus whose speakers span both
    processes."""
    from shennong_tpu_torch.parallel import distributed

    return features_arrays(distributed.extract_features(
        main_config(), utterances('spanning', workdir), device='cpu'),
        'extract')


def run_ubm_round(workdir, rank, world):
    """``train_ubm``, then one ``estimate_vtln`` round with its model."""
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.parallel import distributed
    from shennong_tpu_torch.processor.vtln import VtlnProcessor

    spanning = utterances('spanning', workdir)
    ubm = make_ubm()
    distributed.train_ubm(ubm, spanning, device='cpu')
    out = gmm_arrays(ubm.gmm, 'ubm')
    shard = distributed.shard_utterances(list(spanning))
    feats = pipeline.extract_features(
        {'mfcc': {'dither': 0}, 'delta': {}}, shard, device='cpu')
    ubm.gaussian_selection(feats, device='cpu')
    posteriors = ubm.gaussian_selection_to_post(feats, device='cpu')
    vtln = VtlnProcessor(ubm=ubm.get_params())
    vtln.lvtln = make_lvtln(ubm.gmm.dim())
    transforms, warps = distributed.estimate_vtln(
        vtln, ubm, feats, posteriors,
        {utt.name: utt.speaker for utt in spanning}, device='cpu')
    for group in transforms:
        out[f'round.transform/{group}'] = transforms[group]
        out[f'round.warp/{group}'] = np.float64(warps[group])
    return out


def run_train_vtln(workdir, rank, world):
    """``train_vtln``, then ``extract_features`` with a ``vtln``
    section that trains across the processes ('wired') and one that
    every process trains on the whole collection ('repeated')."""
    from shennong_tpu_torch.parallel import distributed

    spanning = utterances('spanning', workdir)
    vtln = make_vtln()
    warps = distributed.train_vtln(vtln, spanning, group_by='speaker',
                                   device='cpu')
    out = {}
    for speaker, warp in warps.items():
        out[f'vtln.warp/{speaker}'] = np.float64(warp)
    for utt, transform in vtln.transforms.items():
        out[f'vtln.transform/{utt}'] = transform
    out.update(features_arrays(distributed.extract_features(
        vtln_config(), spanning, device='cpu'), 'wired'))
    out.update(features_arrays(distributed.extract_features(
        vtln_config(**REMOVAL), spanning, device='cpu'), 'repeated'))
    return out


def run_reversed(workdir, rank, world):
    """``train_ubm`` on the corpus whose name order reverses its length
    order, without and with component removal."""
    from shennong_tpu_torch.parallel import distributed

    ubm = make_ubm(num_iters_init=2, remove_low_count_gaussians=False)
    distributed.train_ubm(ubm, utterances('reversed', workdir), device='cpu')
    out = gmm_arrays(ubm.gmm, 'reversed')
    ubm = make_ubm(**REMOVAL)
    distributed.train_ubm(ubm, utterances('reversed', workdir), device='cpu')
    out.update(gmm_arrays(ubm.gmm, 'removal'))
    return out


def run_em_steps(workdir, rank, world):
    """The EM step maker on random frames split between the
    processes."""
    from shennong_tpu_torch.parallel.fused import make_em_train_steps

    frames, fweights, model = random_frames()
    _, *params = make_em_train_steps(None, 3)(
        frames[rank::world], fweights[rank::world], *model)
    return {f'steps.{i}': p.numpy() for i, p in enumerate(params)}


def run_shared(workdir, rank, world):
    """Draws of the generator that every process seeds alike from
    process 0's (each process's own generator seeded by its rank)."""
    from shennong_tpu_torch.parallel import distributed

    shared = distributed._shared_generator(
        torch.Generator().manual_seed(rank), 'cpu')
    return {'shared': torch.rand(4, generator=shared).numpy()}


#: the two-process runs, by worker mode: each is one module fixture, read
#: by its own tests only
TWO_PROCESS_RUNS = {
    'extraction': run_extraction,
    'ubm_round': run_ubm_round,
    'train_vtln': run_train_vtln,
    'reversed': run_reversed,
    'em_steps': run_em_steps,
    'shared': run_shared,
}


def run_cuda(workdir):
    """The main path and the VTLN training on the card, for
    ``tests/test_torch_gpu.py``."""
    from chip_smoke import VITERBI, launch_counts, reset_counters
    from shennong_tpu_torch.parallel import distributed

    spanning = utterances('spanning', workdir)
    reset_counters()
    out = features_arrays(distributed.extract_features(
        main_config(), spanning, device='cuda'), 'extract')
    out.update({f'launches.{name}': np.int64(count)
                for name, count in launch_counts(*VITERBI).items()})
    vtln = make_vtln()
    warps = distributed.train_vtln(vtln, spanning, group_by='speaker',
                                   device='cuda')
    for speaker, warp in warps.items():
        out[f'vtln.warp/{speaker}'] = np.float64(warp)
    for utt, transform in vtln.transforms.items():
        out[f'vtln.transform/{utt}'] = transform
    return out


def run_extract(workdir, kind):
    from shennong_tpu_torch.parallel import distributed

    return features_arrays(distributed.extract_features(
        main_config(), utterances(kind, workdir), device='cpu'), 'extract')


def run_unvoiced(workdir):
    from shennong_tpu_torch.parallel import distributed

    ubm = make_ubm(remove_low_count_gaussians=False)
    corpus = utterances('unvoiced', workdir)
    shard = distributed.shard_utterances(list(corpus))
    distributed.train_ubm(ubm, corpus, device='cpu')
    return dict(gmm_arrays(ubm.gmm, 'ubm'),
                shard=np.array([utt.name for utt in shard]))


def worker(mode, rank, world, store, workdir):
    from shennong_tpu_torch.parallel import distributed

    def say(event):
        # the clock of the test's report: which wait gave way
        print(f'{time.strftime("%H:%M:%S")} rank {rank} of {mode}: {event}',
              flush=True)

    torch.set_num_threads(1)
    no_energy_dither()
    say('joining the group')
    if mode == 'stall':
        time.sleep(3600)  # until the test's wait kills it
    distributed.initialize(f'file://{store}', world, rank, backend='gloo',
                           timeout=GROUP_TIMEOUT)
    say('joined')
    if mode == 'dead' and rank == 1:
        os._exit(3)  # before any collective, and with no clean-up
    if mode in TWO_PROCESS_RUNS:
        out = TWO_PROCESS_RUNS[mode](workdir, rank, world)
    elif mode == 'unvoiced':
        out = run_unvoiced(workdir)
    elif mode == 'cuda':
        out = run_cuda(workdir)
    elif mode == 'dead':
        out = run_extract(workdir, 'spanning')
    else:
        out = run_extract(workdir, mode)
    np.savez(os.path.join(workdir, f'{mode}-{rank}.npz'), **out)
    say('done')


# ------------------------------------------------------------ test helpers

def launch(mode, world, workdir):
    """Run ``world`` worker processes of ``mode`` (spawned, never
    forked); returns their (exit code, output) and the seconds until the
    last one exited. Workers still running after ``WORKER_TIMEOUT`` are
    killed, and the test fails with every worker's output."""
    store = os.path.join(workdir, f'{mode}.store')
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [REPO] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep) if p])
    # output to files: a pipe left unread while another process is
    # waited for could fill and block its writer inside a collective
    logs = [open(os.path.join(workdir, f'{mode}-{rank}.log'), 'w+')
            for rank in range(world)]
    started = time.strftime('%H:%M:%S')
    start = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(rank),
         str(world), store, workdir],
        env=env, stdout=log, stderr=subprocess.STDOUT)
        for rank, log in enumerate(logs)]
    timed_out = False
    try:
        for proc in procs:
            proc.wait(timeout=max(
                start + WORKER_TIMEOUT - time.perf_counter(), 1))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        seconds = time.perf_counter() - start
        for proc in procs:
            proc.kill()
            proc.wait()
        results = []
        for proc, log in zip(procs, logs):
            log.seek(0)
            results.append((proc.returncode, log.read()))
            log.close()
    if timed_out:
        pytest.fail(report(
            f'the test stopped waiting for its workers ({WORKER_TIMEOUT} s)',
            mode, started, seconds, results))
    return results, seconds


def report(what, mode, started, seconds, results):
    """A failure's message: what gave way, when, and every worker's
    output."""
    return '\n'.join(
        [f'{mode}: {what}; started {started}, {seconds:.1f} s']
        + [f'--- rank {rank}, exit code {rc}:\n{log}'
           for rank, (rc, log) in enumerate(results)])


def outputs(mode, world, workdir):
    started = time.strftime('%H:%M:%S')
    results, seconds = launch(mode, world, workdir)
    assert all(rc == 0 for rc, _ in results), report(
        'a worker failed', mode, started, seconds, results)
    return [dict(np.load(os.path.join(workdir, f'{mode}-{rank}.npz')))
            for rank in range(world)]


def merged(results, prefix):
    """The arrays of ``prefix`` of every process, by name."""
    out = {}
    for result in results:
        for key, value in result.items():
            if key.startswith(prefix + '/'):
                out[key[len(prefix) + 1:]] = value
    return out


def single_extract(config, kind, workdir):
    from shennong_tpu_torch import pipeline

    return pipeline.extract_features(
        copy.deepcopy(config), utterances(kind, workdir), device='cpu')


def assert_same_bits(results, prefixes):
    """Every array whose key starts with one of ``prefixes`` is the same
    bytes on every process that holds it."""
    first = results[0]
    for result in results[1:]:
        for key in first:
            if key.startswith(prefixes):
                assert first[key].tobytes() == result[key].tobytes(), key


def close(ours, ref, tol):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    gap = np.abs(ours.astype(np.float64) - ref).max()
    assert gap < tol, gap


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp('distributed'))


def two_process_run(mode):
    """A module fixture: the two-process run of worker ``mode``
    (:data:`TWO_PROCESS_RUNS`), its per-process outputs."""
    @pytest.fixture(scope='module')
    def run(workdir):
        return outputs(mode, 2, workdir)
    return run


extraction = two_process_run('extraction')
ubm_round = two_process_run('ubm_round')
train_vtln = two_process_run('train_vtln')
reversed_ubm = two_process_run('reversed')
em_steps = two_process_run('em_steps')
shared = two_process_run('shared')


@pytest.fixture
def quiet_energy(monkeypatch):
    from shennong_tpu.processor import energy as jenergy
    from shennong_tpu_torch.processor import energy

    for cls in (jenergy.EnergyProcessor, energy.EnergyProcessor):
        defaults = list(cls.__init__.__defaults__)
        defaults[3] = 0.0
        monkeypatch.setattr(cls.__init__, '__defaults__', tuple(defaults))


# ------------------------------------------------------------- two processes

def test_two_process_extraction(extraction, workdir, quiet_energy):
    from shennong_tpu import pipeline as jpipeline

    got = merged(extraction, 'extract')
    assert sorted(got) == ['u0', 'u1', 'u2', 'u3']
    assert sorted(merged(extraction[:1], 'extract')) == ['u0', 'u2']
    single = single_extract(main_config(), 'spanning', workdir)
    ref = jpipeline.extract_features(
        main_config(), utterances('spanning', workdir, 'jax'))
    for name in single:
        assert got[name].shape[1] == 42
        close(got[name], single[name].data, FEATURES_TOL)
        close(got[name], ref[name].data, JAX_TOL)


def test_two_process_ubm_and_round(ubm_round, workdir, quiet_energy):
    from shennong_tpu import pipeline as jpipeline
    from shennong_tpu.processor.ubm import DiagUbmProcessor as JUbm
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.processor.ubm import DiagGmm
    from shennong_tpu_torch.processor.vtln import VtlnProcessor

    assert_same_bits(ubm_round, ('ubm.', 'round.'))
    dist = ubm_round[0]
    corpus = utterances('spanning', workdir)
    single = make_ubm()
    single.process(corpus, device='cpu')
    ref = JUbm(**UBM_PARAMS)
    ref.features['mfcc']['dither'] = 0
    ref.process(utterances('spanning', workdir, 'jax'))
    for field in ('weights', 'means', 'inv_vars'):
        # the port's float64 statistics, summed in another order
        np.testing.assert_allclose(
            dist[f'ubm.{field}'], getattr(single.gmm, field), rtol=MODEL_TOL,
            atol=MODEL_TOL)
    np.testing.assert_allclose(dist['ubm.weights'], ref.gmm.weights,
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(dist['ubm.means'], ref.gmm.means,
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(dist['ubm.inv_vars'], ref.gmm.inv_vars,
                               rtol=2e-3, atol=2e-3)
    assert jpipeline  # the JAX package's model comes from its own front-end

    # the round, single-process, with the distributed model: only the
    # accumulation differs
    single.gmm = DiagGmm(dist['ubm.weights'], dist['ubm.means'],
                         dist['ubm.inv_vars'])
    single.selection = None
    feats = pipeline.extract_features(
        {'mfcc': {'dither': 0}, 'delta': {}}, corpus, device='cpu')
    single.gaussian_selection(feats, device='cpu')
    posteriors = single.gaussian_selection_to_post(feats, device='cpu')
    vtln = VtlnProcessor(ubm=single.get_params())
    vtln.lvtln = make_lvtln(single.gmm.dim())
    transforms, warps = vtln.estimate(
        single, feats, posteriors, {utt.name: utt.speaker for utt in corpus},
        device='cpu')
    assert sorted(merged(ubm_round[:1], 'round.warp')) == sorted(warps)
    for group in warps:
        assert dist[f'round.warp/{group}'] == warps[group]
        np.testing.assert_allclose(dist[f'round.transform/{group}'],
                                   transforms[group], rtol=1e-9, atol=1e-9)


def training_frames(corpus, vtln):
    """The LVTLN training frames of the single-process run (voiced,
    subsampled, with sliding CMVN), float64 [N, D]."""
    from shennong_tpu_torch.processor import ubm as ubm_module

    flat, _, w_em, _, _ = ubm_module.stream_frontend(
        vtln.features, make_ubm().vad, vtln.subsample, corpus, device='cpu')
    return flat[w_em > 0].to(torch.float64).numpy()


def test_two_process_train_vtln(train_vtln, workdir):
    sys.path.insert(0, REPO)
    from chip_smoke import action_gap

    assert_same_bits(train_vtln, ('vtln.',))
    corpus = utterances('spanning', workdir)
    plain = make_vtln()
    warps = plain.process(corpus, group_by='speaker', device='cpu')
    assert merged(train_vtln[:1], 'vtln.warp') == warps
    frames = training_frames(corpus, plain)
    for utt, transform in merged(train_vtln[:1], 'vtln.transform').items():
        assert action_gap(transform, plain.transforms[utt], frames) < 1e-6


@pytest.mark.parametrize('prefix,changes', [
    ('wired', {}),
    # component removal: every process trains on the whole collection
    ('repeated', REMOVAL)])
def test_two_process_extraction_with_vtln(train_vtln, workdir, prefix,
                                          changes):
    got = merged(train_vtln, prefix)
    warps = merged(train_vtln, f'{prefix}.warp')
    single = single_extract(vtln_config(**changes), 'spanning', workdir)
    assert sorted(got) == sorted(single.keys())
    for name in single:
        assert warps[name] == single[name].properties['mfcc']['vtln_warp']
        close(got[name], single[name].data, FEATURES_TOL)


def test_repeated_training_draws_alike(shared):
    """The generator of the training every process repeats is seeded
    alike from process 0's (the processes' own generators differ)."""
    assert_same_bits(shared, ('shared',))


def test_two_process_reversed_length_order(reversed_ubm, workdir):
    from shennong_tpu_torch.parallel.stream import streamed_order

    corpus = utterances('reversed', workdir)
    assert streamed_order(corpus) == [5, 4, 3, 2, 1, 0]
    assert_same_bits(reversed_ubm, ('reversed.',))
    single = make_ubm(num_iters_init=2, remove_low_count_gaussians=False)
    single.process(corpus, device='cpu')
    for field in ('weights', 'means', 'inv_vars'):
        np.testing.assert_allclose(
            reversed_ubm[0][f'reversed.{field}'], getattr(single.gmm, field),
            rtol=MODEL_TOL, atol=MODEL_TOL)


def test_two_process_ubm_with_removal(reversed_ubm, workdir):
    assert_same_bits(reversed_ubm, ('removal.',))
    single = make_ubm(**REMOVAL)
    single.process(utterances('reversed', workdir), device='cpu')
    assert (reversed_ubm[0]['removal.weights'].shape
            == single.gmm.weights.shape == (3,))
    for field in ('weights', 'means', 'inv_vars'):
        np.testing.assert_allclose(
            reversed_ubm[0][f'removal.{field}'], getattr(single.gmm, field),
            rtol=MODEL_TOL, atol=MODEL_TOL)


def test_two_process_em_steps(em_steps):
    from shennong_tpu_torch.ops import gmm as gmm_ops

    assert_same_bits(em_steps, ('steps.',))
    frames, fweights, model = random_frames()
    _, *params = gmm_ops.em_steps(frames, fweights, *model, num_iters=3)
    for i, param in enumerate(params):
        np.testing.assert_allclose(em_steps[0][f'steps.{i}'], param.numpy(),
                                   rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------ four processes

def test_four_processes_uneven_shards(workdir, quiet_energy):
    results = outputs('uneven', 4, workdir)
    got = merged(results, 'extract')
    assert [len(merged([r], 'extract')) for r in results] == [2, 1, 1, 1]
    single = single_extract(main_config(), 'uneven', workdir)
    assert sorted(got) == sorted(single.keys())
    for name in single:
        close(got[name], single[name].data, FEATURES_TOL)


def test_four_processes_three_utterances_raise(workdir):
    results, seconds = launch('few', 4, workdir)
    for rc, log in results:
        assert rc != 0
        assert ('ValueError: only 3 utterances for 4 processes: run with at '
                'most 3 processes') in log, log
    assert seconds < WORKER_TIMEOUT


def test_unvoiced_shard_joins_the_collectives(workdir):
    from shennong_tpu_torch.processor import ubm as ubm_module

    results = outputs('unvoiced', 2, workdir)
    assert list(results[1]['shard']) == ['a1', 'a3']
    ubm = make_ubm()
    voiced = ubm_module.stream_frontend(
        ubm.features, ubm.vad, ubm.subsample,
        list(utterances('unvoiced', workdir))[1::2], device='cpu')[3]
    assert voiced == 0
    assert_same_bits(results, ('ubm.',))
    single = make_ubm(remove_low_count_gaussians=False)
    single.process(utterances('unvoiced', workdir), device='cpu')
    for field in ('weights', 'means', 'inv_vars'):
        np.testing.assert_allclose(
            results[0][f'ubm.{field}'], getattr(single.gmm, field),
            rtol=MODEL_TOL, atol=MODEL_TOL)


def test_dead_process_fails_its_peer(workdir):
    results, seconds = launch('dead', 2, workdir)
    (rc0, log0), (rc1, _) = results
    assert rc1 == 3
    assert rc0 not in (0, None), log0
    assert 'RuntimeError' in log0 and 'all_gather' in log0, log0
    assert seconds < DEAD_PEER_SECONDS, seconds


def test_a_stalled_run_reports_every_worker(workdir, monkeypatch):
    """Workers that outlast the test's wait are killed, and the
    failure says that this wait gave way, with every worker's output."""
    monkeypatch.setitem(globals(), 'WORKER_TIMEOUT', 20)
    with pytest.raises(pytest.fail.Exception) as caught:
        launch('stall', 2, workdir)
    message = str(caught.value)
    assert ('stall: the test stopped waiting for its workers (20 s)'
            in message), message
    for rank in range(2):
        assert f'--- rank {rank}, exit code -9:' in message, message


# ------------------------------------------------------------ one process

def test_round_robin_covers_everything(workdir):
    from shennong_tpu_torch.parallel.distributed import shard_utterances

    corpus = utterances('uneven', workdir)
    names = [utt.name for index in range(3)
             for utt in shard_utterances(corpus, index, 3)]
    assert sorted(names) == sorted(utt.name for utt in corpus)
    assert shard_utterances(list(corpus)[:2], 2, 3) is None


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one process."""
    import torch.distributed as dist

    dist.init_process_group(
        'gloo', init_method=f'file://{tmp_path / "store"}', world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize('step', ['em', 'accumulate', 'round', 'rounds'])
def test_step_makers_in_a_world_of_one(world_of_one, step):
    from shennong_tpu_torch.ops import fmllr, gmm as gmm_ops
    from shennong_tpu_torch.parallel import fused

    frames, fweights, model = random_frames(n=256, dim=4)
    if step == 'em':
        ours = fused.make_em_train_steps(world_of_one, 3)(
            frames, fweights, *model)
        ref = gmm_ops.em_steps(frames, fweights, *model, num_iters=3)
    elif step == 'accumulate':
        ours = fused.make_accumulate_step(world_of_one)(
            frames, fweights, *model)
        ref = gmm_ops.accumulate_stats(frames, fweights, *model)
    else:
        rng = np.random.RandomState(2)
        groups, classes = 3, 5
        gid = torch.as_tensor(rng.randint(0, groups, len(frames)))
        base = torch.as_tensor(np.stack([
            np.eye(4) + 0.05 * rng.randn(4, 4) for _ in range(classes)]))
        warps = torch.linspace(0.9, 1.1, classes, dtype=torch.float64)
        _, gsel = gmm_ops.gaussian_selection(frames, *model, 3)
        if step == 'round':
            ours = fused.make_lvtln_round_step(
                world_of_one, groups, num_gselect=3)(
                    frames, fweights, gid, base, warps, *model)
            ref = fmllr.lvtln_rounds(
                frames, fweights, gid, gsel, base, warps, *model,
                num_groups=groups, num_iters=0)[3:]
            # the unsharded round of the JAX package's test, op by op
            _, post = gmm_ops.posteriors_preselect(frames, gsel, *model)
            stats = fmllr.fmllr_stats_groups(
                frames, gsel, post * fweights[:, None], gid, model[1],
                model[2], groups)
            sign, logdet = torch.linalg.slogdet(base)
            plain = fmllr.solve_warp_classes(
                *stats, base, warps, sign > 0,
                torch.where(sign > 0, logdet, 0.0))
            assert torch.equal(ours[2], plain[2])
            for a, b in zip(ours, plain):
                torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
        else:
            ours = fused.make_lvtln_train_steps(world_of_one, groups, 2)(
                frames, fweights, gid, gsel, base, warps, *model)
            ref = fmllr.lvtln_rounds(
                frames, fweights, gid, gsel, base, warps, *model,
                num_groups=groups, num_iters=2)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)


def test_allreduce_in_a_world_of_one(world_of_one):
    from shennong_tpu_torch.parallel import distributed

    array = np.random.RandomState(0).randn(3, 4)
    assert np.array_equal(distributed.allreduce_f64(array), array)
    stats = {'a': np.ones((2, 3))}
    reduced = distributed.reduce_cmvn_stats(stats, ['a', 'b'])
    assert np.array_equal(reduced['a'], stats['a'])
    assert np.array_equal(reduced['b'], np.zeros((2, 3)))
    with pytest.raises(ValueError, match='no process produced'):
        distributed.reduce_cmvn_stats({}, ['a'])


if __name__ == '__main__':
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           sys.argv[5])
