"""Multi-process extraction and training over ``torch.distributed``.

Counterpart of :mod:`shennong_tpu.parallel.distributed`, which replaces
the reference's SLURM fan-out (``examples/features_abx/run.sh``,
``examples/vtln_training/run.sh``) with collectives. Every process
receives the whole utterance collection, takes its round-robin shard
(:func:`shard_utterances`), runs pass 1 and the training front-ends on
its own device, and the corpus statistics cross the processes: the CMVN
statistics (:func:`reduce_cmvn_stats`), the GMM's EM accumulators
(:func:`train_ubm`), the warp-class moments and each LVTLN round's
fMLLR statistics (:func:`train_vtln`). The result on every process
equals the single-process run, and the trained models are the same bits
on every process.

One process per device, the PyTorch idiom: where the JAX package drives
a mesh of devices from one process, the data axis here is the process
group. Start the processes with ``torchrun --nproc-per-node N`` (then
``initialize(backend=..., timeout=...)`` reads torchrun's environment) or
give :func:`initialize` the address, the world size and the rank.

Every statistic crosses as a float64 host tensor (:func:`allreduce_f64`),
so the backend must carry CPU tensors: ``'gloo'``, or
``'cpu:gloo,cuda:nccl'``. Several processes may share one card with
gloo.

A dead process: every check that raises before a collective is decided
on the whole collection, so all processes raise together. A process
that dies anyway (killed, or failing on its own shard) makes its peers'
next collective raise, as soon as gloo sees its connection close or at
the latest after :func:`initialize`'s ``timeout``: an error, never a
hang.
"""

import copy
import datetime
import time

import numpy as np
import torch
import torch.distributed as dist

from shennong_tpu_torch.logger import get_logger, null_logger
from shennong_tpu_torch.parallel.profiler import counters

#: collectives run since the last :func:`reset_collectives`, and their
#: host seconds
COLLECTIVES = {'calls': 0, 'seconds': 0.0}


def reset_collectives():
    """Set the collective count and time to 0."""
    COLLECTIVES.update(calls=0, seconds=0.0)


def initialize(init_method=None, world_size=None, rank=None, *, backend,
               timeout, log=get_logger('distributed', 'info')):
    """Join the process group (a no-op for ``world_size <= 1``).

    ``init_method`` None reads torchrun's environment (``env://``),
    else it is a URL such as ``'tcp://host:port'`` or
    ``'file:///shared/path'``. ``backend`` is the caller's (see the
    module's notes), ``timeout`` the seconds after which a collective
    waiting on a missing peer raises.
    """
    if world_size is not None and world_size <= 1:
        return
    dist.init_process_group(
        backend, init_method=init_method or 'env://',
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=datetime.timedelta(seconds=timeout))
    log.info('joined the process group: rank %d of %d, backend %s',
             dist.get_rank(), dist.get_world_size(), dist.get_backend())


def _process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def _process_count(group=None):
    return dist.get_world_size(group) if dist.is_initialized() else 1


def shard_utterances(utterances, process_index=None, process_count=None):
    """The utterances owned by this process, or None when it owns none.

    Utterances are split round-robin in collection order (an
    ``Utterances`` iterates sorted), balancing counts across processes;
    ``process_index`` and ``process_count`` default to the rank and the
    size of the default process group.
    """
    from shennong_tpu_torch.utterances import Utterances

    if process_index is None:
        process_index = _process_index()
    if process_count is None:
        process_count = _process_count()
    owned = [utt for i, utt in enumerate(utterances)
             if i % process_count == process_index]
    return Utterances(owned) if owned else None


def _owned_shard(utterances):
    """This process's shard of the list ``utterances``; raises on every
    process when some process would own none."""
    count = _process_count()
    if count > len(utterances):
        raise ValueError(
            f'only {len(utterances)} utterances for {count} processes: run '
            f'with at most {len(utterances)} processes')
    return shard_utterances(utterances)


def _allgather_host(vector, group=None):
    """[P, L] float64 stack of every process's host vector [L], in rank
    order (the same on every process)."""
    vector = np.ascontiguousarray(np.asarray(vector, dtype=np.float64))
    count = _process_count(group)
    if count == 1:
        return vector[None]
    start = time.perf_counter()
    tensor = torch.from_numpy(vector)
    parts = [torch.empty_like(tensor) for _ in range(count)]
    dist.all_gather(parts, tensor, group=group)
    COLLECTIVES['calls'] += 1
    COLLECTIVES['seconds'] += time.perf_counter() - start
    return torch.stack(parts).numpy()


def allreduce_f64(array, group=None):
    """Float64 sum of a host array over every process of ``group``.

    An all-gather of the float64 values, summed over the gathered
    [P, ...] stack in rank order: every process adds the same numbers in
    the same order, so every process holds the same bits, whatever the
    backend (``all_reduce``'s summation order is the backend's), and
    the models stay in lockstep without a broadcast.
    """
    arr = np.atleast_1d(np.asarray(array, dtype=np.float64))
    return _allgather_host(arr.reshape(-1), group).sum(
        axis=0).reshape(arr.shape)


def allreduce_tensors(tensors, group=None):
    """:func:`allreduce_f64` of a tuple of float64 tensors of one
    device, in one collective; returns the sums as tensors of that
    device, the ``reduce`` of :func:`shennong_tpu_torch.ops.gmm.em_step`
    and :func:`shennong_tpu_torch.ops.fmllr.lvtln_rounds`."""
    tensors = tuple(tensors)
    if _process_count(group) == 1:
        return tensors
    for tensor in tensors:
        if tensor.dtype != torch.float64:
            raise TypeError(
                f'the statistics must be float64, not {tensor.dtype}')
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    total = torch.from_numpy(allreduce_f64(flat, group)).to(
        tensors[0].device)
    out, cursor = [], 0
    for tensor in tensors:
        out.append(total[cursor:cursor + tensor.numel()].reshape(
            tensor.shape))
        cursor += tensor.numel()
    return tuple(out)


def reduce_cmvn_stats(local_stats, group_keys):
    """Sum per-group CMVN statistics over every process.

    ``group_keys`` is the global ordered key list, the same on every
    process (each process knows the whole collection). Groups absent
    from ``local_stats`` contribute zeros. Returns a dict over
    ``group_keys`` of the summed [2, dim+1] float64 statistics.
    """
    if not group_keys:
        return {}
    # a process with no statistics must still join the collective (a
    # raise on it alone would leave its peers blocked): the widths are
    # exchanged so that it contributes zeros; if no process has any,
    # all of them see width 0 and raise together
    local_shape = (np.asarray(next(iter(local_stats.values()))).shape
                   if local_stats else (0, 0))
    rows, cols = (int(v) for v in _allgather_host(local_shape).max(axis=0))
    if cols == 0:
        raise ValueError('no process produced any CMVN statistics')
    template = np.zeros((rows, cols))
    stacked = np.stack([
        np.asarray(local_stats[key]) if key in local_stats else template
        for key in group_keys])
    total = allreduce_f64(stacked)
    return {key: total[i] for i, key in enumerate(group_keys)}


_FRONTEND_NEEDED = (
    'needs the fused MFCC front-end (MFCC features with deltas and '
    'sliding CMVN at most, one sample rate, no utterance past the '
    'chunking limit)')


def _vtln_refusal(vtln, utterances):
    """Why :func:`train_vtln` does not take the configuration of
    ``vtln`` on the whole collection ``utterances``, or None: it needs
    the fused MFCC front-end for the UBM and the LVTLN features, and a
    UBM of fixed size. A function of the whole collection, so the same
    on every process."""
    from shennong_tpu_torch.processor.ubm import (
        DiagUbmProcessor, fused_frontend_supported)

    ubm = DiagUbmProcessor(**vtln.ubm)
    if ubm.remove_low_count_gaussians:
        return ('distributed VTLN training needs a fixed-size UBM: set '
                'ubm.remove_low_count_gaussians to False')
    if not (fused_frontend_supported(ubm.features, utterances)
            and fused_frontend_supported(vtln.features, utterances)):
        return 'distributed VTLN training ' + _FRONTEND_NEEDED
    return None


def extract_features(configuration, utterances, njobs=1, *, device,
                     generator=None, log=get_logger('distributed', 'info')):
    """Multi-process :func:`shennong_tpu_torch.pipeline.extract_features`.

    Every process receives the whole collection, takes its round-robin
    shard, runs pass 1 on ``device``, sums the CMVN statistics of every
    group over the processes (so a speaker whose utterances span
    processes is normalized as in the single-process run) and returns
    the features of its own shard; the union of the processes'
    collections equals the single-process output. ``generator`` (on
    ``device``) is this process's source of the dithers and the pitch
    noise.

    The warps of a ``vtln`` section train across the processes
    (:func:`train_vtln`) when it takes the configuration, else on the
    whole collection in every process: the same warps everywhere, the
    work repeated. ``njobs`` bounds the audio decode, as in the single
    process.
    """
    from shennong_tpu_torch import pipeline as pipe
    from shennong_tpu_torch.features_collection import FeaturesCollection
    from shennong_tpu_torch.parallel.stream import SignalCache
    from shennong_tpu_torch.pipeline_manager import PipelineManager
    from shennong_tpu_torch.processor.base import fresh_generator
    from shennong_tpu_torch.utterances import Utterances

    utterances = list(utterances)
    config = pipe.init_config(configuration, log=log)
    shard = _owned_shard(utterances)
    if generator is None:
        generator = fresh_generator(device)

    manager = PipelineManager(config, shard, log=log)
    cache = None
    if 'vtln' in config:
        vtln = manager.make('vtln')
        if _vtln_refusal(vtln, utterances) is None:
            cache = SignalCache(device=device)
            vtln._signal_cache = cache
            manager.warps = train_vtln(
                vtln, Utterances(utterances), njobs=njobs, device=device,
                generator=generator, log=log)
        else:
            log.info('VTLN training not distributable: training on the '
                     'whole collection in every process')
            manager.warps = vtln.process(
                Utterances(utterances), njobs=njobs, device=device,
                generator=_shared_generator(generator, device))

    triplets = []
    pipe._pass_one(manager, list(shard), device, generator, log, cache,
                   triplets.extend, njobs)
    if 'cmvn' in config:
        by_speaker = config['cmvn']['by_speaker']
        manager.cmvn_stats = reduce_cmvn_stats(manager.cmvn_stats, sorted({
            utt.speaker if by_speaker else utt.name for utt in utterances}))
    with counters.timed('pass2_s'):
        results = pipe._pass_two(manager, triplets, log)
    return FeaturesCollection({utt.name: results[utt.name] for utt in shard})


def _shared_generator(generator, device):
    """A generator on ``device`` seeded alike on every process, from a
    draw of process 0's ``generator``: the training that every process
    repeats on the whole collection dithers alike and gives the same
    warps everywhere."""
    draw = torch.randint(2 ** 31, (1,), generator=generator,
                         device=generator.device)
    shared = torch.Generator(device=device)
    shared.manual_seed(int(_allgather_host([float(draw)])[0, 0]))
    return shared


def train_ubm(ubm, utterances, njobs=1, signal_cache=None, *, device,
              generator=None, log=get_logger('distributed', 'info')):
    """Multi-process :meth:`DiagUbmProcessor.process` (the fused
    front-end).

    Every process receives the whole collection and streams the
    front-end over its shard only, on ``device`` (``generator`` the
    source of its dither); the statistics cross the processes:

    - the reservoir, the initial means and the data variance index the
      global voiced-frame sequence, the utterances in the whole
      collection's streaming order
      (:func:`shennong_tpu_torch.parallel.stream.streamed_order`), as the
      single-process front-end lays them out: the initialization draws
      from ``ubm``'s random state exactly as the single-process trainer;
    - every EM iteration (the init loop with its splits, then the main
      loop) sums its statistics over the processes
      (:func:`shennong_tpu_torch.parallel.fused.make_em_train_steps`,
      :func:`~shennong_tpu_torch.parallel.fused.make_accumulate_step`)
      and every process applies the same update.

    Sets and returns ``ubm.gmm``, the same bits on every process.
    ``njobs`` bounds the audio decode, as in the single process;
    ``signal_cache`` (a
    :class:`~shennong_tpu_torch.parallel.stream.SignalCache` or None)
    keeps the front-end's uploads for a later sweep.
    """
    return _train_ubm(ubm, list(utterances), device, generator,
                      signal_cache, njobs, log)[0]


def _train_ubm(ubm, utterances, device, generator, signal_cache, njobs,
               log):
    """:func:`train_ubm`, the front-end's uploads in ``signal_cache``
    (or None); returns (gmm, the shard's front-end as
    :func:`shennong_tpu_torch.processor.ubm.stream_frontend` returns it,
    in the GMM's dtype)."""
    from shennong_tpu_torch.parallel.fused import (
        make_accumulate_step, make_em_train_steps)
    from shennong_tpu_torch.parallel.stream import streamed_order
    from shennong_tpu_torch.processor.ubm import (
        GMM_DTYPE, fused_frontend_supported, selected_sums, stream_frontend)

    shard = _owned_shard(utterances)
    # decided on the whole collection, so that every process raises
    if not fused_frontend_supported(ubm.features, utterances):
        raise ValueError('distributed UBM training ' + _FRONTEND_NEEDED)
    log.info('Training UBM across %d processes', _process_count())
    with torch.profiler.record_function('ubm.frontend'):
        front = stream_frontend(
            ubm.features, ubm.vad, ubm.subsample, shard, njobs=njobs,
            device=device, generator=generator, signal_cache=signal_cache)
    flat, w_init, w_em = (t.to(GMM_DTYPE) for t in front[:3])
    layout = front[4]

    # the global voiced-frame sequence: each utterance's voiced rows, in
    # the whole collection's streaming order (one exchange of counts)
    voiced = w_init.cpu().numpy() > 0
    local_rows = {}
    for names, frames_per_row, offset in layout:
        for row, name in enumerate(names):
            start = offset + row * frames_per_row
            local_rows[name] = start + np.flatnonzero(
                voiced[start:start + frames_per_row])
    order = [utterances[i].name for i in streamed_order(utterances)]
    counts = allreduce_f64(
        [len(local_rows.get(name, ())) for name in order]).astype(np.int64)
    offsets = np.cumsum(counts) - counts
    num_read = int(counts.sum())
    mine = [i for i, name in enumerate(order) if name in local_rows]
    owned = np.concatenate(
        [np.arange(offsets[i], offsets[i] + counts[i]) for i in mine]
        + [np.zeros(0, np.int64)])
    owned_rows = np.concatenate(
        [local_rows[order[i]] for i in mine] + [np.zeros(0, np.int64)])

    def rows_of(indices):
        """(mask, flat rows) of the indices of the global sequence that
        this process owns."""
        indices = np.asarray(indices, dtype=np.int64)
        if not len(owned):
            # a shard of unvoiced utterances owns no frame, and still
            # joins every collective
            return np.zeros(indices.shape, bool), owned_rows
        pos = np.minimum(np.searchsorted(owned, indices), len(owned) - 1)
        mask = owned[pos] == indices
        return mask, owned_rows[pos[mask]]

    def em_on(weights):
        def em_fn(params, num_iters):
            return make_em_train_steps(
                None, num_iters, min_gaussian_weight=ubm._min_gaussian_weight)(
                    flat, weights, *params)

        def accumulate_fn(params):
            return make_accumulate_step(None)(flat, weights, *params)
        return em_fn, accumulate_fn

    with torch.profiler.record_function('ubm.init'):
        ubm.log.info('Initializing model')
        num_gauss_init = int(ubm.initial_gauss_proportion * ubm.num_gauss)
        if num_read > ubm.num_frames:
            kept = ubm._reservoir_indices(num_read)
            selected = torch.zeros_like(w_init)
            selected[torch.as_tensor(rows_of(kept)[1], device=flat.device)] = 1
            avail = ubm.num_frames
        else:
            kept, selected, avail = None, w_init, num_read

        def frames_at(indices):
            mask, rows = rows_of(indices)
            frames = np.zeros((len(indices), flat.shape[1]))
            frames[mask] = flat[torch.as_tensor(rows, device=flat.device)
                                ].cpu().numpy()
            return allreduce_f64(frames)

        sums = allreduce_f64(np.stack(selected_sums(flat, selected)))
        ubm._init_from_sums(
            sums[0], sums[1], avail, num_gauss_init, kept, frames_at)
        ubm._init_em_loop(flat, selected, num_gauss_init, avail,
                          *em_on(selected))
    ubm.log.info('Training for %s iterations', ubm.num_iters)
    ubm._main_em(flat, w_em, *em_on(w_em))
    ubm.log.info('Done training UBM.')
    return ubm.gmm, (flat, w_init, w_em, num_read, layout)


def estimate_vtln(vtln, ubm, feats_collection, posteriors, utt2speak, *,
                  device, log=get_logger('distributed', 'info')):
    """Multi-process :meth:`VtlnProcessor.estimate`: one LVTLN round.

    ``feats_collection`` and ``posteriors`` hold this process's shard,
    ``utt2speak`` maps the whole collection (the same on every process,
    so the global group list is known everywhere; a group with no
    utterance here contributes zeros). The per-group fMLLR statistics
    accumulate on ``device``, are summed over the processes, and every
    process solves the same per-(group, warp-class) objective. Returns
    (transforms, warps) over every group, the same on every process.
    """
    groups = {}
    for utt, spk in utt2speak.items():
        groups.setdefault(spk, []).append(utt)
    local = {spk: [utt for utt in utts if utt in feats_collection]
             for spk, utts in groups.items()}
    stats = vtln._accumulate_group_stats(
        ubm, feats_collection, posteriors, local, device=device)
    names = sorted(stats)
    beta = allreduce_f64([stats[g].beta for g in names])
    K = allreduce_f64(np.stack([stats[g].K for g in names]))
    G = allreduce_f64(np.stack([stats[g].G for g in names]))
    transforms, warps = {}, {}
    for i, group in enumerate(names):
        stats[group].beta, stats[group].K, stats[group].G = beta[i], K[i], G[i]
        class_idx, _, transform, objf_impr, count = (
            vtln.lvtln.compute_transform(
                stats[group], vtln.norm_type, vtln.logdet_scale))
        transforms[group] = transform
        warps[group] = vtln.lvtln.get_warp(class_idx)
        log.debug('%s: auxf-impr from LVTLN is %s, over %s frames',
                  group, objf_impr / max(count, 1e-10), count)
    return transforms, warps


def train_vtln(vtln, utterances, group_by='utterance', njobs=1, *, device,
               generator=None, log=get_logger('distributed', 'info')):
    """Multi-process :meth:`VtlnProcessor.process`: the whole LVTLN
    training of its device body, on ``device``, with every corpus
    statistic summed over the processes:

    - the UBM trains through :func:`train_ubm`;
    - the warp-class base transforms come from each process's moments
      (:func:`shennong_tpu_torch.ops.fmllr.merge_moments`), gathered and
      merged in rank order on every process;
    - every round sums its fMLLR statistics and EM accumulators
      (:func:`shennong_tpu_torch.parallel.fused.make_lvtln_train_steps`).

    Every process ends with the same model, transforms and warps. Sets
    ``vtln.transforms`` and ``vtln.warps`` and returns the warps by
    utterance or by speaker (``group_by``), as ``process`` does. Needs
    the fused MFCC front-end and a UBM of fixed size
    (``remove_low_count_gaussians`` False). A ``_signal_cache``
    attribute of ``vtln``, as the pipeline sets it, caches this
    process's uploads. ``njobs`` bounds the audio decode.
    """
    from shennong_tpu_torch import pipeline
    from shennong_tpu_torch.ops import gmm as gmm_ops
    from shennong_tpu_torch.ops.fmllr import LinearVtln, merge_moments
    from shennong_tpu_torch.parallel.fused import make_lvtln_train_steps
    from shennong_tpu_torch.parallel.stream import SignalCache
    from shennong_tpu_torch.processor.ubm import (
        GMM_DTYPE, DiagUbmProcessor, stream_frontend)

    if group_by not in ('utterance', 'speaker'):
        raise ValueError(
            f'group_by must be "utterance" or "speaker", it is: {group_by}')
    if group_by == 'speaker' and not vtln.by_speaker:
        raise ValueError(
            'Asking to group warps by speaker but they are computed per '
            'utterance, please set VtlnProcessor.by_speaker to True')
    everything = list(utterances)
    utt2speak = None
    if vtln.by_speaker:
        utt2speak = {utt.name: utt.speaker for utt in everything}
        if any(spk is None for spk in utt2speak.values()):
            raise ValueError(
                'Requested speaker based VTLN, but speaker information is '
                'missing')
    if vtln.min_warp > vtln.max_warp:
        raise ValueError(
            f'Min warp > max warp: {vtln.min_warp} > {vtln.max_warp}')
    refusal = _vtln_refusal(vtln, everything)
    if refusal is not None:
        raise ValueError(refusal)
    ubm = DiagUbmProcessor(**vtln.ubm)
    ubm.log.setLevel(vtln.log.getEffectiveLevel())

    signal_cache = getattr(vtln, '_signal_cache', None)
    if signal_cache is None:
        signal_cache = SignalCache(device=device)
    _, front = _train_ubm(ubm, everything, device, generator, signal_cache,
                          njobs, log)

    vtln.log.info('Initializing base LVTLN transforms')
    num_classes = int(1.5 + (vtln.max_warp - vtln.min_warp) / vtln.warp_step)
    default_class = int(0.5 + (1 - vtln.min_warp) / vtln.warp_step)
    vtln.lvtln = LinearVtln(ubm.gmm.dim(), num_classes, default_class)
    class_warps = vtln._class_warps(num_classes)

    # the UBM's front-end serves when the configurations agree, as in
    # the single-process device body
    shard = shard_utterances(everything)
    if not (vtln.features == ubm.features
            and int(vtln.subsample) == int(ubm.subsample)):
        with torch.profiler.record_function('ubm.frontend'):
            front = stream_frontend(
                vtln.features, ubm.vad, vtln.subsample, shard, njobs=njobs,
                device=device, generator=generator,
                signal_cache=signal_cache)
    flat, w_em = front[0].to(GMM_DTYPE), front[2].to(GMM_DTYPE)
    layout = front[4]

    w_host = w_em.cpu().numpy()
    keep = {}
    for names, frames_per_row, offset in layout:
        for row, name in enumerate(names):
            start = offset + row * frames_per_row
            keep[name] = w_host[start:start + frames_per_row]
    base_features = {k: copy.deepcopy(v) for k, v in vtln.features.items()
                     if k != 'sliding_window_cmvn'}
    moments = pipeline.accumulate_warp_mapping_stats(
        base_features, shard, class_warps, keep, null_logger(),
        njobs=njobs, device=device, generator=generator,
        signal_cache=signal_cache)
    # a shard whose frames the VAD rejects contributes zero moments
    local = (merge_moments(moments) if sum(float(m[0]) for m in moments) > 0
             else tuple(np.zeros(np.shape(m)) for m in moments[0]))
    sizes = [np.size(m) for m in local]
    gathered = _allgather_host(
        np.concatenate([np.ravel(m) for m in local]))
    merged = [
        tuple(part.reshape(np.shape(m)) for part, m in zip(
            np.split(row, np.cumsum(sizes)[:-1]), local))
        for row in gathered]
    vtln._set_base_transforms(merged, class_warps)

    def group_of(name):
        return utt2speak[name] if utt2speak is not None else name

    group_names = sorted({group_of(utt.name) for utt in everything})
    gindex = {g: i for i, g in enumerate(group_names)}
    gid = np.zeros(flat.shape[0], dtype=np.int32)
    for names, frames_per_row, offset in layout:
        for row, name in enumerate(names):
            start = offset + row * frames_per_row
            gid[start:start + frames_per_row] = gindex[group_of(name)]

    vtln._check_num_gselect(ubm)
    with torch.profiler.record_function('vtln.gselect'):
        _, gsel = gmm_ops.gaussian_selection(
            flat, *ubm.gmm.as_tensors(flat.device), ubm.num_gselect)
    vtln.log.info('Computing LVTLN transforms (%s iterations, %d processes)',
                  vtln.num_iters, _process_count())
    vtln._rounds_fused_arrays(
        ubm, flat, w_em, torch.as_tensor(gid, device=flat.device), gsel,
        group_names, rounds=make_lvtln_train_steps(
            None, num_groups=len(group_names), num_iters=vtln.num_iters,
            norm_type=vtln.norm_type, logdet_scale=vtln.logdet_scale,
            default_class=default_class,
            min_gaussian_weight=ubm.min_gaussian_weight))

    if vtln.by_speaker:
        vtln.transforms = {
            utt: vtln.transforms[spk] for utt, spk in utt2speak.items()}
        vtln.warps = {utt: vtln.warps[spk] for utt, spk in utt2speak.items()}
    vtln.log.info('Done training LVTLN model')
    if group_by == 'utterance':
        return dict(vtln.warps)
    return {spk: vtln.warps[utts[0].name]
            for spk, utts in utterances.by_speaker().items()}
