"""Universal Background Model: diagonal-covariance GMM trainer.

Counterpart of :mod:`shennong_tpu.processor.ubm` (the port of Kaldi's
gmm-global-* tools), on an explicit ``device``: EM accumulation is two
matrix products per iteration over the whole corpus, gaussian selection
a top-k, and the model and the data stay on the device between the
iterations (:mod:`shennong_tpu_torch.ops.gmm`).

The random frames of the initialization and the perturbations of the
splits draw from the processor's ``np.random.RandomState(seed)``, in
the order of the JAX package, so both pick the same frames; only the
MFCC dither draws from the caller's :class:`torch.Generator`.

The model, the training frames and every EM, selection and LVTLN
product on the device are float64 (:data:`GMM_DTYPE`), where the JAX
package computes in float32: the EM of a model whose variances reach
the floor amplifies rounding, and in float32 the means trained on an
H100 and on the CPU differed by 5.9e-3 (another summation order of the
same products); in float64 they agree to 4e-4.

The front-end streams the corpus through one program per signal batch
(:func:`stream_frontend`, under the profiler span ``ubm.frontend``),
the initialization and its EM with splits run under ``ubm.init``, the
main EM iterations under ``ubm.em``. Configurations the fused
front-end does not cover (features other than MFCC, mixed sample
rates, an utterance past ``AUTO_CHUNK_FRAMES``) take the staged
front-end, chosen up front.
"""

import copy
import os

import numpy as np
import torch

from shennong_tpu_torch import pipeline
from shennong_tpu_torch.base import BaseProcessor
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.logger import null_logger
from shennong_tpu_torch.ops import gmm as gmm_ops
from shennong_tpu_torch.ops.framing import bucket_size
from shennong_tpu_torch.postprocessor.cmvn import (
    SlidingWindowCmvnPostProcessor)
from shennong_tpu_torch.postprocessor.vad import VadPostProcessor

#: the dtype of the GMM training and scoring on the device
GMM_DTYPE = torch.float64


class DiagGmm:
    """A diagonal-covariance GMM: weights [G], means [G, D],
    inv_vars [G, D] (float64 numpy)."""

    def __init__(self, weights, means, inv_vars):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.means = np.asarray(means, dtype=np.float64)
        self.inv_vars = np.asarray(inv_vars, dtype=np.float64)

    def num_gauss(self):
        return self.weights.shape[0]

    def dim(self):
        return self.means.shape[1]

    def get_means(self):
        return self.means

    def as_tensors(self, device):
        """(weights, means, inv_vars) as :data:`GMM_DTYPE` tensors on
        ``device``"""
        return tuple(
            torch.as_tensor(a, dtype=GMM_DTYPE, device=device)
            for a in (self.weights, self.means, self.inv_vars))


def _gmm_from_tensors(params):
    return DiagGmm(*[p.cpu().numpy().astype(np.float64) for p in params])


class DiagUbmProcessor(BaseProcessor):
    """Universal Background Model with Diagonal GMM"""

    def __init__(self, num_gauss,
                 num_iters=4, num_gselect=15, initial_gauss_proportion=0.5,
                 num_iters_init=20, num_frames=500000,
                 subsample=5, min_gaussian_weight=1e-4,
                 remove_low_count_gaussians=False, seed=0,
                 features=None, vad=None):
        super().__init__()

        self.num_gauss = num_gauss
        self.num_iters = num_iters
        self.num_iters_init = num_iters_init
        self.num_gselect = num_gselect
        self.initial_gauss_proportion = initial_gauss_proportion
        self.num_frames = num_frames
        self.subsample = subsample
        self.min_gaussian_weight = min_gaussian_weight
        self.remove_low_count_gaussians = remove_low_count_gaussians
        self.seed = seed

        if vad is None:
            config = VadPostProcessor().get_params()
            config['energy_threshold'] = 5.5
            self.vad = config
        else:
            self.vad = vad

        if features in (None, 'default'):
            config = pipeline.get_default_config('mfcc', with_delta=True)
            config['sliding_window_cmvn'] = (
                SlidingWindowCmvnPostProcessor().get_params())
            config['sliding_window_cmvn']['cmn_window'] = 300
            config['delta']['window'] = 3
            self.features = config
        else:
            self.features = features

        self.gmm = None
        self.selection = None

    @property
    def name(self):
        """Processor name"""
        return 'ubm'

    @property
    def num_gauss(self):
        """Number of Gaussians in the model"""
        return self._num_gauss

    @num_gauss.setter
    def num_gauss(self, value):
        if int(value) < 2:
            raise ValueError(
                'Number of gaussians must be at least 2, not {}'
                .format(value))
        self._num_gauss = int(value)

    @property
    def num_iters(self):
        """Number of iterations of training."""
        return self._num_iters

    @num_iters.setter
    def num_iters(self, value):
        self._num_iters = int(value)

    @property
    def num_iters_init(self):
        """ Number of E-M iterations for model initialization."""
        return self._num_iters_init

    @num_iters_init.setter
    def num_iters_init(self, value):
        self._num_iters_init = int(value)

    @property
    def num_gselect(self):
        """Number of Gaussians per frame to limit computation to, for speed."""
        return self._num_gselect

    @num_gselect.setter
    def num_gselect(self, value):
        self._num_gselect = int(value)

    @property
    def initial_gauss_proportion(self):
        """Proportion of Gaussians to start with in initialization phase
        (then split)"""
        return self._initial_gauss_proportion

    @initial_gauss_proportion.setter
    def initial_gauss_proportion(self, value):
        self._initial_gauss_proportion = float(value)

    @property
    def num_frames(self):
        """Maximum num-frames to keep in memory for model initialization."""
        return self._num_frames

    @num_frames.setter
    def num_frames(self, value):
        self._num_frames = int(value)

    @property
    def subsample(self):
        """In main E-M phase, use every n frames (a speedup)"""
        return self._subsample

    @subsample.setter
    def subsample(self, value):
        self._subsample = int(value)

    @property
    def min_gaussian_weight(self):
        """Minimum weight below which a Gaussian is not updated"""
        return np.float32(self._min_gaussian_weight)

    @min_gaussian_weight.setter
    def min_gaussian_weight(self, value):
        self._min_gaussian_weight = float(value)

    @property
    def remove_low_count_gaussians(self):
        """Remove Gaussians with a weight below `min_gaussian_weight`"""
        return self._remove_low_count_gaussians

    @remove_low_count_gaussians.setter
    def remove_low_count_gaussians(self, value):
        self._remove_low_count_gaussians = bool(value)

    @property
    def features(self):
        """Features extraction configuration"""
        return self._features

    @features.setter
    def features(self, value):
        if not isinstance(value, dict):
            raise TypeError('Features configuration must be a dict')
        if 'mfcc' not in value:
            raise ValueError('Need mfcc features to train UBM-GMM')
        self._features = copy.deepcopy(value)

    @property
    def vad(self):
        """VAD configuration for the UBM-GMM"""
        return self._vad

    @vad.setter
    def vad(self, value):
        if not isinstance(value, dict):
            raise TypeError('VAD configuration must be a dict')
        vad_keys = VadPostProcessor().get_params().keys()
        if not value.keys() <= vad_keys:
            raise ValueError('Unknown parameters given for VAD config')
        self._vad = copy.deepcopy(value)

    @property
    def seed(self):
        """Random seed for initialization from random frames"""
        return self._seed

    @seed.setter
    def seed(self, value):
        self._seed = int(value)
        self._rng = np.random.RandomState(seed=self._seed)

    @classmethod
    def load(cls, path):
        """Load a GMM checkpoint: this port's or the JAX package's npz,
        or Kaldi's binary DiagGmm (sniffed from the file header)."""
        if not os.path.isfile(path):
            raise OSError('{}: file not found'.format(path))

        from shennong_tpu_torch import kaldiio
        if kaldiio.is_kaldi_binary(path):
            gmm = DiagGmm(*kaldiio.read_diag_gmm(path))
        else:
            with np.load(path) as data:
                gmm = DiagGmm(
                    data['weights'], data['means'], data['inv_vars'])
        # exact-zero-weight components are the EM's inert shape padding:
        # a loaded real one would be frozen instead of floored
        if np.any(gmm.weights == 0):
            raise ValueError(
                '{}: GMM contains zero-weight components'.format(path))
        ubm = DiagUbmProcessor(gmm.num_gauss())
        ubm.gmm = gmm
        return ubm

    def save(self, path):
        """Save the GMM to an npz checkpoint"""
        if os.path.isfile(path):
            raise OSError('{}: file already exists'.format(path))
        if not isinstance(self.gmm, DiagGmm):
            raise TypeError('GMM not initialized')
        # through an open file: np.savez appends '.npz' to other names
        with open(path, 'wb') as fp:
            np.savez(
                fp, weights=self.gmm.weights, means=self.gmm.means,
                inv_vars=self.gmm.inv_vars)

    def save_kaldi(self, path):
        """Save the GMM in Kaldi's binary DiagGmm format."""
        if os.path.isfile(path):
            raise OSError('{}: file already exists'.format(path))
        if not isinstance(self.gmm, DiagGmm):
            raise TypeError('GMM not initialized')
        from shennong_tpu_torch import kaldiio
        kaldiio.write_diag_gmm(
            path, self.gmm.weights, self.gmm.means, self.gmm.inv_vars)

    def initialize_gmm(self, feats_collection, njobs=1, *, device):
        """Initialize the GMM from a host features collection and run
        the initial EM with splitting on ``device``.

        Means start from randomly sampled frames (reservoir sampling
        bounded by ``num_frames``), variances from the global data
        variance; EM iterations interleave with component splitting up
        to ``num_gauss``. ``njobs`` has no effect: it keeps the JAX
        package's signature, and the features are in memory, nothing
        is decoded.
        """
        num_gauss_init = int(self.initial_gauss_proportion * self.num_gauss)
        self.log.info('Initializing model')
        all_feats = np.concatenate(
            [feats.data for feats in feats_collection.values()], axis=0)
        num_read = all_feats.shape[0]
        if num_read > self.num_frames:
            feats = all_feats[self._reservoir_indices(num_read)]
        else:
            feats = all_feats

        self._init_from_random_frames(feats, num_gauss_init)
        self._init_em_loop(
            torch.as_tensor(feats, dtype=GMM_DTYPE, device=device),
            torch.ones(feats.shape[0], dtype=GMM_DTYPE, device=device),
            num_gauss_init, feats.shape[0])

    def _local_steps(self, feats_dev, weights_dev):
        """The default ``(em_fn, accumulate_fn)`` of the EM loops: the
        iterations and the statistics over ``feats_dev`` and its 0/1
        frame weights ``weights_dev``, on their device."""
        def em_fn(params, num_iters):
            return gmm_ops.em_steps(
                feats_dev, weights_dev, *params, num_iters=num_iters,
                min_gaussian_weight=self._min_gaussian_weight)

        def accumulate_fn(params):
            return gmm_ops.accumulate_stats(feats_dev, weights_dev, *params)
        return em_fn, accumulate_fn

    def _init_em_loop(self, feats_dev, weights_dev, num_gauss_init,
                      nframes_log, em_fn=None, accumulate_fn=None):
        """The init EM-with-splitting loop on device-resident data.

        ``weights_dev`` holds 0/1 per-frame selection weights. The model
        is padded to its final component count with weight-0 components
        (inert: their log-normalizer is -inf), so every iteration runs
        on one shape; the host sees the model only around the splits.
        With ``remove_low_count_gaussians`` (the reference applies it on
        every init iteration) the updates run on the host, the
        statistics on the device.

        ``em_fn(params, num_iters) -> (tot_like, weights, means,
        inv_vars)`` and ``accumulate_fn(params) -> (tot_like, occupancy,
        mean_acc, var_acc)`` replace the iterations and the statistics
        over ``feats_dev``: the multi-process trainer
        (:func:`shennong_tpu_torch.parallel.distributed.train_ubm`)
        passes steps whose statistics sum over every process.
        """
        device = feats_dev.device
        local_em, local_accumulate = self._local_steps(feats_dev, weights_dev)
        em_fn = em_fn or local_em
        accumulate_fn = accumulate_fn or local_accumulate
        cur_num_gauss = num_gauss_init
        gauss_inc = int((self.num_gauss - num_gauss_init)
                        / (max(self.num_iters_init, 1) / 2))
        if gauss_inc == 0:
            self.log.warning(
                'Number of gaussians %s is too low', self.num_gauss)
            gauss_inc = 1

        def pad_params(weights, means, inv_vars):
            short = self.num_gauss - weights.shape[0]
            if short <= 0:
                return DiagGmm(weights, means, inv_vars).as_tensors(device)
            dim = means.shape[1]
            return DiagGmm(
                np.concatenate([weights, np.zeros(short)]),
                np.concatenate([means, np.zeros((short, dim))]),
                np.concatenate([inv_vars, np.ones((short, dim))]),
            ).as_tensors(device)

        def host(param, live):
            return param.cpu().numpy().astype(np.float64)[:live]

        remove = bool(self.remove_low_count_gaussians)
        params = pad_params(
            self.gmm.weights, self.gmm.means, self.gmm.inv_vars)
        live = num_gauss_init   # actual components (removal shrinks)
        i = 0
        while i < self.num_iters_init:
            if remove:
                tot_like, occ, macc, vacc = accumulate_fn(params)
                new = gmm_ops.mle_update(
                    host(occ, live), host(macc, live), host(vacc, live),
                    *[host(p, live) for p in params],
                    min_gaussian_weight=self._min_gaussian_weight,
                    remove_low_count_gaussians=True)
                if new[0].shape[0] < live:
                    self.log.debug(
                        'Removed %s low-count Gaussians during '
                        'initialization', live - new[0].shape[0])
                live = new[0].shape[0]
                params = pad_params(*new)
                i += 1
            else:
                # with no split ahead, every remaining iteration is
                # enqueued at once
                run = (self.num_iters_init - i
                       if cur_num_gauss >= self.num_gauss else 1)
                tot_like, *params = em_fn(params, run)
                i += run
            if self.log.isEnabledFor(10):  # logging.DEBUG
                self.log.debug(
                    'Likelihood per frame: %s over %s frames',
                    float(tot_like) / max(nframes_log, 1), nframes_log)

            next_num_gauss = min(self.num_gauss, cur_num_gauss + gauss_inc)
            if next_num_gauss > live:
                self.log.debug('Splitting to %s Gaussians', next_num_gauss)
                split = gmm_ops.split_gmm(
                    *[host(p, live) for p in params],
                    next_num_gauss, 0.1, self._rng)
                params = pad_params(*split)
                live = next_num_gauss
                cur_num_gauss = next_num_gauss
        self.gmm = DiagGmm(*[host(p, live) for p in params])

    def _reservoir_indices(self, num_read):
        """Frame indices kept by the reference's reservoir sampling."""
        kept = np.arange(self.num_frames)
        for row in range(self.num_frames, num_read):
            if self._rng.random_sample() <= self.num_frames / (row + 1):
                kept[self._rng.randint(0, self.num_frames)] = row
        return kept

    def _init_from_random_frames(self, feats, num_gauss):
        """Means from random distinct frames, variance from the data."""
        num_frames, dim = feats.shape
        if num_frames < 10 * num_gauss:
            raise ValueError(
                f'Too few frames to train on ({num_frames} frames)')

        feats64 = feats.astype(np.float64)
        mean = feats64.mean(axis=0)
        var = (feats64 ** 2).mean(axis=0) - mean ** 2
        if var.max() <= 0:
            raise ValueError(
                f'Features do not have positive variance {var}')

        chosen = self._rng.choice(num_frames, num_gauss, replace=False)
        self.gmm = DiagGmm(
            np.full(num_gauss, 1.0 / num_gauss),
            feats64[chosen],
            np.tile(1.0 / var, (num_gauss, 1)))

    def initialize_gmm_device(self, flat, w_init, num_read):
        """Initialize and run the init EM on device-resident data.

        The device twin of :func:`initialize_gmm`: ``flat`` is the
        padded [N, D] :data:`GMM_DTYPE` feature matrix, ``w_init`` the 0/1
        voiced-frame weights, ``num_read`` their (host) total. The
        reservoir subset, the random-frame means and the data variance
        (summed in float64) come from device gathers and reductions;
        only O(num_gauss) values reach the host.
        """
        num_gauss_init = int(self.initial_gauss_proportion * self.num_gauss)
        self.log.info('Initializing model')

        device = flat.device
        total_rows = flat.shape[0]
        # voiced rows first, in their original order
        order = torch.argsort(
            torch.arange(total_rows, device=device)
            + (1 - w_init.to(torch.int64)) * total_rows, stable=True)

        if num_read > self.num_frames:
            kept = self._reservoir_indices(num_read)
            rows_kept = order[torch.as_tensor(kept, device=device)]
            weights = torch.zeros(total_rows, dtype=flat.dtype,
                                  device=device)
            weights[rows_kept] = 1.0
            avail = self.num_frames
        else:
            kept = None
            weights = w_init
            avail = num_read

        def frames_at(picks):
            rows = order[torch.as_tensor(picks, device=device)]
            return flat[rows].cpu().numpy().astype(np.float64)

        self._init_from_sums(
            *selected_sums(flat, weights), avail, num_gauss_init, kept,
            frames_at)
        self._init_em_loop(flat, weights, num_gauss_init, avail)

    def _init_from_sums(self, sums, sqsums, avail, num_gauss_init, kept,
                        frames_at):
        """The initial model of :meth:`initialize_gmm_device`: the
        variance of the ``avail`` selected frames from their float64
        ``sums`` and ``sqsums``, and means at ``num_gauss_init`` distinct
        random frames of them, drawn from the processor's random state.
        ``kept`` maps the selection to the voiced-frame sequence (the
        reservoir's indices, or None for all of it) and
        ``frames_at(indices)`` returns the [k, D] float64 frames at
        those indices of the sequence."""
        if avail < 10 * num_gauss_init:
            raise ValueError(f'Too few frames to train on ({avail} frames)')
        mean = sums / avail
        var = sqsums / avail - mean ** 2
        if var.max() <= 0:
            raise ValueError(
                f'Features do not have positive variance {var}')

        chosen = self._rng.choice(avail, num_gauss_init, replace=False)
        picks = kept[chosen] if kept is not None else chosen
        self.gmm = DiagGmm(
            np.full(num_gauss_init, 1.0 / num_gauss_init),
            frames_at(picks),
            np.tile(1.0 / var, (num_gauss_init, 1)))

    @staticmethod
    def _flat_frames(feats_collection):
        """Concatenate a collection on the frame axis, padded to a
        bucket (GMM per-frame operations ignore utterance boundaries).

        Returns (names, counts, padded feats [N', D] float32, nrows).
        """
        names = list(feats_collection.keys())
        counts = [feats_collection[n].nframes for n in names]
        nrows = int(sum(counts))
        bucket = bucket_size(max(nrows, 1), minimum=128)
        dim = feats_collection[names[0]].ndims
        flat = np.zeros((bucket, dim), dtype=np.float32)
        offset = 0
        for name, count in zip(names, counts):
            flat[offset:offset + count] = feats_collection[name].data
            offset += count
        return names, counts, flat, nrows

    def gaussian_selection(self, feats_collection, *, device):
        """Select the ``num_gselect`` best components per frame, on
        ``device``.

        Stores per-utterance [nframes, num_gselect] index arrays in
        ``self.selection``. When a selection is already stored, the new
        one refines within it (Kaldi gmm-gselect --gselect).
        """
        if not isinstance(self.gmm, DiagGmm):
            raise TypeError('GMM not initialized')

        already = self.selection is not None
        if not already:
            self.selection = {}

        if self.num_gselect > self.gmm.num_gauss():
            self.log.warning(
                'You asked for %s Gaussians but GMM only has %s,'
                ' returning this many. Note: this means the'
                ' Gaussian selection is pointless',
                self.num_gselect, self.gmm.num_gauss())
            self.num_gselect = self.gmm.num_gauss()

        if already:
            for utt in feats_collection.keys():
                if utt not in self.selection:
                    raise ValueError(
                        f'No gselect information for utterance {utt}')

        params = self.gmm.as_tensors(device)
        names, counts, flat, nrows = self._flat_frames(feats_collection)
        flat = torch.as_tensor(flat, dtype=GMM_DTYPE, device=device)
        if already:
            prev = []
            for name, count in zip(names, counts):
                sel = np.asarray(self.selection[name])
                if sel.shape[0] != count:
                    raise ValueError(
                        f'Input gselect utterance {name} has wrong size')
                prev.append(sel)
            prev = np.concatenate(prev) if prev else np.zeros(
                (0, self.num_gselect), np.int32)
            prev = np.pad(prev, ((0, flat.shape[0] - nrows), (0, 0)))
            like, indices = gmm_ops.gaussian_selection_preselect(
                flat, torch.as_tensor(prev, device=device), *params,
                min(self.num_gselect, prev.shape[1]))
        else:
            like, indices = gmm_ops.gaussian_selection(
                flat, *params, self.num_gselect)
        indices = indices[:nrows].cpu().numpy()
        offset = 0
        for name, count in zip(names, counts):
            self.selection[name] = indices[offset:offset + count]
            offset += count

        if self.log.isEnabledFor(10):  # logging.DEBUG
            self.log.debug(
                'Done %s utterances, mean UBM log-likelihood is %s over '
                '%s frames', len(feats_collection),
                float(like[:nrows].sum()) / max(nrows, 1), nrows)

    def gaussian_selection_to_post(self, feats_collection, min_post=None, *,
                                   device):
        """Per-frame posteriors over the selected components, on
        ``device``.

        Returns a dict utterance -> (indices [nframes, k], posteriors
        [nframes, k]); posteriors below ``min_post`` are pruned and the
        rest renormalized.
        """
        if not isinstance(self.selection, dict):
            raise ValueError('Gaussian selection has not been done')

        for utt in feats_collection.keys():
            if utt not in self.selection:
                raise ValueError(
                    f'No gselect information for utterance {utt}')
            if (self.selection[utt].shape[0]
                    != feats_collection[utt].nframes):
                raise ValueError(
                    f'Input gselect utterance {utt} has wrong size '
                    f'{self.selection[utt].shape[0]} vs '
                    f'{feats_collection[utt].nframes}')

        names, counts, flat, nrows = self._flat_frames(feats_collection)
        num_sel = self.selection[names[0]].shape[1]
        idx_flat = np.zeros((flat.shape[0], num_sel), dtype=np.int32)
        offset = 0
        for name, count in zip(names, counts):
            idx_flat[offset:offset + count] = self.selection[name]
            offset += count
        norm, post_flat = gmm_ops.posteriors_preselect(
            torch.as_tensor(flat, dtype=GMM_DTYPE, device=device),
            torch.as_tensor(idx_flat, device=device),
            *self.gmm.as_tensors(device))
        post_flat = post_flat[:nrows].cpu().numpy().astype(np.float64)

        if min_post is not None:
            post_flat = _prune_min_post(post_flat, min_post)

        posteriors = {}
        offset = 0
        for name, count in zip(names, counts):
            posteriors[name] = (
                self.selection[name], post_flat[offset:offset + count])
            offset += count

        if self.log.isEnabledFor(10):  # logging.DEBUG
            self.log.debug(
                'Overall likelihood per frame is %s over %s frames',
                float(norm[:nrows].sum()) / max(nrows, 1), nrows)
        return posteriors

    def accumulate(self, feats_collection, weights_collection=None,
                   njobs=1, *, device):
        """Accumulate EM statistics over a features collection, on
        ``device``. Returns (occupancy, mean_acc, var_acc) float64
        numpy arrays. ``njobs`` has no effect: it keeps the JAX
        package's signature, and the features are in memory, nothing
        is decoded."""
        if not isinstance(self.gmm, DiagGmm):
            raise TypeError('GMM not initialized')

        dim = self.gmm.dim()
        for utt, feats in feats_collection.items():
            if feats.ndims != dim:
                raise ValueError(
                    f'Features from utterance {utt} have wrong'
                    f' dims {feats.ndims}, instead of {dim}')

        if weights_collection is not None:
            if weights_collection.keys() != feats_collection.keys():
                raise ValueError(
                    'Keys differ between weights and features collections')
            for utt, weights in weights_collection.items():
                if weights.shape[0] != feats_collection[utt].nframes:
                    raise ValueError(
                        f'Wrong size for weights on utterance {utt}')

        names, counts, flat, nrows = self._flat_frames(feats_collection)
        flat_weights = np.zeros(flat.shape[0], dtype=np.float32)
        offset = 0
        for name, count in zip(names, counts):
            flat_weights[offset:offset + count] = (
                1.0 if weights_collection is None else np.asarray(
                    weights_collection[name], dtype=np.float32))
            offset += count

        like, occ, mean_acc, var_acc = gmm_ops.accumulate_stats(
            torch.as_tensor(flat, dtype=GMM_DTYPE, device=device),
            torch.as_tensor(flat_weights, dtype=GMM_DTYPE, device=device),
            *self.gmm.as_tensors(device))
        if self.log.isEnabledFor(10):  # logging.DEBUG
            tot_weight = float(flat_weights.sum())
            self.log.debug(
                'Overall likelihood per frame = %s over %s weighted '
                'frames', float(like) / max(tot_weight, 1e-10), tot_weight)
        return tuple(a.cpu().numpy().astype(np.float64)
                     for a in (occ, mean_acc, var_acc))

    def estimate(self, gmm_accs, mixup=None, perturb_factor=0.01):
        """Re-estimate the GMM from accumulated statistics (host)."""
        if not isinstance(self.gmm, DiagGmm):
            raise TypeError('GMM not initialized')
        if mixup is not None and mixup <= self.num_gauss:
            raise ValueError(
                'Mixup parameter must be greater than the number of '
                'gaussians')

        occ, mean_acc, var_acc = gmm_accs
        new = gmm_ops.mle_update(
            occ, mean_acc, var_acc, self.gmm.weights, self.gmm.means,
            self.gmm.inv_vars,
            min_gaussian_weight=self._min_gaussian_weight,
            remove_low_count_gaussians=self._remove_low_count_gaussians)
        self.gmm = DiagGmm(*new)

        if mixup is not None:
            self.gmm = DiagGmm(*gmm_ops.split_gmm(
                self.gmm.weights, self.gmm.means, self.gmm.inv_vars,
                int(mixup), perturb_factor, self._rng))

    def _staged_frontend(self, utterances, device, generator, njobs):
        """The staged front-end (extraction, VAD, sliding CMVN as
        separate corpus sweeps) for the configurations the fused one
        does not cover; initializes the GMM and returns the
        device-resident (flat feats [N, D], 0/1 weights [N]) of the
        main EM."""
        cmvn_config = self.features.pop('sliding_window_cmvn', None)
        try:
            raw_features = pipeline.extract_features(
                self.features, utterances, njobs=njobs, device=device,
                generator=generator, log=null_logger())
        finally:
            if cmvn_config is not None:
                self.features['sliding_window_cmvn'] = cmvn_config

        vad = {
            utt: decision.data.reshape(-1).astype(bool)
            for utt, decision in VadPostProcessor(**self.vad).process_all(
                raw_features, device=device).items()}
        if cmvn_config is not None:
            features = SlidingWindowCmvnPostProcessor(
                **cmvn_config).process_all(raw_features, device=device)
        else:
            features = raw_features
        features = features.trim(vad)

        self.initialize_gmm(features, device=device)
        features = FeaturesCollection({
            utt: feats.copy(subsample=self.subsample)
            for utt, feats in features.items()})
        _, _, flat, nrows = self._flat_frames(features)
        flat_weights = np.zeros(flat.shape[0], dtype=np.float32)
        flat_weights[:nrows] = 1.0
        return (torch.as_tensor(flat, dtype=GMM_DTYPE, device=device),
                torch.as_tensor(flat_weights, dtype=GMM_DTYPE, device=device))

    def process(self, utterances, njobs=1, *, device, generator=None):
        """Train the UBM-GMM on the given utterances, on ``device``.

        Extracts the configured features (MFCC + delta + sliding CMVN),
        trims them with the energy VAD, initializes the model and runs
        ``num_iters`` EM iterations. ``njobs`` bounds the decode of the
        audio that the native loader does not read. ``generator`` is
        the source of the MFCC dither, on ``device``.
        """
        self.log.info('Training UBM using %s jobs', njobs)
        signal_cache = getattr(self, '_signal_cache', None)
        with torch.profiler.record_function('ubm.frontend'):
            front = stream_frontend(
                self.features, self.vad, self.subsample, utterances,
                njobs=njobs, device=device, generator=generator,
                signal_cache=signal_cache)
        if front is not None:
            flat, w_init, weights_dev = (
                t.to(GMM_DTYPE) for t in front[:3])
            num_read, layout = front[3:]
            front = (flat, w_init, weights_dev, num_read, layout)
            if getattr(self, '_retain_frontend', False):
                # a VTLN trainer with the same feature configuration
                # reuses this pass instead of streaming the corpus again
                self._frontend_result = front
            with torch.profiler.record_function('ubm.init'):
                self.initialize_gmm_device(flat, w_init, num_read)
            feats_dev = flat
        else:
            with torch.profiler.record_function('ubm.frontend'):
                feats_dev, weights_dev = self._staged_frontend(
                    utterances, device, generator, njobs)
        self.log.info('Training for %s iterations', self.num_iters)

        self._main_em(feats_dev, weights_dev)
        self.log.info('Done training UBM.')

    def _main_em(self, feats_dev, weights_dev, em_fn=None,
                 accumulate_fn=None):
        """The ``num_iters`` main EM iterations, under the span
        ``ubm.em``; ``em_fn`` and ``accumulate_fn`` as in
        :meth:`_init_em_loop`."""
        local_em, local_accumulate = self._local_steps(feats_dev, weights_dev)
        em_fn = em_fn or local_em
        accumulate_fn = accumulate_fn or local_accumulate
        with torch.profiler.record_function('ubm.em'):
            params = self.gmm.as_tensors(feats_dev.device)
            if self.num_iters > 0 and self.remove_low_count_gaussians:
                # the final update removes components (a shape change):
                # it runs on the host
                _, *params = em_fn(params, self.num_iters - 1)
                _, occ, mean_acc, var_acc = accumulate_fn(params)
                self.gmm = _gmm_from_tensors(params)
                self.estimate(tuple(
                    a.cpu().numpy().astype(np.float64)
                    for a in (occ, mean_acc, var_acc)))
            elif self.num_iters > 0:
                _, *params = em_fn(params, self.num_iters)
                self.gmm = _gmm_from_tensors(params)


def selected_sums(flat, weights):
    """Float64 host sums and sums of squares [D] of the rows of ``flat``
    under the 0/1 ``weights``, summed on the device."""
    flat64 = flat.to(torch.float64)
    weights64 = weights.to(torch.float64)[:, None]
    return ((flat64 * weights64).sum(dim=0).cpu().numpy(),
            (flat64 * flat64 * weights64).sum(dim=0).cpu().numpy())


def _prune_min_post(post, min_post):
    """The reference's sequential min_post pruning: component ``j`` is
    zeroed when its current, already renormalized, posterior falls
    under ``min_post``, and the frame renormalizes after every
    component. A frame losing all mass puts 1 on its pre-prune argmax.
    Vectorized over frames."""
    post = np.array(post, dtype=np.float64)
    best = post.argmax(axis=1)
    rows = np.arange(post.shape[0])
    for j in range(post.shape[1]):
        post[:, j] = np.where(post[:, j] < min_post, 0.0, post[:, j])
        totals = post.sum(axis=1)
        empty = totals == 0
        if empty.any():
            post[rows[empty], best[empty]] = 1.0
            totals[empty] = 1.0
        post /= totals[:, None]
    return post


def _frontend_processor(features_config, utterances):
    """The MFCC processor and pipeline manager of the fused front-end,
    or None when :func:`stream_frontend` cannot serve this corpus:
    stages beyond MFCC, deltas and sliding CMVN, features other than
    MFCC, several sample rates, or an utterance past
    ``AUTO_CHUNK_FRAMES``."""
    from shennong_tpu_torch.audio import Audio
    from shennong_tpu_torch.utterances import Utterances

    if 'mfcc' not in features_config:
        return None
    if set(features_config) - {'mfcc', 'delta', 'sliding_window_cmvn'}:
        return None
    utterances = list(utterances)
    if not utterances:
        return None
    if len({Audio.scan(utt.audio_file).sample_rate
            for utt in utterances}) != 1:
        return None

    config = {k: copy.deepcopy(v) for k, v in features_config.items()
              if k != 'sliding_window_cmvn'}
    config = pipeline.init_config(config, log=null_logger())
    manager = pipeline.PipelineManager(
        config, Utterances(utterances), log=null_logger())
    proc = manager.make('features', utterances[0])
    limit = proc.AUTO_CHUNK_FRAMES
    if limit and any(
            proc.output_frames(int(utt.duration * float(proc.sample_rate)))
            > limit for utt in utterances):
        return None
    return proc, manager


def fused_frontend_supported(features_config, utterances):
    """True when :func:`stream_frontend` can serve this corpus."""
    return _frontend_processor(features_config, utterances) is not None


def stream_frontend(features_config, vad_params, subsample, utterances,
                    njobs=1, batch_size=64, signal_cache=None, *, device,
                    generator=None):
    """Device-resident GMM-training front-end.

    Streams the corpus and runs
    :func:`shennong_tpu_torch.parallel.fused.ubm_frontend_program` per
    signal batch (MFCC, deltas, energy VAD, sliding CMVN and the
    trim/subsample frame-selection weights), keeping every feature on
    ``device``. Shared by the UBM and the LVTLN trainers. The batches
    come from ``signal_cache`` when one is given, so the later sweeps
    of a training run (warp moments, warped extraction) replay them;
    ``njobs`` bounds the decode of the audio that the native loader
    does not read. Every batch is enqueued before the one host read
    (the voiced count), and the host buffers go back to the stream's
    pool after it.

    Returns None when the configuration needs the staged path (see
    :func:`fused_frontend_supported`), else (flat [N, D], w_init [N],
    w_em [N] -- float32 tensors on ``device``, rows past each
    utterance's frames carrying zero weight -- num_read, the host count
    of voiced frames, and layout, a list of (names, frames_per_row,
    row_offset) mapping each batch's flat rows back to utterances).
    """
    from shennong_tpu_torch.ops.framing import num_frames
    from shennong_tpu_torch.parallel import stream
    from shennong_tpu_torch.parallel.executor import _check_sample_rates
    from shennong_tpu_torch.parallel.fused import ubm_frontend_program
    from shennong_tpu_torch.processor.base import fresh_generator

    found = _frontend_processor(features_config, utterances)
    if found is None:
        return None
    proc, manager = found
    utterances = list(utterances)
    _check_sample_rates(utterances, proc)
    device = torch.device(device)

    delta_order = delta_window = None
    if 'delta' in manager.config:
        dproc = manager.make('delta')
        delta_order, delta_window = dproc.order, dproc.window

    vproc = VadPostProcessor(**vad_params)
    vad_opts = (
        vproc.energy_threshold, vproc.energy_mean_scale,
        vproc.frames_context, vproc.proportion_threshold)

    cmvn_opts = None
    cmvn_config = features_config.get('sliding_window_cmvn')
    if cmvn_config is not None:
        cproc = SlidingWindowCmvnPostProcessor(**cmvn_config)
        cmvn_opts = (
            bool(cproc.center), int(cproc.cmn_window),
            int(cproc.min_window), bool(cproc.normalize_variance))

    mel = torch.as_tensor(
        proc.mel_weights(1.0), dtype=torch.float32, device=device)
    opts = proc.options()
    frame_opts = proc.frame_options()
    if frame_opts.dither != 0 and generator is None:
        generator = fresh_generator(device)

    feats_parts, winit_parts, wem_parts, counts = [], [], [], []
    layout, offset = [], 0
    source = stream.stream_source(
        signal_cache, utterances, batch_size,
        pin_memory=device.type == 'cuda', njobs=njobs)
    uploaded = []
    for names, signals, nsamples, _ in source:
        feats, w_init, w_em, count = ubm_frontend_program(
            signals.to(device, non_blocking=True),
            torch.from_numpy(nsamples).to(device),
            mel, opts, num_frames(signals.shape[1], frame_opts),
            delta_order, delta_window, vad_opts, cmvn_opts, subsample,
            generator=generator)
        frames_per_row = feats.shape[1]
        feats_parts.append(feats.reshape(-1, feats.shape[-1]))
        winit_parts.append(w_init.reshape(-1))
        wem_parts.append(w_em.reshape(-1))
        counts.append(count)
        layout.append((list(names), frames_per_row, offset))
        offset += signals.shape[0] * frames_per_row
        uploaded.append(signals)

    # one host read of the voiced count, after every batch is enqueued
    num_read = int(torch.stack(counts).sum())
    for signals in uploaded:  # their copies ended before the read
        stream.recycle(signals)
    flat = torch.cat(feats_parts, dim=0)
    w_init = torch.cat(winit_parts, dim=0)
    w_em = torch.cat(wem_parts, dim=0)
    nrows = flat.shape[0]
    bucket = bucket_size(max(nrows, 1), minimum=128)
    if bucket > nrows:
        flat = torch.nn.functional.pad(flat, (0, 0, 0, bucket - nrows))
        w_init = torch.nn.functional.pad(w_init, (0, bucket - nrows))
        w_em = torch.nn.functional.pad(w_em, (0, bucket - nrows))
    return flat, w_init, w_em, num_read, layout
