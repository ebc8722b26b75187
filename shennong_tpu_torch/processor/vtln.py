"""VTLN warp factor estimation (linear VTLN).

Counterpart of :mod:`shennong_tpu.processor.vtln` (the port of Kaldi's
gmm-train-lvtln-special and gmm-global-est-lvtln-trans), on an explicit
``device``. :meth:`VtlnProcessor.process` trains a UBM
(:class:`~shennong_tpu_torch.processor.ubm.DiagUbmProcessor`), fits
the per-class base transforms from warped MFCCs and runs the LVTLN
rounds.

Two bodies, chosen up front as in the JAX package:

- the device body: the UBM's device-resident front-end is reused (or
  streamed again when the feature configurations differ), the
  warp-class moments reduce on the device (span ``vtln.moments``), the
  gaussian selection is one top-k (span ``vtln.gselect``), the base
  transforms are solved on the host in float64 (span ``vtln.solve``)
  and every round runs in
  :func:`shennong_tpu_torch.ops.fmllr.lvtln_rounds` (span
  ``vtln.rounds``);
- the staged body, for a UBM that removes low-count components or
  carries a selection to refine, features other than MFCC, mixed
  sample rates, or an utterance past ``AUTO_CHUNK_FRAMES``: the
  features go through the host between stages, and with component
  removal the rounds run on the host too.

As in the UBM's training, the frames, the gaussian selection, the fMLLR
statistics and the rounds are float64 on the device
(:data:`shennong_tpu_torch.processor.ubm.GMM_DTYPE`); the warp-class
moments stay float32 per batch, merged in float64.
"""

import copy
import os

import numpy as np
import torch
import yaml

from shennong_tpu_torch import pipeline
from shennong_tpu_torch.base import BaseProcessor
from shennong_tpu_torch.features import Features
from shennong_tpu_torch.features_collection import FeaturesCollection
from shennong_tpu_torch.logger import null_logger
from shennong_tpu_torch.ops import gmm as gmm_ops
from shennong_tpu_torch.ops.fmllr import (
    FmllrStats, LinearVtln, compute_mapping_transform, fmllr_stats_groups,
    lvtln_rounds, solve_mapping_from_moments)
from shennong_tpu_torch.ops.framing import bucket_size
from shennong_tpu_torch.postprocessor.cmvn import (
    SlidingWindowCmvnPostProcessor)
from shennong_tpu_torch.postprocessor.vad import VadPostProcessor
from shennong_tpu_torch.processor import ubm as ubm_module
from shennong_tpu_torch.processor.ubm import (
    GMM_DTYPE, DiagGmm, DiagUbmProcessor)


class VtlnProcessor(BaseProcessor):
    """VTLN model"""

    def __init__(self, num_iters=15, min_warp=0.85,
                 max_warp=1.25, warp_step=0.01,
                 logdet_scale=0.0, norm_type='offset',
                 subsample=5, features=None,
                 ubm=None, by_speaker=True):
        super().__init__()

        self.num_iters = num_iters
        self.min_warp = min_warp
        self.max_warp = max_warp
        self.warp_step = warp_step
        self.logdet_scale = logdet_scale
        self.norm_type = norm_type
        self.subsample = subsample
        self.by_speaker = by_speaker

        if features in (None, 'default'):
            config = pipeline.get_default_config('mfcc', with_delta=True)
            config['sliding_window_cmvn'] = (
                SlidingWindowCmvnPostProcessor().get_params())
            config['sliding_window_cmvn']['cmn_window'] = 300
            config['delta']['window'] = 3
            self.features = config
        else:
            self.features = features

        if ubm is None:
            self.ubm = DiagUbmProcessor(64).get_params()
        else:
            self.ubm = ubm

        self.lvtln = None
        self.transforms = None
        self.warps = None

    @property
    def name(self):
        return 'vtln'

    @property
    def num_iters(self):
        """How many LVTLN estimation rounds to run"""
        return self._num_iters

    @num_iters.setter
    def num_iters(self, value):
        self._num_iters = int(value)

    @property
    def min_warp(self):
        """Lower bound of the warp grid"""
        return self._min_warp

    @min_warp.setter
    def min_warp(self, value):
        self._min_warp = float(value)

    @property
    def max_warp(self):
        """Upper bound of the warp grid"""
        return self._max_warp

    @max_warp.setter
    def max_warp(self, value):
        self._max_warp = float(value)

    @property
    def warp_step(self):
        """Spacing between consecutive warp classes"""
        return self._warp_step

    @warp_step.setter
    def warp_step(self, value):
        self._warp_step = float(value)

    @property
    def logdet_scale(self):
        """Weight of the log-determinant in the fMLLR objective"""
        return self._logdet_scale

    @logdet_scale.setter
    def logdet_scale(self, value):
        self._logdet_scale = float(value)

    @property
    def norm_type(self):
        """Secondary fMLLR flavor: ``offset``, ``none`` or ``diag``"""
        return self._norm_type

    @norm_type.setter
    def norm_type(self, value):
        if value not in ['offset', 'none', 'diag']:
            raise ValueError('Invalid norm type {}'.format(value))
        self._norm_type = value

    @property
    def subsample(self):
        """Frame subsampling factor while fitting the base transforms"""
        return self._subsample

    @subsample.setter
    def subsample(self, value):
        self._subsample = int(value)

    @property
    def by_speaker(self):
        """Whether warps are shared per speaker or kept per utterance"""
        return self._by_speaker

    @by_speaker.setter
    def by_speaker(self, value):
        self._by_speaker = bool(value)

    @property
    def features(self):
        """Configuration dict of the MFCC features used internally"""
        return self._features

    @features.setter
    def features(self, value):
        if not isinstance(value, dict):
            raise TypeError(
                'Features extraction configuration must be a dict')
        if 'mfcc' not in value:
            raise ValueError('Need mfcc features to train VTLN model')
        self._features = copy.deepcopy(value)

    @property
    def ubm(self):
        "Diagonal UBM-GMM configuration"
        return self._ubm

    @ubm.setter
    def ubm(self, value):
        if not isinstance(value, dict):
            raise TypeError('UBM configuration must be a dict')
        ubm_keys = DiagUbmProcessor(2).get_params().keys()
        if not value.keys() <= ubm_keys:
            raise ValueError('Unknown parameters given for UBM config')
        self._ubm = copy.deepcopy(value)

    @classmethod
    def load(cls, path):
        """Load LVTLN transforms: this port's or the JAX package's npz,
        or Kaldi's binary LinearVtln (sniffed from the file header)."""
        if not os.path.isfile(path):
            raise OSError('{}: file not found'.format(path))

        from shennong_tpu_torch import kaldiio
        vtln = VtlnProcessor()
        if kaldiio.is_kaldi_binary(path):
            transforms, warps, default_class = kaldiio.read_lvtln(path)
            vtln.lvtln = LinearVtln(
                transforms.shape[1], transforms.shape[0], int(default_class))
            vtln.lvtln.transforms = transforms
            vtln.lvtln.warps = warps
        else:
            vtln.lvtln = LinearVtln.load(path)
        return vtln

    def save(self, path):
        """Save the LVTLN transforms to an npz checkpoint"""
        if os.path.isfile(path):
            raise OSError('{}: file already exists'.format(path))
        if not isinstance(self.lvtln, LinearVtln):
            raise TypeError('VTLN not initialized')
        self.lvtln.save(path)

    def save_kaldi(self, path):
        """Save the LVTLN in Kaldi's binary LinearVtln format."""
        if os.path.isfile(path):
            raise OSError('{}: file already exists'.format(path))
        if not isinstance(self.lvtln, LinearVtln):
            raise TypeError('VTLN not initialized')
        from shennong_tpu_torch import kaldiio
        kaldiio.write_lvtln(
            path, self.lvtln.transforms, self.lvtln.warps,
            self.lvtln.default_class)

    @classmethod
    def load_warps(cls, path):
        """Load precomputed warps from a YAML file"""
        if not os.path.isfile(path):
            raise OSError('{}: file not found'.format(path))
        try:
            with open(path, 'r') as fp:
                return yaml.load(fp, Loader=yaml.FullLoader)
        except yaml.YAMLError as err:  # pragma: nocover
            raise ValueError(
                'Error in VTLN warps file when loading: {}'.format(err))

    def save_warps(self, path):
        """Save the computed warps to a YAML file"""
        if os.path.isfile(path):
            raise OSError('{}: file already exists'.format(path))
        if not isinstance(self.warps, dict):
            raise TypeError('Warps not computed')
        with open(path, 'w') as fp:
            yaml.dump(self.warps, fp)

    def compute_mapping_transform(
            self, feats_untransformed, feats_transformed,
            class_idx, warp, weights=None):
        """Fit one warp class as the least-squares map from unwarped to
        warped features (with per-dimension variance normalization)."""
        if not isinstance(self.lvtln, LinearVtln):
            raise TypeError('VTLN not initialized')
        dim = self.lvtln.dim

        def pairs():
            for utt in feats_untransformed:
                if utt not in feats_transformed:
                    raise ValueError(
                        f'No transformed features for key {utt}')
                x = feats_untransformed[utt].data
                y = feats_transformed[utt].data
                if x.shape != y.shape or x.shape[1] != dim:
                    raise ValueError(
                        'Number of rows and/or columns differs: '
                        f'{x.shape[0]} vs {y.shape[0]} rows, '
                        f'{x.shape[1]} vs {y.shape[1]} columns, '
                        f'{dim} dim')
                w = None
                if weights is not None:
                    if utt not in weights:
                        raise ValueError(f'No weights for utterance {utt}')
                    w = weights[utt]
                yield x, y, w

        self.lvtln.set_transform(
            class_idx, compute_mapping_transform(pairs(), dim))
        self.lvtln.set_warp(class_idx, warp)

    def _accumulate_group_stats(self, ubm, feats_collection, posteriors,
                                groups, chunk_frames=16384, *, device):
        """fMLLR statistics of every speaker group, on ``device``.

        The frames of all utterances, with a group index per frame, go
        through :func:`shennong_tpu_torch.ops.fmllr.fmllr_stats_groups`
        in bounded chunks; the chunk statistics are summed in float64
        like Kaldi's double-precision ``AffineXformStats``.
        """
        group_names = sorted(groups)
        group_index = {name: i for i, name in enumerate(group_names)}

        feats_list, idx_list, val_list, gid_list = [], [], [], []
        for group in group_names:
            for utt in groups[group]:
                if utt not in posteriors:
                    raise ValueError(f'No posterior for utterance {utt}')
                feats = feats_collection[utt].data
                indices, values = posteriors[utt]
                if indices.shape[0] != feats.shape[0]:
                    raise ValueError(
                        f'Posterior has wrong size {indices.shape[0]}'
                        f' vs {feats.shape[0]}')
                feats_list.append(feats)
                idx_list.append(indices)
                val_list.append(values)
                gid_list.append(np.full(
                    feats.shape[0], group_index[group], dtype=np.int32))

        dim = self.lvtln.dim
        out = {name: FmllrStats(dim) for name in group_names}
        if not feats_list:
            return out
        feats_all = np.concatenate(feats_list).astype(np.float64)
        idx_all = np.concatenate(idx_list).astype(np.int32)
        val_all = np.concatenate(val_list).astype(np.float64)
        gid_all = np.concatenate(gid_list)
        _, means, inv_vars = ubm.gmm.as_tensors(device)

        def padded(array, rows, bucket):
            out = np.zeros((bucket,) + array.shape[1:], dtype=array.dtype)
            out[:rows] = array
            return torch.as_tensor(out, device=device)

        for start in range(0, feats_all.shape[0], chunk_frames):
            stop = min(start + chunk_frames, feats_all.shape[0])
            rows = stop - start
            bucket = bucket_size(rows, minimum=2048)
            beta, K, G = fmllr_stats_groups(
                *[padded(a[start:stop], rows, bucket)
                  for a in (feats_all, idx_all, val_all, gid_all)],
                means, inv_vars, len(group_names))
            beta, K, G = (a.cpu().numpy().astype(np.float64)
                          for a in (beta, K, G))
            for i, name in enumerate(group_names):
                out[name].beta += beta[i]
                out[name].K += K[i]
                out[name].G += G[i]
        return out

    def estimate(self, ubm, feats_collection, posteriors, utt2speak=None,
                 *, device):
        """Estimate per-speaker (or per-utterance) LVTLN transforms.

        ``posteriors`` maps utterances to (indices, values) from
        :func:`DiagUbmProcessor.gaussian_selection_to_post`. The fMLLR
        statistics accumulate on ``device``, the per-group class solves
        run on the host in float64. Returns (transforms, warps) dicts.
        """
        if not isinstance(self.lvtln, LinearVtln):
            raise TypeError('VTLN not initialized')

        transforms, warps = {}, {}
        tot_impr, tot_count = 0.0, 0.0
        class_counts = np.zeros(self.lvtln.num_classes)

        if utt2speak is not None:
            missing = [
                utt for utt in feats_collection if utt not in utt2speak]
            if missing:
                raise ValueError(
                    'following items are not defined in the '
                    'partition index: {}'.format(', '.join(missing)))
            groups = {}
            for utt, spk in utt2speak.items():
                groups.setdefault(spk, []).append(utt)
        else:
            groups = {utt: [utt] for utt in feats_collection}

        group_stats = self._accumulate_group_stats(
            ubm, feats_collection, posteriors, groups, device=device)

        for group in sorted(groups):
            class_idx, _, transform, objf_impr, count = (
                self.lvtln.compute_transform(
                    group_stats[group], self.norm_type, self.logdet_scale))
            class_counts[class_idx] += 1
            transforms[group] = transform
            warps[group] = self.lvtln.get_warp(class_idx)
            self.log.debug(
                '%s: auxf-impr from LVTLN is %s, over %s frames',
                group, objf_impr / count, count)
            tot_impr += objf_impr
            tot_count += count

        self.log.debug(
            'Distribution of classes is %s, overall LVTLN auxf-impr '
            'per frame is %s over %s frames', class_counts,
            tot_impr / max(tot_count, 1e-10), tot_count)
        return transforms, warps

    def process(self, utterances, ubm=None, group_by='utterance', njobs=1,
                *, device, generator=None):
        """Compute the VTLN warp of each utterance (or speaker) on
        ``device``.

        Trains (or reuses) a UBM-GMM, fits the per-warp base linear
        transforms from warped MFCCs of every warp class, then
        alternates transform estimation and model updates for
        ``num_iters`` rounds. ``njobs`` bounds the decode of the audio
        that the native loader does not read. ``generator`` is the
        source of the MFCC dither, on ``device``. Returns a dict of
        warps keyed by utterance or by speaker according to
        ``group_by``.
        """
        if group_by not in ('utterance', 'speaker'):
            raise ValueError(
                f'group_by must be "utterance" or "speaker", '
                f'it is: {group_by}')
        if group_by == 'speaker' and not self.by_speaker:
            raise ValueError(
                'Asking to group warps by speaker but they are computed '
                'per utterance, please set VtlnProcessor.by_speaker to '
                'True')
        if self.by_speaker and not utterances.has_speakers():
            raise ValueError(
                'Requested speaker based VTLN, but speaker'
                ' information is missing')

        utt2speak = None
        if self.by_speaker:
            utt2speak = {utt.name: utt.speaker for utt in utterances}

        if self.min_warp > self.max_warp:
            raise ValueError(
                f'Min warp > max warp: {self.min_warp} > {self.max_warp}')

        # one signal cache spans every corpus sweep of the training (the
        # UBM front-end, the warp moments), so the audio uploads once
        from shennong_tpu_torch.parallel.stream import SignalCache
        signal_cache = getattr(self, '_signal_cache', None)
        if signal_cache is None:
            signal_cache = SignalCache(device=device)

        if ubm is None:
            ubm = DiagUbmProcessor(**self.ubm)
            ubm.log.setLevel(self.log.getEffectiveLevel())
            ubm._signal_cache = signal_cache
            ubm._retain_frontend = True
            try:
                ubm.process(utterances, njobs=njobs, device=device,
                            generator=generator)
            finally:
                ubm.__dict__.pop('_signal_cache', None)
                ubm.__dict__.pop('_retain_frontend', None)
        else:
            if ubm.gmm is None:
                raise ValueError('Given UBM-GMM has not been trained')
            self.ubm = ubm.get_params()

        self.log.info('Initializing base LVTLN transforms')
        num_classes = int(
            1.5 + (self.max_warp - self.min_warp) / self.warp_step)
        default_class = int(0.5 + (1 - self.min_warp) / self.warp_step)
        self.lvtln = LinearVtln(ubm.gmm.dim(), num_classes, default_class)

        # the UBM's retained front-end is corpus-sized device memory:
        # it is released whichever body runs
        front = ubm.__dict__.pop('_frontend_result', None)
        cmvn_config = self.features.pop('sliding_window_cmvn', None)
        try:
            features_config = copy.deepcopy(self.features)
            if cmvn_config is not None:
                features_config['sliding_window_cmvn'] = cmvn_config
            on_device = (
                not ubm.remove_low_count_gaussians
                and not ubm.selection
                and ubm_module.fused_frontend_supported(
                    features_config, utterances))
            body = self._device_body if on_device else self._staged_body
            body(utterances, ubm, utt2speak, cmvn_config, num_classes,
                 njobs, device=device, generator=generator,
                 signal_cache=signal_cache,
                 front=front if on_device else None)
        finally:
            if cmvn_config is not None:
                self.features['sliding_window_cmvn'] = cmvn_config
        del front

        if self.by_speaker:
            self.transforms = {
                utt: self.transforms[spk] for utt, spk in utt2speak.items()}
            self.warps = {
                utt: self.warps[spk] for utt, spk in utt2speak.items()}

        self.log.info('Done training LVTLN model')
        if group_by == 'utterance':
            return self.warps
        return {spk: self.warps[utts[0].name]
                for spk, utts in utterances.by_speaker().items()}

    def _class_warps(self, num_classes):
        return [self.min_warp + c * self.warp_step
                for c in range(num_classes)]

    def _set_base_transforms(self, moments, class_warps):
        self.log.info(
            'Computing base transforms for %s warp classes (fused device '
            'pass)', len(class_warps))
        with torch.profiler.record_function('vtln.solve'):
            matrices = solve_mapping_from_moments(moments)
        for c, this_warp in enumerate(class_warps):
            self.lvtln.set_transform(c, matrices[c])
            self.lvtln.set_warp(c, this_warp)

    def _device_body(self, utterances, ubm, utt2speak, cmvn_config,
                     num_classes, njobs, *, device, generator,
                     signal_cache, front):
        """Device-resident LVTLN training over the front-end of
        :func:`shennong_tpu_torch.processor.ubm.stream_frontend`: the
        features never reach the host."""
        features_config = copy.deepcopy(self.features)
        if cmvn_config is not None:
            features_config['sliding_window_cmvn'] = cmvn_config
        # the default configuration trains the UBM on exactly these
        # features: reuse its pass instead of streaming the corpus again
        if front is not None and not (
                features_config == ubm.features
                and int(self.subsample) == int(ubm.subsample)):
            front = None
        if front is None:
            with torch.profiler.record_function('ubm.frontend'):
                front = ubm_module.stream_frontend(
                    features_config, ubm.vad, self.subsample, utterances,
                    njobs=njobs, device=device, generator=generator,
                    signal_cache=signal_cache)
        flat, _, w_em, _, layout = front
        flat, w_em = flat.to(GMM_DTYPE), w_em.to(GMM_DTYPE)

        class_warps = self._class_warps(num_classes)
        # per-utterance selection weights for the moment pass (the flat
        # rows map back to utterances through the layout)
        w_host = w_em.cpu().numpy()
        keep = {}
        for names, frames_per_row, offset in layout:
            for row, name in enumerate(names):
                start = offset + row * frames_per_row
                keep[name] = w_host[start:start + frames_per_row]

        moments = pipeline.accumulate_warp_mapping_stats(
            self.features, utterances, class_warps, keep, null_logger(),
            njobs=njobs, device=device, generator=generator,
            signal_cache=signal_cache)
        self._set_base_transforms(moments, class_warps)

        def group_of(name):
            return utt2speak[name] if utt2speak is not None else name

        group_names = sorted(
            {group_of(n) for names, _, _ in layout for n in names})
        gindex = {g: i for i, g in enumerate(group_names)}
        gid = np.zeros(flat.shape[0], dtype=np.int32)
        for names, frames_per_row, offset in layout:
            for row, name in enumerate(names):
                start = offset + row * frames_per_row
                gid[start:start + frames_per_row] = gindex[group_of(name)]
        # batch-padding rows keep gid 0: their weight is zero

        self._check_num_gselect(ubm)
        with torch.profiler.record_function('vtln.gselect'):
            _, gsel = gmm_ops.gaussian_selection(
                flat, *ubm.gmm.as_tensors(device), ubm.num_gselect)
            # ubm.selection as the staged body leaves it: each
            # utterance's selected rows, in time order
            total_rows = flat.shape[0]
            sel_order = torch.argsort(
                torch.arange(total_rows, device=device)
                + (w_em <= 0).to(torch.int64) * total_rows, stable=True)
            num_sel = int(w_host.sum())
            gsel_sel = gsel[sel_order[:num_sel]].cpu().numpy()
        if ubm.selection is None:
            ubm.selection = {}
        cursor = 0
        for names, frames_per_row, offset in layout:
            for row, name in enumerate(names):
                start = offset + row * frames_per_row
                count = int(w_host[start:start + frames_per_row].sum())
                ubm.selection[name] = gsel_sel[cursor:cursor + count]
                cursor += count

        self.log.info(
            'Computing LVTLN transforms (%s iterations)', self.num_iters)
        self._rounds_fused_arrays(
            ubm, flat, w_em, torch.as_tensor(gid, device=device), gsel,
            group_names)

    @staticmethod
    def _check_num_gselect(ubm):
        if ubm.num_gselect > ubm.gmm.num_gauss():
            ubm.log.warning(
                'You asked for %s Gaussians but GMM only has %s,'
                ' returning this many. Note: this means the'
                ' Gaussian selection is pointless',
                ubm.num_gselect, ubm.gmm.num_gauss())
            ubm.num_gselect = ubm.gmm.num_gauss()

    def _staged_body(self, utterances, ubm, utt2speak, cmvn_config,
                     num_classes, njobs, *, device, generator,
                     signal_cache, front):
        """LVTLN training with the features on the host between the
        stages."""
        del front
        raw_mfcc = pipeline.extract_features(
            self.features, utterances, njobs=njobs, device=device,
            generator=generator, log=null_logger())

        vad = {
            utt: decision.data.reshape(-1).astype(bool)
            for utt, decision in VadPostProcessor(**ubm.vad).process_all(
                raw_mfcc, device=device).items()}
        if cmvn_config is not None:
            orig_features = SlidingWindowCmvnPostProcessor(
                **cmvn_config).process_all(raw_mfcc, device=device)
        else:
            orig_features = raw_mfcc
        orig_features = _trim_subsample(orig_features, vad, self.subsample)

        class_warps = self._class_warps(num_classes)
        keep = {}
        for utt, mask in vad.items():
            rank = np.cumsum(mask) - 1
            keep[utt] = (
                mask & (rank % self.subsample == 0)).astype(np.float32)

        moments = pipeline.accumulate_warp_mapping_stats(
            self.features, utterances, class_warps, keep, null_logger(),
            njobs=njobs, device=device, generator=generator,
            signal_cache=signal_cache)
        if moments is not None:
            self._set_base_transforms(moments, class_warps)
        else:
            # mixed sample rates or hour-scale utterances: the warped
            # collections themselves, one least-squares fit per class
            unwarped = _trim_subsample(raw_mfcc, vad, self.subsample)
            warped = pipeline.extract_features_warp_classes(
                self.features, utterances, class_warps, null_logger(),
                njobs=njobs, device=device, generator=generator)
            for c, this_warp in enumerate(class_warps):
                self.compute_mapping_transform(
                    unwarped, _trim_subsample(warped[c], vad, self.subsample),
                    c, this_warp)

        ubm.gaussian_selection(orig_features, device=device)
        self.log.info(
            'Computing LVTLN transforms (%s iterations)', self.num_iters)
        if not ubm.remove_low_count_gaussians:
            self._train_rounds_fused(ubm, orig_features, utt2speak, device)
        else:
            # component removal changes the model's shape between
            # rounds: the rounds run on the host
            self._train_rounds_host(ubm, orig_features, utt2speak, device)

    def _train_rounds_fused(self, ubm, orig_features, utt2speak, device):
        """All ``num_iters`` LVTLN rounds on the device, from host
        features (:func:`shennong_tpu_torch.ops.fmllr.lvtln_rounds`)."""
        if utt2speak is not None:
            groups = {}
            for utt, spk in utt2speak.items():
                groups.setdefault(spk, []).append(utt)
        else:
            groups = {utt: [utt] for utt in orig_features}
        group_names = sorted(groups)
        gindex = {name: i for i, name in enumerate(group_names)}

        feats_list, gid_list, sel_list = [], [], []
        for group in group_names:
            for utt in groups[group]:
                data = orig_features[utt].data
                sel = np.asarray(ubm.selection[utt])
                if sel.shape[0] != data.shape[0]:
                    raise ValueError(
                        f'Input gselect utterance {utt} has wrong size')
                feats_list.append(data)
                gid_list.append(np.full(
                    data.shape[0], gindex[group], dtype=np.int32))
                sel_list.append(sel)

        feats_all = np.concatenate(feats_list)
        nrows = feats_all.shape[0]
        bucket = bucket_size(nrows, minimum=2048)

        def padded(array, dtype):
            out = np.zeros((bucket,) + array.shape[1:], dtype=dtype)
            out[:nrows] = array
            return torch.as_tensor(out, device=device)

        self._rounds_fused_arrays(
            ubm, padded(feats_all, np.float64),
            padded(np.ones(nrows), np.float64),
            padded(np.concatenate(gid_list), np.int32),
            padded(np.concatenate(sel_list), np.int32), group_names)

    def _rounds_fused_arrays(self, ubm, feats, fweights, gid, gsel,
                             group_names, rounds=None):
        """Run the LVTLN rounds on prepared flat device tensors (rows
        with zero weight inert), under the span ``vtln.rounds``; sets
        ``self.transforms``/``self.warps`` per group and updates the
        UBM, like the host rounds. ``rounds`` replaces
        :func:`~shennong_tpu_torch.ops.fmllr.lvtln_rounds` at this
        processor's settings: the multi-process trainer passes
        :func:`shennong_tpu_torch.parallel.fused.make_lvtln_train_steps`'s
        rounds, with the same arguments."""
        device = feats.device
        if rounds is None:
            def rounds(*args):
                return lvtln_rounds(
                    *args, num_groups=len(group_names),
                    num_iters=self.num_iters, norm_type=self.norm_type,
                    logdet_scale=self.logdet_scale,
                    default_class=self.lvtln.default_class,
                    min_gaussian_weight=ubm.min_gaussian_weight)
        with torch.profiler.record_function('vtln.rounds'):
            out = rounds(
                feats, fweights, gid, gsel,
                torch.as_tensor(self.lvtln.transforms, dtype=GMM_DTYPE,
                                device=device),
                torch.as_tensor(self.lvtln.warps, dtype=GMM_DTYPE,
                                device=device),
                *ubm.gmm.as_tensors(device))
            (gmm_w, gmm_m, gmm_iv, transforms, _, best, impr, beta) = (
                o.cpu().numpy() for o in out)

        ubm.gmm = DiagGmm(
            gmm_w.astype(np.float64), gmm_m.astype(np.float64),
            gmm_iv.astype(np.float64))
        self.transforms = {
            name: transforms[i].astype(np.float64)
            for i, name in enumerate(group_names)}
        # warps come back through the class index, not a float32 round
        # trip (0.95 must stay exactly 0.95)
        self.warps = {
            name: float(self.lvtln.warps[best[i]])
            for i, name in enumerate(group_names)}
        self.log.debug(
            'Distribution of classes is %s, overall LVTLN auxf-impr per '
            'frame is %s over %s frames',
            np.bincount(best, minlength=self.lvtln.num_classes),
            impr.sum() / max(beta.sum(), 1e-10), beta.sum())

    def _train_rounds_host(self, ubm, orig_features, utt2speak, device):
        """Host-orchestrated LVTLN rounds (a UBM whose component count
        changes between rounds)."""
        posteriors = ubm.gaussian_selection_to_post(
            orig_features, device=device)
        self.transforms, self.warps = self.estimate(
            ubm, orig_features, posteriors, utt2speak, device=device)

        for i in range(self.num_iters):
            self.log.debug(
                'Updating model on pass %s/%s', i + 1, self.num_iters)
            features = FeaturesCollection()
            for utt, feats in orig_features.items():
                key = utt if utt2speak is None else utt2speak[utt]
                linear = self.transforms[key][:, :feats.ndims]
                offset = self.transforms[key][:, feats.ndims]
                features[utt] = Features(
                    feats.data @ linear.T + offset, feats.times,
                    feats.properties)

            ubm.estimate(ubm.accumulate(features, device=device))
            posteriors = ubm.gaussian_selection_to_post(
                features, device=device)
            self.transforms, self.warps = self.estimate(
                ubm, orig_features, posteriors, utt2speak, device=device)


def _trim_subsample(collection, vad, subsample):
    """The voiced frames of each utterance, then every
    ``subsample``-th of them."""
    return FeaturesCollection({
        utt: feats.copy(subsample=subsample)
        for utt, feats in collection.trim(vad).items()})
