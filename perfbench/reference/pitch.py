"""Vectorised float64 Kaldi pitch and its post-processing in plain torch.

The same arithmetic as the frozen per-frame oracle
(:mod:`perfbench.reference.pitch_oracle`): Kaldi's LinearResample to
the pitch rate, the NCCF at every integer lag, its upsampling to the
geometric lag grid (ArbitraryResample), the Viterbi over the lags with
the whole signal's ballast and a backtrace from the last frame (ties go
to the lowest lag index, as numpy's argmin gives them), and Kaldi's
ProcessPitch (POV feature, POV-weighted normalized log pitch, delta
pitch without its noise).
"""

import math

import numpy as np
import torch

from perfbench.reference.frontend import DTYPE, deltas

#: frames of the NCCF computed in one block (bounds its memory)
NCCF_BLOCK = 16384
#: Viterbi frames a CUDA graph replays at once
GRAPH_STEPS = 128


def _filter(t, cutoff, num_zeros):
    """Kaldi's windowed-sinc resampling filter at times ``t``."""
    width = num_zeros / (2.0 * cutoff)
    window = 0.5 * (1 + torch.cos(2 * math.pi * cutoff / num_zeros * t))
    safe = torch.where(t == 0, torch.ones_like(t), t)
    value = torch.where(
        t == 0, 2 * cutoff * window,
        window * torch.sin(2 * math.pi * cutoff * safe) / (math.pi * safe))
    return torch.where(t.abs() >= width, torch.zeros_like(t), value)


def _ratio(num, den):
    """``num / den``, and 0 where ``den`` is 0 (the oracle's guard)."""
    nonzero = den != 0
    return torch.where(nonzero, num / torch.where(nonzero, den, 1.0), 0.0)


class Pitch:
    """Kaldi pitch at one sample rate from the ``pitch`` section of a
    pipeline configuration (its ``postprocessing`` sub-section drives
    :meth:`post`)."""

    def __init__(self, options, sample_rate, device):
        self.device = device
        self.rate = int(sample_rate)
        self.out_rate = int(float(options['resample_freq']))
        if self.rate % self.out_rate:
            raise ValueError('reference: the pitch rate must divide the '
                             'sample rate')
        self.cutoff = float(options['lowpass_cutoff'])
        self.zeros = int(options['lowpass_filter_width'])
        self.shift = int(self.out_rate * 0.01)
        self.wsize = int(self.out_rate * 0.025)
        max_f0, min_f0 = float(options['max_f0']), float(options['min_f0'])
        self.first_lag = int(math.ceil(self.out_rate / max_f0))
        self.last_lag = int(math.floor(self.out_rate / min_f0))
        self.ballast_factor = float(options['nccf_ballast'])
        delta = float(options['delta_pitch'])

        lags = []
        lag = 1.0 / max_f0
        while lag <= 1.0 / min_f0:
            lags.append(lag)
            lag *= 1 + delta
        self.lags = torch.tensor(lags, dtype=DTYPE, device=device)
        n_meas = self.last_lag + 1 - self.first_lag
        width = int(options['upsample_filter_width'])
        t = self.lags[:, None] - self.first_lag / self.out_rate
        n = torch.arange(n_meas, dtype=DTYPE, device=device)[None, :]
        self.upsample = _filter(
            n / self.out_rate - t, self.out_rate * 0.5, width) / self.out_rate
        soft = float(options['soft_min_f0'])
        self.local_scale = 1.0 - soft * self.lags
        idx = torch.arange(len(lags), dtype=DTYPE, device=device)
        factor = float(options['penalty_factor']) * math.log(1 + delta) ** 2
        self.trans = (idx[:, None] - idx[None, :]) ** 2 * factor

        ratio = self.rate // self.out_rate
        half = int(math.floor(self.zeros / (2.0 * self.cutoff) * self.rate))
        k = torch.arange(-half, half + 1, dtype=DTYPE, device=device)
        self.taps = _filter(k / self.rate, self.cutoff, self.zeros) / self.rate
        self.ratio, self.half = ratio, half

    def num_resampled(self, nsamples):
        """LinearResample's output count with flush, for a source rate
        that is a multiple of the pitch rate."""
        last = nsamples // self.ratio
        if last * self.ratio == nsamples:
            last -= 1
        return last + 1

    def num_frames(self, nsamples):
        n_rs = self.num_resampled(nsamples)
        if n_rs < self.wsize:
            return 0
        return (n_rs - self.wsize) // self.shift + 1

    def resample(self, signal):
        """LinearResample to the pitch rate (input zero outside)."""
        n_out = self.num_resampled(signal.shape[0])
        span = (n_out - 1) * self.ratio + 2 * self.half + 1
        padded = torch.zeros(span, dtype=DTYPE, device=signal.device)
        take = min(signal.shape[0], span - self.half)
        padded[self.half:self.half + take] = signal[:take]
        windows = padded.unfold(0, 2 * self.half + 1, self.ratio)[:n_out]
        return windows @ self.taps

    def nccf(self, rs, nframes):
        """(NCCF with ballast, NCCF without) at the integer lags, each
        [nframes, lags]."""
        mean_square = float((rs * rs).mean() - rs.mean() ** 2)
        ballast = (mean_square * self.wsize) ** 2 * self.ballast_factor
        full = self.wsize + self.last_lag
        padded = torch.cat([rs, torch.zeros(
            full + self.shift, dtype=DTYPE, device=rs.device)])
        pitch, pov = [], []
        for start in range(0, nframes, NCCF_BLOCK):
            stop = min(start + NCCF_BLOCK, nframes)
            span = padded[start * self.shift:(stop - 1) * self.shift + full]
            window = span.unfold(0, full, self.shift)
            window = window - window[:, :self.wsize].mean(
                dim=1, keepdim=True)
            w1 = window[:, :self.wsize]
            w2 = window.unfold(1, self.wsize, 1)[
                :, self.first_lag:self.last_lag + 1]
            e1 = (w1 * w1).sum(dim=1, keepdim=True)
            e2 = (w2 * w2).sum(dim=2)
            inner = torch.einsum('fw,flw->fl', w1, w2)
            prod = e1 * e2
            pitch.append(_ratio(inner, torch.sqrt(prod + ballast)))
            pov.append(_ratio(inner, torch.sqrt(prod)))
        return torch.cat(pitch), torch.cat(pov)

    def terms(self, signal):
        """(local costs [F, L], NCCF for the POV [F, L]) of a 1-D float64
        signal at the source rate."""
        rs = self.resample(signal)
        nframes = self.num_frames(signal.shape[0])
        pitch, pov = self.nccf(rs, nframes)
        local = 1.0 - (pitch @ self.upsample.T) * self.local_scale
        return local, pov @ self.upsample.T

    def _step(self, forward, local, back, best_lag):
        """One Viterbi frame over a batch, in place: the best previous
        lag of each lag into ``back``, the normalized forward costs into
        ``forward``, and the best lag so far into ``best_lag``."""
        total = forward[:, :, None] + self.trans
        best, arg = total.min(dim=1)
        step = local + best
        forward.copy_(step - step.min(dim=1, keepdim=True).values)
        back.copy_(arg)
        best_lag.copy_(forward.argmin(dim=1))

    def viterbi(self, locals_):
        """Best lag indices of each of a list of [F_i, L] local costs,
        decoded together: one step over all sequences per frame (a
        shorter sequence's padding frames come after its own last
        frame, whose best lag is kept). On a card the steps replay as
        CUDA graphs of ``GRAPH_STEPS`` frames: the same operations,
        launched at once."""
        count = len(locals_)
        lengths = [x.shape[0] for x in locals_]
        frames = max(lengths)
        nlags = self.lags.shape[0]
        local = torch.zeros(count, frames, nlags, dtype=DTYPE,
                            device=self.device)
        for i, x in enumerate(locals_):
            local[i, :x.shape[0]] = x
        back = torch.zeros(count, frames, nlags, dtype=torch.int16,
                           device=self.device)
        best_lag = torch.zeros(count, frames, dtype=torch.long,
                               device=self.device)
        forward = local[:, 0].clone()
        best_lag[:, 0] = forward.argmin(dim=1)
        if torch.device(self.device).type == 'cuda' and frames > 1:
            self._graph_steps(local, back, best_lag, forward)
        else:
            for f in range(1, frames):
                self._step(forward, local[:, f], back[:, f], best_lag[:, f])
        back = back.cpu().numpy()
        best_lag = best_lag.cpu().numpy()
        paths = []
        for i, n in enumerate(lengths):
            path = np.empty(n, dtype=np.int64)
            path[n - 1] = best_lag[i, n - 1]
            row = back[i]
            for f in range(n - 1, 0, -1):
                path[f - 1] = row[f, path[f]]
            paths.append(torch.as_tensor(path, device=self.device))
        return paths

    def _graph_steps(self, local, back, best_lag, forward):
        count, frames, nlags = local.shape
        steps = GRAPH_STEPS
        window = torch.zeros(count, steps, nlags, dtype=DTYPE,
                             device=self.device)
        back_out = torch.zeros(count, steps, nlags, dtype=torch.int16,
                               device=self.device)
        best_out = torch.zeros(count, steps, dtype=torch.long,
                               device=self.device)
        # warm the operations on a side stream before the capture, on
        # copies: the capture itself runs nothing
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            scratch = forward.clone()
            for k in range(2):
                self._step(scratch, window[:, k], back_out[:, k],
                           best_out[:, k])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for k in range(steps):
                self._step(forward, window[:, k], back_out[:, k],
                           best_out[:, k])
        for start in range(1, frames, steps):
            take = min(steps, frames - start)
            window.zero_()
            window[:, :take] = local[:, start:start + take]
            graph.replay()
            back[:, start:start + take] = back_out[:, :take]
            best_lag[:, start:start + take] = best_out[:, :take]
        torch.cuda.synchronize()
        del graph

    def raw(self, signals):
        """Kaldi's raw pitch [F, 2] (NCCF for the POV, pitch in Hz) of
        each 1-D float64 signal of a list."""
        terms = [self.terms(s) for s in signals]
        paths = self.viterbi([local for local, _ in terms])
        return [
            torch.stack([pov[torch.arange(len(path)), path],
                         1.0 / self.lags[path]], dim=1)
            for (_, pov), path in zip(terms, paths)]


def nccf_to_pov(n):
    nd = torch.clamp_max(n.abs(), 1.0)
    r = (-5.2 + 5.4 * torch.exp(7.5 * (nd - 1)) + 4.8 * nd
         - 2.0 * torch.exp(-10 * nd) + 4.2 * torch.exp(20 * (nd - 1)))
    return 1.0 / (1 + torch.exp(-r))


def post(raw, options):
    """Kaldi's ProcessPitch of a raw [F, 2] pitch, with no noise on the
    delta pitch: [F, columns] in the oracle's column order."""
    if int(options['delay']) or options['add_raw_log_pitch']:
        raise ValueError('reference: delay and the raw log pitch are not '
                         'implemented')
    nccf, pitch = raw[:, 0], raw[:, 1]
    log_pitch = torch.log(pitch)
    nframes = raw.shape[0]
    cols = []
    if options['add_pov_feature']:
        n = torch.clamp(nccf, -1, 1)
        cols.append(float(options['pov_scale']) * (
            (1.0001 - n) ** 0.15 - 1.0) + float(options['pov_offset']))
    if options['add_normalized_log_pitch']:
        pov = nccf_to_pov(nccf)
        left = int(options['normalization_left_context'])
        right = int(options['normalization_right_context'])
        zero = torch.zeros(1, dtype=DTYPE, device=raw.device)
        weighted = torch.cat([zero, torch.cumsum(pov * log_pitch, 0)])
        weights = torch.cat([zero, torch.cumsum(pov, 0)])
        t = torch.arange(nframes, device=raw.device)
        lo = torch.clamp_min(t - left, 0)
        hi = torch.clamp_max(t + right + 1, nframes)
        avg = (weighted[hi] - weighted[lo]) / (weights[hi] - weights[lo])
        cols.append((log_pitch - avg) * float(options['pitch_scale']))
    if options['add_delta_pitch']:
        delta = deltas(log_pitch[:, None], 1, int(options['delta_window']))
        cols.append(delta[:, 1] * float(options['delta_pitch_scale']))
    return torch.stack(cols, dim=1)
