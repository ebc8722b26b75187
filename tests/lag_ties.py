"""Proof that two pitch tracks of one long signal differ only at ties.

For signals too long for the float64 oracle of tests/pitch_oracle.py
(its resample and NCCF are Python loops): the Viterbi local costs of
the port's whole-signal program, promoted to float64, give the exact
cost of the best complete path through every (frame, lag). A lag
decision that differs between two tracks is a tie when the best path
forced through it costs within ``margin`` of the optimum, the test
tests/pitch_oracle.py applies with its own costs.

Imports no JAX: ``chip_smoke.py`` uses it on the card.
"""

import numpy as np
import torch

from shennong_tpu_torch.ops import pitch, resample


def whole_signal_costs(signal, opts, device):
    """[F, L] float64 local costs of ``signal`` (1-D int16-range numpy)
    as the whole-signal program computes them on ``device``."""
    signal = np.asarray(signal, dtype=np.float32)
    nframes = pitch.num_pitch_frames(signal.shape[0], opts)
    # bit-equal to the whole-signal resample (one filter phase), as is
    # the float64 mean square
    resampled = resample.linear_resample_chunked(
        signal, opts.sample_rate, opts.resample_freq, opts.lowpass_cutoff,
        opts.lowpass_filter_width, device=device)
    mean = resampled.sum(dtype=np.float64) / resampled.shape[0]
    mean_square = (np.einsum('i,i->', resampled, resampled, dtype=np.float64)
                   / resampled.shape[0] - mean * mean)
    local_cost, _, _, _ = pitch.nccf_costs(
        torch.as_tensor(resampled, device=device)[None],
        torch.tensor([mean_square], dtype=torch.float32, device=device),
        opts, nframes)
    return local_cost[0].to(torch.float64)


def path_margins(local_cost, factor, chosen):
    """For each frame f, the cost of the best complete path through
    (f, chosen[f]) minus the cost of the best path ([F] float64)."""
    nframes, nlags = local_cost.shape
    index = torch.arange(nlags, dtype=torch.float64, device=local_cost.device)
    trans = factor * (index[:, None] - index[None, :]) ** 2
    fwd = torch.empty_like(local_cost)
    fwd[0] = local_cost[0]
    for f in range(1, nframes):
        fwd[f] = local_cost[f] + (fwd[f - 1][:, None] + trans).amin(0)
    bwd = torch.zeros_like(local_cost)
    for f in range(nframes - 2, -1, -1):
        bwd[f] = (trans + (local_cost[f + 1] + bwd[f + 1])[None]).amin(1)
    total = fwd + bwd
    chosen = torch.as_tensor(chosen, device=local_cost.device)
    return (total[torch.arange(nframes, device=total.device), chosen]
            - total.amin(1))


def assert_ties(signal, opts, ours, ref, device, margin=1e-4):
    """Assert that ``ours`` and ``ref`` ([F, 2] (NCCF, pitch)) differ
    only at lag decisions that are ties of the whole-signal program's
    costs, and that their NCCF agree where their lags do.

    Returns (frames whose lags differ, their largest margin, NCCF
    max-abs where the lags agree).
    """
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    same = np.isclose(ours[:, 1], ref[:, 1], rtol=1e-4)
    worst = 0.0
    if not same.all():
        costs = whole_signal_costs(signal, opts, device)
        lags = pitch.select_lags(opts.min_f0, opts.max_f0, opts.delta_pitch)
        chosen = np.abs(lags[None, :] - 1.0 / ours[:, 1][:, None]).argmin(1)
        margins = path_margins(
            costs, pitch.inter_frame_factor(opts), chosen).cpu().numpy()
        worst = float(margins[~same].max())
        assert worst < margin, (int((~same).sum()), worst)
    nccf = float(np.abs(ours[same, 0] - ref[same, 0]).max())
    assert nccf < 1e-3, nccf
    return int((~same).sum()), worst, nccf
