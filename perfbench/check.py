"""Whether what the timed calls returned is correct: the arithmetic
that every pipeline's harness (:mod:`perfbench.harness`) shares, and the
numbers of the Kaldi pitch pipelines.

Every utterance of every timed call has to come back in the shape its
harness expects (:func:`count_failures`); one that does not counts as
failed. The utterances of a few speakers drawn from the seed, the
longest utterance's speaker among them (:func:`compared_names`), count
as failed where a value is not finite (:func:`count_unfinished`), and
are held against the harness's plain reference. The harness of Kaldi
pitch (:mod:`perfbench.harness.kaldi_pitch`) holds them against the
plain float64 reference (:mod:`perfbench.reference`), which decodes the
same WAV files and works everything out again, by two numbers, each
under its own limit (``perfbench/checks/<workload>.json``):

- ``feat_rms``: every column that carries a configured random draw:
  the front end's (cepstra or PLP cepstra with the log energy, their
  deltas, after CMVN), which carry the dither, and the delta pitch,
  which carries ``delta_pitch_noise_stddev`` (times
  ``delta_pitch_scale``). In each column, the RMS gap between the
  program and the reference without the draw over every compared frame
  of every call, in units of the draw's own RMS reach there (for the
  front end, the reference dithered as the configuration states against
  undithered; for the delta pitch, the noise's standard deviation, which
  is its RMS by construction). The delta pitch is read twice: per frame,
  and with its gap averaged over ``SMOOTH_FRAMES`` frames, against the
  noise's reach shrunk by the root of their count, so that a wrong sign
  or scale, which the noise hides frame by frame, shows. The number is
  the largest of these readings over the columns. A dither of
  1.0 moves the higher cepstra of quiet frames as far as a TF32 or
  bfloat16 rounding does, so the widest gap of a frame cannot tell them
  apart; the rounding reaches every frame, the dither mostly the quiet
  ones, and the RMS does.
- ``pitch_off``: the share of frames whose POV feature or normalized
  log pitch is off the reference's by more than ``PITCH_TOL``. The
  Viterbi's float32 costs pick the neighbouring lag at near-ties (paths
  within 1e-7 of the float64 optimum), and such a frame is off by one
  lag step (0.01 in the normalized log pitch).
"""

import numpy as np

#: columns of the post-processed pitch: POV feature, normalized log
#: pitch, delta pitch
PITCH_COLUMNS = 3
PITCH_TOL = 1e-3
#: the least dither reach (RMS) a column is measured against
SPREAD_FLOOR = 1e-6
#: frames the delta pitch's gap is also averaged over: the noise is
#: drawn anew for every frame and its mean over them shrinks by the
#: root of their count, where a fault of the delta pitch, which follows
#: the smooth pitch contour, stays
SMOOTH_FRAMES = 9


def compared_names(samples, entries, mix, seed):
    """The utterances held against the reference: every utterance of
    ``mix['compared_speakers']`` speakers drawn from the seed, with the
    speaker of the longest utterance."""
    import torch

    speaker_of = {name: speaker for name, _, speaker in entries}
    speakers = sorted(set(speaker_of.values()))
    rng = torch.Generator().manual_seed(int(seed) + 1)
    count = min(int(mix['compared_speakers']), len(speakers))
    chosen = {speakers[i] for i in
              torch.randperm(len(speakers), generator=rng)[:count].tolist()}
    chosen.add(speaker_of[max(samples, key=samples.get)])
    return [name for name, _, speaker in entries if speaker in chosen]


def count_failures(shapes, expected):
    """Utterances of one call's output that are missing (None) or not of
    their ``expected`` shape, both lists in the same order."""
    return sum(shape != want for shape, want in zip(shapes, expected))


def count_unfinished(arrays):
    """Arrays (a dict name -> array) that hold a value that is not
    finite."""
    return sum(not np.isfinite(data).all() for data in arrays.values())


def noise_reach(pitch_options):
    """The RMS of the delta pitch's configured noise."""
    return (float(pitch_options['delta_pitch_noise_stddev'])
            * float(pitch_options['delta_pitch_scale']))


def dither_rms(reference, dithered, front_columns):
    """Per front-end column, the RMS gap between the dithered and the
    undithered reference over the compared frames."""
    squares, frames = np.zeros(front_columns), 0
    for name, ref in reference.items():
        gap = dithered[name][:ref.shape[0], :front_columns] - ref[
            :, :front_columns]
        squares += (gap * gap).sum(axis=0)
        frames += ref.shape[0]
    return np.maximum(np.sqrt(squares / max(frames, 1)), SPREAD_FLOOR)


def moving_sum(column, width):
    """Sums of ``width`` consecutive frames of a column (valid part)."""
    sums = np.concatenate([[0.0], np.cumsum(column)])
    return sums[width:] - sums[:-width]


def numbers(outputs, reference, reach, noise):
    """``feat_rms`` and ``pitch_off`` of the program's ``outputs`` (one
    dict name -> [frames, columns] array per call) against the
    reference without dither or noise, with the dither's RMS ``reach``
    per front-end column and the delta pitch's ``noise``; and the delta
    pitch's two ``feat_rms`` readings, per frame and smoothed."""
    front = reach.shape[0]
    delta = front + PITCH_COLUMNS - 1
    squares, frames, off = np.zeros(front + 1), 0, 0
    smooth, windows = 0.0, 0
    for call in outputs:
        for name, ref in reference.items():
            data = call.get(name)
            if data is None or data.shape != ref.shape:
                continue
            gap = data.astype(np.float64) - ref
            squares[:front] += (gap[:, :front] ** 2).sum(axis=0)
            squares[front] += (gap[:, delta] ** 2).sum()
            if gap.shape[0] >= SMOOTH_FRAMES:
                means = moving_sum(gap[:, delta], SMOOTH_FRAMES) / (
                    SMOOTH_FRAMES)
                smooth += (means ** 2).sum()
                windows += means.shape[0]
            pitch = np.abs(gap[:, front:delta])
            off += int((pitch > PITCH_TOL).any(axis=1).sum())
            frames += ref.shape[0]
    noise = max(noise, SPREAD_FLOOR)
    ratios = np.sqrt(squares / max(frames, 1)) / np.append(reach, noise)
    smoothed = np.sqrt(smooth / max(windows, 1)) / (
        noise / np.sqrt(SMOOTH_FRAMES))
    # a value that is not a number makes the number not a number
    return ({'feat_rms': float(np.max(np.append(ratios, smoothed))),
             'pitch_off': off / max(frames, 1)},
            (float(ratios[front]), float(smoothed)))
