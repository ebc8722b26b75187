"""Feature-quality evaluation: ABX phone discriminability.

Counterpart of :mod:`shennong_tpu.eval`: an in-framework ABX evaluator
(batched DTW divergences on the device, machine-ABX scoring on the
host) and its seeded synthetic benchmark (:mod:`.abx_bench`).
"""

from shennong_tpu_torch.eval.abx import (  # noqa: F401
    abx_error, dtw_divergences, pairwise_distances,
    segments_from_alignment)
