"""Window functions (numpy, host-side API).

Counterpart of :mod:`shennong_tpu.window`; the formulas live in
:func:`shennong_tpu_torch.ops.framing.window_function` (shared with
the processors' framing).
"""

import numpy as np

from shennong_tpu_torch.ops.framing import WINDOW_TYPES, window_function


def types():
    """The supported window function names, sorted"""
    return sorted(WINDOW_TYPES)


def window(length, type='povey', blackman_coeff=0.42):
    """Return a window of the given ``type`` and ``length`` in samples.

    Raises ValueError on unknown type or non-positive length. As in
    the reference, degenerate lengths (1, or 2 for the types whose
    formula would yield all zeros) return an all-ones window.
    """
    if int(length) <= 0:
        raise ValueError(
            'length must be strictly positive but is {}'.format(length))

    if type not in types():
        raise ValueError(
            'type must be in {} but is {}'.format(types(), type))

    if length == 1:
        return np.ones((1,))
    if length == 2 and type in ('povey', 'blackman', 'hanning'):
        return np.ones((2,))

    # copy: window_function's return value is lru_cached and shared
    # with the processors' framing — in-place mutation by a caller must
    # not poison it
    return window_function(
        type, int(length), float(blackman_coeff)).copy()
