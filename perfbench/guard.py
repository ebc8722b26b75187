"""The benchmark loads neither JAX nor the JAX package it was ported
from: a module counts by its top-level name (the part before the first
dot), compared whole, so ``shennong_tpu_torch`` is the port and
``shennong_tpu`` is not."""

import sys

FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'shennong_tpu'})


def loaded(forbidden=FORBIDDEN, modules=None):
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({name.split('.', 1)[0] for name in names}
                  & set(forbidden))
