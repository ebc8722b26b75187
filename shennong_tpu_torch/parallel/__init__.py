"""Batched execution of the pipeline's pass 1 on one device, and the
multi-process extraction and training (:mod:`.distributed`).

:class:`BatchExecutor` is exported lazily (PEP 562): the executor
imports the processors, which import this package's other modules.
"""


def __getattr__(name):
    if name == 'BatchExecutor':
        from shennong_tpu_torch.parallel.executor import BatchExecutor
        return BatchExecutor
    raise AttributeError(
        f'module {__name__!r} has no attribute {name!r}')
