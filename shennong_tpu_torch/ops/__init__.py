"""Batched PyTorch DSP ops, counterparts of :mod:`shennong_tpu.ops`.

Every function works on padded batches ``[batch, time]`` with explicit
per-utterance sample counts, on whatever device its input tensors lie.
"""
