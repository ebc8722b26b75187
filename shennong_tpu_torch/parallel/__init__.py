"""Batched execution of the pipeline's pass 1 on one device."""
