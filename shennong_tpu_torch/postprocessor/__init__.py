"""Feature post-processors (Features -> Features)."""

from shennong_tpu_torch.postprocessor.cmvn import (
    CmvnPostProcessor, SlidingWindowCmvnPostProcessor, apply_cmvn)
from shennong_tpu_torch.postprocessor.delta import DeltaPostProcessor
from shennong_tpu_torch.postprocessor.vad import VadPostProcessor
