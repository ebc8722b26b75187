"""Pipeline stage wiring: config sections -> configured processors.

The stage factory of :class:`shennong_tpu.pipeline_manager.PipelineManager`,
resolving every processor to its counterpart in
:mod:`shennong_tpu_torch`. Processors not yet ported raise.
"""

import importlib

from shennong_tpu.pipeline_manager import PipelineManager as _Reference
from shennong_tpu_torch.ops.postops import accumulate_cmvn_stats

#: the config sections whose processors are ported
PORTED = ('spectrogram', 'filterbank', 'mfcc', 'plp', 'energy',
          'kaldi_pitch', 'kaldi_pitch_post', 'cmvn', 'sliding_window_cmvn',
          'delta', 'vad')


class PipelineManager(_Reference):
    """Builds and wires the processors of one extraction pipeline"""

    @classmethod
    def get_processor_class(cls, name):
        """Import and return the port's processor class ``name``."""
        try:
            module_kind, class_name = cls.valid_processors[name]
        except KeyError:
            raise ValueError(f'invalid processor "{name}"') from None
        if name not in PORTED:
            raise NotImplementedError(
                f'processor "{name}" is not yet ported to '
                'shennong_tpu_torch')
        module_name = cls._processor_modules.get(name, name)
        module = importlib.import_module(
            f'shennong_tpu_torch.{module_kind}.{module_name}')
        return getattr(module, class_name)

    def accumulate_cmvn(self, utterance, features, weights=None):
        """Add one utterance's statistics to its group accumulator."""
        self.cmvn_stats[self.cmvn_key(utterance)] += \
            accumulate_cmvn_stats(features.data, weights=weights)
