"""Base class for feature post-processors.

Counterpart of :mod:`shennong_tpu.postprocessor.base`: a
post-processor maps Features to Features, appending its own entry to
the provenance metadata chain carried in the properties dict.
"""

import abc

from shennong_tpu_torch.utils import copy_properties
from shennong_tpu_torch.processor.base import FeaturesProcessor


class FeaturesPostProcessor(FeaturesProcessor):
    """Common behavior of the post-processors (Features -> Features)"""

    @abc.abstractmethod
    def process(self, features):
        """Return new features computed from the input ``features``"""

    def get_properties(self, features):
        """Extend the input features' properties with this step.

        The returned dict is a deep copy of the input properties with
        this post-processor's parameters stored under its name and a
        new entry appended to the ``pipeline`` provenance list.
        """
        properties = copy_properties(features.properties)
        properties[self.name] = self.get_params()
        properties.setdefault('pipeline', []).append({
            'name': self.name,
            'columns': [0, self.ndims - 1]})
        return properties
