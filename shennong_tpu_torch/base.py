"""Base class shared by every processor in shennong_tpu_torch.

Implements the sklearn-style introspectable parameter system of the
reference toolbox (``shennong/base.py``): every processor declares its
parameters as explicit keyword arguments of ``__init__`` and exposes
``get_params()`` / ``set_params()`` with ``__``-separated nesting for
sub-processors.
"""

import abc
import collections
import inspect

from shennong_tpu_torch.logger import get_logger


class BaseProcessor:
    """Root of the processor hierarchy.

    Subclasses must list every tunable parameter as an explicit keyword
    argument in their constructor (no ``*args``/``**kwargs``) so that
    parameters can be discovered by introspection.
    """

    def __init__(self):
        self._logger = get_logger(self.name, level='info')

    def __repr__(self):
        return self.__class__.__name__

    @property
    @abc.abstractmethod
    def name(self):
        """Processor name"""

    @property
    def log(self):
        """The processor's logger"""
        return self._logger

    def set_logger(
            self, level, formatter='%(levelname)s - %(name)s - %(message)s'):
        """Reconfigure the processor's logger level and format."""
        self._logger = get_logger(self.name, level=level, formatter=formatter)

    @classmethod
    def _get_param_names(cls):
        """Introspect the constructor to discover parameter names."""
        # signature introspection costs ~0.5 ms; processors call this
        # once per utterance through get_properties, so cache per
        # class (cls.__dict__, not getattr: a subclass must not
        # inherit its parent's cached names)
        cached = cls.__dict__.get('_param_names_cache')
        if cached is not None:
            return cached

        init = getattr(cls.__init__, 'deprecated_original', cls.__init__)
        if init is object.__init__:  # pragma: nocover
            return []

        signature = inspect.signature(init)
        names = []
        for param in signature.parameters.values():
            if param.name == 'self' or param.kind == param.VAR_KEYWORD:
                continue
            if param.kind == param.VAR_POSITIONAL:
                raise RuntimeError(
                    f'processors must declare their parameters explicitly '
                    f'in __init__ (no varargs), {cls} violates this')
            names.append(param.name)
        cls._param_names_cache = sorted(names)
        return cls._param_names_cache

    def get_params(self, deep=True):
        """Return the processor parameters as a dict name -> value.

        With ``deep=True`` the parameters of nested processors are
        included with ``<name>__<subname>`` keys.
        """
        params = {}
        for name in self._get_param_names():
            value = getattr(self, name, None)
            if deep and hasattr(value, 'get_params'):
                for sub_name, sub_value in value.get_params().items():
                    params[f'{name}__{sub_name}'] = sub_value
            params[name] = value
        return params

    def set_params(self, **params):
        """Update processor parameters, returns ``self``.

        Raises ValueError on any unknown parameter.
        """
        if not params:
            return self

        valid = self.get_params(deep=True)
        nested = collections.defaultdict(dict)
        for key, value in params.items():
            key, delim, sub_key = key.partition('__')
            if key not in valid:
                raise ValueError(
                    f'invalid parameter {key} for processor {self}, '
                    f'check the list of available parameters '
                    f'with `processor.get_params().keys()`.')
            if delim:
                nested[key][sub_key] = value
            else:
                try:
                    setattr(self, key, value)
                except AttributeError:
                    raise ValueError(
                        f'cannot set attribute {key} for {self}') from None
                valid[key] = value

        for key, sub_params in nested.items():
            valid[key].set_params(**sub_params)

        return self
