"""Logging helpers for shennong_tpu_torch.

Mirrors the logging surface of the reference toolbox
(``shennong/logger.py``): named stderr loggers with a controllable
level, plus a null logger used as the silent default by library code.
"""

import logging
import sys

_LEVELS = {
    'debug': logging.DEBUG,
    'info': logging.INFO,
    'warning': logging.WARNING,
    'error': logging.ERROR,
}

_DEFAULT_FORMAT = '%(levelname)s - %(name)s - %(message)s'


def null_logger(name='null'):
    """Return a logger that swallows every message."""
    logger = logging.getLogger(name)
    logger.handlers = []
    logger.addHandler(logging.NullHandler())
    return logger


def get_logger(name, level, formatter=_DEFAULT_FORMAT):
    """Return a logger writing to stderr at the requested ``level``.

    ``level`` must be one of 'debug', 'info', 'warning' or 'error',
    otherwise a ValueError is raised.
    """
    if level not in _LEVELS:
        raise ValueError(
            'invalid logging level "{}", must be in {}'.format(
                level, ', '.join(_LEVELS)))

    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(formatter))

    logger = logging.getLogger(name)
    logger.handlers = []
    logger.addHandler(handler)
    logger.setLevel(_LEVELS[level])
    return logger
