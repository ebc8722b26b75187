"""Small utilities shared across shennong_tpu_torch.

The port's own copy of the host helpers of ``shennong_tpu/utils.py``
that it calls: njobs clamping, properties copies, numpy-aware dict
comparison, file listing, a CLI exception guard and a numpy-aware JSON
codec for the serializers' sidecars.
"""

import json
import multiprocessing
import os
import re
import sys

import numpy as np

from shennong_tpu_torch.logger import null_logger


def get_njobs(njobs=None, log=null_logger()):
    """Clamp a requested number of jobs to the machine's CPU count.

    Raises ValueError if ``njobs`` is not strictly positive. ``None``
    selects the number of available cores.
    """
    ncpus = multiprocessing.cpu_count()
    if njobs is None:
        return ncpus
    if njobs <= 0:
        raise ValueError(
            'njobs must be strictly positive, it is {}'.format(njobs))
    if njobs > ncpus:
        log.warning(
            'asking %d CPU cores but reducing to %d (max available)',
            njobs, ncpus)
        return ncpus
    return njobs


def copy_properties(obj):
    """Independent copy of a features ``properties`` structure.

    Semantically ``copy.deepcopy`` for the data that properties
    actually hold — nested dicts/lists/tuples of scalars, strings and
    numpy values — at a fraction of the cost (deepcopy's memo
    bookkeeping dominates on these small acyclic trees, and it copies
    immutable numpy generics member by member). Properties are cloned
    once per utterance per post-processor, so this is on the corpus
    hot path.
    """
    if isinstance(obj, dict):
        return {key: copy_properties(val) for key, val in obj.items()}
    if isinstance(obj, list):
        return [copy_properties(val) for val in obj]
    if isinstance(obj, tuple):
        return tuple(copy_properties(val) for val in obj)
    if isinstance(obj, np.ndarray):
        return obj.copy()
    # scalars, strings, numpy generics: immutable, safe to share
    return obj


def list2array(seq):
    """Recursively convert lists into numpy arrays."""
    if isinstance(seq, list):
        return np.asarray(seq)
    if isinstance(seq, dict):
        return {k: list2array(v) for k, v in seq.items()}
    return seq


def array2list(seq):
    """Recursively convert numpy arrays into plain lists."""
    if isinstance(seq, dict):
        return {k: array2list(v) for k, v in seq.items()}
    if isinstance(seq, np.ndarray):
        return seq.tolist()
    return seq


def dict_equal(dict1, dict2):
    """Compare two (possibly numpy-containing) dictionaries."""
    return array2list(dict1) == array2list(dict2)


def list_files_with_extension(
        directory, extension, abspath=False, realpath=True, recursive=True):
    """Return the sorted files below ``directory`` ending in ``extension``."""
    expr = r'(.*)' + re.escape(extension) + '$'

    if recursive:
        matched = []
        for path, _, files in os.walk(directory):
            matched += [
                os.path.join(path, f) for f in files if re.match(expr, f)]
    else:
        matched = (
            os.path.join(directory, f)
            for f in os.listdir(directory) if re.match(expr, f))

    if abspath:
        matched = (os.path.abspath(m) for m in matched)
    if realpath:
        matched = (os.path.realpath(m) for m in matched)
    return sorted(matched)


class _NumpyJSONEncoder(json.JSONEncoder):
    """JSON encoder understanding numpy arrays and scalars."""

    def default(self, o):
        if isinstance(o, np.ndarray):
            return {
                '__ndarray__': o.tolist(),
                'dtype': str(o.dtype),
                'shape': list(o.shape)}
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.bool_):
            return bool(o)
        return super().default(o)  # pragma: nocover


def _numpy_json_hook(obj):
    if '__ndarray__' in obj:
        return np.asarray(
            obj['__ndarray__'], dtype=obj['dtype']).reshape(obj['shape'])
    return obj


def json_dumps(data, indent=None):
    """Serialize ``data`` (may contain numpy arrays) to a JSON string."""
    return json.dumps(data, cls=_NumpyJSONEncoder, indent=indent)


def json_loads(text):
    """Inverse of :func:`json_dumps`."""
    return json.loads(text, object_hook=_numpy_json_hook)


class CatchExceptions:
    """Decorator turning uncaught exceptions into friendly CLI errors.

    Wraps a CLI entry point: expected exception types print a one-line
    message on stderr and exit with code 1 instead of a traceback.
    """

    def __init__(self, function):
        self.function = function

    def __call__(self):
        try:
            self.function()
        except (IOError, ValueError, OSError,
                RuntimeError, AssertionError) as err:
            self.exit('fatal error: {}'.format(err))
        except KeyboardInterrupt:
            self.exit('keyboard interruption, exiting')

    @staticmethod
    def exit(msg):
        sys.stderr.write(msg.strip() + '\n')
        sys.exit(1)

