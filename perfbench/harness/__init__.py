"""What the benchmark knows of a configuration's pipeline: its shape.

A shape of pipeline has a module of its own,
``perfbench/harness/<name>.py``, which the configuration file names with
its ``"harness"`` key (:data:`DEFAULT` where it has none) and
:meth:`perfbench.manifest.Manifest.harness` loads by path, as it loads a
per-layer metric's reader. The module defines ``build(config,
sample_rate)``, which returns one :class:`Harness` for a cell from the
configuration file's ``pipeline`` section and sample rate. Building it
does no work: the harness works out what it needs when a method is
called.

:mod:`perfbench.bench` and :mod:`perfbench.control` know a pipeline
only through these methods:

- :meth:`Harness.prepare`, in set-up;
- :meth:`Harness.expected_shape`, for ``failed``;
- :meth:`Harness.compare`, for ``correct``;
- :meth:`Harness.trace_inputs`, for the per-layer readers.

A harness module, like the rest of the benchmark, imports neither JAX
nor the JAX package (:mod:`perfbench.guard` ends a run that loaded
them), and its reference imports nothing of the program.
"""

#: the harness of a configuration file without a ``"harness"`` key
DEFAULT = 'kaldi_pitch'


class Harness:
    """One cell's pipeline, from the configuration file's ``pipeline``
    section (``config``) and its ``sample_rate``."""

    def __init__(self, config, sample_rate):
        self.config = config
        self.sample_rate = int(sample_rate)

    def prepare(self, seed, workdir, device):
        """Set-up before the warm call, counted in ``setup_s``: what the
        program needs beside the corpus, made from ``seed`` (weights
        written under ``workdir``, the run's temporary directory, for
        instance). Returns the overrides merged into the pipeline
        configuration the program runs (:func:`merge`); none here."""
        return {}

    def expected_shape(self, nsamples):
        """The ``(rows, columns)`` of the output of an utterance of
        ``nsamples`` samples: an utterance that comes back in another
        shape counts as failed."""
        raise NotImplementedError

    def compare(self, entries, compared, outputs, device, seed):
        """``(numbers, details)``. ``numbers``: what decides ``correct``,
        keyed as the limits of ``perfbench/checks/<cell>.json`` (a number
        without a limit, or a limit without a number, ends the run).
        ``details``: further readings for standard error, a dict of
        values JSON can write. ``entries`` are the corpus's (name, wav
        path, speaker); ``outputs`` one dict (name -> [rows, columns]
        numpy array) of the ``compared`` utterances per timed call."""
        raise NotImplementedError

    def trace_inputs(self, samples):
        """The keyword fields of :class:`perfbench.tracing.TracedRun`
        that come from the pipeline (``pitch_frames``, ``lags``,
        ``work``) for the utterances of the traced window: ``samples``
        holds the sample count of each utterance of each of its calls.
        None here."""
        return {}


def merge(config, overrides):
    """A copy of ``config`` with ``overrides`` merged in: a dict merged
    key by key, any other value replaced."""
    merged = dict(config)
    for key, value in overrides.items():
        if isinstance(value, dict) and isinstance(merged.get(key), dict):
            merged[key] = merge(merged[key], value)
        else:
            merged[key] = value
    return merged
