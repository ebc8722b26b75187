"""Tracing, per-stage timing and the extraction plane's counters.

Counterpart of :mod:`shennong_tpu.parallel.profiler`:

- :class:`StageTimer`: wall-clock accounting of pipeline stages,
  reported through a logger (x real-time per stage);
- :class:`Counters` and the process-global :data:`counters`: the cost
  centres of a corpus run, written by the host layer's seams;
- :func:`trace`: a context manager around :mod:`torch.profiler`
  writing a trace that TensorBoard and Perfetto read.
"""

import contextlib
import os
import threading
import time

import torch

from shennong_tpu_torch.logger import null_logger


class StageTimer:
    """Accumulates wall-clock time per named pipeline stage."""

    def __init__(self, log=null_logger()):
        self._log = log
        self._stages = {}

    @contextlib.contextmanager
    def stage(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self._stages[name] = self._stages.get(name, 0.0) + elapsed

    def report(self, audio_seconds=None):
        """Log one line per stage; with ``audio_seconds`` also log the
        per-stage real-time factor. Returns the timing dict."""
        total = sum(self._stages.values())
        for name, elapsed in sorted(
                self._stages.items(), key=lambda kv: -kv[1]):
            if audio_seconds:
                self._log.info(
                    'stage %-20s %8.3fs (%5.1f%%, %8.0fx real-time)',
                    name, elapsed, 100 * elapsed / max(total, 1e-9),
                    audio_seconds / max(elapsed, 1e-9))
            else:
                self._log.info(
                    'stage %-20s %8.3fs (%5.1f%%)',
                    name, elapsed, 100 * elapsed / max(total, 1e-9))
        return dict(self._stages)


def profiler_options():
    """The keyword arguments of :class:`torch.profiler.profile` for a
    trace of this process: the CPU activity, plus the CUDA activity
    when the process has a card, and every thread's annotations (pass 2
    runs on the thread ``pass-two``, decoding on the stream's pool
    threads; by default only the thread that starts the profiler is
    recorded). They decide what is recorded, not where anything runs."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return {'activities': activities,
            'experimental_config': _ExperimentalConfig(
                profile_all_threads=True)}


@contextlib.contextmanager
def trace(logdir):
    """Capture a trace of this process under ``logdir``: a Chrome trace
    (``<host>_<pid>.<n>.pt.trace.json``) that TensorBoard's profiler
    plugin and Perfetto read, with the host annotations (``pass2``,
    ``pass1.dispatch``, ...) and, on a card, the kernels.

    Wrap any extraction call::

        with profiler.trace('/tmp/trace'):
            features = pipeline.extract_features(config, utts, device=...)
    """
    from torch.profiler import profile, tensorboard_trace_handler

    os.makedirs(str(logdir), exist_ok=True)
    with profile(on_trace_ready=tensorboard_trace_handler(str(logdir)),
                 **profiler_options()):
        yield


class Counters:
    """Process-global performance counters for the extraction plane.

    A benchmark reads these to split a corpus run into its cost centres
    without a profiler. Keys written by the instrumented seams:

    - ``decode_s``: host audio decode into the batch buffers
      (:func:`shennong_tpu_torch.parallel.stream.decode_batch`; thread
      seconds: decoding runs on the stream's pool threads, overlapped
      with the device work, so it can exceed its wall share);
    - ``dispatch_s`` / ``dispatches``: wall seconds of enqueuing a
      batch's upload and program, and the count of those programs: one
      per batch of the fused pass 1 and of ``BatchExecutor.process_all``
      (the JAX package counts two per fused batch, adding its payload
      packing, which the port does not have);
    - ``fetch_s`` / ``bytes_down``: wall seconds blocked on a batch's
      outputs (the CUDA event of their copy to pinned memory, or the
      ``.cpu()`` of the stage-wise path), and the bytes fetched;
    - ``bytes_up``: host-to-device bytes of the batches decoded for an
      upload (int16 signals plus the int32 ``nsamples``); a batch
      replayed from a ``SignalCache`` uploads nothing;
    - ``pass2_s``: host pass 2 (CMVN apply, deltas, pitch
      concatenation). Thread seconds, like ``decode_s``: the fused
      path runs it per CMVN group on the thread ``pass-two`` while
      pass 1 goes on, so it can exceed its wall share.

    ``dispatch_s + fetch_s`` is the wall time spent on the device path
    from the host's side; the device's own busy time comes from a
    :func:`trace`.
    """

    def __init__(self):
        self._data = {}
        self._lock = threading.Lock()  # decode and pass 2 run on threads

    def reset(self):
        with self._lock:
            self._data.clear()

    def add(self, key, value=1.0):
        with self._lock:
            self._data[key] = self._data.get(key, 0.0) + value

    @contextlib.contextmanager
    def timed(self, key):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add(key, time.perf_counter() - start)

    def snapshot(self):
        with self._lock:  # threads may be inserting keys
            return dict(self._data)


#: The process-global counter set (reset it around a measured region).
counters = Counters()
