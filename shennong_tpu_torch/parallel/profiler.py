"""Tracing, per-stage timing and the extraction plane's counters.

Counterpart of :mod:`shennong_tpu.parallel.profiler`:

- :class:`StageTimer`: wall-clock accounting of pipeline stages,
  reported through a logger (x real-time per stage);
- :class:`Counters` and the process-global :data:`counters`: the cost
  centres of a corpus run, written by the host layer's seams;
- :func:`span`: a profiler annotation that may also add its wall
  seconds to a counter;
- :func:`trace`: a context manager around :mod:`torch.profiler`
  writing a trace that TensorBoard and Perfetto read.

This docstring is the one list of the port's counters and spans. A span
is a :func:`torch.profiler.record_function`, on the profiler's clock
with the kernels it launches (nothing measurable when no profiler
runs); a counter is always on. Seconds are wall seconds of the thread
that runs the seam ("thread seconds" where that thread overlaps the
caller's).

Counters (key: seam; span over the same interval, if any):

- ``calls``, ``call_s``: one per :func:`shennong_tpu_torch.pipeline.
  extract_features` call, and its whole body (span
  ``extract_features``);
- ``plan_s``: the host work before the first batch: the configuration,
  ``PipelineManager`` and its header scan, the path choice
  (``pipeline.plan`` in ``extract_features``, ``_pass_one`` and
  ``_fused_pass_one``); the fused executor's sample-rate scan, options
  and shared mel bank (``pass1.plan``, ``FusedPipelineExecutor.run``);
  the batch plan's header scan (``stream.plan``,
  ``parallel.stream.plan_batches``);
- ``decode_s``: host audio decode into the batch buffers (``decode``,
  ``parallel.stream.decode_batch``); thread seconds of the stream's
  pool threads, overlapped with the device work;
- ``decode_wait_s``: the consumer blocked on the next decoded batch
  (``decode.wait``, ``parallel.stream.stream_batches``);
- ``dispatch_s`` / ``dispatches``: enqueuing a batch's upload and
  program, and the count of those programs, one per batch of the fused
  pass 1 (``pass1.dispatch``) and of ``BatchExecutor.process_all``
  (``batch.dispatch``); the JAX package counts two per fused batch,
  adding its payload packing;
- ``dispatch_front_s``, ``dispatch_pitch_s``: inside ``dispatch_s``, the
  enqueue of the fused program's features front end (``pass1.front``)
  and of its pitch, noise draw and post-processing included
  (``pass1.pitch``; ``parallel.fused.pass_one_program``);
- ``fetch_s`` / ``bytes_down``: blocked on a batch's outputs and
  viewing them (the fused path's event, span ``pass1.wait``, and
  payload unpacking; the stage-wise ``.cpu()``, ``batch.wait``), and
  the bytes fetched;
- ``drain_s``: the fused executor's host work on a landed batch after
  ``fetch_s``: each utterance's copies, CMVN statistics and hand-off to
  pass 2, up to the payload's return to its pool (``pass1.drain``);
- ``bytes_up``: host-to-device bytes of the decoded batches (int16
  signals plus int32 ``nsamples``); a batch replayed from a
  ``SignalCache`` uploads nothing;
- ``pass2_s``: pass 2 of a group (CMVN apply, deltas, pitch
  concatenation), thread seconds: the fused path runs it on the thread
  ``pass-two`` while pass 1 goes on (the span ``pass2`` lies inside);
- ``pass2_pack_s``, ``pass2_compute_s``, ``pass2_unpack_s``: inside
  ``pass2`` (``pipeline._pass_two``), the CMVN affines, the packing of
  the group and its upload (``pass2.pack``); the kernel or the plain
  version up to the output rows' landing on the host
  (``pass2.compute``); each utterance's checks, Features and
  properties (``pass2.unpack``);
- ``pass2_kernel_utts``: utterances whose pass 2 ran in the kernel
  (``csrc/pass_two.cu``; 0 is added for those on the CPU);
- ``pass2_utts``: utterances pass 2's worker finished;
  ``pass2_backlog_utts``: those handed to it and not yet finished when
  the caller starts to wait for it, one add per call;
- ``pass2_join_s``: the caller waiting for pass 2's worker after pass 1
  (``pass2.join``, ``pipeline._pass_two_worker``);
- ``crepe_load_s``, ``crepe_cnn_s``, ``crepe_decode_s``: inside
  ``CrepePitchProcessor.process_all`` (``processor/pitch_crepe.py``),
  each utterance's audio load, check and padding (``crepe.load``); the
  enqueue of a slice's upload, framing, normalization and CNN
  (``crepe.cnn``); the host decode of a slice's bin paths
  (``crepe.decode``); ``crepe_post_s``: the CREPE post-processing of
  every utterance in the stage-wise pass 1 (``crepe.post``,
  ``pipeline._stagewise_pass_one``);
- ``crepe_frames``, ``crepe_cnn_frames``, ``crepe_slices``: the
  batched path of ``process_all``: the model frames of its utterances
  (``models.crepe.frame_count``), the frames its CNN ran (the real
  frames of every slice's rows, handed to ``forward_audio_chunk`` as
  ``counts``: the padding up to the frame bucket and the empty rows
  never reach the CNN), and its slices; ``crepe_conv_kernel_frames``:
  the frames whose six conv blocks ran in the conv kernel, counted
  where the kernel launches (``ops.crepe_conv.conv_block``, at each
  launch of the first block; none on the CPU);
- ``launches.<kernel>``: the hand-written kernels' launches,
  ``launches.viterbi_forward`` and ``launches.viterbi_backtrace``
  (``ops.cuda_viterbi``), ``launches.banded_viterbi``
  (``ops.viterbi``), ``launches.dtw`` (``ops.dtw``),
  ``launches.pass_two`` (``ops.pass_two``), ``launches.crepe_conv``
  (``ops.crepe_conv``, one a conv block).

``plan_s``, ``decode_wait_s``, ``dispatch_s``, ``fetch_s``, ``drain_s``
and ``pass2_join_s`` are disjoint intervals of a fused call's thread,
so their sum is at most ``call_s``.

Spans with no counter: ``pass1.vad`` (the fused program's energy and
VAD), ``pass1.pack`` (its payload packing, the pinned copy and its
event); ``batch.chunked`` (an hour-scale utterance's chunked
extraction), ``vtln.moments``; the stages ``plp.rasta``,
``plp.durbin``, ``bottleneck.frontend``, ``bottleneck.forward``,
``ubm.frontend``, ``ubm.init``, ``ubm.em``, ``vtln.solve``,
``vtln.gselect``, ``vtln.rounds``.
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
    without a profiler; the module's docstring lists the keys that the
    instrumented seams write.
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


@contextlib.contextmanager
def span(name, key=None):
    """Annotate the block as ``name`` on the profiler's timeline and,
    with ``key``, add its wall seconds to ``counters[key]``."""
    timed = (contextlib.nullcontext() if key is None
             else counters.timed(key))
    with torch.profiler.record_function(name), timed:
        yield
