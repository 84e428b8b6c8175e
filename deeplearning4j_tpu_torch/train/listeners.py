"""Training listeners — the port of ``deeplearning4j_tpu/train/listeners.py``
(ref: ``org.deeplearning4j.optimize.api.TrainingListener`` and
``listeners.{ScoreIterationListener, PerformanceListener,
TimeIterationListener, CheckpointListener, EvaluativeListener}``, and the
``MetricsListener`` bridge into the metrics registry).

A network calls ``onIterationStart(model, i)`` and ``iterationDone(model,
i, epoch)`` around each update step and ``onEpochEnd(model)`` after each
epoch (``setListeners``/``addListeners``). After a K-step dispatch the K
pairs run once the dispatch has returned, each step's loss a lazy device
slice that a listener's ``model.score()`` reads (``train.stepping.
record_megastep``): a listener that reads the model at iteration N sees
the state at the end of the dispatch, so an iteration-indexed side
effect (checkpoints, evaluation) should use an interval K divides.

Not ported yet (ROADMAP.md): ``StatsListener`` (with ``ui/``) and
``ProfilingListener`` (with the device-time profiler).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.profiler.metrics import get_registry

logger = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    """Listener protocol (ref: TrainingListener)."""

    def iterationDone(self, model, iteration: int, epoch: int):
        pass

    def onEpochEnd(self, model):
        pass


class ScoreIterationListener(TrainingListener):
    """Log the score every N iterations (ref: ScoreIterationListener);
    ``history`` keeps every iteration's score (each a host read)."""

    def __init__(self, print_iterations: int = 10, out: Callable = None):
        self.n = print_iterations
        self.out = out or (lambda msg: logger.info(msg))
        self.history: List[float] = []

    def iterationDone(self, model, iteration, epoch):
        score = model.score()
        self.history.append(score)
        if iteration % self.n == 0:
            self.out(f"Score at iteration {iteration} is {score}")


class PerformanceListener(TrainingListener):
    """Throughput (ref: PerformanceListener: iterations and samples a
    second every ``frequency`` iterations), also set as the gauges
    ``dl4j_throughput_batches_per_sec`` and
    ``dl4j_throughput_samples_per_sec``."""

    def __init__(self, frequency: int = 10, report_batch: bool = True,
                 out: Callable = None):
        self.frequency = frequency
        self.report_batch = report_batch
        self.out = out or (lambda msg: logger.info(msg))
        self._last_time = None
        self._last_iter = 0
        self._samples = 0
        self.samples_per_sec: Optional[float] = None
        self.batches_per_sec: Optional[float] = None

    def iterationDone(self, model, iteration, epoch):
        now = time.monotonic()     # a duration: immune to wall-clock steps
        self._samples += getattr(model, "_last_batch_size", 0)
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            if dt > 0:
                self.batches_per_sec = iters / dt
                self.samples_per_sec = self._samples / dt
                msg = f"iter {iteration}: {iters / dt:.1f} iterations/sec"
                if self.report_batch and self._samples:
                    msg += f", {self.samples_per_sec:.1f} samples/sec"
                self.out(msg)
                reg = get_registry()
                reg.gauge("dl4j_throughput_batches_per_sec",
                          "Training throughput (PerformanceListener)"
                          ).set(iters / dt)
                if self._samples:
                    reg.gauge("dl4j_throughput_samples_per_sec",
                              "Training throughput (PerformanceListener)"
                              ).set(self.samples_per_sec)
            self._last_time = now
            self._last_iter = iteration
            self._samples = 0
        elif self._last_time is None:
            self._last_time = now
            self._last_iter = iteration


class TimeIterationListener(TrainingListener):
    """ETA logging (ref: TimeIterationListener)."""

    def __init__(self, total_iterations: int, out: Callable = None):
        self.total = total_iterations
        self.start = time.monotonic()
        self.out = out or (lambda msg: logger.info(msg))

    def iterationDone(self, model, iteration, epoch):
        elapsed = time.monotonic() - self.start
        if iteration > 0:
            remaining = elapsed / iteration * (self.total - iteration)
            self.out(f"iter {iteration}/{self.total}, ETA {remaining:.0f}s")


class CheckpointListener(TrainingListener):
    """Periodic model archives, the last ``keep_last`` kept (ref:
    CheckpointListener)."""

    def __init__(self, directory: str, save_every_n_iterations: int = None,
                 save_every_n_epochs: int = None, keep_last: int = 3):
        self.dir = directory
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.keep_last = keep_last
        self.saved: List[str] = []
        os.makedirs(directory, exist_ok=True)

    def _save(self, model, tag: str):
        path = os.path.join(self.dir, f"checkpoint_{tag}.zip")
        model.save(path, save_updater=True)
        self.saved.append(path)
        while len(self.saved) > self.keep_last:
            old = self.saved.pop(0)
            if os.path.exists(old):
                os.remove(old)

    def iterationDone(self, model, iteration, epoch):
        if self.every_iter and iteration % self.every_iter == 0:
            self._save(model, f"iter_{iteration}")

    def onEpochEnd(self, model):
        if self.every_epoch and model.getEpochCount() % self.every_epoch == 0:
            self._save(model, f"epoch_{model.getEpochCount()}")


class EvaluativeListener(TrainingListener):
    """Evaluation on a held-out iterator every ``frequency`` iterations
    (ref: EvaluativeListener)."""

    def __init__(self, iterator, frequency: int, evaluation_factory=None,
                 out: Callable = None):
        from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation
        self.iterator = iterator
        self.frequency = frequency
        self.factory = evaluation_factory or Evaluation
        self.out = out or (lambda msg: logger.info(msg))
        self.last_evaluation = None

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            ev = model.evaluate(self.iterator, self.factory())
            self.last_evaluation = ev
            self.out(f"iter {iteration}: accuracy={ev.accuracy():.4f}")


class MetricsListener(TrainingListener):
    """The listener bus into the metrics registry: per iteration
    ``dl4j_listener_iterations_total``, the ``dl4j_train_score`` gauge
    (a host read of the score unless ``sync_score=False``) and
    ``dl4j_train_iteration_seconds`` (from ``onIterationStart``); per
    epoch ``dl4j_train_epochs_total``. (The JAX package counts
    iterations in ``dl4j_train_iterations_total``, which the port's
    train step already counts.)"""

    def __init__(self, registry=None, sync_score: bool = True):
        reg = registry or get_registry()
        self.registry = reg
        self.sync_score = sync_score
        self._c_iters = reg.counter(
            "dl4j_listener_iterations_total",
            "Training iterations seen by MetricsListener")
        self._c_epochs = reg.counter(
            "dl4j_train_epochs_total",
            "Training epochs seen by MetricsListener")
        self._g_score = reg.gauge(
            "dl4j_train_score", "Last minibatch score (loss)")
        self._g_epoch = reg.gauge(
            "dl4j_train_epoch", "Current epoch number")
        self._h_iter = reg.histogram(
            "dl4j_train_iteration_seconds",
            "Wall time per iteration incl. listener-forced host sync")
        self._t0 = None

    def onIterationStart(self, model, iteration):
        self._t0 = time.perf_counter()

    def iterationDone(self, model, iteration, epoch):
        self._c_iters.inc()
        self._g_epoch.set(epoch)
        if self.sync_score:
            score = model.score()
            if score == score:      # NaN: the gauge keeps its last value
                self._g_score.set(float(score))
        if self._t0 is not None:
            self._h_iter.observe(time.perf_counter() - self._t0)
            self._t0 = None

    def onEpochEnd(self, model):
        self._c_epochs.inc()
