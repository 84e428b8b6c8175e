"""Training listeners — the port of ``deeplearning4j_tpu/train/listeners.py``
(ref: ``org.deeplearning4j.optimize.api.TrainingListener`` and
``listeners.{ScoreIterationListener, PerformanceListener,
TimeIterationListener, CheckpointListener, EvaluativeListener}``, the
``MetricsListener`` bridge into the metrics registry, ``StatsListener``
(the producer of the StatsListener -> ``ui.StatsStorage`` -> ``ui.UIServer``
chain) and ``ProfilingListener`` (a torch.profiler window written as a
Chrome trace)).

A network calls ``onIterationStart(model, i)`` and ``iterationDone(model,
i, epoch)`` around each update step and ``onEpochEnd(model)`` after each
epoch (``setListeners``/``addListeners``). After a K-step dispatch the K
pairs run once the dispatch has returned, each step's loss a lazy device
slice that a listener's ``model.score()`` reads (``train.stepping.
record_megastep``): a listener that reads the model at iteration N sees
the state at the end of the dispatch, so an iteration-indexed side
effect (checkpoints, evaluation) should use an interval K divides.
"""

from __future__ import annotations

import itertools
import logging
import os
import time
import uuid
from typing import Callable, List, Optional

import torch

from deeplearning4j_tpu_torch.profiler.metrics import get_registry
from deeplearning4j_tpu_torch.utils.environment import Environment

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


class StatsListener(TrainingListener):
    """Per-iteration training statistics into a StatsStorage (ref:
    org.deeplearning4j.ui.model.stats.StatsListener): every ``frequency``
    iterations one update record with the score, the minibatch size, the
    iteration's wall time and, per parameter leaf (``"<layer>/<name>"``,
    in the JAX package's tree order), ``param_mean``, ``param_std``,
    ``param_norm``, ``update_norm``, ``update_ratio`` and, with
    ``with_histograms``, ``hist_counts`` (``hist_bins`` bins over
    ``hist_range`` [min, max]); a static record (model class, parameter
    count, backend, devices) before the first.

    The summaries are computed on the card in one batched pass over one
    flat fp32 copy of every leaf (a leaf's sums from an fp64 running sum
    at its ends; the std two-pass; a histogram bin an element) and pulled
    as one small tensor: never the weights. The pre-step copy of the
    params is that flat device copy (a copy, so it keeps no autograd
    node, which would break the step's CUDA-graph capture), freed after
    the update is taken. Under K steps a dispatch the hooks run after the
    dispatch (``train.stepping.record_megastep``), as in the JAX
    package: iteration N's record sees the end-of-dispatch params."""

    def __init__(self, storage, frequency: int = 1, session_id: str = None,
                 with_histograms: bool = False, hist_bins: int = 20):
        self.storage = storage
        self.frequency = max(1, frequency)
        self.session_id = session_id or f"sess_{uuid.uuid4().hex[:12]}"
        self.with_histograms = with_histograms
        self.hist_bins = hist_bins
        self._snapshot = None
        self._static_sent = False
        self._t_iter_start = None

    def _sampled(self, iteration: int) -> bool:
        return iteration % self.frequency == 0

    @staticmethod
    def _leaves(model):
        """``(name, param)`` of every non-empty leaf, ``"<layer>/<name>"``
        in the JAX package's tree order."""
        return [(f"{n}/{k}", model._params[n][k])
                for n, k in model._leaf_keys()
                if model._params[n][k].numel()]

    @staticmethod
    def _flat(leaves) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1).float() for _, p in leaves])

    def onIterationStart(self, model, iteration: int):
        if not self._sampled(iteration):
            return
        self._t_iter_start = time.monotonic()
        with torch.no_grad():
            self._snapshot = self._flat(self._leaves(model))

    def _stats(self, model) -> dict:
        """``{leaf: record}`` from one batched pass on the device and one
        host read."""
        leaves = self._leaves(model)
        if not leaves:
            return {}
        n, bins = len(leaves), self.hist_bins
        sizes = [p.numel() for _, p in leaves]
        with torch.no_grad():
            w = self._flat(leaves)
            dev = w.device
            ends = torch.tensor(list(itertools.accumulate(sizes)), device=dev)
            count = torch.tensor(sizes, dtype=torch.float64, device=dev)
            seg = torch.repeat_interleave(
                torch.arange(n, device=dev), torch.tensor(sizes, device=dev),
                output_size=w.numel())

            def seg_sum(v):
                # a segment's sum as the difference of an fp64 running sum
                # at its ends: one scan, no atomics
                cs = torch.cumsum(v, 0, dtype=torch.float64)[ends - 1]
                return torch.diff(cs, prepend=cs.new_zeros(1))
            mean = seg_sum(w) / count
            centered = w - mean.float()[seg]
            std = (seg_sum(centered * centered) / count).sqrt()
            pn = seg_sum(w * w).sqrt()
            upd = w - self._snapshot
            un = seg_sum(upd * upd).sqrt()
            cols = [mean, std, pn, un, un / (pn + 1e-12)]
            if self.with_histograms:
                lo = w.new_full((n,), float("inf")).scatter_reduce(
                    0, seg, w, "amin")
                hi = w.new_full((n,), -float("inf")).scatter_reduce(
                    0, seg, w, "amax")
                counts = _histogram(w, seg, n, bins, lo, hi)
                cols += [lo.double(), hi.double()]
            stats = torch.stack(cols, 1)
            if self.with_histograms:
                stats = torch.cat([stats, counts.double()], 1)
            host = stats.cpu().numpy()
        out = {}
        for (name, _), row in zip(leaves, host):
            rec = {"param_mean": float(row[0]), "param_std": float(row[1]),
                   "param_norm": float(row[2]), "update_norm": float(row[3]),
                   "update_ratio": float(row[4])}
            if self.with_histograms:
                rec["hist_range"] = [float(row[5]), float(row[6])]
                rec["hist_counts"] = [int(c) for c in row[7:]]
            out[name] = rec
        return out

    def iterationDone(self, model, iteration, epoch):
        if not self._sampled(iteration) or self._snapshot is None:
            return
        if not self._static_sent:
            self._send_static(model)
        layers = self._stats(model)
        self._snapshot = None
        dur = (time.monotonic() - self._t_iter_start) \
            if self._t_iter_start else None
        self.storage.putUpdate({
            "session_id": self.session_id,
            "worker_id": "0",
            "iteration": iteration,
            "epoch": epoch,
            "score": float(model.score()),
            "minibatch_size": getattr(model, "_last_batch_size", None),
            "iteration_time_sec": dur,
            "layers": layers,
        })

    def _send_static(self, model):
        dev = torch.device(model._device) if model._device is not None \
            else torch.device("cpu")
        self.storage.putStaticInfo({
            "session_id": self.session_id,
            "worker_id": "0",
            "model_class": type(model).__name__,
            "n_parameters": int(model.numParams()),
            "backend": dev.type,
            "n_devices": torch.cuda.device_count() if dev.type == "cuda"
            else 1,
        })
        self._static_sent = True


def _histogram(w, seg, n: int, bins: int, lo, hi):
    """``[n, bins]`` counts: each segment's ``bins`` equal bins over its
    [lo, hi], the last closed, as ``jnp.histogram`` bins one tensor (a
    constant segment's range widened by 0.5 each way); on the device,
    with no host read."""
    flat = hi == lo
    lo = torch.where(flat, lo - 0.5, lo)
    hi = torch.where(flat, hi + 0.5, hi)
    width = (hi - lo) / bins
    b = ((w - lo[seg]) / width[seg]).floor().long().clamp_(0, bins - 1)
    b = torch.where(w == hi[seg], torch.full_like(b, bins - 1), b)
    idx = seg * bins + b
    return torch.zeros(n * bins, dtype=torch.long, device=w.device
                       ).scatter_add_(0, idx, torch.ones_like(idx)
                                      ).view(n, bins)


def default_profile_dir() -> str:
    """``Environment.profile_dir``: ``DL4J_TPU_PROFILE_DIR``, else
    ``dl4j_tpu_profile`` in the temporary directory (the JAX package's
    ``/tmp/dl4j_tpu_profile``)."""
    return Environment.get().profile_dir


class ProfilingListener(TrainingListener):
    """A torch.profiler window over iterations ``[start_iter, start_iter +
    n_iters)`` (1-based, relative to where the trace actually started),
    written once as a Chrome trace (``trace_<pid>_<iteration>.json``) under
    ``log_dir`` (:func:`default_profile_dir`); ``trace_path`` names it.
    CPU and CUDA activity are traced; the per-layer
    ``dl4j_L<i>_<name>`` scopes of ``profiler.devicetime`` are on while
    the window is open, so an eager forward's kernels sit under their
    layer. A captured step's replay has no Python forward, so it shows
    as the graph's launch (and such kernels as the profiler reports under
    replay) with no layer scope. The window synchronizes the card before
    it stops (the JAX listener reads ``model.score()`` for that), so the
    last iteration's kernels land in the trace. For the framework-side
    timeline (dispatch, data wait) use ``profiler.trace_span``."""

    def __init__(self, log_dir: str = None, start_iter: int = 2,
                 n_iters: int = 3, create_perfetto_trace: bool = True):
        # create_perfetto_trace: the JAX listener's switch, kept for its
        # callers; the Chrome trace written here always loads in Perfetto
        self.log_dir = log_dir or default_profile_dir()
        self.start_iter = start_iter
        self.n_iters = n_iters
        self.trace_path: Optional[str] = None
        self._prof = None
        self._scopes = None
        self._done = False
        self._trace_start = None

    def onIterationStart(self, model, iteration: int):
        if self._done or self._prof is not None \
                or iteration < self.start_iter:
            return
        from torch.profiler import ProfilerActivity, profile

        from deeplearning4j_tpu_torch.profiler import devicetime
        os.makedirs(self.log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._scopes = devicetime.recording()
        self._scopes.__enter__()
        self._trace_start = iteration

    def _stop(self, model):
        model.score()          # the card has finished the window's work
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._scopes.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        path = os.path.join(self.log_dir, f"trace_{os.getpid()}_"
                                          f"{self._trace_start}.json")
        self._prof.export_chrome_trace(path)
        self.trace_path = path
        self._prof = self._scopes = None
        self._done = True

    def iterationDone(self, model, iteration, epoch):
        if self._prof is not None \
                and iteration - self._trace_start + 1 >= self.n_iters:
            self._stop(model)

    def onEpochEnd(self, model):
        if self._prof is not None:      # an epoch shorter than the window
            self._stop(model)
