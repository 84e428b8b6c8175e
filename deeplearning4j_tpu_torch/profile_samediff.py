"""Where a SameDiff BERT-base spends its time on the card, served and
fine-tuned, with the training step run eagerly and replayed as a CUDA
graph.

Usage (on a machine with a CUDA card, from the root of a checkout)::

    python3 -m deeplearning4j_tpu_torch.profile_samediff

Builds the SameDiff BERT-base sequence classifier of ``chip_smoke.py``
(``build_bert`` at full width, fp32, random weights from
``numpy.random.default_rng(0)``) with the CUDA kernels installed before
recording. Times, on the host clock around each call and a synchronize:

- the forward a served batch of 32 runs (``samediff_forward(sd,
  ["probs"])`` under ``torch.inference_mode``, as ``ModelServer`` calls
  it; median of 10 after 3 warm);
- one eager training step at B=32 (Adam 1e-4): ``sd._train_step`` on the
  fed batch, op by op, as a graph with host control flow trains (median
  of 5 after 2 warm); its kernels are counted in ``cuda_kernels.LAUNCHES``;
- one ``sd.fit`` step at B=32, which replays the step captured for its
  placeholder signature (``CachedDispatch``, scope ``samediff:fit``; the
  capture falls in the warm calls; median of 5 after 2 warm); a replay's
  kernels are counted in ``cuda_kernels.REPLAYS``, beside the launches
  recorded at its capture.

Then it traces one of each with ``torch.profiler``. Each trace's device
time is summed by group, each kernel going to the first group that its
own name or its launching op's caller chain names: the softmax kernel,
the layer-norm kernel, the composed backwards of the overrides
(``_*KernelBackward``), the optimizer (the updater's ``apply``), the
matrix products (``aten::mm``, ``bmm``, ``addmm``, ``matmul``, forward
and backward) and the rest. A replayed graph's kernels have no launching
op on the host, so in the captured step's trace only the softmax and
layer-norm kernels, grouped by their own names, leave ``rest``.
It prints one JSON object; the traced time beside its host time gives
the card's busy share under the profiler. Without a card it exits
non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.profile_fit import _device_us, _group_of
from deeplearning4j_tpu_torch.serving import samediff_forward
from deeplearning4j_tpu_torch.train.updaters import Adam

BATCH = 32
_LABEL = "dl4j::"
_KERNELS = (("softmax kernel", "softmax_warp_kernel"),
            ("softmax kernel", "softmax_block_kernel"),
            ("layer_norm kernel", "layer_norm_fwd_kernel"))
#: (group, substring of an op name on the launching op's caller chain)
_SCOPES = (("composed backwards (LN, softmax)", "KernelBackward"),
           ("optimizer", _LABEL + "optimizer"),
           ("matmul", "aten::mm"), ("matmul", "aten::bmm"),
           ("matmul", "aten::addmm"), ("matmul", "aten::matmul"))


def _named(kernel: str):
    """The group a kernel's own name gives it, or None."""
    return next((grp for grp, needle in _KERNELS if needle in kernel), None)


def _scoped(fn, label):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapped


def _timed(fn, warm: int, iters: int):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def trace(fn) -> dict:
    """One traced call of ``fn``: host ms, device ms by group, kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    total, n_kernels, by_group = 0.0, 0, {}
    for ev in prof.key_averages():
        us = _device_us(ev)
        # the label shows up as a range on the device timeline: a span,
        # not a kernel
        if not us or ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.key.startswith(_LABEL):
            continue
        n_kernels += ev.count
        total += us / 1e3
        g = _named(ev.key)
        if g is not None:
            by_group[g] = by_group.get(g, 0.0) + us / 1e3
    for ev in prof.events():
        for k in getattr(ev, "kernels", ()):
            if k.name.startswith(_LABEL) or _named(k.name) is not None:
                continue
            g = _group_of(ev, _SCOPES)
            by_group[g] = by_group.get(g, 0.0) + k.duration / 1e3
    attributed = sum(v for g, v in by_group.items() if g != "rest")
    by_group["rest"] = max(total - attributed, 0.0)
    return {"traced_host_ms": host_ms, "traced_device_ms": total,
            "device_busy_share_traced": total / host_ms,
            "device_kernels": n_kernels, "device_ms_by_group": by_group}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_samediff: needs a CUDA card", file=sys.stderr)
        return 1
    # the graph's one builder outside the tests lives in chip_smoke.py
    from chip_smoke import BERT_SD, build_bert

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    ck.install_platform_overrides()
    sd = build_bert(SameDiff.create(), **BERT_SD)
    updater = Adam(1e-4)
    updater.apply = _scoped(updater.apply, _LABEL + "optimizer")
    sd.setTrainingConfig(TrainingConfig(
        updater=updater, data_set_feature_mapping=["input_ids"],
        data_set_label_mapping=["labels"]))
    rng = np.random.default_rng(0)
    T = BERT_SD["T"]
    ids = torch.from_numpy(rng.integers(0, BERT_SD["V"], (BATCH, T),
                                        dtype=np.int32)).cuda()
    labels = torch.from_numpy(rng.integers(0, BERT_SD["n_labels"], BATCH,
                                           dtype=np.int32)).cuda()
    forward = samediff_forward(sd, ["probs"], input_name="input_ids")

    def serve():
        with torch.inference_mode():
            forward(ids)

    batch = {"input_ids": ids, "labels": labels}

    def captured_step():
        sd.fit([batch])

    sd._prepare_fit()
    phs = sd._feed(batch)

    def eager_step():
        sd._train_step(phs)

    fwd_ms = _timed(serve, 3, 10)
    ck.reset_counts()
    serve()
    fwd_launches = dict(ck.LAUNCHES)
    eager_ms = _timed(eager_step, 2, 5)
    ck.reset_counts()
    eager_step()
    eager_launches = dict(ck.LAUNCHES)
    cc.reset_stats()
    captured_ms = _timed(captured_step, 2, 5)
    stats = cc.cache_stats()
    ck.reset_counts()
    captured_step()
    replayed = dict(ck.REPLAYS)
    out = {"card": smi, "batch": BATCH, "T": T,
           "forward_ms_median": float(np.median(fwd_ms)),
           "forward_ms_min": float(np.min(fwd_ms)),
           "tokens_per_s_forward": BATCH * T / (np.median(fwd_ms) / 1e3),
           "launches_per_forward": fwd_launches,
           "eager_step_ms_median": float(np.median(eager_ms)),
           "eager_step_ms_min": float(np.min(eager_ms)),
           "eager_step_ms_max": float(np.max(eager_ms)),
           "launches_per_eager_step": eager_launches,
           "captured_step_ms_median": float(np.median(captured_ms)),
           "captured_step_ms_min": float(np.min(captured_ms)),
           "captured_step_ms_max": float(np.max(captured_ms)),
           "captures": stats["compile_seconds"]["cold_compiles"],
           "capture_failures": stats["capture_failures"],
           "launches_recorded_at_capture": [
               a for d in sd.fit_dispatches()
               for a in d.launches_at_capture()],
           "launches_per_replayed_step": replayed,
           "forward_trace": trace(serve),
           "eager_step_trace": trace(eager_step),
           "captured_step_trace": trace(captured_step)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
