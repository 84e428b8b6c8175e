"""Where one training step of ResNet-50 or TinyYOLO spends its time on
the card.

Usage (on a machine with a CUDA card, from the root of a checkout)::

    python3 -m deeplearning4j_tpu_torch.profile_fit [--model tiny_yolo]

Builds ``zoo.ResNet50(num_classes=1000)`` (the default; a
``ComputationGraph``, one [64, 3, 224, 224] batch of one-hot labels) or
``zoo.TinyYOLO(num_classes=20)`` (``--model tiny_yolo``; a
``MultiLayerNetwork``, one [32, 3, 416, 416] batch whose YOLO labels hold
1-3 boxes an image), random weights from the zoo's seed, in the bf16 /
NHWC / fused-epilogue configuration with the CUDA kernels installed;
times ``net.fit`` on that batch (host clock around the step and the
``score()`` that waits for it, median of 5 after 2 warm steps) and
traces one more step with ``torch.profiler``. The trace's device time is
summed by kernel name and by group, each kernel going to the first group
its launching op or one of that op's callers names: the
``scale_shift_act`` kernel, its composed backward, the BN statistics
(``channel_moments``, forward and backward), the optimizer
(``_process_and_apply_grads``), the YOLO loss's forward
(``Yolo2OutputLayer.compute_loss``; its backward runs as generic autograd
ops and lands in "rest"), cuDNN convolutions (forward and backward) and
the rest. It prints one JSON object. Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import network as network_mod
from deeplearning4j_tpu_torch.nn.objdetect import Yolo2OutputLayer, yolo_labels
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import normalization as norm_ops

BATCH = {"resnet50": 64, "tiny_yolo": 32}
WARM = 2
ITERS = 5

_LABEL = "dl4j::"
#: (group, substring of an op name on the launching op's caller chain)
_SCOPES = (("scale_shift_act backward (composed)", "ScaleShiftAct"),
           ("bn_stats", "ChannelMoments"),
           ("bn_stats", _LABEL + "bn_stats"),
           ("optimizer", _LABEL + "optimizer"),
           ("yolo loss (forward)", _LABEL + "yolo_loss"),
           ("conv (cuDNN)", "convolution"))


def _scoped(fn, label):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapped


def _group_of(event, scopes=_SCOPES) -> str:
    """The first group whose needle names the event or one of its
    callers, walking up from the launching op; "rest" if none does."""
    e = event
    while e is not None:
        for group, needle in scopes:
            if needle in e.name:
                return group
        e = e.cpu_parent
    return "rest"


def _device_us(ev) -> float:
    us = getattr(ev, "device_time_total", None)
    if us is None:
        us = getattr(ev, "cuda_time_total", 0.0)
    return us


def profile(net, ds) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # label the BN statistics, the optimizer and the YOLO loss for the
    # trace only
    patches = [(norm_ops, "channel_moments", "bn_stats"),
               (network_mod.BaseNetwork, "_process_and_apply_grads",
                "optimizer"),
               (Yolo2OutputLayer, "compute_loss", "yolo_loss")]
    saved = [(owner, name, getattr(owner, name))
             for owner, name, _ in patches]
    for owner, name, label in patches:
        setattr(owner, name, _scoped(getattr(owner, name), _LABEL + label))
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            net.fit(ds)
            net.score()
            traced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    by_kernel, n_kernels = {}, 0
    for ev in prof.key_averages():
        us = _device_us(ev)
        # the labels also show up as ranges on the device's timeline: they
        # are spans, not kernels
        if not us or ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.key.startswith(_LABEL):
            continue
        n_kernels += ev.count
        by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us / 1e3
    total = sum(by_kernel.values())
    ssa_ms = sum(v for k, v in by_kernel.items()
                 if "scale_shift_act_kernel" in k)
    by_group = {"scale_shift_act": ssa_ms}
    for ev in prof.events():
        for k in getattr(ev, "kernels", ()):
            if "scale_shift_act_kernel" in k.name \
                    or k.name.startswith(_LABEL):
                continue
            g = _group_of(ev)
            by_group[g] = by_group.get(g, 0.0) + k.duration / 1e3
    attributed = sum(v for g, v in by_group.items() if g != "rest")
    by_group["rest"] = max(total - attributed, 0.0)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"traced_step_ms": traced_ms,
            "traced_device_ms": total,
            "device_busy_share_traced": total / traced_ms,
            "device_kernels_per_step": n_kernels,
            "device_ms_by_group": by_group,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def build(model: str):
    """(net, DataSet) for ``model`` on the card, in the bench's
    bf16 / NHWC / fused configuration."""
    rng = np.random.default_rng(0)
    batch = BATCH[model]
    if model == "resnet50":
        net = zoo.ResNet50(num_classes=1000).init()
        x = rng.standard_normal((batch, 3, 224, 224), dtype=np.float32)
        y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, batch)]
    else:
        net = zoo.TinyYOLO(num_classes=20).init()
        x = rng.standard_normal((batch, 3, 416, 416), dtype=np.float32)
        y = yolo_labels(rng, batch, 20)
    net.setPrecisionPolicy("bf16")
    net.setComputeLayout("NHWC")
    net.setEpilogueFusion(True)
    return net, DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(BATCH), default="resnet50")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fit: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    ck.install_platform_overrides()
    net, ds = build(args.model)
    batch = BATCH[args.model]
    for _ in range(WARM):
        net.fit(ds)
    net.score()
    ck.reset_counts()
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        net.fit(ds)
        net.score()
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"card": smi, "model": args.model, "batch": batch,
           "launches_per_step": {k: v // ITERS for k, v in ck.LAUNCHES.items()},
           "step_ms_median": float(np.median(times)),
           "step_ms_min": float(np.min(times)),
           "step_ms_max": float(np.max(times)),
           "images_per_s": batch / (float(np.median(times)) / 1e3),
           "loss": net.score()}
    out.update(profile(net, ds))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
