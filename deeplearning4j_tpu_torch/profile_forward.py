"""Where one served BERT-base forward spends its time on the card.

Usage (on a machine with a CUDA card, from the root of a checkout)::

    python3 -m deeplearning4j_tpu_torch.profile_forward

For T in (128, 512) it builds ``TransformerLM(bert_base(
use_flash_attention=True))`` in bf16 (random weights from seed 0) with
the CUDA kernels installed, times ``lm.logits`` on a [32, T] token
batch with CUDA events (median of 10 forwards after a warmup),
and traces one forward with ``torch.profiler`` to sum device time by
kernel name and by group (the port's two kernels, matrix products, the
rest). It prints one JSON object per length. Without a card it exits
non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.transformer import (TransformerConfig,
                                                         TransformerLM)
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

BATCH = 32                 # the serving path's largest bucket
LENGTHS = (128, 512)       # the two request lengths chip_smoke.py serves
ITERS = 10


def _group(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    if "layer_norm_fwd_kernel" in name:
        return "layer_norm"
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "sm90_xmma", "nvjet",
                              "cublas", "matmul")):
        return "matmul"
    return "other"


def profile(lm: TransformerLM, tokens: torch.Tensor, iters: int) -> dict:
    for _ in range(3):
        lm.logits(tokens)
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        lm.logits(tokens)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        lm.logits(tokens)
        torch.cuda.synchronize()
    by_kernel, by_group, launches = {}, {}, 0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if not us or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        launches += ev.count
        by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us / 1e3
        g = _group(ev.key)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"forward_ms_median": float(np.median(times)),
            "forward_ms_min": float(np.min(times)),
            "traced_device_ms": sum(by_group.values()),
            "device_kernels_per_forward": launches,
            "device_ms_by_group": by_group,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_forward: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    ck.install_platform_overrides()
    lm = TransformerLM(TransformerConfig.bert_base(use_flash_attention=True),
                       seed=0)
    rng = np.random.default_rng(0)
    for T in LENGTHS:
        tokens = torch.from_numpy(rng.integers(
            0, lm.cfg.vocab_size, (BATCH, T))).cuda()
        ck.reset_counts()
        lm.logits(tokens)
        launches = dict(ck.LAUNCHES)
        out = {"card": smi, "batch": BATCH, "T": T,
               "launches_per_forward": launches}
        out.update(profile(lm, tokens, ITERS))
        out["tokens_per_s"] = BATCH * T / (out["forward_ms_median"] / 1e3)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
