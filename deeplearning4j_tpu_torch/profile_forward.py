"""Where one served BERT-base forward spends its time on the card.

Usage (on a machine with a CUDA card, from the root of a checkout)::

    python3 -m deeplearning4j_tpu_torch.profile_forward [--model keras]

For T in (128, 512) it builds ``TransformerLM(bert_base(
use_flash_attention=True))`` in bf16 (random weights from seed 0) with
the CUDA kernels installed, times ``lm.logits`` on a [32, T] token
batch with CUDA events (median of 10 forwards after a warmup),
and traces one forward with ``torch.profiler`` to sum device time by
kernel name and by group (the port's two kernels, matrix products,
softmax, copies and transposes, other elementwise work, the rest). It
prints one JSON object per length. ``--model keras`` does the same at
B=32, T=128 for two fp32 BERT-base-wide classifiers: the Keras encoder
of ``keras_fixtures.encoder_h5`` imported through ``modelimport.keras``
(a ``ComputationGraph``) and phase 23's path A (``transformer.encode``
over a checkpoint of ``tf_fixtures.bert_weights``, with its pooler and
head). Without a card it exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

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
    if "softmax" in low:
        return "softmax"
    if "copy" in low or "transpose" in low:
        return "copy"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def profile(fn, iters: int) -> dict:
    """Time ``fn()`` (a forward) with CUDA events, then trace one call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
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


def keras_and_path_a(smi: str) -> None:
    """The imported Keras encoder against path A, both fp32 at B=32,
    T=128, one JSON object each."""
    from deeplearning4j_tpu_torch.modelimport import keras_fixtures as kf
    from deeplearning4j_tpu_torch.modelimport import tf_fixtures as fx
    from deeplearning4j_tpu_torch.modelimport.bert import \
        importBertModelAndWeights
    from deeplearning4j_tpu_torch.modelimport.keras import \
        importKerasModelAndWeights
    from deeplearning4j_tpu_torch.models import transformer as tfm
    T = 128
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "encoder.h5")
        kf.encoder_h5(path, 0, T=T)
        net = importKerasModelAndWeights(path)
        w = fx.bert_weights(0, **fx.BERT_BASE)
        path = os.path.join(d, "bert.bin")
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in fx.hf_state(w).items()}, path)
        cfg, params = importBertModelAndWeights(path,
                                                use_flash_attention=True)
    head = {k: torch.from_numpy(w[k]).cuda() for k in (
        "bert/pooler/dense/kernel", "bert/pooler/dense/bias",
        "output_weights", "output_bias")}
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 30522, (BATCH, T),
                                           dtype=np.int32)).cuda()
    pos = torch.arange(T, device="cuda", dtype=torch.int32).expand(BATCH, T)

    def path_a():
        with torch.inference_mode():
            x = tfm.encode(params, tokens.long(), cfg)
            pooled = torch.tanh(x[:, 0] @ head["bert/pooler/dense/kernel"]
                                + head["bert/pooler/dense/bias"])
            return pooled @ head["output_weights"].T + head["output_bias"]

    for name, fn in (("keras_import", lambda: net.output([tokens, pos])),
                     ("path_a_encode", path_a)):
        ck.reset_counts()
        fn()
        out = {"card": smi, "model": name, "dtype": "float32",
               "batch": BATCH, "T": T,
               "launches_per_forward": dict(ck.LAUNCHES)}
        out.update(profile(fn, ITERS))
        out["tokens_per_s"] = BATCH * T / (out["forward_ms_median"] / 1e3)
        print(json.dumps(out), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_forward: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    ck.install_platform_overrides()
    if "--model" in sys.argv and \
            sys.argv[sys.argv.index("--model") + 1] == "keras":
        keras_and_path_a(smi)
        return 0
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
        out.update(profile(lambda: lm.logits(tokens), ITERS))
        out["tokens_per_s"] = BATCH * T / (out["forward_ms_median"] / 1e3)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
