#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``deeplearning4j_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit):

1. Environment: card name and power limit, torch/CUDA versions, and the
   build of every CUDA kernel from ``deeplearning4j_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, all started together).
2. Each kernel against its plain PyTorch version on the card, at the
   listed shapes, with the tolerances below; then each one timed (CUDA
   events, median of 30 launches, L2 flushed before each) beside its
   plain version, its roofline bound, and one PyTorch library call that
   computes the same function (a yardstick only; the port never calls it).
3. Serve BERT-base (full width, bf16, random weights from a seed) through
   ``ModelServer(lm.logits, head="argmax")`` with the kernels installed:
   warmup, then 64 requests of 1-8 rows at T=128 and T=512 from four
   threads. Every request must resolve exactly once, agree with a direct
   ``lm.logits`` on >= 99.9% of tokens, and the launch counters must read
   12 flash-attention and 25 layer-norm launches per dispatched forward.
   One forward with the kernels is held against the same forward on the
   plain versions.

Tolerances: fp32 ``rtol=atol=2e-5`` (as ``tests/test_pallas.py``); bf16
``rtol=atol=2e-2`` (a few bf16 ulps: both sides round the same fp32
value, summed in another order); lse 1e-5 absolute in fp32.

Output: progress lines, then a JSON line ``{"kernels": [...]}``, the
``nvidia-smi`` name/power-limit line, and as the last line
``{"ok": true, "device": {...}}``. Without a card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # fp32 outside the tensor cores
TIMED_RUNS = 30


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "deeplearning4j_tpu_torch")):
        fail(f"no deeplearning4j_tpu_torch package beside {__file__}: run "
             "from the root of a checkout")
    sys.path.insert(0, root)
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.serving import ModelServer

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()

    # ------------------------------------------------------ 1. environment
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    paths = ck.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s for "
        f"{', '.join(p.name for p in paths.values())}")

    # ------------------------------------------- 2. kernels against plain
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def rand(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=gen, device=dev) * scale + shift
        return x.to(dtype)

    def tol(dtype):
        return 2e-5 if dtype == torch.float32 else 2e-2

    def check(name, got, want, dtype, atol=None):
        a = tol(dtype) if atol is None else atol
        r = tol(dtype) if atol is None else 0.0
        err = (got.float() - want.float()).abs()
        bad = err > a + r * want.float().abs()
        if bool(bad.any()):
            fail(f"{name}: max |err| {err.max().item():.3g} over "
                 f"atol={a:g} rtol={r:g} at {int(bad.sum())} element(s)")
        return float(err.max().item())

    def time_ms(fn):
        for _ in range(3):
            fn()
        ts = []
        for _ in range(TIMED_RUNS):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    # the serving path's LN rows are B*T for T in (128, 512), B <= 32
    for n, d in ((4096, 768), (16384, 768), (1000, 1024), (4093, 768)):
        for dt in (torch.float32, torch.bfloat16):
            x = rand(n, d, dtype=dt, scale=2.0, shift=0.5)
            g, b = rand(d, scale=0.5, shift=1.0), rand(d, scale=0.1)
            y = ck.layer_norm_fwd(x, g, b, 1e-5)
            torch.cuda.synchronize()
            e = check(f"layer_norm [{n},{d}] {dt}", y,
                      ck.layer_norm_plain(x, g, b, 1e-5), dt)
            log(f"layer_norm [{n}, {d}] {str(dt)[6:]}: max|err| {e:.3g}")

    flash_cases = [(2, T, 12, 64, dt, c) for T in (128, 512)
                   for dt in (torch.float32, torch.bfloat16)
                   for c in (False, True)]
    flash_cases.append((32, 512, 12, 64, torch.bfloat16, False))
    flash_cases.append((2, 256, 6, 128, torch.bfloat16, False))
    flash_cases.append((2, 256, 6, 128, torch.float32, True))
    for B, T, H, D, dt, causal in flash_cases:
        q, k, v = (rand(B, T, H, D, dtype=dt) for _ in range(3))
        o, lse = ck.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        op, lp = ck.flash_attention_plain(q, k, v, causal)
        name = f"flash_attention B={B} T={T} H={H} D={D} {dt} causal={causal}"
        e = check(name, o, op, dt)
        el = check(name + " lse", lse, lp, dt, atol=1e-5)
        log(f"{name}: max|err| o {e:.3g}, lse {el:.3g}")

    # timing at the serving path's shapes: LN on [B*T, E] fp32 with
    # B=32, T=128; flash on B=32, T=128, H=12, D=64 bf16, non-causal
    N, E = 32 * 128, 768
    x = rand(N, E, scale=2.0, shift=0.5)
    g, b = rand(E, scale=0.5, shift=1.0), rand(E, scale=0.1)
    ln_err = check("layer_norm main shape", ck.layer_norm_fwd(x, g, b, 1e-5),
                   ck.layer_norm_plain(x, g, b, 1e-5), torch.float32)
    ln = {
        "name": "layer_norm", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/ops/csrc/layer_norm.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:72",
        "shape": f"x [{N}, {E}] float32",
        "max_abs_err": ln_err,
        "ms": time_ms(lambda: ck.layer_norm_fwd(x, g, b, 1e-5)),
        "plain_ms": time_ms(lambda: ck.layer_norm_plain(x, g, b, 1e-5)),
        "library_ms": time_ms(lambda: F.layer_norm(x, (E,), g, b, 1e-5)),
    }
    ln_bytes = 2 * N * E * 4 + 2 * E * 4
    ln_ops = 8 * N * E
    ln.update(bound(ln_bytes, ln_ops, FP32_FLOPS))

    B, T, H, D = 32, 128, 12, 64
    q, k, v = (rand(B, T, H, D, dtype=torch.bfloat16) for _ in range(3))
    fa_err = check("flash_attention main shape",
                   ck.flash_attention_fwd(q, k, v, False)[0],
                   ck.flash_attention_plain(q, k, v, False)[0],
                   torch.bfloat16)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    fa = {
        "name": "flash_attention", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:341",
        "shape": f"q, k, v [{B}, {T}, {H}, {D}] bfloat16, non-causal",
        "max_abs_err": fa_err,
        "ms": time_ms(lambda: ck.flash_attention_fwd(q, k, v, False)),
        "plain_ms": time_ms(lambda: ck.flash_attention_plain(q, k, v, False)),
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh)),
    }
    fa_bytes = 4 * B * T * H * D * 2 + B * H * T * 4
    fa_ops = 4 * B * H * T * T * D
    fa.update(bound(fa_bytes, fa_ops, BF16_FLOPS))
    for kr in (ln, fa):
        log(f"{kr['name']} at {kr['shape']}: kernel {kr['ms']:.4f} ms, "
            f"plain {kr['plain_ms']:.4f} ms, library {kr['library_ms']:.4f} "
            f"ms, bound {kr['bound_ms']:.4f} ms ({kr['bound_by']}) [{smi}]")
    del flush

    # ------------------------------------------------- 3. serve BERT-base
    ck.install_platform_overrides()
    cfg = TransformerConfig.bert_base(use_flash_attention=True)
    t0 = time.perf_counter()
    lm = TransformerLM(cfg, seed=0)
    log(f"BERT-base: {lm.n_params()} parameters, {cfg.n_layers} layers, "
        f"E={cfg.d_model}, H={cfg.n_heads}, dtype {cfg.dtype}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    server = ModelServer(lm.logits, batch_limit=32, input_dtype=np.int32,
                         head="argmax", coalesce_ms=5.0, max_queue=256)
    try:
        t0 = time.perf_counter()
        server.warmup([(128,), (512,)])
        log(f"warmup: buckets {server.buckets()} x T in (128, 512) in "
            f"{time.perf_counter() - t0:.2f} s")

        rng = np.random.default_rng(0)
        reqs_in = [rng.integers(0, cfg.vocab_size,
                                (int(rng.integers(1, 9)),
                                 128 if i % 2 == 0 else 512), dtype=np.int32)
                   for i in range(64)]
        handles = [None] * len(reqs_in)
        errors = []
        batches0 = server.stats()["batches"]

        def client(idx):
            try:
                for i in idx:
                    handles[i] = server.submit(reqs_in[i])
                    time.sleep(0.002)
            except Exception as e:     # reported below, fails the run
                errors.append(e)

        ck.reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(range(j, 64, 4),))
                   for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        if errors or any(t.is_alive() for t in threads):
            fail(f"client threads failed: {errors}")
        served = [h.get(300) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        plain = dict(ck.PLAIN_CALLS)
        n_fwd = server.stats()["batches"] - batches0
    finally:
        server.close()

    if any(h.resolutions != 1 for h in handles):
        fail("a request was not resolved exactly once")
    if server.counts["completed"] != 64:
        fail(f"expected 64 completed requests, counts {dict(server.counts)}")
    if launches != {"flash_attention": 12 * n_fwd, "layer_norm": 25 * n_fwd} \
            or any(plain.values()):
        fail(f"launch counts {launches} (plain {plain}) over {n_fwd} "
             "forwards: want 12 flash_attention and 25 layer_norm each")
    log(f"served 64 requests in {n_fwd} forwards; launches {launches}")
    lat = sorted(h.resolved_at - h.enqueued_at for h in handles)
    tokens = sum(int(r.size) for r in reqs_in)
    log(f"latency p50 {1e3 * float(np.percentile(lat, 50)):.2f} ms, "
        f"p99 {1e3 * float(np.percentile(lat, 99)):.2f} ms, "
        f"{tokens / wall:.1f} tokens/s ({tokens} tokens in {wall:.3f} s) "
        f"[{smi}]")

    agree = total = 0
    for r, got in zip(reqs_in, served):
        want = lm.logits(r).argmax(-1).to(torch.int32).cpu().numpy()
        if got.shape != want.shape:
            fail(f"served shape {got.shape} != direct {want.shape}")
        agree += int((got == want).sum())
        total += want.size
    frac = agree / total
    log(f"served argmax agrees with direct lm.logits on {agree}/{total} "
        f"tokens ({frac:.5f})")
    if frac < 0.999:
        fail(f"served/direct argmax agreement {frac:.5f} < 0.999")

    # the same forward with the plain versions of both kernels
    tok = reqs_in[0]
    with torch.inference_mode():
        kern = lm.logits(tok)
        registry.register_platform_override(
            "layer_norm", lambda x, g, b=None, *, axis=-1, eps=1e-5:
            ck.layer_norm_plain(x, g, b, eps))
        registry.register_platform_override(
            "flash_attention", lambda q, k, v, *, mask=None, is_causal=False,
            block_size=512: ck.flash_attention_plain(q, k, v, is_causal)[0])
        plain_logits = lm.logits(tok)
        ck.install_platform_overrides()
    if not bool(torch.isfinite(kern).all()) or \
            kern.shape != (tok.shape[0], tok.shape[1], cfg.vocab_size):
        fail(f"logits not finite or of shape {tuple(kern.shape)}")
    dl = (kern - plain_logits).abs()
    scale = float(plain_logits.abs().max())
    log(f"kernel vs plain forward logits: max|diff| {float(dl.max()):.4g}, "
        f"mean|diff| {float(dl.mean()):.4g}, max|logit| {scale:.4g}")
    # bound: bf16 activations carry 8 significant bits; the two forwards
    # round the same values after sums in another order, so each layer
    # may move a value by an ulp or two and 12 layers compound that
    if float(dl.max()) > 0.05 * scale or float(dl.mean()) > 2e-3 * scale:
        fail("kernel and plain forwards disagree beyond the bf16 bound "
             "(max 5%, mean 0.2% of max|logit|)")

    ln["launches"] = launches["layer_norm"]
    fa["launches"] = launches["flash_attention"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: kr[k] for k in keys}
                                  for kr in (ln, fa)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def bound(nbytes: int, ops: int, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate for their
    type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


if __name__ == "__main__":
    main()
