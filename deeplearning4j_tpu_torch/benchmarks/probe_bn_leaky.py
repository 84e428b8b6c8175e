"""Probe: is TinyYOLO's 416² BN+leaky block bound by the card's memory,
or by how it is lowered? The port of ``benchmarks/probe_bn_leaky.py``.

The op chain is training-mode BatchNorm (per-channel mean and variance
over N, H, W) followed by a leaky relu on TinyYOLO's first block,
[32, 16, 416, 416] bf16: a few flops per element against ~6 bytes of
device-memory traffic, so it is bandwidth-bound. The probe measures the
card's streaming rate (one read and one write per element), then times
the composed PyTorch version (:func:`bn_leaky`, the counterpart of the
JAX probe's XLA line) and the two hand-written CUDA kernels
(:func:`bn_leaky_kernels`: ``cuda_kernels.bn_stats`` and
``cuda_kernels.bn_apply_leaky``, three passes over x, the fewest the
training-mode op allows) against that rate, and gives the JAX probe's
three-way verdict with its thresholds (0.7 of the stream, 1.15x).

The probe's semantics, which differ from the networks' ``fused_bn_act``:
slope 0.1 with ``y > 0``; the variance ``E[x²] - E[x]²`` without a clamp
at 0; scale and shift kept in fp32.

Run on a machine with a CUDA card::

    python3 -m deeplearning4j_tpu_torch.benchmarks.probe_bn_leaky [--trace]

``--trace`` also traces one call of each version with ``torch.profiler``
and prints the device time of every kernel it launched.

Without a card it exits non-zero: the probe measures the card and has no
CPU fallback.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

#: H100 SXM HBM3, the data sheet's figure (the stream below is measured)
HBM_PEAK_GBPS = 3350.0
SHAPE = (32, 16, 416, 416)
ITERS = 30


def _chained_ms(fn, x, iters: int) -> float:
    """Milliseconds per call of ``x = fn(x)`` chained ``iters`` times on
    the card, between two CUDA events, after one warm call."""
    fn(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    acc = x
    for _ in range(iters):
        acc = fn(acc)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measured_stream_gbps(x, iters: int = ITERS) -> float:
    """The streaming rate the card reaches on ``x``'s bytes: a one-pass
    elementwise op (``x * 1.0000001``, one read and one write an
    element) chained ``iters`` times between CUDA events."""
    ms = _chained_ms(lambda a: torch.mul(a, 1.0000001), x, iters)
    return 2 * x.numel() * x.element_size() / (ms * 1e-3) / 1e9


def bn_leaky(x, gamma, beta, alpha: float = 0.1, eps: float = 1e-5):
    """The composed version over x [N, C, H, W]: fp32 batch mean and
    (centred) variance over N, H, W, normalize, scale and shift, then
    ``y > 0 ? y : alpha*y``, cast back to x's dtype."""
    x32 = x.float()
    m = x32.mean(dim=(0, 2, 3), keepdim=True)
    v = (x32 - m).square().mean(dim=(0, 2, 3), keepdim=True)
    y = (x32 - m) * torch.rsqrt(v + eps)
    y = y * gamma[None, :, None, None] + beta[None, :, None, None]
    return torch.where(y > 0, y, alpha * y).to(x.dtype)


def two_pass_bytes(x) -> int:
    """Statistics read + apply read + write, in x's dtype."""
    return 3 * x.numel() * x.element_size()


def bn_leaky_kernels(x2d, gamma, beta, alpha: float = 0.1,
                     eps: float = 1e-5):
    """BN+leaky over the channel-major x [C, M] (M = N*H*W) through the
    two kernels: ``bn_stats``, then the fp32 [C] arithmetic of the JAX
    ``pallas_bn_leaky`` (benchmarks/probe_bn_leaky.py:58; mean ``s/M``,
    variance ``q/M - mean²`` unclamped, fp32 scale and shift), then
    ``bn_apply_leaky``. Its ``rows``/``cols`` (VMEM block shapes) have no
    counterpart on the card. Returns y [C, M] in x's dtype."""
    m = x2d.shape[1]
    sums, sumsq = ck.bn_stats(x2d)
    mean = sums / m
    var = sumsq / m - mean * mean
    scale = gamma.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    return ck.bn_apply_leaky(x2d, scale.contiguous(), shift.contiguous(),
                             alpha)


def verdict(stream_gbps: float, composed_ms: float, kernels_ms: float,
            nbytes: int) -> Tuple[str, float, float]:
    """The JAX probe's three-way verdict: ``(line, composed share of the
    stream, speedup of the kernels over the composed version)``."""
    frac = nbytes / (composed_ms * 1e-3) / 1e9 / stream_gbps
    speedup = composed_ms / kernels_ms
    if frac > 0.7 and speedup < 1.15:
        line = (f"verdict: PHYSICS — the composed version runs at {frac:.0%} "
                f"of this card's measured streaming bandwidth and the "
                f"kernels are {speedup:.2f}x; the plateau is set by "
                "effective memory bandwidth, not by the lowering.")
    elif speedup >= 1.15:
        line = (f"verdict: LOWERING — the kernels are {speedup:.2f}x over "
                "the composed version here; promote them to a platform "
                "override.")
    else:
        line = (f"verdict: INCONCLUSIVE — the composed version at {frac:.0%} "
                f"of the measured stream, the kernels {speedup:.2f}x; "
                "neither is near the roofline, so something else (dispatch, "
                "layout) dominates at this shape.")
    return line, frac, speedup


def _inputs():
    """x at SHAPE in bf16 from seed 0, with gamma 1 and beta 0, on the card."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    c = SHAPE[1]
    return x, torch.ones(c, device=dev), torch.zeros(c, device=dev)


def main() -> Dict:
    """Run the probe on the card at SHAPE (N, C, H, W) bf16 and print the
    JAX probe's lines and verdict; returns the numbers, with ``calls``,
    the number of :func:`bn_leaky_kernels` calls made (one ``bn_stats``
    and one ``bn_apply_leaky`` launch each)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures a CUDA card; none is "
                           "available")
    n, c, h, w = SHAPE
    x, gamma, beta = _inputs()
    nbytes = two_pass_bytes(x)
    stream = measured_stream_gbps(x.reshape(-1))
    composed_ms = _chained_ms(lambda a: bn_leaky(a, gamma, beta), x, ITERS)
    print(f"measured stream roofline: {stream:.0f} GB/s "
          f"(= {stream / HBM_PEAK_GBPS:.1%} of the public "
          f"{HBM_PEAK_GBPS:.0f} GB/s)")
    gbps = nbytes / (composed_ms * 1e-3) / 1e9
    print(f"composed bn+leaky {list(SHAPE)} bf16: {composed_ms:.3f} ms/iter, "
          f"{gbps:.0f} GB/s = {gbps / stream:.0%} of the measured roofline")

    # the kernels over the channel-major view, made once outside the loop
    x2d = x.transpose(0, 1).reshape(c, n * h * w)
    ref = bn_leaky(x, gamma, beta).float()
    got = bn_leaky_kernels(x2d, gamma, beta).float()
    err = float((got.reshape(c, n, h, w).transpose(0, 1) - ref).abs().max())
    print(f"kernels vs composed max|err|: {err}")
    if not err < 0.05:
        raise AssertionError(f"kernels and composed version differ by {err}")
    kernels_ms = _chained_ms(lambda a: bn_leaky_kernels(a, gamma, beta), x2d,
                             ITERS)
    gbpsk = nbytes / (kernels_ms * 1e-3) / 1e9
    line, frac, speedup = verdict(stream, composed_ms, kernels_ms, nbytes)
    print(f"CUDA kernels (bn_stats + bn_apply_leaky): {kernels_ms:.3f} "
          f"ms/iter, {gbpsk:.0f} GB/s = {gbpsk / stream:.0%} of the "
          f"measured roofline, {speedup:.2f}x vs composed")
    print(line, flush=True)
    return {"shape": list(SHAPE), "stream_gbps": stream,
            "composed_ms": composed_ms, "composed_share": frac,
            "kernels_ms": kernels_ms, "kernels_share": gbpsk / stream,
            "speedup": speedup, "max_abs_err": err, "verdict": line,
            "calls": 1 + 1 + ITERS}


def trace() -> Dict[str, Dict[str, float]]:
    """Device microseconds by kernel name of one call of the composed
    version and one of the kernels, from a ``torch.profiler`` trace
    (each version warmed first)."""
    n, c, h, w = SHAPE
    x, gamma, beta = _inputs()
    x2d = x.transpose(0, 1).reshape(c, n * h * w)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name, fn in (("composed", lambda: bn_leaky(x, gamma, beta)),
                     ("kernels", lambda: bn_leaky_kernels(x2d, gamma, beta))):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        out[name] = {ev.key[:80]: getattr(ev, "device_time_total",
                                          getattr(ev, "cuda_time_total", 0))
                     for ev in prof.key_averages()
                     if ev.device_type == torch.autograd.DeviceType.CUDA}
    return out


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true",
                    help="print each kernel's device time of one call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_bn_leaky: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    main()
    if args.trace:
        for name, kernels in trace().items():
            print(f"{name}: " + ", ".join(
                f"{k} {us:.1f} us" for k, us in sorted(
                    kernels.items(), key=lambda kv: -kv[1])))
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
