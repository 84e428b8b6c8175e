"""Hand-written CUDA kernels — platform overrides for the port's paths.

The port's counterpart of ``deeplearning4j_tpu/ops/pallas_kernels.py``:
each Pallas kernel on the path becomes a CUDA C++ kernel for Hopper
(``csrc/*.cu``, ``sm_90a``) that shadows the generic op through
:func:`ops.registry.register_platform_override`.

- **Build.** At first use every ``csrc/*.cu`` is compiled by ``nvcc``
  (one process per source, all started together) into a shared library
  with a plain C interface, keyed by a hash of the source and the flags
  (each kernel is one self-contained ``.cu``), under
  ``deeplearning4j_tpu_torch/_build/``; a later process reuses it. The
  compiler's output (``-Xptxas -v``: registers, shared memory and spills
  of every kernel) is kept beside the library and read by
  :func:`ptxas_report`. A missing ``nvcc`` or a failed build raises.
- **Binding.** ``ctypes``; every pointer and the stream
  (``torch.cuda.current_stream().cuda_stream``) is a ``c_void_p``. Each
  launcher returns ``cudaGetLastError()`` and the wrapper raises on
  anything but 0.
- **Wrappers.** ``layer_norm_fwd``, ``flash_attention_fwd``,
  ``scale_shift_act_fwd``, ``softmax_fwd``, ``bn_stats`` and
  ``bn_apply_leaky`` check device, dtype, shape and contiguity, allocate
  their outputs (and scratch) with ``torch.empty`` and launch on the
  current stream. A tensor on the CPU takes the kernel's plain
  PyTorch version (``*_plain``) instead; there is no fallback from a CUDA
  tensor. ``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` counts
  plain-version calls made by the wrappers, one a wrapper call, keyed by
  ``KERNELS``: a ``bn_stats`` count covers its two ``__global__``
  kernels (the partial sums and the final sum). ``FLASH_ROUTES`` splits
  the flash launches by route (:func:`flash_route`). A launch recorded
  into a CUDA graph counts once, at capture; ``REPLAYS`` counts the
  launches replayed graphs run (``nn.compilecache``).
- **Names.** ``KERNELS`` are the counter keys, one a wrapper;
  ``SOURCES`` are the ``.cu`` files, one library each. :func:`build`,
  :func:`ptxas_report` and ``_lib`` take source names (``bn_stats`` and
  ``bn_apply_leaky`` both live in ``bn_leaky``).
- **Gates.** ``supported`` / ``flash_supported`` /
  ``scale_shift_act_supported`` / ``softmax_supported`` decide, as in the
  JAX package, which calls the kernels take; masked attention and
  shapes/dtypes outside the gates go to the generic ops. Inside the flash
  gate, :func:`flash_route` picks the bf16 tensor-core kernel, the 3xTF32
  tensor-core kernel (fp32; each where its 16-byte copies align) or the
  CUDA-core kernel (the rest) before launch; a launch that fails raises
  and is never retried on another route.

The BN+leaky probe's two kernels (``csrc/bn_leaky.cu``: ``bn_stats``
and ``bn_apply_leaky``, the port of ``benchmarks/probe_bn_leaky.py``'s
Pallas passes) are not installed over any op: the probe
(``deeplearning4j_tpu_torch.benchmarks.probe_bn_leaky``) calls them, as
the JAX package never routes BN through the probe's kernels.

Gradients: each override runs its kernel under a
``torch.autograd.Function`` whose backward is composed torch, as the JAX
custom VJPs are composed jnp (pallas_kernels.py:101-115 layer norm,
:165-169 softmax, :253-263 the epilogue, :375-409 flash attention). The
Function also runs on CPU tensors, where its forward takes the plain
version, so the CPU tests reach the composed backwards.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from deeplearning4j_tpu_torch.ops import attention as attn_ops
from deeplearning4j_tpu_torch.ops import normalization as norm_ops

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: kernel sources, one library each (``csrc/<name>.cu``)
SOURCES = ("layer_norm", "flash_attention", "scale_shift_act", "softmax",
           "bn_leaky")
#: counter keys of ``LAUNCHES``/``PLAIN_CALLS``, one a wrapper
KERNELS = ("layer_norm", "flash_attention", "scale_shift_act", "softmax",
           "bn_stats", "bn_apply_leaky")

#: kernel launches made by the wrappers (CUDA tensors only)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
#: plain-version calls made by the wrappers (CPU tensors only)
PLAIN_CALLS: Dict[str, int] = {name: 0 for name in KERNELS}
#: flash-attention launches by route (``LAUNCHES`` counts them all)
FLASH_ROUTES: Dict[str, int] = {"tensor_core": 0, "tf32x3": 0,
                                "cuda_core": 0}
#: the ``route`` argument of ``dl4j_flash_attention_fwd``
_FLASH_ROUTE_CODE = {"cuda_core": 0, "tensor_core": 1, "tf32x3": 2}
#: kernel launches run by replaying captured CUDA graphs (a wrapper
#: counts its launch in ``LAUNCHES`` once, while the graph is captured;
#: ``nn.compilecache`` adds the graph's count here at each replay)
REPLAYS: Dict[str, int] = {name: 0 for name in KERNELS}
_COUNT_LOCK = threading.Lock()

_LIB_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LN_MAX_D = 8192           # above 1024 a row is staged in 32 KB of smem
_FLASH_D = (64, 128, 192, 256)
_SSA_MAX_C = 4096          # the JAX gate's bound (epilogue_supported)
_SOFTMAX_MAX_D = 12288     # a staged row in 48 KB of shared memory
_FLASH_BWD_K = 256         # the k block of the composed flash backward


def reset_counts() -> None:
    with _COUNT_LOCK:
        for name in KERNELS:
            LAUNCHES[name] = 0
            PLAIN_CALLS[name] = 0
        for route in FLASH_ROUTES:
            FLASH_ROUTES[route] = 0
        for name in KERNELS:
            REPLAYS[name] = 0


def _bump(counter: Dict[str, int], name: str) -> None:
    with _COUNT_LOCK:
        counter[name] += 1


def count_replay(launches: Dict[str, int]) -> None:
    """Add one replayed graph's recorded launches to ``REPLAYS``."""
    with _COUNT_LOCK:
        for name, n in launches.items():
            REPLAYS[name] += n


# ------------------------------------------------------------------ build
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from deeplearning4j_tpu_torch/ops/csrc at first use and need the "
        "CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every kernel source not yet built (in parallel) and
    return each source's library path. Raises on a missing ``nvcc`` or a
    failed compile, with the compiler's output."""
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, out in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT),
                           tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n"
                              f"{log.decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                out.with_suffix(".log").write_bytes(log)
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    return paths


def ptxas_report(name: str) -> List[Tuple[str, int, int, int]]:
    """(kernel, registers, spill-store bytes, spill-load bytes) of every
    kernel in source ``name``'s library, from the ``-Xptxas -v`` output kept at
    build time (empty if the library was built before that was kept)."""
    log = _lib_path(name).with_suffix(".log")
    if not log.exists():
        return []
    rows, fn, spills = [], None, (0, 0)
    for line in log.read_text(errors="replace").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            rows.append((fn, int(m.group(1))) + spills)
            fn, spills = None, (0, 0)
    return rows


def _lib(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, building every source at
    first use."""
    with _LIB_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build()
            for n, path in paths.items():
                _LIBS[n] = _bind(n, ctypes.CDLL(str(path)))
            lib = _LIBS[name]
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    if name == "layer_norm":
        fn = lib.dl4j_layer_norm_fwd
        fn.argtypes = [P, P, P, P, LL, I, F, I, P]
    elif name == "flash_attention":
        fn = lib.dl4j_flash_attention_fwd
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I,
                       ctypes.POINTER(LL), F, I, I, I, P]
    elif name == "scale_shift_act":
        fn = lib.dl4j_scale_shift_act_fwd
        fn.argtypes = [P, P, P, P, LL, I, F, I, I, P]
    elif name == "softmax":
        fn = lib.dl4j_softmax_fwd
        fn.argtypes = [P, P, LL, I, I, P]
    elif name == "bn_leaky":
        lib.dl4j_bn_chunks.argtypes = [LL, I]
        lib.dl4j_bn_chunks.restype = LL
        lib.dl4j_bn_stats.argtypes = [P, LL, LL, I, P, P, P, P]
        lib.dl4j_bn_stats.restype = I
        fn = lib.dl4j_bn_apply_leaky
        fn.argtypes = [P, P, P, P, LL, LL, F, I, P]
    else:
        raise KeyError(f"no binding for source {name!r}")
    fn.restype = I
    return lib


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ------------------------------------------------------------- layer_norm
def layer_norm_plain(x, gain, bias, eps: float = 1e-5):
    """The kernel's function in plain PyTorch: fp32 mean, biased
    variance, ``(x-m)*rsqrt(v+eps)*g+b`` cast back to x's dtype."""
    x32 = x.float()
    m = x32.mean(dim=-1, keepdim=True)
    v = (x32 - m).square().mean(dim=-1, keepdim=True)
    y = (x32 - m) * torch.rsqrt(v + eps)
    return (y * gain.float() + bias.float()).to(x.dtype)


def layer_norm_fwd(x, gain, bias, eps: float = 1e-5):
    """Row LayerNorm of x [N, D] (fp32/bf16) with gain, bias [D]."""
    if x.device.type == "cpu":
        _bump(PLAIN_CALLS, "layer_norm")
        return layer_norm_plain(x, gain, bias, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"layer_norm: no kernel for device {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"layer_norm: want a 2-D fp32/bf16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, d = x.shape
    if not 1 <= d <= _LN_MAX_D or n < 1:
        raise ValueError(f"layer_norm: shape {tuple(x.shape)} outside "
                         f"1 <= D <= {_LN_MAX_D}, N >= 1")
    if not x.is_contiguous():
        raise ValueError("layer_norm: x must be contiguous")
    for t, what in ((gain, "gain"), (bias, "bias")):
        if t.device != x.device or tuple(t.shape) != (d,):
            raise ValueError(f"layer_norm: {what} must be [{d}] on {x.device}")
    g = gain.to(torch.float32).contiguous()
    b = bias.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    lib = _lib("layer_norm")
    with torch.cuda.device(x.device):
        rc = lib.dl4j_layer_norm_fwd(x.data_ptr(), g.data_ptr(),
                                     b.data_ptr(), y.data_ptr(), n, d,
                                     float(eps), _DTYPE_CODE[x.dtype],
                                     _stream(x.device))
    _check_launch("layer_norm", rc)
    _bump(LAUNCHES, "layer_norm")
    return y


class _LayerNormKernel(torch.autograd.Function):
    """The kernel forward; the backward mirrors the JAX custom VJP
    (pallas_kernels.py:101-115): ``xhat`` and the cotangent in fp32, dx
    in x's dtype, dgain and dbias reduced in fp32 and cast to gain's
    dtype."""

    @staticmethod
    def forward(ctx, x, gain, bias, eps):
        ctx.save_for_backward(x, gain)
        ctx.eps = eps
        return layer_norm_fwd(x, gain, bias, eps)

    @staticmethod
    def backward(ctx, ct):
        x, gain = ctx.saved_tensors
        x32 = x.float()
        g32 = ct.float()
        m = x32.mean(dim=1, keepdim=True)
        v = (x32 - m).square().mean(dim=1, keepdim=True)
        inv = torch.rsqrt(v + ctx.eps)
        xhat = (x32 - m) * inv
        gy = g32 * gain.float()
        dx = inv * (gy - gy.mean(dim=1, keepdim=True)
                    - xhat * (gy * xhat).mean(dim=1, keepdim=True))
        dgain = (g32 * xhat).sum(dim=0)
        dbias = g32.sum(dim=0)
        return (dx.to(x.dtype), dgain.to(gain.dtype), dbias.to(gain.dtype),
                None)


def supported(x, axis: int = -1) -> bool:
    """Calls the layer-norm kernel takes: 2-D fp32/bf16, normalized axis
    last, D <= 8192, any N (wider than the TPU kernel's (8, 128) tiling
    gate, which it contains)."""
    if x.dim() != 2 or axis not in (-1, 1):
        return False
    n, d = x.shape
    return n >= 1 and 1 <= d <= _LN_MAX_D and x.dtype in _DTYPE_CODE


def make_layer_norm_override():
    """The ``layer_norm`` platform override (signature-compatible with
    ``ops.normalization.layer_norm``; calls outside the gate take the
    generic op)."""

    def layer_norm(x, gain, bias=None, *, axis=-1, eps: float = 1e-5):
        if gain is None or bias is None or \
                not supported(x, axis if isinstance(axis, int) else -2):
            return norm_ops.layer_norm(x, gain, bias, axis=axis, eps=eps)
        return _LayerNormKernel.apply(x.contiguous(), gain, bias, float(eps))

    return layer_norm


# ------------------------------------------------------- flash attention
def flash_k_tile(D: int, dtype: torch.dtype) -> int:
    """The k tile of the route the kernel takes for head dim ``D`` and
    ``dtype`` (``k_tile<D>`` in flash_attention.cu). Both routes use the
    same tile for a D, so the plain version rounds P at the same running
    max as whichever route the gate picks."""
    return 64 if D <= 128 else 32


def flash_route(q, k, v) -> str:
    """The kernel a call takes, chosen before launch: ``"tensor_core"``
    for bf16 and ``"tf32x3"`` (three TF32 tensor-core products a product,
    fp32-accurate) for fp32, each when every base pointer is 16-byte
    aligned and the b, t, h strides (of dims longer than 1) are multiples
    of a 16-byte chunk (8 bf16, 4 fp32 elements), so every ``cp.async``
    chunk is aligned; ``"cuda_core"`` (the FMA kernel) for every other
    call. The output is allocated contiguous by the wrapper and always
    qualifies."""
    per_chunk = 16 // q.element_size()
    for t in (q, k, v):
        if t.data_ptr() % 16:
            return "cuda_core"
        for dim in (0, 1, 2):
            if t.shape[dim] > 1 and t.stride(dim) % per_chunk:
                return "cuda_core"
    return "tensor_core" if q.dtype == torch.bfloat16 else "tf32x3"


def flash_attention_plain(q, k, v, causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch: k tiles of
    :func:`flash_k_tile`, fp32 online softmax, scale after the dot, P
    rounded to v's dtype before P.V. Returns (o [B,Tq,H,D] in q's dtype,
    lse fp32 [B,H,Tq])."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    bk = flash_k_tile(D, q.dtype)
    scale = float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32))
    dev = q.device
    qf = q.float().permute(0, 2, 1, 3)                     # [B,H,Tq,D]
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    rows = torch.arange(Tq, device=dev)[:, None]
    m = torch.full((B, H, Tq), -math.inf, device=dev)
    l = torch.zeros((B, H, Tq), device=dev)
    acc = torch.zeros((B, H, Tq, D), device=dev)
    kend = min(Tk, Tq) if causal else Tk
    for k0 in range(0, kend, bk):
        kb = kf[:, :, k0:k0 + bk]
        s = (qf @ kb.transpose(-1, -2)) * scale
        if causal:
            cols = k0 + torch.arange(kb.shape[2], device=dev)[None, :]
            s = s.masked_fill(cols > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use[..., None])
        l = l * alpha + p.sum(dim=-1)
        pr = p.to(v.dtype).float()
        acc = acc * alpha[..., None] + pr @ vf[:, :, k0:k0 + bk]
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    o = (acc / lc[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    return o, m + torch.log(lc)


def flash_attention_fwd(q, k, v, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FlashAttention forward over q [B,Tq,H,D], k/v [B,Tk,H,D] (any
    strides with the last dim contiguous) -> (o [B,Tq,H,D], lse fp32
    [B,H,Tq]), on the route :func:`flash_route` picks."""
    if q.device.type == "cpu":
        _bump(PLAIN_CALLS, "flash_attention")
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError("flash_attention: want q [B,Tq,H,D], k = v "
                         "[B,Tk,H,D]")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on B, H or D")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: want one of fp32/bf16 for q, k, "
                         f"v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in _FLASH_D:
        raise ValueError(f"flash_attention: head dim {D} not in {_FLASH_D}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if min(Tq, Tk, B, H) < 1:
        raise ValueError("flash_attention: empty input")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    route = flash_route(q, k, v)
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(int(t.stride(i)) for t in (q, k, v, o) for i in (0, 1, 2)))
    scale = 1.0 / math.sqrt(D)
    lib = _lib("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.dl4j_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, Tq, Tk, D, strides, scale,
            int(bool(causal)), _DTYPE_CODE[q.dtype],
            _FLASH_ROUTE_CODE[route], _stream(q.device))
    _check_launch("flash_attention", rc)
    _bump(LAUNCHES, "flash_attention")
    _bump(FLASH_ROUTES, route)
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, ct, causal: bool = False):
    """The flash backward from the saved ``(o, lse)``, composed torch
    after ``_flash_bwd_blockwise`` (pallas_kernels.py:375-409): fp32
    throughout, ``delta = sum(ct * o)``, then a loop over k blocks of
    256 (the last one ragged, as the kernel takes any Tk) that
    recomputes ``p = exp(q.k * scale - lse)`` under the causal mask, so
    the [Tq, Tk] scores never materialise. Returns (dq, dk, dv) in the
    dtypes of q, k, v, laid out [B, T, H, D]."""
    D = q.shape[-1]
    Tq, Tk = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, of, cf = (t.float().permute(0, 2, 1, 3)
                          for t in (q, k, v, o, ct))      # [B,H,T,D]
    delta = (cf * of).sum(dim=-1, keepdim=True)           # [B,H,Tq,1]
    lse = lse.float()[..., None]
    rows = torch.arange(Tq, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    bk = _FLASH_BWD_K
    for k0 in range(0, Tk, bk):
        kj, vj = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = (qf @ kj.transpose(-1, -2)) * scale
        if causal:
            cols = k0 + torch.arange(kj.shape[2], device=q.device)[None, :]
            s = s.masked_fill(cols > rows, -math.inf)
        p = torch.exp(s - lse)                            # [B,H,Tq,bk]
        dvs.append(p.transpose(-1, -2) @ cf)
        ds = p * (cf @ vj.transpose(-1, -2) - delta)
        dq = dq + (ds @ kj) * scale
        dks.append((ds.transpose(-1, -2) @ qf) * scale)
    dk, dv = torch.cat(dks, dim=2), torch.cat(dvs, dim=2)
    return tuple(g.permute(0, 2, 1, 3).to(t.dtype)
                 for g, t in ((dq, q), (dk, k), (dv, v)))


class _FlashAttentionKernel(torch.autograd.Function):
    """The kernel forward, saving ``(q, k, v, o, lse)`` as the JAX custom
    VJP does (pallas_kernels.py:452-467); the backward is
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, ct):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, ct, ctx.causal)
        return dq, dk, dv, None


def flash_supported(q, k) -> bool:
    """Calls the flash kernel takes: fp32/bf16 q, k, v of one dtype and
    D in {64, 128, 192, 256} (the JAX gate's D % 64 == 0, D <= 256), any
    Tq and Tk (the kernel masks ragged tiles, so it accepts every length
    the JAX block-divisibility gate does, and more)."""
    return (q.dim() == 4 and k.dim() == 4 and q.dtype in _DTYPE_CODE
            and k.dtype == q.dtype and q.shape[-1] in _FLASH_D
            and q.numel() > 0 and k.numel() > 0)


def make_flash_attention_override():
    """The ``flash_attention`` platform override: the CUDA kernel for
    unmasked calls inside the gate, the generic blockwise op
    (``_flash_attention_scan``) for the rest."""

    def flash_attention(q, k, v, *, mask=None, is_causal: bool = False,
                        block_size: int = 512):
        if mask is not None or not flash_supported(q, k) \
                or v.dtype != q.dtype:
            return attn_ops._flash_attention_scan(
                q, k, v, mask=mask, is_causal=is_causal,
                block_size=block_size)
        if q.stride(-1) != 1:
            q = q.contiguous()
        if k.stride(-1) != 1:
            k = k.contiguous()
        if v.stride(-1) != 1:
            v = v.contiguous()
        return _FlashAttentionKernel.apply(q, k, v, bool(is_causal))

    return flash_attention


# -------------------------------------------------------- scale_shift_act
def scale_shift_act_plain(x2d, scale, shift, alpha: float = 0.0):
    """The kernel's arithmetic in plain PyTorch: x, scale and shift as
    x's dtype, ``x*scale + shift`` with one rounding to fp32 (the
    product and sum in fp64 and rounded once, which is what the kernel's
    fp32 FMA gives), then ``y < 0 ? alpha*y : y`` in fp32 with alpha
    rounded to x's dtype (``y < 0 ? 0 : y`` at alpha 0: NaN stays NaN),
    rounded once to x's dtype."""
    y = torch.addcmul(shift.to(x2d.dtype).double(), x2d.double(),
                      scale.to(x2d.dtype).double()).float()
    neg = y * _alpha_in(x2d.dtype, alpha) if alpha else 0.0
    return torch.where(y < 0, neg, y).to(x2d.dtype)


def _alpha_in(dtype, alpha: float) -> float:
    """The negative slope as x's dtype holds it (JAX multiplies by a
    weakly typed scalar, which takes the array's dtype)."""
    return float(torch.tensor(float(alpha), dtype=dtype))


def scale_shift_act_fwd(x2d, scale, shift, alpha: float = 0.0):
    """``act(x*scale + shift)`` over x [rows, C] (fp32/bf16, contiguous)
    with scale, shift [C] in x's dtype; alpha 0 is relu, alpha > 0 the
    leaky slope."""
    if x2d.device.type == "cpu":
        _bump(PLAIN_CALLS, "scale_shift_act")
        return scale_shift_act_plain(x2d, scale, shift, alpha)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"scale_shift_act: no kernel for device "
                           f"{x2d.device}")
    if x2d.dim() != 2 or x2d.dtype not in _DTYPE_CODE:
        raise ValueError(f"scale_shift_act: want a 2-D fp32/bf16 tensor, "
                         f"got {tuple(x2d.shape)} {x2d.dtype}")
    rows, c = x2d.shape
    if not 1 <= c <= _SSA_MAX_C or rows < 1:
        raise ValueError(f"scale_shift_act: shape {tuple(x2d.shape)} "
                         f"outside 1 <= C <= {_SSA_MAX_C}, rows >= 1")
    if not x2d.is_contiguous():
        raise ValueError("scale_shift_act: x must be contiguous "
                         "(channels minor)")
    for t, what in ((scale, "scale"), (shift, "shift")):
        if t.device != x2d.device or tuple(t.shape) != (c,) \
                or t.dtype != x2d.dtype or not t.is_contiguous():
            raise ValueError(f"scale_shift_act: {what} must be a "
                             f"contiguous [{c}] {x2d.dtype} tensor on "
                             f"{x2d.device}")
    y = torch.empty_like(x2d)
    lib = _lib("scale_shift_act")
    with torch.cuda.device(x2d.device):
        rc = lib.dl4j_scale_shift_act_fwd(
            x2d.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            y.data_ptr(), rows, c, _alpha_in(x2d.dtype, alpha),
            _DTYPE_CODE[x2d.dtype],
            torch.cuda.get_device_properties(x2d.device).multi_processor_count,
            _stream(x2d.device))
    _check_launch("scale_shift_act", rc)
    _bump(LAUNCHES, "scale_shift_act")
    return y


class _ScaleShiftAct(torch.autograd.Function):
    """The kernel forward; the backward mirrors the JAX custom VJP
    (pallas_kernels.py:253-263): y recomputed in x's dtype, slope 1
    where ``y >= 0`` (so 1 at y == 0) and alpha elsewhere, dx in x's
    dtype, dscale and dshift reduced in fp32 and cast to their dtype."""

    @staticmethod
    def forward(ctx, x2d, scale, shift, alpha):
        ctx.save_for_backward(x2d, scale, shift)
        ctx.alpha = alpha
        return scale_shift_act_fwd(x2d, scale, shift, alpha)

    @staticmethod
    def backward(ctx, ct):
        x2d, scale, shift = ctx.saved_tensors
        y = x2d * scale.to(x2d.dtype)[None, :] + shift.to(x2d.dtype)[None, :]
        slope = torch.where(y >= 0, 1.0, float(ctx.alpha))
        g = ct.float() * slope
        dx = (g * scale.float()[None, :]).to(x2d.dtype)
        dscale = (g * x2d.float()).sum(dim=0)
        dshift = g.sum(dim=0)
        return dx, dscale.to(scale.dtype), dshift.to(shift.dtype), None


def scale_shift_act_supported(x, axis: int) -> bool:
    """Calls the kernel takes: fp32/bf16, the channel axis last
    (``axis == ndim-1``), channels-minor memory (x contiguous: checked
    on the strides, never copied to fit), C <= 4096, any row count.
    Wider than the JAX gate (``epilogue_supported``: C % 128 == 0 and
    rows a multiple of the sublane), which it contains."""
    return (x.dim() >= 2 and axis == x.dim() - 1
            and x.dtype in _DTYPE_CODE and x.numel() > 0
            and x.shape[-1] <= _SSA_MAX_C and x.is_contiguous())


def make_scale_shift_act_override():
    """The ``scale_shift_act`` platform override (signature-compatible
    with ``ops.normalization.scale_shift_act``): the CUDA kernel on the
    ``[rows, C]`` view inside the gate, the generic op outside it."""

    def scale_shift_act(x, scale, shift, *, alpha: float = 0.0,
                        axis: int = 1):
        axis = axis % x.dim()
        if not scale_shift_act_supported(x, axis):
            return norm_ops.scale_shift_act(x, scale, shift, alpha=alpha,
                                            axis=axis)
        c = x.shape[-1]
        y = _ScaleShiftAct.apply(x.view(-1, c),
                                 scale.to(x.dtype).contiguous(),
                                 shift.to(x.dtype).contiguous(),
                                 float(alpha))
        return y.view(x.shape)

    return scale_shift_act


# ---------------------------------------------------------------- softmax
def softmax_plain(x2d):
    """The kernel's function in plain PyTorch: the row read as fp32, its
    max subtracted, ``exp``, divided by the fp32 row sum, cast back to
    x's dtype (NaN in a row gives a NaN row; a row of -inf gives NaN)."""
    x32 = x2d.float()
    e = torch.exp(x32 - x32.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x2d.dtype)


def softmax_fwd(x2d):
    """Row softmax of x [N, D] (fp32/bf16, contiguous, D <= 12288)."""
    if x2d.device.type == "cpu":
        _bump(PLAIN_CALLS, "softmax")
        return softmax_plain(x2d)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"softmax: no kernel for device {x2d.device}")
    if x2d.dim() != 2 or x2d.dtype not in _DTYPE_CODE:
        raise ValueError(f"softmax: want a 2-D fp32/bf16 tensor, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    n, d = x2d.shape
    if not 1 <= d <= _SOFTMAX_MAX_D or n < 1:
        raise ValueError(f"softmax: shape {tuple(x2d.shape)} outside "
                         f"1 <= D <= {_SOFTMAX_MAX_D}, N >= 1")
    if not x2d.is_contiguous():
        raise ValueError("softmax: x must be contiguous")
    y = torch.empty_like(x2d)
    lib = _lib("softmax")
    with torch.cuda.device(x2d.device):
        rc = lib.dl4j_softmax_fwd(x2d.data_ptr(), y.data_ptr(), n, d,
                                  _DTYPE_CODE[x2d.dtype], _stream(x2d.device))
    _check_launch("softmax", rc)
    _bump(LAUNCHES, "softmax")
    return y


class _SoftmaxKernel(torch.autograd.Function):
    """The kernel forward; the backward mirrors the JAX custom VJP
    (pallas_kernels.py:165-169): ``y * (g - sum(g * y))`` in fp32, cast
    to y's dtype."""

    @staticmethod
    def forward(ctx, x2d):
        y = softmax_fwd(x2d)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, ct):
        (y,) = ctx.saved_tensors
        y32 = y.float()
        g = ct.float()
        return (y32 * (g - (g * y32).sum(dim=-1, keepdim=True))).to(y.dtype)


def softmax_supported(x, axis: int = -1) -> bool:
    """Calls the kernel takes: fp32/bf16, the softmax axis last, x
    contiguous (any rank, viewed as [rows, D]), any row count and
    1 <= D <= 12288. Wider than the JAX gate (``supported``: 2-D,
    D % 128 == 0, N % 8 == 0, D <= 4096), which it contains."""
    return (isinstance(axis, int) and x.dim() >= 1
            and axis in (-1, x.dim() - 1) and x.dtype in _DTYPE_CODE
            and x.numel() > 0 and 1 <= x.shape[-1] <= _SOFTMAX_MAX_D
            and x.is_contiguous())


def make_softmax_override():
    """The ``softmax`` platform override (signature-compatible with the
    generic registry op): the CUDA kernel on the ``[rows, D]`` view
    inside the gate, the generic op outside it."""
    from deeplearning4j_tpu_torch.ops import registry

    def softmax(x, axis: int = -1):
        if not softmax_supported(x, axis):
            return registry.softmax(x, axis=axis)
        return _SoftmaxKernel.apply(x.view(-1, x.shape[-1])).view(x.shape)

    return softmax


# ------------------------------------------------ the BN+leaky probe's pair
def bn_stats_plain(x2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """The statistics kernel's function in plain PyTorch: per row of x
    [C, M], ``sum(x)`` and ``sum(x*x)`` of x read as fp32, fp32 [C]
    each."""
    x32 = x2d.float()
    return x32.sum(dim=1), x32.square().sum(dim=1)


def bn_apply_leaky_plain(x2d, scale, shift, alpha: float = 0.1):
    """The apply kernel's function in plain PyTorch: ``x*scale + shift``
    per row with fp32 scale and shift, rounded once to fp32 (product and
    sum in fp64, which is what the kernel's fp32 FMA gives), then ``y > 0
    ? y : alpha*y`` in fp32 (NaN stays NaN), rounded once to x's
    dtype."""
    y = torch.addcmul(shift.double()[:, None], x2d.double(),
                      scale.double()[:, None]).float()
    return torch.where(y > 0, y, y * float(alpha)).to(x2d.dtype)


def _check_bn_x(name: str, x2d) -> None:
    if x2d.dim() != 2 or x2d.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: want a 2-D fp32/bf16 x [C, M], got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    if min(x2d.shape) < 1:
        raise ValueError(f"{name}: empty x {tuple(x2d.shape)}")
    if not x2d.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous (channel-major)")


def bn_stats(x2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel ``(sum(x), sum(x*x))`` over x [C, M] (fp32/bf16,
    contiguous), fp32 [C] each, the same bits on every run."""
    if x2d.device.type == "cpu":
        _bump(PLAIN_CALLS, "bn_stats")
        return bn_stats_plain(x2d)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"bn_stats: no kernel for device {x2d.device}")
    _check_bn_x("bn_stats", x2d)
    c, m = x2d.shape
    lib = _lib("bn_leaky")
    dtype = _DTYPE_CODE[x2d.dtype]
    chunks = int(lib.dl4j_bn_chunks(m, dtype))
    partials = torch.empty(2 * c * chunks, dtype=torch.float32,
                           device=x2d.device)
    sums = torch.empty(c, dtype=torch.float32, device=x2d.device)
    sumsq = torch.empty(c, dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        rc = lib.dl4j_bn_stats(x2d.data_ptr(), c, m, dtype,
                               partials.data_ptr(), sums.data_ptr(),
                               sumsq.data_ptr(), _stream(x2d.device))
    _check_launch("bn_stats", rc)
    _bump(LAUNCHES, "bn_stats")
    return sums, sumsq


def bn_apply_leaky(x2d, scale, shift, alpha: float = 0.1):
    """``y = x*scale + shift`` per channel row of x [C, M] (fp32/bf16,
    contiguous) with fp32 scale and shift [C], then ``y > 0 ? y :
    alpha*y``; y in x's dtype."""
    if x2d.device.type == "cpu":
        _bump(PLAIN_CALLS, "bn_apply_leaky")
        return bn_apply_leaky_plain(x2d, scale, shift, alpha)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"bn_apply_leaky: no kernel for device "
                           f"{x2d.device}")
    _check_bn_x("bn_apply_leaky", x2d)
    c, m = x2d.shape
    for t, what in ((scale, "scale"), (shift, "shift")):
        if t.device != x2d.device or tuple(t.shape) != (c,) \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"bn_apply_leaky: {what} must be a contiguous "
                             f"[{c}] float32 tensor on {x2d.device}")
    y = torch.empty_like(x2d)
    lib = _lib("bn_leaky")
    with torch.cuda.device(x2d.device):
        rc = lib.dl4j_bn_apply_leaky(x2d.data_ptr(), scale.data_ptr(),
                                     shift.data_ptr(), y.data_ptr(), c, m,
                                     float(alpha), _DTYPE_CODE[x2d.dtype],
                                     _stream(x2d.device))
    _check_launch("bn_apply_leaky", rc)
    _bump(LAUNCHES, "bn_apply_leaky")
    return y


# ------------------------------------------------------------ installation
def install_platform_overrides() -> None:
    """Register the CUDA kernels over their generic ops."""
    from deeplearning4j_tpu_torch.ops import registry
    registry.register_platform_override("layer_norm",
                                        make_layer_norm_override())
    registry.register_platform_override("flash_attention",
                                        make_flash_attention_override())
    registry.register_platform_override("scale_shift_act",
                                        make_scale_shift_act_override())
    registry.register_platform_override("softmax", make_softmax_override())


def uninstall_platform_overrides() -> None:
    from deeplearning4j_tpu_torch.ops import registry
    for name in KERNELS:
        registry.clear_platform_override(name)
