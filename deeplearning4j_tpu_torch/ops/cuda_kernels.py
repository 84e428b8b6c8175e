"""Hand-written CUDA kernels — platform overrides for the serving path.

The port's counterpart of ``deeplearning4j_tpu/ops/pallas_kernels.py``:
each Pallas kernel on the path becomes a CUDA C++ kernel for Hopper
(``csrc/*.cu``, ``sm_90a``) that shadows the generic op through
:func:`ops.registry.register_platform_override`.

- **Build.** At first use every ``csrc/*.cu`` is compiled by ``nvcc``
  (one process per source, all started together) into a shared library
  with a plain C interface, keyed by a hash of the source and the flags,
  under ``deeplearning4j_tpu_torch/_build/``; a later process reuses it.
  A missing ``nvcc`` or a failed build raises.
- **Binding.** ``ctypes``; every pointer and the stream
  (``torch.cuda.current_stream().cuda_stream``) is a ``c_void_p``. Each
  launcher returns ``cudaGetLastError()`` and the wrapper raises on
  anything but 0.
- **Wrappers.** ``layer_norm_fwd`` and ``flash_attention_fwd`` check
  device, dtype, shape and contiguity, allocate their outputs with
  ``torch.empty`` and launch on the current stream. A tensor on the CPU
  takes the kernel's plain PyTorch version (``*_plain``) instead; there
  is no fallback from a CUDA tensor. ``LAUNCHES`` counts kernel launches
  and ``PLAIN_CALLS`` counts plain-version calls made by the wrappers.
- **Gates.** ``supported`` / ``flash_supported`` decide, as in the JAX
  package, which calls the kernels take; masked attention and
  shapes/dtypes outside the gates go to the generic ops.

Forward only: serving needs no gradient (the backward kernels are
queued in ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.ops import attention as attn_ops
from deeplearning4j_tpu_torch.ops import normalization as norm_ops

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("layer_norm", "flash_attention")

#: kernel launches made by the wrappers (CUDA tensors only)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
#: plain-version calls made by the wrappers (CPU tensors only)
PLAIN_CALLS: Dict[str, int] = {name: 0 for name in KERNELS}
_COUNT_LOCK = threading.Lock()

_LIB_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LN_MAX_D = 8192           # the row is staged in 32 KB of shared memory
_FLASH_D = (64, 128, 192, 256)


def reset_counts() -> None:
    with _COUNT_LOCK:
        for name in KERNELS:
            LAUNCHES[name] = 0
            PLAIN_CALLS[name] = 0


def _bump(counter: Dict[str, int], name: str) -> None:
    with _COUNT_LOCK:
        counter[name] += 1


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
    return each kernel's library path. Raises on a missing ``nvcc`` or a
    failed compile, with the compiler's output."""
    paths = {name: _lib_path(name) for name in KERNELS}
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
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    return paths


def _lib(name: str) -> ctypes.CDLL:
    with _LIB_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build()
            for n, path in paths.items():
                _LIBS[n] = _bind(n, ctypes.CDLL(str(path)))
            lib = _LIBS[name]
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "layer_norm":
        fn = lib.dl4j_layer_norm_fwd
        fn.argtypes = [P, P, P, P, I, I, F, I, P]
    else:
        fn = lib.dl4j_flash_attention_fwd
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I,
                       ctypes.POINTER(ctypes.c_longlong), F, I, I, P]
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
        return layer_norm_fwd(x.contiguous(), gain, bias, eps)

    return layer_norm


# ------------------------------------------------------- flash attention
def flash_k_tile(D: int) -> int:
    """The kernel's k tile (``k_tile<D>`` in flash_attention.cu)."""
    return 64 if D <= 128 else 32


def flash_attention_plain(q, k, v, causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch: k tiles of
    :func:`flash_k_tile`, fp32 online softmax, scale after the dot, P
    rounded to v's dtype before P.V. Returns (o [B,Tq,H,D] in q's dtype,
    lse fp32 [B,H,Tq])."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    bk = flash_k_tile(D)
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
    [B,H,Tq])."""
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
            int(bool(causal)), _DTYPE_CODE[q.dtype], _stream(q.device))
    _check_launch("flash_attention", rc)
    _bump(LAUNCHES, "flash_attention")
    return o, lse


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
        return flash_attention_fwd(q, k, v, bool(is_causal))[0]

    return flash_attention


# ------------------------------------------------------------ installation
def install_platform_overrides() -> None:
    """Register the CUDA kernels over their generic ops."""
    from deeplearning4j_tpu_torch.ops import registry
    registry.register_platform_override("layer_norm",
                                        make_layer_norm_override())
    registry.register_platform_override("flash_attention",
                                        make_flash_attention_override())


def uninstall_platform_overrides() -> None:
    from deeplearning4j_tpu_torch.ops import registry
    registry.clear_platform_override("layer_norm")
    registry.clear_platform_override("flash_attention")
