"""Op registry — name -> callable dispatch with platform overrides.

The port's counterpart of ``deeplearning4j_tpu/ops/registry.py`` (the
``register`` / ``register_platform_override`` / ``get`` subset). A
platform override shadows the generic op at dispatch time, the way
libnd4j's PlatformHelpers shadow its declarable ops: here the CUDA
kernels of :mod:`.cuda_kernels` shadow the generic PyTorch ops of
:mod:`.normalization` and :mod:`.attention`.
"""

from __future__ import annotations

from typing import Callable, Dict

from deeplearning4j_tpu_torch.ops import attention as _attn
from deeplearning4j_tpu_torch.ops import normalization as _norm

_REGISTRY: Dict[str, Callable] = {}
_PLATFORM_OVERRIDES: Dict[str, Callable] = {}


def register(name: str, fn: Callable = None):
    """Register an op (decorator or direct)."""
    if fn is None:
        def deco(f):
            _REGISTRY[name] = f
            return f
        return deco
    _REGISTRY[name] = fn
    return fn


def register_platform_override(name: str, fn: Callable) -> None:
    """Shadow a generic op with a platform-specific (CUDA kernel) impl."""
    if name not in _REGISTRY:
        raise KeyError(f"cannot override unknown op '{name}'")
    _PLATFORM_OVERRIDES[name] = fn


def clear_platform_override(name: str) -> None:
    _PLATFORM_OVERRIDES.pop(name, None)


def get(name: str) -> Callable:
    """Resolve an op by name, honouring platform overrides."""
    if name in _PLATFORM_OVERRIDES:
        return _PLATFORM_OVERRIDES[name]
    if name not in _REGISTRY:
        raise KeyError(f"Unknown op '{name}' ({len(_REGISTRY)} registered)")
    return _REGISTRY[name]


def has(name: str) -> bool:
    return name in _REGISTRY


register("layer_norm", _norm.layer_norm)
register("flash_attention", _attn.flash_attention)
