"""PrecisionPolicy — the mixed-precision seam (the slice's subset of
``deeplearning4j_tpu/nn/precision.py``).

A policy declares ``(compute, params, loss_scale)``. Conv and dense
layers run in ``compute``; master params, updater state, BatchNorm
statistics and the loss head stay fp32 (``nn.layers.policy_cast``). A
static ``loss_scale`` multiplies the loss before the backward pass and
divides the gradients straight back out. Dynamic loss scaling is not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

#: canonical dtype spellings accepted everywhere a policy names a dtype
_DTYPE_ALIASES = {
    "float32": "float32", "fp32": "float32", "f32": "float32",
    "single": "float32",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "float16": "float16", "fp16": "float16", "f16": "float16",
    "half": "float16",
}

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def normalize_dtype(name) -> str:
    key = str(name).strip().lower()
    if key not in _DTYPE_ALIASES:
        raise ValueError(
            f"unknown precision dtype {name!r} (use one of "
            f"{sorted(set(_DTYPE_ALIASES.values()))} or an alias like "
            f"'bf16'/'fp16')")
    return _DTYPE_ALIASES[key]


class PrecisionPolicy:
    """``compute`` is the dtype conv/dense layers run in, ``params`` the
    master-weight (and updater-state) dtype, ``loss_scale`` None or a
    static positive float. ``PrecisionPolicy("bfloat16")`` is bf16
    compute with fp32 masters and no scale."""

    __slots__ = ("compute", "params", "loss_scale")

    def __init__(self, compute: str = "float32", params: str = "float32",
                 loss_scale=None):
        self.compute = normalize_dtype(compute)
        self.params = normalize_dtype(params)
        if isinstance(loss_scale, str):
            raise NotImplementedError(
                f"loss_scale={loss_scale!r}: dynamic loss scaling is not "
                "ported yet; pass a static float or None")
        if loss_scale is not None:
            loss_scale = float(loss_scale)
            if loss_scale <= 0:
                raise ValueError(
                    f"loss_scale must be positive, got {loss_scale}")
        self.loss_scale = loss_scale

    @staticmethod
    def coerce(value) -> Optional["PrecisionPolicy"]:
        """None | PrecisionPolicy | dtype string ("bf16") | dict ->
        PrecisionPolicy (or None). A bare dtype string means that compute
        dtype with fp32 master params and no loss scale."""
        if value is None or isinstance(value, PrecisionPolicy):
            return value
        if isinstance(value, str):
            return PrecisionPolicy(compute=value)
        if isinstance(value, dict):
            return PrecisionPolicy(**value)
        raise TypeError(f"cannot coerce {type(value).__name__} to a "
                        "PrecisionPolicy (pass a policy, a dtype string, "
                        "or a {'compute': ..., 'params': ...} dict)")

    def signature(self):
        """Hashable identity of the policy."""
        return (self.compute, self.params, self.loss_scale)

    def compute_torch(self) -> Optional[torch.dtype]:
        """The torch compute dtype for ``nn.layers.policy_cast`` (the JAX
        package's ``compute_jnp``) — None for a pure-fp32 policy."""
        if self.compute == "float32":
            return None
        return _TORCH_DTYPES[self.compute]

    def __repr__(self):
        return (f"PrecisionPolicy(compute={self.compute!r}, "
                f"params={self.params!r}, loss_scale={self.loss_scale})")


def runtime_check(policy: PrecisionPolicy) -> PrecisionPolicy:
    """The runtime keeps master params and updater state in fp32: a
    low-precision ``params`` declaration raises."""
    if policy.params != "float32":
        raise ValueError(
            f"PrecisionPolicy(params={policy.params!r}): the runtime "
            "keeps fp32 master params; declare params='float32' (the "
            f"compute dtype may still be {policy.compute!r}).")
    return policy
