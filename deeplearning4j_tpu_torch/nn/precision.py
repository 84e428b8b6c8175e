"""PrecisionPolicy — the mixed-precision seam (the port of
``deeplearning4j_tpu/nn/precision.py``). Its static half
(``LOW_PRECISION``, ``DTYPE_MAX``, ``is_low_precision``,
``numeric_loss_scale``, ``compute_max``, ``params_max``,
``from_config_dtype``) is what ``analysis/`` reasons with.

A policy declares ``(compute, params, loss_scale)``. Conv and dense
layers run in ``compute``; master params, updater state, BatchNorm
statistics and the loss head stay fp32 (``nn.layers.policy_cast``). A
static ``loss_scale`` multiplies the loss before the backward pass and
divides the gradients straight back out. ``loss_scale="dynamic"`` is the
grow/backoff automaton (the fp16 recipe): the scale starts at
``loss_scale_init``; a step whose unscaled gradients are not all finite
drops its update and multiplies the scale by ``backoff_factor``
(floored at ``min_loss_scale``); ``growth_interval`` clean steps in a
row multiply it by ``growth_factor`` (capped at ``max_loss_scale``).
The networks keep ``[scale, good_steps]`` as a device tensor of their
dispatch state and tick it inside the step (``nn.network``), so a
captured step carries it without a host read.
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

#: dtypes with a reduced mantissa/exponent the numerics lints reason about
LOW_PRECISION = frozenset({"bfloat16", "float16"})

#: finite maxima the static range model compares against (IEEE half,
#: bfloat16, single)
DTYPE_MAX = {"float16": 65504.0, "bfloat16": 3.39e38, "float32": 3.40e38}


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
    master-weight (and updater-state) dtype, ``loss_scale`` None, a
    static positive float, or ``"dynamic"`` with its automaton's knobs.
    ``PrecisionPolicy("bfloat16")`` is bf16 compute with fp32 masters and
    no scale."""

    __slots__ = ("compute", "params", "loss_scale", "loss_scale_init",
                 "growth_interval", "growth_factor", "backoff_factor",
                 "min_loss_scale", "max_loss_scale")

    DYNAMIC = "dynamic"

    def __init__(self, compute: str = "float32", params: str = "float32",
                 loss_scale=None, loss_scale_init: float = 2.0 ** 15,
                 growth_interval: int = 2000, growth_factor: float = 2.0,
                 backoff_factor: float = 0.5,
                 min_loss_scale: float = 2.0 ** -14,
                 max_loss_scale: float = 2.0 ** 24):
        self.compute = normalize_dtype(compute)
        self.params = normalize_dtype(params)
        if isinstance(loss_scale, str):
            if loss_scale.strip().lower() != self.DYNAMIC:
                raise ValueError(
                    f"loss_scale={loss_scale!r}: the only string value is "
                    f"'{self.DYNAMIC}' (or pass a static float)")
            loss_scale = self.DYNAMIC
        elif loss_scale is not None:
            loss_scale = float(loss_scale)
            if loss_scale <= 0:
                raise ValueError(
                    f"loss_scale must be positive, got {loss_scale}")
        self.loss_scale = loss_scale
        self.loss_scale_init = float(loss_scale_init)
        self.growth_interval = int(growth_interval)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.min_loss_scale = float(min_loss_scale)
        self.max_loss_scale = float(max_loss_scale)
        if self.is_dynamic and (
                self.loss_scale_init <= 0 or self.growth_factor <= 1.0
                or not 0.0 < self.backoff_factor < 1.0
                or self.growth_interval < 1):
            raise ValueError(
                "dynamic loss scaling needs loss_scale_init > 0, "
                "growth_factor > 1, 0 < backoff_factor < 1, and "
                "growth_interval >= 1")

    @staticmethod
    def from_config_dtype(conf_dtype) -> Optional["PrecisionPolicy"]:
        """The implicit policy a configuration's ``dataType`` declares:
        bf16/fp16 configs run the mixed policy with fp32 masters;
        fp32/f64 configs have no policy (None)."""
        try:
            name = normalize_dtype(conf_dtype)
        except ValueError:
            return None                      # float64 etc: no mixed policy
        if name in LOW_PRECISION:
            return PrecisionPolicy(compute=name)
        return None

    @property
    def is_low_precision(self) -> bool:
        return self.compute in LOW_PRECISION

    @property
    def is_dynamic(self) -> bool:
        """True when ``loss_scale="dynamic"``."""
        return self.loss_scale == self.DYNAMIC

    def numeric_loss_scale(self) -> Optional[float]:
        """The scale static analysis reasons with: the static factor, the
        dynamic automaton's initial value (its worst-case overflow
        exposure: backoff only shrinks it), or None when nothing
        scales."""
        if self.is_dynamic:
            return self.loss_scale_init
        return self.loss_scale

    def compute_max(self) -> float:
        return DTYPE_MAX[self.compute]

    def params_max(self) -> float:
        return DTYPE_MAX[self.params]

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
        """Hashable identity of the policy (the automaton's knobs join it
        when the policy is dynamic)."""
        if self.is_dynamic:
            return (self.compute, self.params, self.loss_scale,
                    self.loss_scale_init, self.growth_interval,
                    self.growth_factor, self.backoff_factor,
                    self.min_loss_scale, self.max_loss_scale)
        return (self.compute, self.params, self.loss_scale)

    def to_config(self):
        out = {"compute": self.compute, "params": self.params,
               "loss_scale": self.loss_scale}
        if self.is_dynamic:
            out.update(loss_scale_init=self.loss_scale_init,
                       growth_interval=self.growth_interval,
                       growth_factor=self.growth_factor,
                       backoff_factor=self.backoff_factor,
                       min_loss_scale=self.min_loss_scale,
                       max_loss_scale=self.max_loss_scale)
        return out

    @staticmethod
    def from_config(d):
        return PrecisionPolicy(**d)

    def __eq__(self, other):
        return isinstance(other, PrecisionPolicy) \
            and self.signature() == other.signature()

    def __hash__(self):
        return hash(self.signature())

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


def grads_all_finite(grads) -> torch.Tensor:
    """0-d bool on the device: every gradient is finite (ref
    ``_grads_all_finite``). One reduction over all of them: each leaf's
    max |g| (a NaN anywhere stays NaN), stacked and tested at once."""
    norms = torch._foreach_norm(list(grads), float("inf"))
    return torch.isfinite(torch.stack([n.float() for n in norms])).all()


def dynamic_scale_next(pol: PrecisionPolicy, scale_state: torch.Tensor,
                       ok: torch.Tensor) -> torch.Tensor:
    """One tick of the grow/backoff automaton on ``[scale, good_steps]``
    (ref ``_dynamic_scale_next``), tensor ops only: a clean step counts
    one more good step and grows the scale by ``growth_factor`` (capped)
    once ``growth_interval`` are reached, resetting the count; an
    overflow backs the scale off (floored) and resets the count."""
    scale = scale_state[0]
    good = scale_state[1] + 1.0
    grew = good >= float(pol.growth_interval)
    grown = torch.where(
        grew, torch.clamp(scale * float(pol.growth_factor),
                          max=float(pol.max_loss_scale)), scale)
    new_scale = torch.where(
        ok, grown, torch.clamp(scale * float(pol.backoff_factor),
                               min=float(pol.min_loss_scale)))
    new_good = torch.where(ok & ~grew, good, torch.zeros_like(good))
    return torch.stack([new_scale, new_good])
