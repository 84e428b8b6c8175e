"""Numerics & precision lints (E3xx/W30x) — dtype-flow analysis ahead of
any compile.

A YOLO run once found Adam's second moment overflowing to inf on raw
[0, 255] pixels — every update silently zeroed, caught only by training
a YOLO for hours and watching the loss go flat.  That bug class (dtype
x dynamic-range x updater-state interactions) is statically decidable
from the configuration + a :class:`~deeplearning4j_tpu_torch.nn.precision.
PrecisionPolicy` + a :class:`DataRangeSpec` input declaration, the same
ahead-of-time posture as the rest of ``analysis/`` (TVM's whole-graph
checks before codegen; TensorFlow's validate-before-dispatch).

The pass propagates a (compute dtype, activation-magnitude estimate)
pair layer by layer — per-layer dtype rules mirror the runtime's
``nn.layers.policy_cast`` islands (BatchNorm / LRN / loss heads stay
fp32; per-layer ``dataType=`` overrides refine it) and the magnitude
model assumes variance-preserving init (activations track the input
scale; saturating activations clamp to 1; normalization layers reset).

Codes (all in ``DIAGNOSTIC_CODES``, suppressible like every pass):

- ``E301`` policy conflict — low-precision STATEFUL updater state (the
  moments live in a dtype that cannot hold their dynamic range), or a
  per-layer dtype override contradicting the policy.
- ``E302`` precision-unsafe accumulation — softmax / large-axis
  reductions / a loss head forced to accumulate in the low-precision
  compute dtype with no fp32 island.
- ``E303`` dynamic-range overflow — fp16 compute without loss scaling,
  or a declared input range whose gradient/second-moment magnitude
  estimate exceeds what the dtype x updater combination tolerates (the
  YOLO bug, now at ``validate()`` time).
- ``W301`` redundant cast churn — a non-island fp32 override sandwiched
  between low-precision layers bounces activations dtype->fp32->dtype.
- ``W302`` loss-scaling misconfiguration — a scale where the dtype
  does not need one (bf16/fp32 share fp32's exponent range) or a scale
  large enough to overflow the scaled loss itself.
- ``W303`` unnormalized input — a declared [0, 255]-style range with no
  normalizer attached and no normalization layer first in the net.

Like the whole package: no tensor is touched — dtype rules are name-based and
every layer fact comes through the declared-shape hooks
(``param_shapes``, ``activation``, ``dtype_override``).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

from deeplearning4j_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from deeplearning4j_tpu_torch.nn.precision import (DTYPE_MAX, LOW_PRECISION,
                                                   PrecisionPolicy,
                                                   normalize_dtype)

#: softmax over an axis at least this long in a low-precision dtype gets
#: E302 (the sum of that many low-mantissa exponentials loses the tail)
SOFTMAX_AXIS_THRESHOLD = 512
#: plain mean/variance reductions (LayerNorm/GlobalPooling) over an axis
#: at least this long in low precision get E302
REDUCTION_AXIS_THRESHOLD = 4096
#: declared |input| above this with no normalizer -> W303
UNNORMALIZED_THRESHOLD = 8.0
#: loss scales above this overflow the scaled loss itself in fp16
LOSS_SCALE_CEILING = float(2 ** 24)

#: updaters whose state stores SQUARED gradient magnitudes (second
#: moments / accumulators) — the dynamic-range-quadrupling class
_SQUARING_UPDATERS = frozenset({
    "Adam", "AdamW", "AMSGrad", "Nadam", "RmsProp", "AdaGrad", "AdaDelta",
})

#: layer classes the runtime keeps as fp32 islands (mirrors
#: nn.layers._POLICY_FP32_PARAM_LAYERS + BaseOutputLayer subclasses,
#: matched by name so the pass imports no layer module)
_ISLAND_CLASSES = frozenset({
    "BatchNormalization", "LocalResponseNormalization",
})

#: activations that clamp magnitude to ~1 regardless of input scale
_SATURATING = frozenset({"sigmoid", "tanh", "softmax", "softsign",
                         "hardsigmoid", "hardtanh"})

_RANGE_RE = re.compile(
    r"^\s*(?P<lo>[-+]?\d+(?:\.\d+)?)\s*(?:\.\.|:|,)\s*"
    r"(?P<hi>[-+]?\d+(?:\.\d+)?)\s*(?P<flags>(?:,\s*\w+\s*)*)$")


class DataRangeSpec:
    """Declared input value range: what the training data actually
    contains, so range-dependent lints (E303, W303) can run before any
    batch exists.  ``normalized=True`` declares a normalizer IS attached
    to the iterator (``ImagePreProcessingScaler`` and friends) — the
    lints then reason about the post-normalizer range [0, 1]."""

    __slots__ = ("lo", "hi", "normalized")

    def __init__(self, lo: float, hi: float, normalized: bool = False):
        self.lo = float(lo)
        self.hi = float(hi)
        if self.hi < self.lo:
            raise ValueError(f"DataRangeSpec: hi={hi} < lo={lo}")
        self.normalized = bool(normalized)

    @property
    def max_abs(self) -> float:
        if self.normalized:
            return 1.0
        return max(abs(self.lo), abs(self.hi))

    @staticmethod
    def parse(text: str) -> "DataRangeSpec":
        """``"0..255"`` / ``"0:255"`` / ``"-1..1,normalized"`` — the CLI
        ``--data-range`` spelling."""
        m = _RANGE_RE.match(str(text))
        if not m:
            raise ValueError(
                f"cannot parse data range {text!r} (expected 'LO..HI' "
                f"with an optional ',normalized' flag, e.g. '0..255')")
        flags = {f.strip().lower() for f in m.group("flags").split(",")
                 if f.strip()}
        unknown = flags - {"normalized"}
        if unknown:
            raise ValueError(f"unknown data-range flag(s) {sorted(unknown)}")
        return DataRangeSpec(float(m.group("lo")), float(m.group("hi")),
                             normalized="normalized" in flags)

    @staticmethod
    def coerce(value) -> Optional["DataRangeSpec"]:
        if value is None or isinstance(value, DataRangeSpec):
            return value
        if isinstance(value, str):
            return DataRangeSpec.parse(value)
        if isinstance(value, dict):
            return DataRangeSpec(**value)
        if isinstance(value, (tuple, list)) and len(value) in (2, 3):
            return DataRangeSpec(*value)
        raise TypeError(
            f"cannot coerce {type(value).__name__} to a DataRangeSpec "
            "(pass a spec, '0..255', (lo, hi), or a dict)")

    def __repr__(self):
        return (f"DataRangeSpec({self.lo}, {self.hi}, "
                f"normalized={self.normalized})")


def resolve_policy(conf, policy=None, model=None) -> PrecisionPolicy:
    """Effective policy for the lints: explicit ``policy=`` wins, then a
    model's attached ``setPrecisionPolicy``, then the configuration's
    ``dataType`` — mirroring the runtime's ``_compute_dtype`` order.  A
    plain-fp32 config resolves to the identity policy (still linted:
    E303's range clause applies to fp32 Adam state too)."""
    pol = PrecisionPolicy.coerce(policy)
    if pol is not None:
        return pol
    if model is not None:
        attached = getattr(model, "_precision", None)
        if attached is not None:
            return attached
    implied = PrecisionPolicy.from_config_dtype(
        getattr(getattr(conf, "base", None), "dtype", None))
    return implied if implied is not None else PrecisionPolicy()


# ----------------------------------------------------------- layer facts
def _cls(layer) -> str:
    return type(layer).__name__


def _is_loss_head(layer) -> bool:
    return hasattr(layer, "compute_loss")


def _is_island(layer) -> bool:
    """Layers the runtime's policy_cast keeps in fp32 regardless."""
    return _cls(layer) in _ISLAND_CLASSES or _is_loss_head(layer)


def _override_of(layer) -> Optional[str]:
    ov = getattr(layer, "dtype_override", None)
    if ov is None:
        return None
    try:
        return normalize_dtype(ov)
    except ValueError:
        return str(ov).lower()          # undocumented dtype: still linted

def _layer_dtype(layer, policy: PrecisionPolicy) -> str:
    """Effective compute dtype of one layer under policy + override —
    the per-layer dtype rule mirroring ``policy_cast``."""
    if not policy.is_low_precision:
        return "float32"
    ov = _override_of(layer)
    if _is_loss_head(layer):
        # the loss head is an island unless an override drags it down
        # (which E302 flags — the runtime refuses to honor it)
        return policy.compute if ov in LOW_PRECISION else "float32"
    if ov == "float32":
        return "float32"
    if _is_island(layer):
        return "float32"
    return policy.compute


def _softmax_axis(layer, in_type, out_type) -> Optional[int]:
    """Axis length a softmax in this layer reduces over, when statically
    known: the feature axis for softmax activations, the timestep axis
    for attention layers."""
    if getattr(layer, "n_heads", None) is not None:
        it = in_type if in_type is not None else out_type
        if it is not None and getattr(it, "kind", None) == "rnn":
            t = int(it.dims.get("timesteps", -1) or -1)
            return t if t > 0 else None
        return None
    if str(getattr(layer, "activation", "") or "").lower() == "softmax":
        n = getattr(layer, "nOut", None)
        return int(n) if n else None
    return None


def _reduction_axis(layer, in_type) -> Optional[int]:
    """Axis length of a plain mean/variance reduction (LayerNorm,
    GlobalPooling) when statically known."""
    cls = _cls(layer)
    if cls == "LayerNorm":
        n = getattr(layer, "nIn", None)
        return int(n) if n else None
    if cls == "GlobalPoolingLayer" and in_type is not None:
        kind = getattr(in_type, "kind", None)
        if kind == "cnn":
            return int(in_type.dims.get("height", 1) or 1) * \
                int(in_type.dims.get("width", 1) or 1)
        if kind == "rnn":
            t = int(in_type.dims.get("timesteps", -1) or -1)
            return t if t > 0 else None
    return None


def _located_layers(conf) -> List[Tuple[str, Any, Any, Any]]:
    """(location, layer, in_type, out_type) for sequential AND graph
    configurations, reusing the distribution pass's best-effort type
    propagation (environments without the layer stack degrade to None
    types)."""
    from deeplearning4j_tpu_torch.analysis import distribution as _dist
    if hasattr(conf, "graph_inputs"):
        from deeplearning4j_tpu_torch.analysis.analyzer import _node_loc
        out = []
        for node in getattr(conf, "nodes", []):
            if node.kind == "layer":
                out.append((_node_loc(node), node.obj, None, None))
        return out
    from deeplearning4j_tpu_torch.analysis.analyzer import _layer_loc
    types = _dist._propagate_types(conf)
    return [(_layer_loc(i, l), l, types[i][0], types[i][1])
            for i, l in enumerate(conf.layers)]


# ------------------------------------------------------------- the pass
def lint_numerics(conf, policy=None, data_range=None,
                  model=None) -> List[Diagnostic]:
    """Run every numerics lint over a configuration under an (optional)
    policy and input-range declaration.  Called from ``analyze()``; the
    standalone entry point for tests and tooling."""
    pol = resolve_policy(conf, policy, model)
    rng = DataRangeSpec.coerce(data_range)
    entries = _located_layers(conf)
    diags: List[Diagnostic] = []
    diags.extend(_lint_policy_conflict(conf, pol, entries))
    diags.extend(_lint_unsafe_accumulation(pol, entries))
    diags.extend(_lint_dynamic_range(conf, pol, rng, entries))
    if not hasattr(conf, "graph_inputs"):
        # W301 reasons about LAYER ADJACENCY, which only a sequential
        # config's list order actually is — graph node order is not
        # dataflow adjacency, so the sandwich test would hallucinate
        diags.extend(_lint_cast_churn(pol, entries))
    diags.extend(_lint_loss_scaling(pol))
    diags.extend(_lint_unnormalized(rng, entries))
    return diags


def _updater_name(conf) -> str:
    upd = getattr(getattr(conf, "base", None), "updater", None)
    return type(upd).__name__ if upd is not None else ""


# E301 ------------------------------------------------------------------
def _updater_is_stateful(conf) -> bool:
    from deeplearning4j_tpu_torch.analysis.analyzer import \
        _updater_is_stateful as check
    upd = getattr(getattr(conf, "base", None), "updater", None)
    return upd is not None and check(upd)


def _lint_policy_conflict(conf, pol: PrecisionPolicy,
                          entries) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    upd = _updater_name(conf)
    if pol.params in LOW_PRECISION and _updater_is_stateful(conf):
        diags.append(Diagnostic(
            "DL4J-E301", Severity.ERROR, "policy",
            f"PrecisionPolicy(params={pol.params!r}) with stateful "
            f"updater {upd}: master params AND updater state would live "
            f"in {pol.params} — second moments overflow (fp16) or lose "
            f"every small update to rounding (bf16's 8-bit mantissa)",
            fix_hint="keep params='float32' (fp32 master params); the "
                     "compute dtype may stay low-precision"))
    for loc, layer, _, _ in entries:
        ov = _override_of(layer)
        if ov is None:
            continue
        allowed = {"float32", pol.compute}
        if ov not in allowed:
            diags.append(Diagnostic(
                "DL4J-E301", Severity.ERROR, loc,
                f"per-layer dataType={ov!r} contradicts the "
                f"{pol.compute} policy — the runtime honors only "
                f"'float32' islands and policy-matching overrides, so "
                f"this declaration would silently not happen",
                fix_hint=f"drop the override, or set it to 'float32' "
                         f"(island) / {pol.compute!r} (policy dtype)"))
    return diags


# E302 ------------------------------------------------------------------
def _lint_unsafe_accumulation(pol: PrecisionPolicy,
                              entries) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    if not pol.is_low_precision:
        return diags
    for loc, layer, in_t, out_t in entries:
        dt = _layer_dtype(layer, pol)
        if _is_loss_head(layer):
            if dt in LOW_PRECISION:
                diags.append(Diagnostic(
                    "DL4J-E302", Severity.ERROR, loc,
                    f"loss head forced to accumulate in {dt} by its "
                    f"dataType override — loss reductions and the "
                    f"softmax/loss pairing need the fp32 island the "
                    f"policy normally provides",
                    fix_hint="remove the loss head's dataType override "
                             "(output layers are fp32 islands by design)"))
            continue
        if dt not in LOW_PRECISION:
            continue
        axis = _softmax_axis(layer, in_t, out_t)
        if axis is not None and axis >= SOFTMAX_AXIS_THRESHOLD:
            diags.append(Diagnostic(
                "DL4J-E302", Severity.ERROR, loc,
                f"softmax over a {axis}-long axis accumulates in {dt} "
                f"— summing {axis} low-mantissa exponentials loses the "
                f"distribution tail (attention scores / mid-net softmax "
                f"need an fp32 island)",
                fix_hint="set dataType='float32' on this layer, or "
                         "shrink the softmax axis below "
                         f"{SOFTMAX_AXIS_THRESHOLD}"))
            continue
        red = _reduction_axis(layer, in_t)
        if red is not None and red >= REDUCTION_AXIS_THRESHOLD:
            diags.append(Diagnostic(
                "DL4J-E302", Severity.ERROR, loc,
                f"mean/variance reduction over {red} elements "
                f"accumulates in {dt} — the running sum outgrows the "
                f"mantissa and the tail of the axis stops contributing",
                fix_hint="set dataType='float32' on this layer (fp32 "
                         "island) or normalize over a smaller axis"))
    return diags


# E303 ------------------------------------------------------------------
def _grad_magnitude(rng: DataRangeSpec, entries) -> float:
    """Static weight-gradient magnitude estimate at the loss head:
    activations track the input scale under variance-preserving init
    (xavier/relu keep the variance; saturating activations clamp to 1;
    normalization layers reset to ~N(0,1)), and the head weight
    gradient is dL/dW ~ delta x act_in — the loss delta times the
    activation feeding the head.  A saturating head bounds |delta| at
    1; a regression-shaped loss on an unbounded head has delta ~
    (pred - label) ~ act_in, which is what made raw [0, 255] pixels
    quadratically dangerous."""
    act = rng.max_abs
    for _, layer, _, _ in entries:
        cls = _cls(layer)
        if cls in ("BatchNormalization", "LayerNorm", "GroupNorm",
                   "UnitNormLayer", "LocalResponseNormalization"):
            act = 3.0                    # normalized: ~N(0,1) + margin
            continue
        a = str(getattr(layer, "activation", "") or "").lower()
        if _is_loss_head(layer):
            loss = str(getattr(layer, "loss_fn", "") or "").lower()
            if a in _SATURATING:
                delta = 1.0              # softmax/sigmoid head: |delta|<=1
            elif loss in ("mse", "l2", "squaredloss", "huber", "l1",
                          "mae"):
                delta = act              # unbounded pred: delta ~ act_in
            else:
                delta = 1.0
            return delta * act           # dL/dW ~ delta x act_in
        if a in _SATURATING:
            act = 1.0
    return act


def _lint_dynamic_range(conf, pol: PrecisionPolicy,
                        rng: Optional[DataRangeSpec],
                        entries) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    if pol.compute == "float16" and pol.loss_scale is None:
        diags.append(Diagnostic(
            "DL4J-E303", Severity.ERROR, "policy",
            "float16 compute without loss scaling: activation gradients "
            "below ~6e-8 flush to zero and anything past 65504 "
            "overflows — fp16 training does not survive an unscaled "
            "backward pass",
            fix_hint="set PrecisionPolicy(loss_scale=2**15) (static), "
                     "or use bfloat16 (fp32 exponent range, no scale "
                     "needed)"))
    if rng is None or not entries:
        return diags
    upd = _updater_name(conf)
    grad = _grad_magnitude(rng, entries)
    state_max = DTYPE_MAX[pol.params]
    if upd in _SQUARING_UPDATERS:
        second_moment = grad * grad
        if second_moment > state_max:
            diags.append(Diagnostic(
                "DL4J-E303", Severity.ERROR, "policy",
                f"declared input range [{rng.lo:g}, {rng.hi:g}] with "
                f"{upd} state in {pol.params}: the squared-gradient "
                f"estimate ~{second_moment:.2g} exceeds "
                f"{pol.params}'s max ({state_max:.3g}) — the second "
                f"moment saturates to inf and every update silently "
                f"zeroes (the raw-pixel YOLO bug, caught statically)",
                fix_hint="normalize the input (ImagePreProcessingScaler "
                         "/ DataRangeSpec(normalized=True)) or keep "
                         "updater state in fp32 master params"))
    compute_max = pol.compute_max()
    # the backward pass flows SCALED activation gradients in the compute
    # dtype (the step scales the loss before value_and_grad and unscales
    # after) — the overflow test must apply the scale. A dynamic policy
    # is judged at its INITIAL scale: that is its worst-case exposure,
    # and an automaton that starts every run by overflowing (dropping
    # updates until backoff converges) is misconfigured even though it
    # eventually recovers
    scaled = grad * (pol.numeric_loss_scale() or 1.0)
    if scaled > compute_max:
        what = ("dynamic loss scaling starts at" if pol.is_dynamic
                else "the backward pass sees")
        consequence = (
            "every run begins by overflowing and dropping updates until "
            "the automaton backs off — lower loss_scale_init"
            if pol.is_dynamic else
            "the backward pass overflows before the updater ever sees it")
        diags.append(Diagnostic(
            "DL4J-E303", Severity.ERROR, "policy",
            f"declared input range [{rng.lo:g}, {rng.hi:g}]: {what} a "
            f"(loss-scaled) gradient-magnitude estimate ~{scaled:.2g} "
            f"exceeding the {pol.compute} compute dtype's max "
            f"({compute_max:.3g}) — {consequence}",
            fix_hint="normalize the input below the overflow range, "
                     "lower loss_scale (or loss_scale_init), or raise "
                     "the compute dtype"))
    return diags


# W301 ------------------------------------------------------------------
def _lint_cast_churn(pol: PrecisionPolicy, entries) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    if not pol.is_low_precision:
        return diags
    dts = [_layer_dtype(layer, pol) for _, layer, _, _ in entries]
    for i, (loc, layer, _, _) in enumerate(entries):
        if _is_island(layer) or _override_of(layer) != "float32":
            continue                      # only explicit non-island islands
        prev_low = i > 0 and dts[i - 1] in LOW_PRECISION
        next_low = i + 1 < len(dts) and dts[i + 1] in LOW_PRECISION
        if prev_low and next_low:
            diags.append(Diagnostic(
                "DL4J-W301", Severity.WARNING, loc,
                f"fp32 override sandwiched between {pol.compute} layers "
                f"— activations cast {pol.compute}->fp32->{pol.compute} "
                f"at both boundaries every step (2 extra casts + 2x "
                f"activation bandwidth for this layer)",
                fix_hint="drop the override unless this layer is a "
                         "numerics island on purpose; if it is, say so "
                         "with a suppression comment"))
    return diags


# W302 ------------------------------------------------------------------
def _lint_loss_scaling(pol: PrecisionPolicy) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    scale = pol.numeric_loss_scale()
    if scale is None:
        return diags
    # a dynamic policy's numeric view is its init value; name it so the
    # message matches what the user wrote
    label = (f"loss_scale='dynamic' (init {scale:g})" if pol.is_dynamic
             else f"loss_scale={scale:g}")
    if pol.compute in ("float32", "bfloat16"):
        diags.append(Diagnostic(
            "DL4J-W302", Severity.WARNING, "policy",
            f"{label} with {pol.compute} compute "
            f"is a no-op numerically: {pol.compute} shares fp32's "
            f"exponent range, so there is no small-gradient underflow "
            f"to rescue — the scale just adds two multiplies",
            fix_hint="drop loss_scale (it exists for float16)"))
    if scale < 1.0:
        diags.append(Diagnostic(
            "DL4J-W302", Severity.WARNING, "policy",
            f"{label} < 1 SHRINKS gradients — "
            f"the opposite of what loss scaling is for (rescuing the "
            f"small-gradient tail from fp16 underflow)",
            fix_hint="use a power of two >= 2**8 (2**15 is the usual "
                     "static choice)"))
    if scale > LOSS_SCALE_CEILING and not pol.is_dynamic:
        diags.append(Diagnostic(
            "DL4J-W302", Severity.WARNING, "policy",
            f"{label} is past 2**24 — the SCALED "
            f"loss/gradients themselves overflow fp16 long before "
            f"underflow is a concern",
            fix_hint="use a scale in the 2**8..2**16 band"))
    return diags


# W303 ------------------------------------------------------------------
def _lint_unnormalized(rng: Optional[DataRangeSpec],
                       entries) -> List[Diagnostic]:
    if rng is None or rng.normalized or rng.max_abs <= UNNORMALIZED_THRESHOLD:
        return []
    # a normalization layer FIRST in the net does the normalizer's job
    for _, layer, _, _ in entries:
        cls = _cls(layer)
        if cls in ("BatchNormalization", "LayerNorm", "GroupNorm"):
            return []
        if getattr(layer, "has_params", False) or cls not in (
                "ActivationLayer", "DropoutLayer"):
            break
    return [Diagnostic(
        "DL4J-W303", Severity.WARNING, "config",
        f"declared input range [{rng.lo:g}, {rng.hi:g}] is unnormalized "
        f"and no normalizer is attached — raw-pixel-scale inputs made "
        f"Adam's second moment overflow (tiny-YOLO trained to a "
        f"flat loss for hours), and cost a dynamic-range headroom of "
        f"{rng.max_abs:g}x in every activation",
        fix_hint="attach ImagePreProcessingScaler (or declare "
                 "DataRangeSpec(..., normalized=True) if a normalizer "
                 "is in fact attached), or start the net with "
                 "BatchNormalization")]
