"""Whole-program static cost model (E12x/W12x) — the port of
``deeplearning4j_tpu/analysis/cost.py``, priced for the H100.

Every open ROADMAP item needs a cost oracle before the code runs:
pipeline scheduling needs per-stage time, elastic shrink needs "will the
survivors OOM?", the serving fleet needs "how many replicas for this
QPS/SLO?", and the tuner burns real measurements on candidates a model
could reject statically.  This module is that oracle, built on the
:mod:`analysis.graphir` facts every model kind lowers to:

1. **Liveness-aware HBM planning** (:func:`memory_plan`) — a pass over
   the IR's producer/consumer edges computing the true training-step
   high-water mark: params, grads, fp32 masters, updater state
   (ZeRO-aware via the MeshSpec plan), live activations held for the
   backward pass, megastep ``[K, B, ...]`` staging, prefetch depth —
   replacing E104/E111's params-only accounting with lifetime
   accounting.  Conventions (pinned analytically by test against a
   hand-computed MLP):

   - params + grads at the policy's COMPUTE dtype; fp32 masters appear
     only when compute is low-precision;
   - updater state is ``updater_state_factor x param-elements x 4``
     bytes (state lives on the fp32 masters), divided by the declared
     ZeRO plan's divisor;
   - every produced activation (the input placeholder included — the
     first layer's dW needs it) is held for backward at the compute
     dtype, batch dim sharded over the data axis;
   - megastep staging is ``K x input bytes`` when K > 1; prefetch adds
     ``depth x input bytes``.

2. **Roofline step-time / MFU estimation** (:func:`step_time`) — per-op
   ``max(flops / peak_flops, bytes / hbm_bw)`` (train factor 3x for
   fwd+bwd), plus gradient-collective time from
   ``distribution.collective_payload_estimates`` over the chip's interconnect
   bandwidth, rolled up into predicted step time, per-stage time under
   a declared pipeline, and predicted MFU with the binding resource
   named (compute / hbm / comms).

3. **Planner / capacity entry points** — ``analyze(cost=CostSpec(...))``
   / ``conf.validate(cost=...)`` / CLI ``--cost --chip h100-sxm``, the
   :func:`plan` report, and :func:`plan_pruner` (the tune/ seam:
   statically dominated candidates are pruned before measurement).

Codes (documented in :mod:`analysis.diagnostics`): ``E120`` step-peak
HBM overflow (names the dominating liveness component), ``E121``
serving-bucket peak overflow, ``E122`` capacity shortfall (names the
minimal replica count), ``W120`` remat opportunity, ``W121`` comms-bound
step, ``W122`` predicted MFU below target.

Warning gates are deliberate: ``W121`` needs a DECLARED batch size (the
per-device batch is unknowable otherwise), ``W122`` a declared
``mfu_target``, ``E121`` declared buckets, ``E122`` a declared ``qps``
or ``p99_ms`` — so ``--cost --chip h100-sxm`` alone judges exactly what
it can know: the HBM plan.

The formulas are the JAX package's, unchanged; ``chip_smoke.py`` phase 33
holds the predicted step time and peak bytes against the card's own.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.analysis import distribution as _dist
from deeplearning4j_tpu_torch.analysis import graphir as _gir
from deeplearning4j_tpu_torch.analysis.chipspec import ChipSpec
from deeplearning4j_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from deeplearning4j_tpu_torch.analysis.distribution import (
    MeshSpec, _fmt_bytes, dtype_bytes, updater_state_factor)
from deeplearning4j_tpu_torch.nn.precision import \
    LOW_PRECISION, PrecisionPolicy

#: W120 fires only when the step peak is at least this fraction of the
#: chip's HBM — a remat hint far from the budget is noise.
REMAT_BUDGET_FRACTION = 0.5
#: W121 fires when predicted collective time exceeds this fraction of
#: the predicted step time.
COMMS_BOUND_FRACTION = 0.5


class CostSpec:
    """Declarative input to the cost model (the ``analyze(cost=...)`` /
    CLI ``--cost`` surface).

    :param chip: a :class:`ChipSpec`, registry name, or dict
        (default ``"h100-sxm"``).
    :param qps: declared fleet load — enables the E122 capacity check.
    :param p99_ms: declared latency SLO — enables the E122 latency check.
    :param replicas: declared replica count for the capacity check
        (default 1 when qps is declared).
    :param mfu_target: declared MFU floor — enables W122.
    :param buckets: serving batch buckets — enables E121.
    :param steps_per_dispatch: megastep K (staging bytes scale with it).
    :param prefetch: host->device prefetch depth (staged input copies).
    :param precision: policy override for prediction (e.g. ``"bf16"``) —
        the tune/ pruner varies this per candidate plan.
    """

    def __init__(self, chip="h100-sxm", qps: Optional[float] = None,
                 p99_ms: Optional[float] = None,
                 replicas: Optional[int] = None,
                 mfu_target: Optional[float] = None,
                 buckets: Optional[Sequence[int]] = None,
                 steps_per_dispatch: int = 1, prefetch: int = 2,
                 precision=None):
        self.chip = ChipSpec.coerce(chip)
        self.qps = None if qps is None else float(qps)
        self.p99_ms = None if p99_ms is None else float(p99_ms)
        self.replicas = None if replicas is None else int(replicas)
        self.mfu_target = None if mfu_target is None else float(mfu_target)
        self.buckets = tuple(int(b) for b in buckets) if buckets else None
        self.steps_per_dispatch = max(int(steps_per_dispatch), 1)
        self.prefetch = max(int(prefetch), 0)
        self.precision = precision

    @staticmethod
    def coerce(obj) -> Optional["CostSpec"]:
        """CostSpec | True (all defaults) | chip name string | dict."""
        if obj is None or isinstance(obj, CostSpec):
            return obj
        if obj is True:
            return CostSpec()
        if isinstance(obj, str):
            return CostSpec(chip=obj)
        if isinstance(obj, dict):
            return CostSpec(**obj)
        raise TypeError(f"cannot interpret {obj!r} as a cost declaration "
                        "(use CostSpec, True, a chip name, or a dict)")

    def __repr__(self):
        return f"CostSpec(chip={self.chip.name!r})"


# ------------------------------------------------------------- lowering

def lower(target, batch_size: int = 1) -> _gir.GraphIR:
    """Any model kind -> GraphIR: an IR passes through; SameDiff-shaped
    objects, graph configs, and sequential configs take their
    lowerings.  ``model.conf``-bearing wrappers unwrap first."""
    if isinstance(target, _gir.GraphIR):
        return target
    target = getattr(target, "conf", target)
    if hasattr(target, "_nodes") and hasattr(target, "_placeholders"):
        return _gir.from_samediff(target, batch_size=batch_size)
    if hasattr(target, "graph_inputs") and hasattr(target, "nodes"):
        return _gir.from_graph(target, batch_size=batch_size)
    if hasattr(target, "layers"):
        return _gir.from_multilayer(target, batch_size=batch_size)
    raise TypeError(f"cannot lower {type(target).__name__} to a GraphIR "
                    "for cost analysis")


def _resolve_policy(ir: _gir.GraphIR, policy, cost: CostSpec
                    ) -> PrecisionPolicy:
    if cost.precision is not None:
        pol = PrecisionPolicy.coerce(cost.precision)
        if pol is not None:
            return pol
    pol = PrecisionPolicy.coerce(policy)
    if pol is not None:
        return pol
    implied = PrecisionPolicy.from_config_dtype(
        _gir._dominant_param_dtype(ir))
    return implied if implied is not None else PrecisionPolicy()


# ---------------------------------------------------------- memory plan

class MemoryPlan:
    """Per-device training-step HBM high-water mark, by liveness
    component. ``components`` maps name -> bytes; the peak is their sum
    (every component is live simultaneously at the end of the forward
    pass, where the backward begins)."""

    def __init__(self, components: Dict[str, float], chip: ChipSpec):
        self.components = dict(components)
        self.chip = chip

    @property
    def peak_bytes(self) -> float:
        return sum(self.components.values())

    def dominating(self) -> Tuple[str, float]:
        name = max(self.components, key=lambda k: self.components[k])
        return name, self.components[name]

    def format(self) -> str:
        parts = ", ".join(f"{k}: {_fmt_bytes(v)}"
                          for k, v in sorted(self.components.items(),
                                             key=lambda kv: -kv[1]) if v)
        return (f"step-peak HBM {_fmt_bytes(self.peak_bytes)}/device "
                f"of {self.chip.hbm_gb:g} GiB ({parts})")


def _input_bytes(ir: _gir.GraphIR, itemsize: int, data_width: int) -> float:
    total = 0.0
    for t in ir.placeholders():
        if t.size_known():
            total += _dist._prod(t.shape) * itemsize
    return total / max(data_width, 1)


def _activation_bytes(ir: _gir.GraphIR, itemsize: int,
                      data_width: int) -> float:
    """Backward-liveness activation bytes per device: every produced
    activation plus the input placeholders, held until its consumer's
    gradient — for a training step that is ALL of them at the fwd/bwd
    boundary. Batch dim shards over the data axis."""
    total = 0.0
    for t in ir.tensors.values():
        if t.kind not in ("activation", "placeholder"):
            continue
        if not t.size_known():
            continue
        total += _dist._prod(t.shape) * itemsize
    return total / max(data_width, 1)


def _forward_liveness_peak(ir: _gir.GraphIR, itemsize: int) -> float:
    """Inference-mode high-water mark over the op schedule: at op ``i``
    the live set is every activation/placeholder produced at or before
    ``i`` whose last consumer is at or after ``i``.  Returns TOTAL bytes
    (not per-device) at the IR's own batch size."""
    spans = []
    for t in ir.tensors.values():
        if t.kind not in ("activation", "placeholder") \
                or not t.size_known():
            continue
        start = t.producer if t.producer is not None else 0
        end = max(t.consumers) if t.consumers else start
        spans.append((start, end, _dist._prod(t.shape) * itemsize))
    peak = 0.0
    for i in range(len(ir.ops) or 1):
        live = sum(b for s, e, b in spans if s <= i <= e)
        peak = max(peak, live)
    if not ir.ops:
        peak = sum(b for _s, _e, b in spans)
    return peak


def memory_plan(target, cost=None, mesh=None, batch_size: Optional[int] = None,
                policy=None) -> MemoryPlan:
    """The liveness-aware training-step HBM plan for one device."""
    cost = CostSpec.coerce(cost) or CostSpec()
    mesh = MeshSpec.coerce(mesh) or MeshSpec({})
    batch = int(batch_size or 1)
    ir = lower(target, batch_size=batch)
    pol = _resolve_policy(ir, policy, cost)
    compute_bytes = dtype_bytes(pol.compute)
    low = pol.compute in LOW_PRECISION
    data_width = mesh.size(mesh.data_axis)

    entries = _gir._ir_entries(ir)
    facts = _dist._param_facts(entries, mesh, compute_bytes)
    factor = updater_state_factor(ir.updater)
    params = grads = masters = updater = 0.0
    for f in facts:
        params += f.bytes_per_device
        grads += f.bytes_per_device
        elems = f.bytes_per_device / compute_bytes
        if low:
            masters += elems * 4
        updater += elems * 4 * factor / _dist._zero_state_divisor(f, mesh)

    acts = _activation_bytes(ir, compute_bytes, data_width)
    inp = _input_bytes(ir, compute_bytes, data_width)
    k = cost.steps_per_dispatch
    staging = k * inp if k > 1 else 0.0
    prefetch = cost.prefetch * inp
    return MemoryPlan({
        "params": params, "grads": grads, "fp32 masters": masters,
        "updater state": updater, "live activations": acts,
        "megastep staging": staging, "prefetch": prefetch,
    }, cost.chip)


def serving_peak_bytes(target, cost=None, mesh=None, policy=None,
                       buckets: Optional[Sequence[int]] = None) -> float:
    """Serving-mode per-device peak: replicated params plus the largest
    bucket's forward-liveness activation high-water mark."""
    cost = CostSpec.coerce(cost) or CostSpec()
    mesh = MeshSpec.coerce(mesh) or MeshSpec({})
    buckets = tuple(buckets or cost.buckets or (1,))
    ir = lower(target, batch_size=1)
    pol = _resolve_policy(ir, policy, cost)
    compute_bytes = dtype_bytes(pol.compute)
    data_width = mesh.size(mesh.data_axis)
    facts = _dist._param_facts(_gir._ir_entries(ir), mesh, compute_bytes)
    params = sum(f.bytes_per_device for f in facts)
    act_peak = _forward_liveness_peak(ir, compute_bytes) / max(
        ir.batch_size, 1)
    return params + act_peak * max(buckets) / max(data_width, 1)


# -------------------------------------------------------------- roofline

class StepTimeEstimate:
    """Predicted training-step time on one chip, with the binding
    resource named and a per-stage breakdown under a declared
    pipeline."""

    def __init__(self, compute_s: float, hbm_s: float, roofline_s: float,
                 collective_s: float, mfu: float, chip: ChipSpec,
                 per_stage: Optional[List[float]] = None):
        self.compute_s = compute_s      # pure-FLOP lower bound
        self.hbm_s = hbm_s              # pure-bandwidth lower bound
        self.roofline_s = roofline_s    # sum of per-op max()
        self.collective_s = collective_s
        self.mfu = mfu
        self.chip = chip
        self.per_stage = per_stage

    @property
    def step_s(self) -> float:
        return self.roofline_s + self.collective_s

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "hbm bandwidth": self.hbm_s,
                 "collectives": self.collective_s}
        return max(terms, key=lambda k: terms[k])

    def format(self) -> str:
        stages = ""
        if self.per_stage:
            stages = " (per stage: %s)" % ", ".join(
                f"{s * 1e3:.2f} ms" for s in self.per_stage)
        return (f"predicted step {self.step_s * 1e3:.3f} ms on "
                f"{self.chip.name} (roofline {self.roofline_s * 1e3:.3f} "
                f"ms + collectives {self.collective_s * 1e3:.3f} ms), "
                f"MFU {self.mfu:.3f}, {self.bound}-bound{stages}")


def _per_op_costs(ir: _gir.GraphIR, itemsize: int, batch: int,
                  data_width: int) -> List[Tuple[int, float, float]]:
    """[(op index, flops per device, bytes per device)] for one forward
    pass.  Sequential/graph lowerings carry per-example FLOPs (scale by
    batch); SameDiff lowerings already include the batch dim."""
    per_example = ir.subject != "SameDiff"
    out = []
    for op in ir.ops:
        flops = float(op.flops)
        if per_example:
            flops *= batch
        flops /= max(data_width, 1)
        bytes_ = 0.0
        for ref in tuple(op.inputs) + tuple(op.outputs):
            t = ir.tensors.get(ref)
            if t is None or not t.size_known():
                continue
            b = _dist._prod(t.shape) * itemsize
            if t.kind in ("activation", "placeholder"):
                b /= max(data_width, 1)     # batch dim sharded
            bytes_ += b
        out.append((op.index, flops, bytes_))
    return out


def step_time(target, cost=None, mesh=None, batch_size: Optional[int] = None,
              policy=None, train: bool = True) -> StepTimeEstimate:
    """Roofline step-time estimate: per-op max(flops/peak, bytes/bw)
    (x3 for fwd+bwd when training) plus gradient-collective time over
    the chip's interconnect (NVLink) bandwidth."""
    cost = CostSpec.coerce(cost) or CostSpec()
    mesh = MeshSpec.coerce(mesh) or MeshSpec({})
    batch = int(batch_size or 1)
    ir = lower(target, batch_size=batch)
    pol = _resolve_policy(ir, policy, cost)
    compute_bytes = dtype_bytes(pol.compute)
    chip = cost.chip
    peak = chip.peak_for(pol.compute)
    bw = chip.hbm_gbps * 1e9
    data_width = mesh.size(mesh.data_axis)
    factor = 3.0 if train else 1.0

    costs = _per_op_costs(ir, compute_bytes, batch, data_width)
    compute_s = sum(f for _i, f, _b in costs) * factor / peak
    hbm_s = sum(b for _i, _f, b in costs) * factor / bw
    roofline_s = sum(max(f * factor / peak, b * factor / bw)
                     for _i, f, b in costs)

    collective_s = 0.0
    if train and data_width > 1:
        facts = _dist._param_facts(_gir._ir_entries(ir), mesh,
                                   compute_bytes)
        payload = sum(_dist.collective_payload_estimates(
            facts, mesh).values())
        collective_s = payload / (chip.ici_gbps * 1e9)

    per_stage = None
    stages = _dist._stage_assignment(mesh, len(ir.ops))
    if stages is not None and ir.ops:
        per_stage = [0.0] * mesh.pipeline.stages
        for i, f, b in costs:
            per_stage[stages[i]] += max(f * factor / peak,
                                        b * factor / bw)

    step_s = roofline_s + collective_s
    total_flops = sum(f for _i, f, _b in costs) * factor
    mfu = total_flops / (step_s * peak) if step_s > 0 else 0.0
    return StepTimeEstimate(compute_s, hbm_s, roofline_s, collective_s,
                            mfu, chip, per_stage=per_stage)


# ------------------------------------------------------ capacity planner

def capacity(target, cost, mesh=None, policy=None) -> Dict[str, float]:
    """Serving capacity facts for the E122 check: per-request latency at
    the largest bucket, per-replica QPS, and (when qps is declared) the
    minimal replica count that sustains it."""
    cost = CostSpec.coerce(cost) or CostSpec()
    bucket = max(cost.buckets) if cost.buckets else 1
    est = step_time(target, cost=cost, mesh=mesh, batch_size=bucket,
                    policy=policy, train=False)
    latency_s = est.step_s
    per_replica_qps = bucket / latency_s if latency_s > 0 else float("inf")
    out = {"bucket": bucket, "latency_ms": latency_s * 1e3,
           "per_replica_qps": per_replica_qps}
    if cost.qps is not None:
        out["min_replicas"] = max(
            1, int(math.ceil(cost.qps / per_replica_qps))
            if per_replica_qps > 0 else 10 ** 9)
    return out


# ---------------------------------------------------------------- lints

def lint_cost(target, cost, mesh=None, batch_size: Optional[int] = None,
              policy=None) -> List[Diagnostic]:
    """The E12x/W12x family over one model. Gating: E120/W120 always run
    (the HBM plan needs no extra declaration); W121 needs a declared
    batch size, W122 a declared mfu_target, E121 declared buckets, E122
    a declared qps or p99_ms."""
    cost = CostSpec.coerce(cost)
    if cost is None:
        return []
    diags: List[Diagnostic] = []
    chip = cost.chip
    budget = chip.hbm_bytes

    mem = memory_plan(target, cost=cost, mesh=mesh, batch_size=batch_size,
                      policy=policy)
    dom_name, dom_bytes = mem.dominating()
    if mem.peak_bytes > budget:
        diags.append(Diagnostic(
            "DL4J-E120", Severity.ERROR, "cost model",
            f"training step-peak HBM {_fmt_bytes(mem.peak_bytes)}/device "
            f"exceeds {chip.name}'s {chip.hbm_gb:g} GiB — the dominating "
            f"liveness component is {dom_name} "
            f"({_fmt_bytes(dom_bytes)}); full plan: {mem.format()}",
            fix_hint="shard params over a model axis, declare ZeRO "
                     "(zero=True), drop steps_per_dispatch/prefetch, or "
                     "rematerialize activations"))
    elif dom_name == "live activations" \
            and mem.peak_bytes >= REMAT_BUDGET_FRACTION * budget:
        diags.append(Diagnostic(
            "DL4J-W120", Severity.WARNING, "cost model",
            f"rematerialization opportunity: live backward activations "
            f"({_fmt_bytes(dom_bytes)}) dominate the "
            f"{_fmt_bytes(mem.peak_bytes)} step peak, which sits at "
            f"{mem.peak_bytes / budget:.0%} of {chip.name}'s "
            f"{chip.hbm_gb:g} GiB — recomputing activations in the "
            f"backward pass trades cheap FLOPs for the dominating term",
            fix_hint="enable activation rematerialization (or shrink the "
                     "batch) before scaling further"))

    est = step_time(target, cost=cost, mesh=mesh, batch_size=batch_size,
                    policy=policy, train=True)
    if batch_size is not None and est.step_s > 0 \
            and est.collective_s > COMMS_BOUND_FRACTION * est.step_s:
        diags.append(Diagnostic(
            "DL4J-W121", Severity.WARNING, "cost model",
            f"comms-bound step: predicted gradient-collective time "
            f"{est.collective_s * 1e3:.3f} ms is "
            f"{est.collective_s / est.step_s:.0%} of the "
            f"{est.step_s * 1e3:.3f} ms predicted step over "
            f"{chip.name}'s {chip.ici_gbps:g} GB/s interconnect — scaling "
            f"the data axis further buys little",
            fix_hint="raise the per-device batch, accumulate gradients "
                     "(steps_per_dispatch), or allreduce in bf16"))
    if cost.mfu_target is not None and est.mfu < cost.mfu_target:
        diags.append(Diagnostic(
            "DL4J-W122", Severity.WARNING, "cost model",
            f"predicted MFU {est.mfu:.3f} is below the declared target "
            f"{cost.mfu_target:g} on {chip.name} — the binding resource "
            f"is {est.bound} ({est.format()})",
            fix_hint="raise the batch, fuse epilogues / switch to bf16 "
                     "compute, or lower the target for this chip"))

    if cost.buckets:
        peak = serving_peak_bytes(target, cost=cost, mesh=mesh,
                                  policy=policy)
        if peak > budget:
            diags.append(Diagnostic(
                "DL4J-E121", Severity.ERROR, "cost model",
                f"serving-bucket peak HBM {_fmt_bytes(peak)}/device "
                f"(params + bucket {max(cost.buckets)}'s forward "
                f"liveness peak) exceeds {chip.name}'s "
                f"{chip.hbm_gb:g} GiB at peak coalesced load",
                fix_hint="cap the bucket ladder, shard params over a "
                         "model axis, or serve on a bigger chip"))

    if cost.qps is not None or cost.p99_ms is not None:
        cap = capacity(target, cost, mesh=mesh, policy=policy)
        if cost.p99_ms is not None and cap["latency_ms"] > cost.p99_ms:
            diags.append(Diagnostic(
                "DL4J-E122", Severity.ERROR, "cost model",
                f"capacity: predicted per-request latency "
                f"{cap['latency_ms']:.3f} ms at bucket {cap['bucket']} "
                f"already exceeds the {cost.p99_ms:g} ms p99 budget on "
                f"an IDLE {chip.name} replica — no replica count fixes "
                f"latency",
                fix_hint="serve smaller buckets, a faster chip, or a "
                         "smaller model"))
        if cost.qps is not None:
            need = cap["min_replicas"]
            have = cost.replicas if cost.replicas is not None else 1
            if need > have:
                diags.append(Diagnostic(
                    "DL4J-E122", Severity.ERROR, "cost model",
                    f"capacity shortfall: {have} replica(s) sustain "
                    f"~{cap['per_replica_qps'] * have:.1f} QPS at bucket "
                    f"{cap['bucket']} but {cost.qps:g} QPS is declared "
                    f"— the minimal replica count is {need}",
                    fix_hint=f"deploy >= {need} replicas (or serve "
                             f"larger buckets to raise per-replica "
                             f"throughput)"))
    return diags


# --------------------------------------------------------------- planner

class CostReport:
    """The :func:`plan` bundle: memory plan + step estimate + capacity +
    the E12x/W12x diagnostics, with a human ``format()``."""

    def __init__(self, memory: MemoryPlan, step: StepTimeEstimate,
                 cap: Optional[Dict[str, float]],
                 diagnostics: List[Diagnostic]):
        self.memory = memory
        self.step = step
        self.capacity = cap
        self.diagnostics = diagnostics

    def format(self) -> str:
        lines = [self.memory.format(), self.step.format()]
        if self.capacity is not None:
            c = self.capacity
            line = (f"capacity: bucket {c['bucket']} at "
                    f"{c['latency_ms']:.3f} ms -> "
                    f"{c['per_replica_qps']:.1f} QPS/replica")
            if "min_replicas" in c:
                line += f", minimal replicas {c['min_replicas']}"
            lines.append(line)
        for d in self.diagnostics:
            lines.append(d.format())
        return "\n".join(lines)


def plan(target, cost=None, mesh=None, batch_size: Optional[int] = None,
         policy=None) -> CostReport:
    """One-stop planner: the full cost picture for a model on a chip."""
    cost = CostSpec.coerce(cost) or CostSpec()
    mem = memory_plan(target, cost=cost, mesh=mesh, batch_size=batch_size,
                      policy=policy)
    est = step_time(target, cost=cost, mesh=mesh, batch_size=batch_size,
                    policy=policy, train=True)
    cap = capacity(target, cost, mesh=mesh, policy=policy) \
        if (cost.qps is not None or cost.p99_ms is not None
            or cost.buckets) else None
    diags = lint_cost(target, cost, mesh=mesh, batch_size=batch_size,
                      policy=policy)
    return CostReport(mem, est, cap, diags)


# --------------------------------------------------------- tune/ pruning

def plan_pruner(conf, batch_size: Optional[int], cost, mesh=None,
                policy=None, bound: float = 3.0):
    """Build the tune/ static-domination pruner: a callable mapping a
    :class:`tune.TuningPlan` to a prune REASON string (or None to keep
    it).  A candidate is dominated when its predicted step peak OOMs the
    chip or its predicted step time exceeds the DEFAULT plan's
    prediction x ``bound``.  The caller (tune.driver) guarantees the
    incumbent default plan is never offered for pruning."""
    cost = CostSpec.coerce(cost) or CostSpec()

    def spec_for(tuning_plan) -> CostSpec:
        return CostSpec(
            chip=cost.chip, steps_per_dispatch=getattr(
                tuning_plan, "steps_per_dispatch", 1) or 1,
            prefetch=getattr(tuning_plan, "prefetch", 0) or 0,
            precision=getattr(tuning_plan, "precision", None))

    base = step_time(
        conf, cost=CostSpec(chip=cost.chip, steps_per_dispatch=1,
                            prefetch=0),
        mesh=mesh, batch_size=batch_size, policy=policy)

    def pruner(tuning_plan) -> Optional[str]:
        c = spec_for(tuning_plan)
        mem = memory_plan(conf, cost=c, mesh=mesh, batch_size=batch_size,
                          policy=policy)
        if mem.peak_bytes > c.chip.hbm_bytes:
            dom, dom_b = mem.dominating()
            return (f"predicted OOM on {c.chip.name}: "
                    f"{_fmt_bytes(mem.peak_bytes)}/device of "
                    f"{c.chip.hbm_gb:g} GiB ({dom} {_fmt_bytes(dom_b)} "
                    f"dominates)")
        est = step_time(conf, cost=c, mesh=mesh, batch_size=batch_size,
                        policy=policy)
        if base.step_s > 0 and est.step_s > base.step_s * bound:
            return (f"predicted step {est.step_s * 1e3:.3f} ms > "
                    f"{bound:g}x the default plan's "
                    f"{base.step_s * 1e3:.3f} ms")
        return None

    return pruner
