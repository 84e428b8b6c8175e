"""Declarative tuning space over the optimization seams — a copy of
``deeplearning4j_tpu/tune/space.py`` (the JAX package's module imports no
JAX; the port keeps its own copy, as it imports nothing of that package).

Every performance knob of the stack — the conv compute layout, fused
epilogues (``scale_shift_act``), ``steps_per_dispatch`` megasteps (one
captured CUDA graph for K steps), mixed precision, prefetch depth,
serving bucket ladders, sharding plans — is a *seam*: a setter whose
change drops the captured steps once. A :class:`TuningPlan` is one
point in the cross product of those seams; a :class:`TuningSpace`
enumerates the points deterministically so a search driver
(``tune.driver``) can walk them and a record store (``tune.records``)
can persist the winner under a stable :meth:`TuningPlan.signature`.

The sharding axis takes live ``ShardedTrainingPlan`` objects
(``TuningSpace.for_model(sharding_variants=[...])``) over a mesh of
ranks; :meth:`TuningPlan.apply` attaches the plan's variant to the
model, and a record keeps its signature string.
"""

from __future__ import annotations

import itertools
import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Axis names in CANONICAL ORDER — signatures, enumeration order, and
#: the greedy refinement walk all follow it, so two processes building
#: the same space agree on plan identity and trial order.
AXES = ("compute_layout", "fuse_epilogues", "steps_per_dispatch",
        "precision", "prefetch", "bucket_limit", "sharding")

_LAYOUTS = ("NCHW", "NHWC")
#: Megastep K candidates: 1 = plain per-batch dispatch.
K_CHOICES = (1, 4, 8, 16)


def _sharding_sig(value) -> Optional[str]:
    """A sharding-axis value is None or an object with ``signature()``
    (a ``ShardedTrainingPlan`` / ZeRO variant); records persist the
    signature string, so a restored plan may carry the bare string."""
    if value is None:
        return None
    sig = getattr(value, "signature", None)
    return sig() if callable(sig) else str(value)


class TuningPlan:
    """One candidate assignment over the optimization seams.

    Immutable by convention (use :meth:`replace`); equality and hashing
    follow :meth:`signature`, so a search driver can dedupe revisits and
    the record store can key winners stably across processes.
    """

    def __init__(self, compute_layout: str = "NCHW",
                 fuse_epilogues: bool = False,
                 steps_per_dispatch: int = 1,
                 precision: Optional[str] = None,
                 prefetch: int = 2,
                 bucket_limit: Optional[int] = None,
                 sharding=None):
        if compute_layout not in _LAYOUTS:
            raise ValueError(f"compute_layout must be one of {_LAYOUTS}, "
                             f"got {compute_layout!r}")
        if int(steps_per_dispatch) < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if int(prefetch) < 0:
            raise ValueError("prefetch must be >= 0")
        self.compute_layout = compute_layout
        self.fuse_epilogues = bool(fuse_epilogues)
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.precision = precision      # None (fp32) or a policy string
        self.prefetch = int(prefetch)
        self.bucket_limit = None if bucket_limit is None \
            else int(bucket_limit)
        self.sharding = sharding

    # ------------------------------------------------------------ identity
    def signature(self) -> str:
        """Stable, human-greppable identity — the record-store key
        component and the dedupe key for trial revisits."""
        return (f"layout={self.compute_layout}"
                f";fuse={int(self.fuse_epilogues)}"
                f";k={self.steps_per_dispatch}"
                f";prec={self.precision or 'fp32'}"
                f";prefetch={self.prefetch}"
                f";buckets={self.bucket_limit if self.bucket_limit else '-'}"
                f";shard={_sharding_sig(self.sharding) or '-'}")

    def __repr__(self):
        return f"TuningPlan({self.signature()})"

    def __eq__(self, other):
        return isinstance(other, TuningPlan) \
            and other.signature() == self.signature()

    def __hash__(self):
        return hash(self.signature())

    # ---------------------------------------------------------- transforms
    def replace(self, **kv) -> "TuningPlan":
        cfg = {a: getattr(self, a) for a in AXES}
        cfg.update(kv)
        return TuningPlan(**cfg)

    def to_config(self) -> dict:
        """JSON-serializable form for the record store. The sharding
        axis degrades to its signature string — an attached
        ``ShardedTrainingPlan`` holds live mesh/device handles that
        cannot round-trip a process boundary; the record's KEY already
        carries the mesh, so the string is informational."""
        return {"compute_layout": self.compute_layout,
                "fuse_epilogues": self.fuse_epilogues,
                "steps_per_dispatch": self.steps_per_dispatch,
                "precision": self.precision,
                "prefetch": self.prefetch,
                "bucket_limit": self.bucket_limit,
                "sharding": _sharding_sig(self.sharding)}

    @classmethod
    def from_config(cls, cfg: dict) -> "TuningPlan":
        known = {k: cfg[k] for k in AXES if k in cfg}
        return cls(**known)

    # ------------------------------------------------------------- applying
    def apply(self, model) -> dict:
        """Apply the model-level seams to ``model`` (layout, fusion,
        precision) and return the FIT-level knobs as kwargs
        (``steps_per_dispatch``, ``prefetch``) for the caller's
        ``fit``/megastep loop.  Each setter is signature-keyed: applying
        an equal plan twice keeps the compiled-step caches (zero
        steady-state recompiles).  The sharding axis is NOT re-attached
        here — a restored plan only carries its signature string, and
        tuning runs inside the caller's chosen mesh (the record key
        separates meshes)."""
        if hasattr(model, "setComputeLayout"):
            model.setComputeLayout(self.compute_layout)
        if hasattr(model, "setEpilogueFusion"):
            model.setEpilogueFusion(self.fuse_epilogues)
        if hasattr(model, "setPrecisionPolicy"):
            model.setPrecisionPolicy(self.precision)
        if self.sharding is not None and hasattr(self.sharding, "mesh") \
                and hasattr(model, "setShardingPlan"):
            model.setShardingPlan(self.sharding)
        return {"steps_per_dispatch": self.steps_per_dispatch,
                "prefetch": self.prefetch}


class TuningSpace:
    """The cross product of per-axis candidate values.

    ``axes`` maps axis name -> value tuple; missing axes pin to the
    :class:`TuningPlan` default.  Enumeration is deterministic
    (itertools.product in canonical ``AXES`` order) and sampling is
    seeded, so the same (space, seed, budget) triple visits the same
    plans on every host — a property the record store's cross-process
    key-identity test pins.
    """

    def __init__(self, axes: Dict[str, Sequence]):
        unknown = set(axes) - set(AXES)
        if unknown:
            raise ValueError(f"unknown tuning axes {sorted(unknown)}; "
                             f"valid axes: {list(AXES)}")
        defaults = TuningPlan()
        self.axes: Dict[str, Tuple] = {}
        for name in AXES:       # canonical order, defaults filled in
            vals = tuple(axes.get(name, (getattr(defaults, name),)))
            if not vals:
                vals = (getattr(defaults, name),)
            self.axes[name] = vals

    @classmethod
    def for_model(cls, model=None, *, serving: bool = False,
                  sharding_variants: Sequence = (),
                  max_steps_per_dispatch: int = 16) -> "TuningSpace":
        """The default search space for a network: both conv layouts,
        fusion on/off, megastep K, bf16-vs-fp32, prefetch depth.  A
        model without conv layers (no ``setComputeLayout`` consumer
        benefit) keeps the layout/fusion axes anyway — they are cheap
        no-ops there and the K/precision axes dominate; callers with
        tighter budgets pass explicit ``axes``.  ``serving=True`` adds
        the bucket-ladder cap axis; distributed runs pass live
        ``ShardedTrainingPlan`` objects as ``sharding_variants``."""
        ks = tuple(k for k in K_CHOICES if k <= max_steps_per_dispatch)
        axes = {"compute_layout": _LAYOUTS,
                "fuse_epilogues": (False, True),
                "steps_per_dispatch": ks or (1,),
                "precision": (None, "bf16"),
                "prefetch": (0, 2, 4)}
        if serving:
            axes["bucket_limit"] = (None, 8, 32)
        if sharding_variants:
            axes["sharding"] = (None,) + tuple(sharding_variants)
        return cls(axes)

    # ---------------------------------------------------------- enumeration
    @property
    def size(self) -> int:
        n = 1
        for vals in self.axes.values():
            n *= len(vals)
        return n

    def default_plan(self) -> TuningPlan:
        return TuningPlan()

    def enumerate_plans(self) -> List[TuningPlan]:
        """Every plan, deterministic order (product over canonical axis
        order, values in declaration order)."""
        names = list(self.axes)
        plans = []
        for combo in itertools.product(*(self.axes[n] for n in names)):
            plans.append(TuningPlan(**dict(zip(names, combo))))
        return plans

    def sample(self, n: int, seed: int = 0) -> List[TuningPlan]:
        """``n`` distinct plans, seeded — the random phase of the search.
        Sampling enumerates first (spaces here are small — tens to a few
        thousand points) so identical (seed, n) pairs agree across
        hosts regardless of hash randomization."""
        plans = self.enumerate_plans()
        if n >= len(plans):
            return plans
        return random.Random(int(seed)).sample(plans, n)

    def neighbors(self, plan: TuningPlan,
                  axis_order: Optional[Iterable[str]] = None
                  ) -> List[Tuple[str, TuningPlan]]:
        """Single-axis mutations of ``plan`` — the greedy-refinement
        moves.  ``axis_order`` biases which seams are tried first (the
        driver feeds ``DeviceTimeTable.top_offenders`` through
        ``axis_priority``); axes not listed follow in canonical order."""
        order = [a for a in (axis_order or ()) if a in self.axes]
        order += [a for a in AXES if a not in order]
        out: List[Tuple[str, TuningPlan]] = []
        for name in order:
            for val in self.axes[name]:
                if val != getattr(plan, name):
                    out.append((name, plan.replace(**{name: val})))
        return out


def axis_priority(timings) -> List[str]:
    """Map a :class:`~deeplearning4j_tpu_torch.profiler.devicetime.
    DeviceTimeTable` onto a refinement order: conv-dominated profiles
    try the layout/fusion seams first (the tensor-core-facing knobs), matmul/
    attention-dominated ones try precision and megastep K.  ``None`` (no
    device timing available) keeps the canonical order."""
    if timings is None:
        return list(AXES)
    try:
        offenders = timings.top_offenders(3)
    except Exception:
        return list(AXES)
    kinds = " ".join(str(getattr(r, "op", r)) for r in offenders).lower()
    if "conv" in kinds or "pool" in kinds or "norm" in kinds:
        lead = ["compute_layout", "fuse_epilogues", "precision",
                "steps_per_dispatch"]
    else:
        lead = ["precision", "steps_per_dispatch", "prefetch"]
    return lead + [a for a in AXES if a not in lead]
