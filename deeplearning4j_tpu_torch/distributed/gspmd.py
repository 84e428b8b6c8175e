"""The sharded fit path (tier 1) — the port of
``deeplearning4j_tpu/distributed/gspmd.py``.

A :class:`ShardedTrainingPlan` declares how a model trains over a
:class:`~deeplearning4j_tpu_torch.parallel.mesh.DeviceMesh`: the batch
splits over ``batch_axes`` (the data axis by default, or the product of
several); a parameter that a rule shards over any mesh axes is split at
rest (each rank holds its piece), the others replicate; a
:class:`~deeplearning4j_tpu_torch.distributed.zero.ZeroPlan` shards the
updater state over the data axis. Attached to a network
(``setShardingPlan``), it changes the network's own step, eager or
captured (``nn.network``):

- staging: a global batch is padded to the data multiple with zero-
  weight rows and each rank keeps its rows, on the host
  (:meth:`localize`);
- the step gets a :class:`~deeplearning4j_tpu_torch.parallel.
  collectives.DataParallelStep`: sync BN, each rank's loss weighed by its
  share of the real rows, dropout at the rank's global row offset;
- split parameters are all-gathered whole before the forward
  (:meth:`gather_params`, one flat all-gather a dtype over the data
  axis; a piece over other axes is gathered over them);
- the gradients: a parameter split over the data axis alone has its
  gradient reduce-scattered to this rank's piece, the others' and the
  loss summed in one flat all-reduce over the batch axes, before
  gradient normalization (whose norms then sum the pieces' squares over
  their axes); a parameter split over a ``model`` or ``seq`` axis keeps
  its slice of the summed gradient: every rank of that axis ran the same
  rows on the same gathered weights, so there is no reduction over it.
  A split parameter is updated on its piece and stays split, and under
  ZeRO a replicated parameter is updated on its piece and the pieces
  are all-gathered. The updater state of a parameter split over a
  non-data axis is split with it (ZeRO splits the rest over data).

There is no compiler to partition a global program here, so the
collectives are explicit (``parallel.collectives``), over the mesh's
process groups; DTensor and FSDP2 are not used: the step is functional
over dicts of tensors updated in place, its kernels are bound through
ctypes and it is captured into CUDA graphs. A plan with no rules and no
ZeRO runs exactly the step ``ParallelWrapper`` runs (the same
reduction, in the same order). Rules over ``model`` are this gather at
the step, not Megatron's split matmuls: a network's layers are opaque to
the plan, so each rank runs them whole; the Megatron layout is
``models.transformer``'s, whose forward is written for it.

:func:`hlo_collective_bytes` is the counterpart of the JAX function of
that name: the ``{kind: bytes}`` of the collectives one recorded step
issued on this rank (:func:`step_collective_bytes`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.distributed.zero import (ZeroPlan, full_value,
                                                       updater_hbm_bytes)
from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel.mesh import (DeviceMesh, Placement,
                                                    ShardingRule,
                                                    global_shape,
                                                    local_piece,
                                                    placement_of,
                                                    set_placement, split_of)


def _coerce_rules(rules) -> Optional[ShardingRule]:
    if rules is None or isinstance(rules, ShardingRule):
        return rules
    if isinstance(rules, dict):
        return ShardingRule(rules)
    raise TypeError(f"cannot interpret {rules!r} as sharding rules "
                    "(use ShardingRule or a {regex: spec-tuple} dict)")


def _rows(a, lo: int, hi: int, dim: int):
    if a is None:
        return None
    idx = (slice(None),) * dim + (slice(lo, hi),)
    return a[idx]


class ShardedTrainingPlan:
    """Declarative mapping from a mesh to a sharded fit.

    - ``rules``: {param-name-regex: spec-tuple} (or a
      :class:`ShardingRule`) matched against ``"<layer-or-node-name>/
      <param>"``. A dim ruled over ``data`` splits the parameter at rest
      over the data ranks (FSDP style); over ``model``, ``seq`` or any
      other axis it splits it over that axis's ranks, gathered whole for
      each step (see the module note). Rules naming size-1 axes
      replicate.
    - ``batch_axes``: mesh axes the batch dim shards over (default
      ``("data",)``; several split it over their product, and the
      gradients sum over all of them).
    - ``zero``: a :class:`ZeroPlan` (or ``True``) sharding updater state
      across the data axis.
    """

    def __init__(self, mesh: DeviceMesh, rules=None,
                 batch_axes: Tuple[str, ...] = ("data",), zero=None):
        self.mesh = mesh
        self.rules = _coerce_rules(rules)
        self.batch_axes = tuple(batch_axes)
        for a in self.batch_axes:
            if a not in mesh.axis_names:
                raise ValueError(f"batch axis {a!r} is not a mesh axis "
                                 f"{tuple(mesh.axis_names)}")
        if self.rules is not None:
            for pat, spec in self.rules.rules:
                split_of(mesh, spec, f"rule {pat.pattern!r}")
        self.zero = ZeroPlan.coerce(zero)
        # a product group is formed collectively: now, on every rank alike
        self.batch_group = mesh.group_over(self.batch_axes)

    # ------------------------------------------------------------ identity
    def signature(self):
        """Hashable identity for the step caches: mesh shape and ranks,
        rule patterns, batch axes and the ZeRO declaration."""
        rules = None
        if self.rules is not None:
            rules = tuple((pat.pattern, tuple(spec))
                          for pat, spec in self.rules.rules)
        return ("gspmd", tuple(self.mesh.shape.items()),
                tuple(self.mesh.ranks), rules, self.batch_axes,
                self.zero.signature() if self.zero is not None else None)

    def data_shards(self) -> int:
        """How many ways the batch dim splits (the pad-to multiple)."""
        n = 1
        for a in self.batch_axes:
            n *= self.mesh.size(a)
        return n

    @property
    def group(self):
        """The data axis's process group (None on one rank): the one
        ZeRO and the data-axis split of a parameter work over."""
        return self.mesh.group("data")

    def full(self, t: torch.Tensor) -> torch.Tensor:
        """The whole value of a piece this plan placed (a collective over
        its axes); an untagged tensor as it is."""
        p = placement_of(t)
        if p is None or (p.axes == ("data",) and p.groups == 1):
            return full_value(t, self.group)
        return self.mesh.gather(t)

    def mesh_spec(self, **kw):
        """The declaration for the static analyzer: the mesh with this
        plan's rules and ZeRO declaration attached."""
        kw.setdefault("sharding", self.rules)
        if self.zero is not None:
            kw.setdefault("zero", self.zero.declare())
        return self.mesh.spec(**kw)

    # ------------------------------------------------------- param naming
    def _leaf_param_name(self, model, n, k) -> str:
        """``"<layer-or-node-name>/<param>"``: a list index resolves to the
        layer's name (or class), a dict key is the graph node."""
        layers = getattr(model, "layers", None)
        if isinstance(n, int) and layers is not None:
            layer = layers[n]
            lname = getattr(layer, "name", None) or type(layer).__name__
        else:
            lname = str(n)
        return f"{lname}/{k}"

    def _param_spec(self, model, n, k, leaf) -> Tuple:
        if self.rules is None:
            return ()
        return self.rules.spec_for(self._leaf_param_name(model, n, k),
                                   leaf.dim())

    def param_specs(self, model) -> Dict:
        """``{(layer, param): spec}`` of every parameter."""
        return {(n, k): self._param_spec(model, n, k, v)
                for n, p in model._items(model._params)
                for k, v in p.items()}

    def opt_specs(self, model) -> Dict:
        """``{(layer, param, state key): spec}``: each param-shaped state
        tensor's ZeRO spec (its param's spec without ZeRO; a split
        param's state is split with it, and so is a param's split over a
        non-data axis under ZeRO)."""
        n_axis = self.mesh.size(self.zero.axis) \
            if self.zero is not None else 1
        out = {}
        for n, p in model._items(model._params):
            for k, v in p.items():
                pspec = self._param_spec(model, n, k, v)
                for sk, s in model._opt_state[n][k].items():
                    shape = global_shape(s)
                    if shape != global_shape(v):
                        out[(n, k, sk)] = ()
                    elif self.zero is not None and not self._split_beyond(
                            pspec):
                        out[(n, k, sk)] = self.zero.state_spec(
                            pspec, shape, s.element_size(), n_axis)
                    else:
                        out[(n, k, sk)] = pspec
        return out

    def _split_beyond(self, spec) -> bool:
        """Whether ``spec`` splits over an axis other than ``data``."""
        sp = split_of(self.mesh, spec, "rule")
        return sp is not None and sp[1] != ("data",)

    def param_layout(self, model) -> Dict:
        """``{(layer, param): (dim, axes)}`` of the params split at rest:
        a rule shards them over mesh axes of size above 1 (``("data",)``
        alone is FSDP style), with the dim each is split along."""
        if self.rules is None:
            return {}
        out = {}
        for (n, k), spec in self.param_specs(model).items():
            sp = split_of(self.mesh, spec, f"rule for {n}/{k}")
            if sp is not None:
                out[(n, k)] = sp
        return out

    def zero_layout(self, model) -> Dict:
        """``{(layer, param): dim}`` of the params whose updater state is
        split over the data axis alone (the dim it is split along):
        ZeRO's, and a data-split parameter's, whose state follows it."""
        layout = {}
        for (n, k, _sk), spec in self.opt_specs(model).items():
            sp = split_of(self.mesh, spec, f"state of {n}/{k}")
            if sp is not None and sp[1] == ("data",):
                layout[(n, k)] = sp[0]
        return layout

    # ----------------------------------------------------- batch placement
    def batch_spec(self, ndim: int, mega: bool = False) -> Tuple:
        """The batch spec: dim 0 (dim 1 under a ``[K, B, ...]`` megabatch)
        over ``batch_axes``; every other dim replicated."""
        if ndim == 0:
            return ()
        axes = self.batch_axes if len(self.batch_axes) > 1 \
            else self.batch_axes[0]
        if mega:
            if ndim == 1:
                return (None,)
            return (None, axes) + (None,) * (ndim - 2)
        return (axes,) + (None,) * (ndim - 1)

    def place(self, a, mega: bool = False):
        """One global batch array onto the mesh: this rank's rows (dim 1
        of a megabatch) on its device, tagged with their place; a tensor
        already placed passes through."""
        if a is None:
            return None
        if mega and np.ndim(a) == 1:
            return self.mesh.replicate(a)
        return self.mesh.shard_rows(a, dim=1 if mega else 0,
                                    axes=self.batch_axes)

    def localize(self, item):
        """A global DataSet, MultiDataSet or MegaBatch -> this rank's rows
        of it, on the host: padded first to the data multiple with zero-
        weight rows (a MegaBatch must already split evenly)."""
        from deeplearning4j_tpu_torch.parallel.data import (SHARD_BYTES,
                                                            pad_to_data_axis)
        from deeplearning4j_tpu_torch.train.stepping import MegaBatch
        n = self.data_shards()
        r = self.mesh.index_over(self.batch_axes)
        mega = isinstance(item, MegaBatch)
        if not mega:
            item = pad_to_data_axis(item, n)
        dim = 1 if mega else 0
        multi = isinstance(item, MultiDataSet) or (mega and item.multi)
        first = item.features[0] if multi else item.features
        b = int(first.shape[dim])
        if b % n:
            raise ValueError(f"a megabatch of {b} rows does not split over "
                             f"the batch axes' {n} ranks")
        c = b // n
        lo, hi = r * c, (r + 1) * c

        def cut(a):
            return _rows(a, lo, hi, dim)

        def cuts(xs):
            return None if xs is None else [cut(a) for a in xs]
        if _prof.instrumentation_active():
            arrs = list(item.features) if multi else [item.features]
            SHARD_BYTES.labels(site="wrapper").inc(
                sum(int(a.nbytes) for a in arrs if hasattr(a, "nbytes")))
        if mega:
            out = MegaBatch()
            out.steps, out.multi = item.steps, item.multi
            f = cuts if item.multi else cut
            out.features, out.labels = f(item.features), f(item.labels)
            out.features_mask = f(item.features_mask)
            out.labels_mask = f(item.labels_mask)
            return out
        if multi:
            return MultiDataSet(cuts(item.features), cuts(item.labels),
                                cuts(item.features_masks),
                                cuts(item.labels_masks))
        return DataSet(cut(item.features), cut(item.labels),
                       cut(item.features_mask), cut(item.labels_mask))

    def stages_on_host(self, t: torch.Tensor) -> bool:
        """Whether the step's collectives on ``t``'s device stage through
        pinned host memory (gloo on the card): such a step stays eager."""
        return collectives.stages_on_host(self.batch_group, t)

    def step_context(self, rows: int) -> collectives.DataParallelStep:
        """The data-parallel facts of one step over ``rows`` local rows
        (over the batch axes' group)."""
        return collectives.DataParallelStep(self.batch_group, rows)

    # ------------------------------------------------------ the step's seams
    def gather_params(self, model, grad: bool = True):
        """The model's params whole, for one step (``grad``: the gathered
        tensors are fresh autograd leaves) or one read: a copy of the
        params tree with each split param all-gathered (over the data
        axis one flat all-gather a dtype; a collective every rank of the
        split axes enters), the others the model's own tensors."""
        layout = model._fsdp_layout
        params = model._map(model._params, lambda v: v)
        keys = [nk for nk in layout if layout[nk][1] == ("data",)]
        wholes = collectives.flat_all_gather(
            [(model._params[n][k], layout[(n, k)][0]) for n, k in keys],
            self.group)
        for nk in layout:
            if nk not in keys:
                keys.append(nk)
                wholes.append(self.mesh.gather(model._params[nk[0]][nk[1]]))
        for (n, k), w in zip(keys, wholes):
            params[n][k] = w.requires_grad_(True) if grad else w
        return params

    def _scatters(self, split) -> bool:
        """Whether a split param's gradient is reduce-scattered (split
        over the data axis alone, the batch over it alone) rather than
        summed whole and sliced."""
        return split is not None and split[1] == ("data",) and \
            self.batch_axes == ("data",)

    def reduce_gradients(self, grads, loss, splits=None):
        """Reduce one step's gradients and (scaled) loss over the batch
        axes: a gradient whose ``splits`` entry is ``(dim, ("data",))`` (a
        data-split param's) is reduce-scattered to this rank's piece
        along it; the others and the loss are summed in one flat
        all-reduce a dtype, and a param split over other axes keeps its
        slice of the sum; returns ``(grads, loss)``."""
        splits = splits or [None] * len(grads)
        whole = [i for i, d in enumerate(splits) if not self._scatters(d)]
        scat = [i for i, d in enumerate(splits) if self._scatters(d)]
        out = list(grads)
        summed = collectives.flat_all_reduce(
            [grads[i] for i in whole] + [loss.reshape(1)], self.batch_group)
        for i, g in zip(whole, summed):
            out[i] = g
        if scat:
            pieces = collectives.flat_reduce_scatter(
                [(grads[i], splits[i][0]) for i in scat], self.group)
            for i, g in zip(scat, pieces):
                out[i] = g
        for i in whole:
            if splits[i] is not None:
                dim, axes = splits[i]
                p = Placement(out[i].shape, dim, self.mesh.size(axes),
                              self.mesh.index_over(axes), axes)
                out[i] = local_piece(out[i], p)
        return out, summed[-1].reshape(loss.shape)

    def grad_sq_norms(self, grads, splits) -> torch.Tensor:
        """Each gradient's squared L2 norm (fp32), a piece's summed over
        the ranks of its split axes: what gradient normalization divides
        by when some gradients are pieces."""
        sq = torch.stack([g.float().square().sum() for g in grads])
        out = sq
        for axes in sorted({s[1] for s in splits if s is not None}):
            mine = torch.tensor([s is not None and s[1] == axes
                                 for s in splits], device=sq.device)
            total = collectives.all_reduce(torch.where(mine, sq, 0.0),
                                           self.mesh.group_over(axes))
            out = torch.where(mine, total, out)
        return out

    def all_finite(self, ok: torch.Tensor, splits=()) -> torch.Tensor:
        """A rank's all-finite flag over its gradient pieces -> the whole
        gradient's: every rank's flag over each axis a param splits along
        (``splits``: the split params' ``(dim, axes)``; the data axis
        without them)."""
        axes = {a for s in splits for a in s[1]} or {"data"}
        bad = (~ok).to(torch.float32).reshape(1)
        for a in [a for a in self.mesh.axis_names if a in axes]:
            bad = collectives.all_reduce(bad, self.mesh.group(a))
        return (bad == 0).reshape(())

    def gather_pieces(self, pieces) -> None:
        """The ZeRO update's all-gather: ``[(param, dim, new piece)]`` ->
        every param written whole, in place, from the ranks' new pieces
        (one flat all-gather a dtype)."""
        wholes = collectives.flat_all_gather(
            [(new, dim) for _, dim, new in pieces], self.group)
        for (p, _, _), w in zip(pieces, wholes):
            p.copy_(w)

    # ------------------------------------------------------------ lifecycle
    def apply(self, model):
        """Place the model per this plan: params and layer states made
        equal on every rank (broadcast from data rank 0), the params a
        rule splits cut to this rank's piece, the updater state split per
        the ZeRO layout or with its split param (this rank keeps its
        pieces), the ``dl4j_updater_hbm_bytes`` gauge refreshed. A layout
        change drops the captured steps (they hold the old tensors).
        Idempotent."""
        if not model._initialized:
            model.init()
        model._ensure_opt_state()
        with _prof.trace_span("collective:place_params",
                              devices=self.mesh.size()):
            changed = self.place_params(model)
            layout = self.zero_layout(model)
            beyond = {nk: sp for nk, sp in self.param_layout(model).items()
                      if sp[1] != ("data",)}
            for n_, p in model._items(model._params):
                for k, v in p.items():
                    st = model._opt_state[n_][k]
                    d = beyond.get((n_, k))
                    if d is None and (n_, k) in layout:
                        d = (layout[(n_, k)], ("data",))
                    for sk, s in list(st.items()):
                        shaped = global_shape(s) == global_shape(v)
                        new = self._placed(s, d if shaped else None)
                        if new is not s:
                            st[sk] = new
                            changed = True
        if changed:
            model._step_cache = {}
        model._zero_layout = dict(layout) or None
        updater_hbm_bytes(model._opt_state)
        return model

    def _placed(self, t: torch.Tensor, split):
        """``t`` (whole, or a piece) as this plan places it: this rank's
        piece of ``split`` (``(dim, axes)``), or whole for None; ``t``
        itself when it is placed so already."""
        cur = placement_of(t)
        want = None
        if split is not None:
            dim, axes = split
            n = self.mesh.size(axes)
            shape = global_shape(t)
            # the data axis's collectives take equal pieces; the others
            # split unevenly where they must (``Placement``)
            if shape[dim] < n or (axes == ("data",) and shape[dim] % n):
                raise ValueError(f"dim {dim} ({shape[dim]}) does not split "
                                 f"over {'x'.join(axes)} of {n}")
            want = Placement(shape, dim, n, self.mesh.index_over(axes), axes)
        if _same(cur, want):
            return t
        full = self.full(t) if cur is not None else t.detach()
        if want is None:
            return set_placement(full.contiguous(), None)
        return set_placement(full[want.slices()].contiguous().clone(), want)

    def place_params(self, model) -> bool:
        """Params and layer states (not updater state): each whole one
        equal on every rank (broadcast from rank 0 of the data axis, in
        place, then along each other axis of size above 1), then the
        params a rule splits cut to this rank's piece (a split param is a
        fresh tensor). Returns whether any param changed its placement."""
        layout = self.param_layout(model)
        tensors = [v for _, p in model._items(model._params)
                   for v in p.values() if placement_of(v) is None]
        tensors += [v for _, s in model._items(model._states)
                    for v in (s or {}).values()]
        group = self.group
        changed = False
        with torch.no_grad():
            # on one rank too: NCCL makes its communicator at the first
            # collective, which must not be inside a capture
            for t in tensors:
                collectives.broadcast(t.data, group)
            for a in self.mesh.axis_names:
                if a != "data" and self.mesh.size(a) > 1:
                    for t in tensors:
                        collectives.broadcast(t.data, self.mesh.group(a))
            for n, p in model._items(model._params):
                for k, v in list(p.items()):
                    new = self._placed(v, layout.get((n, k)))
                    if new is not v:
                        p[k] = new.requires_grad_(True)
                        changed = True
        model._fsdp_layout = dict(layout) or None
        return changed

    def checkpoint_view(self, model):
        """The model as a checkpoint writer must see it: itself when
        nothing is split, else a shallow copy whose split params and
        updater state are gathered whole (a collective every rank of the
        data group enters; then one rank writes)."""
        if not getattr(model, "_zero_layout", None) and \
                not getattr(model, "_fsdp_layout", None):
            return model
        import copy
        view = copy.copy(model)
        if model._fsdp_layout:
            view._params = self.gather_params(model, grad=False)
            view._fsdp_layout = None
        view._opt_state = model._map(model._opt_state, lambda sd: {
            sk: self.full(sv) for sk, sv in sd.items()})
        return view

    def ensure_placed(self, model) -> None:
        """Cheap guard before a dispatch: re-place the model when its
        params or updater state do not match this plan's layout (a fresh
        init, a restore, a plan change)."""
        layout = self.param_layout(model)
        if model._opt_state is None or \
                getattr(model, "_zero_layout", None) != \
                (self.zero_layout(model) or None) or \
                getattr(model, "_fsdp_layout", None) != (layout or None) or \
                any(placement_of(model._params[n][k]) is None
                    for n, k in layout):
            self.apply(model)

    def __repr__(self):
        return (f"ShardedTrainingPlan(mesh={self.mesh.shape}, "
                f"rules={'yes' if self.rules else None}, "
                f"batch_axes={self.batch_axes}, zero={self.zero})")


def _same(a: Optional[Placement], b: Optional[Placement]) -> bool:
    if a is None or b is None:
        return a is b
    return (a.global_shape, a.dim, a.parts, a.index, a.axes, a.groups) == \
        (b.global_shape, b.dim, b.parts, b.index, b.axes, b.groups)


# --------------------------------------------------------------- trainer
class GSPMDTrainer:
    """The plan-driven fit driver: the network's own ``fit`` with the plan
    attached, so one call covers data parallelism and ZeRO, with
    resilience (``checkpoint=``/``nan_policy=``/``faults=``) and K-step
    dispatch composing unchanged."""

    def __init__(self, model, plan: ShardedTrainingPlan,
                 prefetch_buffer: int = 2):
        self.model = model
        self.plan = plan
        self.prefetch = prefetch_buffer

    @property
    def mesh(self) -> DeviceMesh:
        return self.plan.mesh

    def validate(self, batch_size: int = None, **kw):
        """Static lint against this plan's mesh + rules + ZeRO
        declaration."""
        kw.setdefault("mesh", self.plan.mesh_spec())
        return self.model.validate(batch_size=batch_size, **kw)

    def warmup(self, shapes, *, steps_per_dispatch: int = 1, dtype=None,
               label_dtype=None, policy=None):
        """Warm the model's steps under this plan (the compile cache's
        seam): batch dims pad up to the plan's data multiple, as ``fit``
        pads real batches, and each rank warms its rows' step (a batch
        that pads, the masked step its zero-weight rows make)."""
        model = self.model
        model.setShardingPlan(self.plan)
        if not model._initialized:
            model.init()
        self.plan.apply(model)
        if policy is not None:
            model.setPrecisionPolicy(policy)
        warm_rows(model, shapes, self.plan.data_shards(),
                  max(int(steps_per_dispatch), 1), dtype, label_dtype)
        return model

    def fit(self, data, epochs: int = 1, steps_per_dispatch: int = 1,
            checkpoint=None, nan_policy=None, faults=None,
            prefetch: int = None):
        """Fit through the network's own loop with this plan attached:
        each global batch pads up to the data multiple with zero-weight
        examples as the fit stages it (``ShardedTrainingPlan.localize``;
        the JAX package's ``_PaddingIterator`` has nothing left to do),
        each rank steps on its rows, and the step reduces over the data
        group."""
        model = self.model
        model.setShardingPlan(self.plan)
        if not model._initialized:
            model.init()
        self.plan.apply(model)
        return model.fit(
            data, epochs=epochs, steps_per_dispatch=steps_per_dispatch,
            prefetch=self.prefetch if prefetch is None else prefetch,
            checkpoint=checkpoint, nan_policy=nan_policy, faults=faults)


def _is_pair(spec) -> bool:
    return (isinstance(spec, (tuple, list)) and len(spec) == 2
            and isinstance(spec[0], (tuple, list)))


def local_shapes(shapes, n: int, k: int = 1):
    """Warm-up shapes (``(features, labels)`` pairs or bare feature
    shapes) -> one rank's rows of each, its batch dim padded first to the
    data multiple ``n`` as ``fit`` pads real batches."""
    def local(shape):
        shape = tuple(int(d) for d in shape)
        b = -(-shape[0] // n) * n
        return (b // n,) + shape[1:]
    out = [(local(s[0]), local(s[1])) if _is_pair(s) else local(s)
           for s in shapes]
    if k > 1 and any(not _is_pair(s) for s in shapes):
        raise ValueError(
            "steps_per_dispatch>1 warms the megastep from "
            "(features, labels) pairs; bare forward shapes cannot "
            "be megabatched — warm them in a separate call")
    return out


def warm_rows(model, shapes, n: int, k: int = 1, dtype=None,
              label_dtype=None) -> None:
    """Warm one rank's steps for global ``shapes`` over ``n`` data ranks
    through the compile cache's seam: :func:`local_shapes`' rows, and
    for a ``(features, labels)`` pair whose batch pads, the masked step
    too (``fit`` gives the zero-weight rows a labels mask, per example,
    or per time step for ``[N, C, T]`` labels)."""
    from deeplearning4j_tpu_torch.nn import compilecache as _cc
    local = local_shapes(shapes, n, k)
    _cc.warmup(model, local, steps_per_dispatch=k, dtype=dtype,
               label_dtype=label_dtype)
    fdt = np.dtype(dtype) if dtype is not None else np.float32
    ldt = np.dtype(label_dtype) if label_dtype is not None else np.float32
    lead = (k,) if k > 1 else ()
    for spec, (fshape, lshape) in zip(shapes, local):
        if int(spec[0][0]) % n == 0:
            continue
        mask = lshape[:1] + (lshape[2:3] if len(lshape) == 3 else ())
        model._warm_dispatch(np.zeros(lead + fshape, fdt),
                             np.zeros(lead + lshape, ldt),
                             np.ones(lead + mask, np.float32), steps=k)


# ------------------------------------------------- collective accounting
def step_collective_bytes(model, features, labels, steps: int = 1
                          ) -> Dict[str, int]:
    """Run one recorded dispatch of the model's train step (``steps`` K
    under a megabatch ``[K, B, ...]``) on this global batch under the
    attached plan and return ``{kind: bytes}`` of the collectives this
    rank issued (``parallel.collectives.record``). The step runs: the
    model's state advances by it."""
    from deeplearning4j_tpu_torch.data.dataset import stage_item
    from deeplearning4j_tpu_torch.train.stepping import stack_megabatch
    plan = model._sharding_plan
    ds = DataSet(features, labels)
    item = stack_megabatch([ds] * steps) if steps > 1 else ds
    item = stage_item(plan.localize(item), model._device)
    with collectives.record() as rec:
        if steps > 1:
            model._fit_mega(item)
        else:
            model._fit_one(item)
    return dict(rec.bytes)


def hlo_collective_bytes(record) -> Dict[str, int]:
    """``{kind: bytes}`` of a :func:`parallel.collectives.record` block
    (or of a dict of them, passed through): the keys are the JAX
    package's HLO names (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``collective-permute``), absent kinds omitted."""
    b = record if isinstance(record, dict) else record.bytes
    return {k: int(v) for k, v in b.items() if v}
