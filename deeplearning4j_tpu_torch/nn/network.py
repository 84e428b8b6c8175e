"""What :class:`.graph.ComputationGraph` and
:class:`.multilayer.MultiLayerNetwork` share: the eager training step,
the dtype policy, the layout and fusion switches, and the flat parameter
views.

A subclass holds its params and layer states in ``_params``/``_states``
(a dict by node name in the graph, a list by layer index in the
sequential network) and supplies:

- ``_layers()``: ``[(key, layer)]`` of every layer, in order;
- ``_leaf_keys()``: the params' ``(key, name)`` in the JAX package's
  pytree order (what :meth:`params` flattens);
- ``_ds_inputs(ds, train)``: a DataSet as ``(inputs, labels, masks)`` in
  the form its ``_loss_and_reg`` takes;
- ``_loss_and_reg(params, states, inputs, labels, train, masks)`` and
  ``_ensure_epilogue_plan()``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.train import updaters as upd


class BaseNetwork:

    def __init__(self, conf):
        self.conf = conf
        self._opt_state: Optional[Dict] = None
        self._iteration = 0
        self._epoch = 0
        self._score = float("nan")
        self._device: Optional[torch.device] = None
        self._precision = None  # PrecisionPolicy (see setPrecisionPolicy)
        self._initialized = False
        self._compute_layout = "NCHW"
        self._fuse_epilogues = False
        self._epilogue_plan = None

    def _items(self, tree) -> List[Tuple]:
        return list(tree.items() if isinstance(tree, dict)
                    else enumerate(tree))

    def _to_device(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a))
        return a.to(self._device)

    def _adopt_jax(self, params, states) -> None:
        """Take the JAX package's params and states (a dict or a list of
        dicts of arrays, each leaf through ``np.asarray`` as fp32) on
        ``self._device``; the updater state and iteration start afresh."""
        def conv(a):
            return torch.from_numpy(np.array(np.asarray(a), np.float32)
                                    ).to(self._device)

        def each(tree, fn):
            if isinstance(tree, dict):
                return {n: fn(d) for n, d in tree.items()}
            return [fn(d) for d in tree]

        self._params = each(params, lambda p: {
            k: conv(v).requires_grad_(True) for k, v in p.items()})
        self._states = each(states, lambda s: {k: conv(v)
                                               for k, v in s.items()})
        self._opt_state = None
        self._iteration = 0
        self._initialized = True

    def _require_init(self):
        if not self._initialized:
            raise RuntimeError("call init() (or params_from_jax()) first")

    def _compute_dtype(self):
        """The compute dtype: the attached PrecisionPolicy's, else the
        config's dataType."""
        if self._precision is not None:
            return self._precision.compute_torch()
        return L.compute_dtype_of(self.conf.base.dtype)

    @staticmethod
    def _regularization(pairs):
        """L1/L2 over ``(layer, params)`` pairs, on the weights (``W*``,
        ``RW*``) only, as the reference regularizes them."""
        reg = 0.0
        for layer, p in pairs:
            l1 = layer.l1 or 0.0
            l2 = layer.l2 or 0.0
            if not p or (l1 == 0.0 and l2 == 0.0):
                continue
            for name, w in p.items():
                if not name.startswith(("W", "RW")):
                    continue
                if l2:
                    reg = reg + 0.5 * l2 * torch.sum(w.square())
                if l1:
                    reg = reg + l1 * torch.sum(w.abs())
        return reg

    # ------------------------------------------------------------------- fit
    def _ensure_opt_state(self):
        if self._opt_state is None:
            updater = self.conf.base.updater
            self._opt_state = {
                n: {k: updater.init_state(v.detach()) for k, v in p.items()}
                for n, p in self._items(self._params)}

    def fit(self, data, labels=None, epochs: int = 1):
        """Train on a DataSet, a list of DataSets, or (features, labels)
        arrays: one update step per batch, ``epochs`` times."""
        if not self._initialized:
            self.init()
        self._ensure_opt_state()
        if isinstance(data, DataSet):
            batches = [data]
        elif isinstance(data, (list, tuple)) and data \
                and isinstance(data[0], DataSet):
            batches = list(data)
        else:
            batches = [DataSet(data, labels)]
        for _ in range(epochs):
            for ds in batches:
                self._fit_one(ds)
            self._epoch += 1
        return self

    def _fit_one(self, ds: DataSet):
        ins, labels, masks = self._ds_inputs(ds, True)
        pol = self._precision
        loss_scale = pol.loss_scale if pol is not None else None
        loss, new_states = self._loss_and_reg(self._params, self._states, ins,
                                              labels, True, masks)
        names = [(n, k) for n, p in self._items(self._params) for k in p]
        leaves = [self._params[n][k] for n, k in names]
        scaled = loss * loss_scale if loss_scale else loss
        # a folded conv bias takes no part in the train-mode loss (it
        # cancels against the batch mean): its gradient is zero
        grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if loss_scale:
            inv = 1.0 / loss_scale
            grads = [g * inv for g in grads]
        self._process_and_apply_grads(names, leaves, grads)
        self._states = new_states
        # kept on the device; score() converts lazily
        self._score = loss.detach()
        self._iteration += 1

    def _process_and_apply_grads(self, names, leaves, grads):
        """Gradient normalization, then the updater per leaf; the fp32
        master params are updated in place (``p -= update``)."""
        base = self.conf.base
        updater = base.updater
        if base.grad_norm == "clip_value":
            grads = upd.clip_by_value(grads, base.grad_norm_threshold)
        elif base.grad_norm == "clip_l2":
            grads = upd.clip_by_norm(grads, base.grad_norm_threshold)
        elif base.grad_norm == "clip_global":
            grads = upd.clip_by_global_norm(grads, base.grad_norm_threshold)
        elif base.grad_norm == "renorm":
            grads = upd.renormalize_l2(grads)
        t = self._iteration
        lr = updater.lr_at(t)
        with torch.no_grad():
            for (n, k), p, g in zip(names, leaves, grads):
                u, s2 = updater.apply(g, self._opt_state[n][k], lr, t)
                p.sub_(u)
                self._opt_state[n][k] = s2

    def score(self, ds: DataSet = None) -> float:
        """The last fit step's loss, or the loss on ``ds`` (inference
        mode)."""
        if ds is None:
            if isinstance(self._score, torch.Tensor):
                self._score = float(self._score)
            return self._score
        self._require_init()
        ins, labels, masks = self._ds_inputs(ds, False)
        with torch.no_grad():
            loss, _ = self._loss_and_reg(self._params, self._states, ins,
                                         labels, False, masks)
        return float(loss)

    # --------------------------------------------------------- configuration
    def setComputeLayout(self, fmt: str):
        """NHWC compute layout for the conv stacks: channels-minor conv/
        pool/BN between layout-aware layers, the public NCHW API
        unchanged."""
        if fmt not in ("NCHW", "NHWC"):
            raise ValueError(f"compute layout must be 'NCHW' or 'NHWC', "
                             f"got {fmt!r}")
        self._compute_layout = fmt
        self.conf.base.compute_layout = fmt
        L.stamp_layout([layer for _, layer in self._layers()], fmt)
        return self

    def setEpilogueFusion(self, enabled: bool = True):
        """Fuse conv-bias + BN + relu/leaky blocks (and BN + act pairs)
        into one ``scale_shift_act`` dispatch each; the plan is rebuilt
        when the switch changes."""
        enabled = bool(enabled)
        if enabled != self._fuse_epilogues:
            self._epilogue_plan = None
        self._fuse_epilogues = enabled
        return self

    def setPrecisionPolicy(self, policy):
        """Attach (or detach with ``None``) a ``PrecisionPolicy`` or a
        dtype string such as ``"bf16"``: fp32 master params, the compute
        dtype in conv/dense layers, an optional static loss scale."""
        from deeplearning4j_tpu_torch.nn.precision import (PrecisionPolicy,
                                                           runtime_check)
        policy = PrecisionPolicy.coerce(policy)
        if policy is not None:
            runtime_check(policy)
        self._precision = policy
        return self

    # ------------------------------------------------------------ param views
    def params(self) -> torch.Tensor:
        """Every parameter flattened and concatenated in the JAX package's
        order (:meth:`_leaf_keys`)."""
        leaves = [self._params[n][k].detach().reshape(-1)
                  for n, k in self._leaf_keys()]
        if not leaves:
            return torch.zeros((0,))
        return torch.cat(leaves)

    def setParams(self, flat) -> None:
        """Write a flat vector (in :meth:`params` order) back into the
        parameters, in place."""
        flat = self._to_device(flat).reshape(-1)
        if flat.numel() != self.numParams():
            raise ValueError(f"setParams: {flat.numel()} values for "
                             f"{self.numParams()} parameters")
        pos = 0
        with torch.no_grad():
            for n, k in self._leaf_keys():
                p = self._params[n][k]
                p.copy_(flat[pos:pos + p.numel()].view_as(p))
                pos += p.numel()

    def numParams(self) -> int:
        return sum(v.numel() for _, p in self._items(self._params)
                   for v in p.values())
