"""MultiLayerNetwork — the sequential network and its training step (the
slice's subset of ``deeplearning4j_tpu/nn/multilayer.py``).

As in :mod:`.graph`, the JAX package's one compiled step becomes the
shared step of :mod:`.network`: the forward, ``torch.autograd.grad`` of
the loss, gradient normalization and the updater in place on the fp32
master params, eager or captured as a CUDA graph (K steps a dispatch
with ``fit(steps_per_dispatch=K)``). The forward (``_forward``) follows the JAX one layer for layer:
the input preprocessors (an NHWC activation goes back to NCHW before
one, so a flatten reads ``[c, h, w]``), the NHWC compute layout, the fp32
islands of the dtype policy, the per-layer dropout keys, and the
sequential epilogue plan (``nn.layers.build_epilogue_plan``), in which a
conv(identity, bias) + BN + relu/leaky triple runs as one conv without
its bias and one ``scale_shift_act`` dispatch. ``evaluate``,
``save``/``load`` (the JAX package's archive, ``train.serializer``),
``clone`` and ``summary`` are the reference's.

Not ported yet (ROADMAP.md): dynamic loss scaling, TBPTT and
``rnnTimeStep``, listeners, resilience, sharding, augmentation.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.evaluation.evaluation import (
    RegressionEvaluation)
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.network import EVAL_PULL_CHUNK, BaseNetwork
from deeplearning4j_tpu_torch.ops.normalization import StepKey


class MultiLayerNetwork(BaseNetwork):
    """Sequential network (ref: org.deeplearning4j.nn.multilayer.
    MultiLayerNetwork). Parameters and layer states are lists (one dict a
    layer) on the network's device."""

    def __init__(self, conf: MultiLayerConfiguration):
        super().__init__(conf)
        self.layers = conf.layers
        self._params: List[Dict[str, torch.Tensor]] = []
        self._states: List[Dict[str, torch.Tensor]] = []
        fmt = getattr(conf.base, "compute_layout", None)
        if fmt and fmt != "NCHW":
            self.setComputeLayout(fmt)

    def _layers(self):
        return list(enumerate(self.layers))

    def _leaf_keys(self):
        """Layers in order, each layer's param names sorted (the JAX
        pytree's leaf order)."""
        return [(i, k) for i, p in enumerate(self._params) for k in sorted(p)]

    # ------------------------------------------------------------------ init
    def init(self, seed: int = None, device=None) -> "MultiLayerNetwork":
        """Initialize params (from a seeded ``torch.Generator``; the draws
        differ from the JAX package's, see :meth:`params_from_jax`) and
        layer states on ``device``: the card unless the caller names
        another; without a card and without ``device`` this raises."""
        self._device = resolve_device(device)
        seed = self.conf.base.seed if seed is None else seed
        gen = torch.Generator().manual_seed(int(seed))
        self._params, self._states = [], []
        for layer in self.layers:
            p, s = layer.initialize(gen)
            self._params.append({k: v.to(self._device).requires_grad_(True)
                                 for k, v in p.items()})
            self._states.append({k: v.to(self._device) for k, v in s.items()})
        self._reset_training_state()
        self._initialized = True
        return self

    def params_from_jax(self, params, states, device=None
                        ) -> "MultiLayerNetwork":
        """Carry the JAX package's per-layer lists of param dicts and
        state dicts over (each leaf through ``np.asarray``, as fp32) into
        this network on ``device``. The updater state and the iteration
        count start afresh."""
        if len(params) != len(self.layers) or len(states) != len(self.layers):
            raise ValueError(f"{len(params)} param and {len(states)} state "
                             f"dicts for {len(self.layers)} layers")
        self._device = resolve_device(device)
        self._adopt_jax(params, states)
        return self

    # --------------------------------------------------------------- forward
    def _forward(self, params, states, x, train: bool,
                 key: Optional[StepKey] = None):
        """The forward; ``key`` is the train step's dropout key (layer i
        draws from ``key.fold(i)``, in a fused group too, as the JAX
        forward's one key split a layer)."""
        cdt = self._compute_dtype()
        if cdt is None and x.dtype == torch.uint8:
            x = x.float()                  # image bytes (fp32 nets)
        nhwc = self._compute_layout == "NHWC"
        plan = self._ensure_epilogue_plan() if self._fuse_epilogues else {}
        new_states: List[Optional[Dict]] = [None] * len(self.layers)
        cur_nhwc = False
        i = 0
        pre = self.conf.preprocessors
        while i < len(self.layers):
            layer = self.layers[i]
            if i in pre:
                if cur_nhwc:
                    x, cur_nhwc = L.to_nchw(x), False
                x = pre[i](x)
            x, cur_nhwc = L.layout_step(layer, x, cur_nhwc, nhwc)
            sub = key.fold(i) if key is not None else None
            fuse = plan.get(i)
            if fuse is not None:
                n_used, conv_leads, alpha = fuse
                bn_idx, bias = i, None
                if conv_leads:
                    p = params[i]
                    if cdt is not None:
                        p, x = L.policy_cast(layer, p, x, cdt)
                    x, new_states[i] = layer.apply(p, states[i], x, train,
                                                   sub, skip_bias=True)
                    bias = p.get("b")
                    bn_idx = i + 1
                bn = self.layers[bn_idx]
                pbn = params[bn_idx]
                if cdt is not None:
                    pbn, x = L.policy_cast(bn, pbn, x, cdt)
                x, new_states[bn_idx] = L.fused_bn_act(
                    bn, pbn, states[bn_idx], x, train, alpha, bias=bias)
                for j in range(bn_idx + 1, i + n_used):
                    new_states[j] = states[j]       # the folded activation
                i += n_used
                continue
            p = params[i]
            if cdt is not None:
                p, x = L.policy_cast(layer, p, x, cdt)
            x, new_states[i] = layer.apply(p, states[i], x, train, sub)
            i += 1
        if cur_nhwc and x.dim() == 4:
            x = L.to_nchw(x)
        return x, new_states

    def feedForward(self, x, train: bool = False) -> List[torch.Tensor]:
        """Every layer's activation, the input first (ref: feedForward),
        in the public NCHW layout; unfused, as in the JAX package."""
        self._require_init()
        cur = self._to_device(x)
        acts = [cur]
        nhwc = self._compute_layout == "NHWC"
        cur_nhwc = False
        key = StepKey(0, 0)
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                if i in self.conf.preprocessors:
                    if cur_nhwc:
                        cur, cur_nhwc = L.to_nchw(cur), False
                    cur = self.conf.preprocessors[i](cur)
                cur, cur_nhwc = L.layout_step(layer, cur, cur_nhwc, nhwc)
                cur, _ = layer.apply(self._params[i], self._states[i], cur,
                                     train, key.fold(i))
                cur_nhwc = cur_nhwc and cur.dim() == 4
                acts.append(L.to_nchw(cur) if cur_nhwc else cur)
        return acts

    def output(self, x, train: bool = False) -> torch.Tensor:
        """Inference forward (ref: MultiLayerNetwork.output), on the
        network's device; ``train=True`` draws dropout from a fixed key
        (the JAX package's ``PRNGKey(0)``)."""
        self._require_init()
        with torch.no_grad():
            out, _ = self._forward(self._params, self._states,
                                   self._to_device(x), train, StepKey(0, 0))
        return out

    # ------------------------------------------------------------------ loss
    def _loss_and_reg(self, params, states, x, y, train, lmask=None,
                      key=None):
        out, new_states = self._forward(params, states, x, train, key)
        out_layer = self.layers[-1]
        if not isinstance(out_layer, L.BaseOutputLayer):
            raise ValueError("last layer must be an output/loss layer for "
                             "fit()")
        loss = out_layer.compute_loss(y, out, mask=lmask)
        reg = self._regularization(zip(self.layers, params))
        return loss + reg, new_states

    def _pack(self, x, y, lmask, train: bool):
        return x, y, lmask

    # --------------------------------------------------------- configuration
    def _ensure_epilogue_plan(self):
        if self._epilogue_plan is None:
            self._epilogue_plan = L.build_epilogue_plan(
                self.layers, self.conf.preprocessors)
        return self._epilogue_plan

    def getLayer(self, i: int):
        return self.layers[i]

    def getParam(self, i: int, name: str) -> torch.Tensor:
        return self._params[i][name]

    # ------------------------------------------------------------ evaluation
    def evaluateRegression(self, iterator,
                           pull_chunk: int = EVAL_PULL_CHUNK
                           ) -> RegressionEvaluation:
        return self.evaluate(iterator, RegressionEvaluation(), pull_chunk)

    def summary(self) -> str:
        lines = ["=" * 70,
                 f"{'LayerName (Type)':<36}{'nIn,nOut':<16}{'Params':<10}",
                 "=" * 70]
        total = 0
        for i, layer in enumerate(self.layers):
            n = sum(v.numel() for v in self._params[i].values()) \
                if self._initialized else 0
            total += n
            lines.append(f"{f'{i}_{layer.name} ({type(layer).__name__})':<36}"
                         f"{f'{layer.nIn},{layer.nOut}':<16}{n:<10}")
        lines.append("-" * 70)
        lines.append(f"Total params: {total}")
        lines.append("=" * 70)
        return "\n".join(lines)

    # ------------------------------------------------------------ save / load
    def save(self, path: str, save_updater: bool = True):
        """ref: ModelSerializer.writeModel — the JAX package's archive
        (``train.serializer``)."""
        from deeplearning4j_tpu_torch.train.serializer import ModelSerializer
        ModelSerializer.writeModel(self, path, save_updater)

    @staticmethod
    def load(path: str, load_updater: bool = True,
             device=None) -> "MultiLayerNetwork":
        """An archive of either package, on ``device`` (the card unless the
        caller names another)."""
        from deeplearning4j_tpu_torch.train.serializer import ModelSerializer
        return ModelSerializer.restoreMultiLayerNetwork(path, load_updater,
                                                        device)

    def clone(self) -> "MultiLayerNetwork":
        """ref: clone — the same configuration, copies of the params and
        states on the same device; the updater state starts afresh."""
        return self._copy_into(MultiLayerNetwork(self.conf))
