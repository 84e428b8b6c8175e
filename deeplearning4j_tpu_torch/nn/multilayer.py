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

Sequences: a DataSet's ``features_mask`` ([N, T]) reaches the mask-aware
layers (``_MASK_AWARE``) in training and in ``score``; ``output()`` takes
none, as in the JAX package. Truncated BPTT (``fitTBPTT``, and ``fit()``
under ``backpropType("tbptt", L)``) splits a batch into windows of L
steps, one update a window, the recurrent layers' ``(h, c)`` carried
from window to window without its gradient; the window step is one
``CachedDispatch`` a label-mask signature, eager until warmed and then
one captured CUDA graph for every window (the first window starts from
zero state, as the JAX one's ``None`` does). ``rnnTimeStep`` streams
inference through the same ``apply_with_state``, eagerly.

Under truncated BPTT ``fit`` ignores ``steps_per_dispatch``, as the JAX
package does: every 3-D batch goes through ``fitTBPTT``, one window a
dispatch; ``warmup(steps_per_dispatch=K)`` warms the plain K-step
megastep, as the JAX one does.

The fit's surroundings are :mod:`.network`'s (listeners, device
augmentation, dynamic loss scaling, the ``train.resilience`` session);
the TBPTT window step scales, tests and drops its update as the plain
step does, and under a session one batch's windows are one recovery
unit (the JAX package's: checkpoints land between batches, where no
recurrent state is carried).

Frozen layers (``_frozen_layers``, set by ``nn.transfer``) keep their
params and updater state in every step (the plain and dynamic-scaling
steps, the K-step megastep and the TBPTT window step); they still run in
train mode and their gradients still enter gradient normalization, as in
the JAX step.

Under ``NAN_PANIC``/``INF_PANIC`` each TBPTT window goes through the
provenance sanitizer (``profiler.sanitizer``, kind ``"tbptt"``) with the
carried state it was handed.

Sharding: ``setShardingPlan`` (``nn.network``) attaches a
``distributed.gspmd.ShardedTrainingPlan``; the loss of the output layer
is weighed by this rank's share of the global batch's real rows
(``parallel.collectives.DataParallelStep``). Truncated BPTT runs under
it as the plain step does: ``fit`` cuts each batch to this rank's rows
(padded first with zero-weight rows, which makes an odd batch's windows
masked ones), each window's step weighs its loss by the rank's share and
sums the gradients over the data group, and the carried state, sized by
the rank's rows, stays on its rank. The result is the JAX package's on
the whole padded batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.analysis import churn
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.evaluation.evaluation import (
    RegressionEvaluation)
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.network import EVAL_PULL_CHUNK, BaseNetwork
from deeplearning4j_tpu_torch.ops.normalization import StepKey
from deeplearning4j_tpu_torch.profiler import devicetime as _dt
from deeplearning4j_tpu_torch.profiler import sanitizer as _san
from deeplearning4j_tpu_torch.train import stepping

#: layers that take the feature mask (the JAX package's tuple; GravesLSTM
#: and LearnedSelfAttentionLayer by subclassing, GRU not at all)
_MASK_AWARE = (L.LSTM, L.SimpleRnn, L.Bidirectional, L.LastTimeStep,
               L.GlobalPoolingLayer, L.SelfAttentionLayer,
               L.RecurrentAttentionLayer)

_TBPTT_NAMES = ("tbptt", "truncatedbptt", "truncated_bptt")


class MultiLayerNetwork(BaseNetwork):
    """Sequential network (ref: org.deeplearning4j.nn.multilayer.
    MultiLayerNetwork). Parameters and layer states are lists (one dict a
    layer) on the network's device."""

    def __init__(self, conf: MultiLayerConfiguration):
        super().__init__(conf)
        self.layers = conf.layers
        self._params: List[Dict[str, torch.Tensor]] = []
        self._states: List[Dict[str, torch.Tensor]] = []
        self._rnn_states: Optional[List] = None    # rnnTimeStep's carry
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
    def init(self, seed: int = None, device=None,
             strict: bool = False) -> "MultiLayerNetwork":
        """Initialize params (from a seeded ``torch.Generator``; the draws
        differ from the JAX package's, see :meth:`params_from_jax`) and
        layer states on ``device``: the card unless the caller names
        another; without a card and without ``device`` this raises.
        ``strict=True`` runs the static analyzer first and raises
        ``ModelValidationError`` on any E-code diagnostic, before any
        parameter is allocated."""
        if strict:
            self.validate().raise_if_errors()
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
                 key: Optional[StepKey] = None, fmask=None, visit=None):
        """The forward; ``key`` is the train step's dropout key (layer i
        draws from ``key.fold(i)``, in a fused group too, as the JAX
        forward's one key split a layer); ``fmask`` goes to the
        mask-aware layers. ``visit(name, layer, cast_params, out)``, when
        given, sees every layer's output as ``"<i>:<layer name>"`` (a
        fused group's conv, its BN, then the folded activations with the
        BN's output): the sanitizer's eager walk. While
        ``profiler.devicetime`` records, each layer runs in its scope
        ``dl4j_L<i>_<name>``."""
        rec = _dt.recorder()
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
                    with _dt.layer_scope(rec, i, layer.name):
                        p = params[i]
                        if cdt is not None:
                            p, x = L.policy_cast(layer, p, x, cdt)
                        x, new_states[i] = layer.apply(
                            p, states[i], x, train, sub, skip_bias=True)
                    if visit is not None:
                        visit(f"{i}:{layer.name}", layer, p, x)
                    bias = p.get("b")
                    bn_idx = i + 1
                bn = self.layers[bn_idx]
                with _dt.layer_scope(rec, bn_idx, bn.name):
                    pbn = params[bn_idx]
                    if cdt is not None:
                        pbn, x = L.policy_cast(bn, pbn, x, cdt)
                    x, new_states[bn_idx] = L.fused_bn_act(
                        bn, pbn, states[bn_idx], x, train, alpha, bias=bias,
                        sync=None if key is None else key.sync)
                if visit is not None:
                    visit(f"{bn_idx}:{bn.name}", bn, pbn, x)
                for j in range(bn_idx + 1, i + n_used):
                    new_states[j] = states[j]       # the folded activation
                    if visit is not None:
                        visit(f"{j}:{self.layers[j].name}", self.layers[j],
                              params[j], x)
                i += n_used
                continue
            with _dt.layer_scope(rec, i, layer.name):
                p = params[i]
                if cdt is not None:
                    p, x = L.policy_cast(layer, p, x, cdt)
                if isinstance(layer, _MASK_AWARE):
                    x, new_states[i] = layer.apply(p, states[i], x, train,
                                                   sub, mask=fmask)
                else:
                    x, new_states[i] = layer.apply(p, states[i], x, train,
                                                   sub)
            if visit is not None:
                visit(f"{i}:{layer.name}", layer, p, x)
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
        params = self._whole_params()
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                if i in self.conf.preprocessors:
                    if cur_nhwc:
                        cur, cur_nhwc = L.to_nchw(cur), False
                    cur = self.conf.preprocessors[i](cur)
                cur, cur_nhwc = L.layout_step(layer, cur, cur_nhwc, nhwc)
                cur, _ = layer.apply(params[i], self._states[i], cur,
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
            out, _ = self._forward(self._whole_params(), self._states,
                                   self._to_device(x), train, StepKey(0, 0))
        return out

    # ------------------------------------------------------------------ loss
    def _loss_and_reg(self, params, states, x, y, train, lmask=None,
                      key=None, fmask=None, dp=None):
        out, new_states = self._forward(params, states, x, train, key, fmask)
        out_layer = self.layers[-1]
        if not isinstance(out_layer, L.BaseOutputLayer):
            raise ValueError("last layer must be an output/loss layer for "
                             "fit()")
        loss = out_layer.compute_loss(y, out, mask=lmask)
        if dp is not None:
            loss = dp.scale_loss(out_layer, loss, y, lmask)
        reg = self._regularization(zip(self.layers, params), dp)
        return loss + reg, new_states

    def _pack(self, x, y, lmask, train: bool):
        return x, y, lmask

    # ---------------------------------------------------- truncated BPTT
    def _tbptt_length(self) -> Optional[int]:
        """The window length when the configuration declares truncated
        BPTT (``backpropType("tbptt", L)``), else None."""
        bp = str(getattr(self.conf, "backprop_type", None) or "standard")
        if bp.lower() in _TBPTT_NAMES and self.conf.tbptt_length:
            return int(self.conf.tbptt_length)
        return None

    def _fit_epoch(self, data, labels, k: int, prefetch: int,
                   session=None) -> None:
        """As :meth:`BaseNetwork._fit_epoch`; under a truncated-BPTT
        configuration each batch of 3-D features goes through
        :meth:`fitTBPTT` (any other batch through the plain step), one
        window a dispatch, and ``steps_per_dispatch`` and ``prefetch`` do
        not apply (JAX multilayer.py:907-913). Under a sharding plan each
        batch is first cut to this rank's rows (``plan.localize``)."""
        length = self._tbptt_length()
        if length is None:
            return super()._fit_epoch(data, labels, k, prefetch, session)
        plan = self._sharding_plan
        batches = self._batches(data, labels, 1, session)
        if plan is not None:
            batches = map(plan.localize, batches)
        if session is not None:
            batches = session.wrap_batches(batches)
        for ds in _prof.iter_with_data_wait(batches):
            if ds.features.ndim == 3:
                self.fitTBPTT(ds, length)
            else:
                self._fit_one(ds)

    def fitTBPTT(self, ds, tbptt_length: int):
        """Truncated BPTT (ref: BackpropType.TruncatedBPTT + tBPTTLength):
        the batch's T steps in windows of ``tbptt_length``, one update a
        window; the recurrent layers' state carries across windows
        without its gradient. Labels that are not 3-D go whole to every
        window; the feature mask is not used (the JAX package's window
        step passes ``mask=None``), the label mask is sliced. Under a
        session the batch's windows are one dispatch for its hooks (one
        pull, ``ceil(T/L)`` steps). Under a sharding plan ``ds`` is this
        rank's rows (``fit`` cuts them) and each window's step reduces
        over the data group."""
        if not self._initialized:
            self.init()
        length = int(tbptt_length)
        x, y, lmask, _ = self._batch_tensors(ds.features, ds.labels,
                                             ds.labels_mask)
        res = self._resilience
        if res is not None:
            res.before_dispatch()
        carry = self._zero_carry(x)
        losses = []
        for start in range(0, x.shape[2], length):
            sl = slice(start, start + length)
            out = self._fit_window(
                x[:, :, sl], y[:, :, sl] if y.dim() == 3 else y,
                None if lmask is None else lmask[:, sl], carry)
            carry = out[1:]
            losses.append(out[0])
        self._last_batch_size = int(x.shape[0])
        if res is not None:
            res.after_dispatch(torch.stack(losses), len(losses), pulls=1)
        return self

    def _fit_window(self, x, y, lmask, carry):
        """One window's update through its dispatch; returns ``(loss,
        *new carry)``. Listeners see ``onIterationStart`` (the JAX window
        step calls no ``iterationDone``)."""
        self._ensure_step_state()
        churn.get_churn_detector().record(
            "MultiLayerNetwork.tbptt", churn.array_fingerprint(x, y, lmask),
            owner=self)
        # the window keeps the carried state it was handed, so the
        # sanitizer can name a poisoned carry (op "carried-state")
        masked = lmask is not None
        tok = _san.snapshot(self, "tbptt", masked, (x, y, lmask, *carry))
        self._iteration_start()
        out = self._tbptt_for(masked)(x, y, lmask, *carry)
        stepping.STEPS_PER_DISPATCH.set(1)
        stepping.TRAIN_ITERATIONS.inc()
        self._score = out[0]
        _san.check(self, tok, out[0],
                   context=f"tBPTT loss at iteration {self._iteration}")
        self._iteration += 1
        return out

    def _tbptt_for(self, masked: bool) -> cc.CachedDispatch:
        """The window step's dispatch for a label-mask signature: eager
        until :meth:`_warm_tbptt` captures it."""
        key = ("tbptt", masked) + self._step_mode()
        d = self._step_cache.get(key)
        if d is None:
            d = cc.CachedDispatch(self._tbptt_step, "MultiLayerNetwork.tbptt",
                                  state=self._dispatch_state)
            self._step_cache[key] = d
        return d

    def _zero_carry(self, x) -> List[torch.Tensor]:
        """The first window's state of every stateful layer, flat: zeros
        of the layer's input dtype (the JAX ``None`` start is zeros of
        x's dtype)."""
        cdt = self._compute_dtype()
        n = x.shape[0]
        out: List[torch.Tensor] = []
        for layer in self.layers:
            if not hasattr(layer, "zero_state"):
                continue
            if cdt is None or layer.dtype_override == "float32":
                dt = x.dtype if x.is_floating_point() else torch.float32
            else:
                dt = cdt
            s = layer.zero_state(n, dt, x.device)
            out.extend(s if isinstance(s, tuple) else (s,))
        return out

    def _tbptt_step(self, x, y, lmask, *carry):
        """One window: :meth:`_tbptt_forward` from the carried state, the
        output layer's loss (no L1/L2, as the JAX window step), the
        update in place and the clock. Under a sharding plan as
        :meth:`_step_on` (:meth:`_step_setup`): the loss weighed by this rank's share of the
        global rows, the rank's key, the params gathered whole where the
        plan splits them, the gradients (and the reported loss) summed
        over the data group. Returns ``(loss, *new carry)``, all
        detached."""
        dp, key, params = self._step_setup(int(y.shape[0]))
        cur, new_carry = self._tbptt_forward(x, carry, key, params)
        out_layer = self.layers[-1]
        loss = out_layer.compute_loss(y, cur, mask=lmask)
        if dp is not None:
            loss = dp.scale_loss(out_layer, loss, y, lmask)
        # the dynamic policy's drop too
        _, loss = self._apply_loss(loss, params)
        with torch.no_grad():
            self._t_dev.add_(1)
        return (loss.detach(),) + tuple(c.detach() for c in new_carry)

    def _tbptt_forward(self, x, carry, key, params=None, visit=None):
        """The window's forward from the carried state: params and the
        input under the dtype policy; the stateful layers through
        ``apply_with_state``, the others in train mode, mask-aware ones
        with ``mask=None``. Returns ``(output, new carry)``.
        ``visit(name, layer, cast_params, out, carried)`` sees each
        layer (``carried`` the state it was handed, None for a stateless
        layer): the sanitizer's walk."""
        rec = _dt.recorder()
        params = self._params if params is None else params
        cdt = self._compute_dtype()
        carry = list(carry)
        new_carry: List[torch.Tensor] = []
        cur = x
        for i, layer in enumerate(self.layers):
            if i in self.conf.preprocessors:
                cur = self.conf.preprocessors[i](cur)
            s = None
            with _dt.layer_scope(rec, i, layer.name):
                p = params[i]
                if cdt is not None:
                    p, cur = L.policy_cast(layer, p, cur, cdt)
                if hasattr(layer, "apply_with_state"):
                    n = 2 if isinstance(layer, L.LSTM) else 1
                    s = tuple(carry[:n]) if n == 2 else carry[0]
                    del carry[:n]
                    cur, s2 = layer.apply_with_state(p, cur, s)
                    new_carry.extend(s2 if isinstance(s2, tuple) else (s2,))
                elif isinstance(layer, _MASK_AWARE):
                    cur, _ = layer.apply(p, self._states[i], cur, True,
                                         key.fold(i), mask=None)
                else:
                    cur, _ = layer.apply(p, self._states[i], cur, True,
                                         key.fold(i))
            if visit is not None:
                visit(f"{i}:{layer.name}", layer, p, cur, s)
        return cur, new_carry

    def _warm_tbptt(self, x, y, lmask=None, tbptt_length: int = None):
        """Capture the window step for the windows of a ``[N, C, T]``
        batch (the full window and a shorter last one) without changing
        any state. Under a sharding plan the batch is this rank's rows;
        a plan whose collectives stage through host memory (gloo on the
        card) leaves the step eager."""
        if not self._initialized:
            self.init()
        length = int(tbptt_length or self._tbptt_length())
        self._ensure_step_state()
        x, y, lmask, _ = self._batch_tensors(x, y, lmask)
        plan = self._sharding_plan
        if plan is not None and plan.stages_on_host(x):
            return self
        carry = self._zero_carry(x)
        T = x.shape[2]
        for start in sorted({0, T - T % length} - {T}):
            sl = slice(start, start + length)
            self._tbptt_for(lmask is not None).warm(
                x[:, :, sl], y[:, :, sl] if y.dim() == 3 else y,
                None if lmask is None else lmask[:, sl], *carry)
        return self

    def _warm_dispatch(self, x, y, lmask=None, steps: int = 1, fmask=None,
                       tbptt_length: int = None):
        """As :meth:`BaseNetwork._warm_dispatch`; under truncated BPTT
        (configured, or ``tbptt_length``) a 3-D batch at one step a
        dispatch warms the window step instead. K > 1 steps always warm
        the plain K-step megastep, as the JAX ``warmup`` does."""
        length = tbptt_length or self._tbptt_length()
        if length is None or steps != 1 or np.ndim(x) != 3:
            return super()._warm_dispatch(x, y, lmask, steps, fmask)
        return self._warm_tbptt(x, y, lmask, length)

    # ------------------------------------------------- streaming inference
    def rnnTimeStep(self, x) -> torch.Tensor:
        """Streaming inference carrying the recurrent layers' state across
        calls (ref: MultiLayerNetwork.rnnTimeStep): ``x`` [N, C, T_chunk],
        or [N, C] for one step (then [N, C_out] comes back). Preprocessors
        apply; layers without ``apply_with_state`` (Bidirectional,
        LastTimeStep) run on the chunk alone with ``mask=None``, as in
        the JAX package. Eager, no dtype policy (the JAX one casts
        nothing here either)."""
        self._require_init()
        x = self._to_device(x)
        single = x.dim() == 2
        if single:
            x = x[:, :, None]
        if self._rnn_states is None:
            self._rnn_states = [None] * len(self.layers)
        key = StepKey(0, 0)
        cur = x
        params = self._whole_params()
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                if i in self.conf.preprocessors:
                    cur = self.conf.preprocessors[i](cur)
                if hasattr(layer, "apply_with_state"):
                    cur, self._rnn_states[i] = layer.apply_with_state(
                        params[i], cur, self._rnn_states[i])
                elif isinstance(layer, _MASK_AWARE):
                    cur, _ = layer.apply(params[i], self._states[i],
                                         cur, False, key.fold(i), mask=None)
                else:
                    cur, _ = layer.apply(params[i], self._states[i],
                                         cur, False, key.fold(i))
        if single and cur.dim() == 3:
            cur = cur[:, :, -1]
        return cur

    def rnnClearPreviousState(self) -> None:
        """ref: rnnClearPreviousState — the next rnnTimeStep starts from
        zero state."""
        self._rnn_states = None

    def rnnGetPreviousState(self, layer_idx: int):
        """Layer ``layer_idx``'s carried state (``(h, c)`` for an LSTM,
        ``h`` for GRU/SimpleRnn), None before the first rnnTimeStep."""
        states = self._rnn_states
        return states[layer_idx] if states else None

    # --------------------------------------------------------- configuration
    def _ensure_epilogue_plan(self):
        if self._epilogue_plan is None:
            self._epilogue_plan = L.build_epilogue_plan(
                self.layers, self.conf.preprocessors)
        return self._epilogue_plan

    def getLayer(self, i: int):
        return self.layers[i]

    def getParam(self, i: int, name: str) -> torch.Tensor:
        return self._whole_params()[i][name]

    # ------------------------------------------------------------ evaluation
    def evaluateRegression(self, iterator,
                           pull_chunk: int = EVAL_PULL_CHUNK,
                           prefetch: bool = True) -> RegressionEvaluation:
        return self.evaluate(iterator, RegressionEvaluation(), pull_chunk,
                             prefetch)

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
