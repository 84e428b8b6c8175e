"""SameDiff graph engine: record a graph op by op, run it eagerly.

The port's counterpart of ``deeplearning4j_tpu/autodiff/samediff.py``
(ref: ``org.nd4j.autodiff.samediff.SameDiff`` + ``SDVariable`` and the
op namespaces). Where the JAX package traces the recorded graph into one
XLA program, the port runs it node by node on the graph's device, each
node calling the op its name resolved to in :mod:`..ops.registry` **at
record time**, so kernels installed as platform overrides before a node
is recorded run in it. Gradients come from ``torch.autograd`` over the
same eager run.

Graph model, as in the JAX package: ``variable`` (trainable),
``constant``, ``placeholder`` (fed at execution) and op nodes created
through ``SDVariable`` methods and the ``math`` / ``nn`` / ``loss``
namespaces, in topological order.

Serialization is the JAX package's zip (``graph.json`` + ``arrays.npz``,
optional updater state): a graph either package saves loads in the
other. Placeholder dtypes are numpy dtype names.

Control flow: ``while_loop``, ``cond`` and ``invoke_subgraph`` take Python
callables or SameDiff subgraphs; a subgraph serializes to a self-contained
JSON spec (:func:`subgraph_spec`), so such nodes round-trip through
``save``/``load``, as the TF importer's ``While``/``If``/``PartitionedCall``
nodes do. Where the JAX package lowers them to ``lax.while_loop`` and
``lax.cond``, the port runs them eagerly: the loop is a Python loop over the
body on the graph's device, reading the predicate on the host once an
iteration.

Static analysis: ``infer_shapes`` (on ``meta`` tensors), ``validate``
(the ``analysis`` package's SameDiff lints) and ``summary``.

Not ported yet (ROADMAP.md queue 1): RNG ops and dropout; multi-head
attention, ``std`` and ``variance``; the native backend; the CNN, RNN,
Random, Linalg, Bitwise and Image namespaces; listeners and the public
``rename``.
"""

from __future__ import annotations

import base64
import io
import json
import os
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ops import registry as op_registry
from deeplearning4j_tpu_torch.train import updaters as upd
from deeplearning4j_tpu_torch.train.updaters import IUpdater

#: the 64-bit dtypes jnp.asarray narrows without x64 (Python and numpy
#: defaults): the port feeds the graph the dtypes the JAX package does
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


class _Node:
    __slots__ = ("op", "fn", "inputs", "outputs", "attrs", "rebuild")

    def __init__(self, op: str, fn: Callable, inputs: List[str],
                 outputs: List[str], attrs: Dict[str, Any],
                 rebuild: str = None):
        self.op = op
        self.fn = fn
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs
        # key into _FN_REBUILDERS for nodes whose callable is a closure
        # (not a plain registry op): save() records it, load() rebuilds
        self.rebuild = rebuild


class SDVariable:
    """Symbolic handle into a SameDiff graph (ref: SDVariable)."""

    def __init__(self, sd: "SameDiff", name: str, var_type: str,
                 shape: Optional[Tuple] = None, dtype=None):
        self.sd = sd
        self.name = name
        self.var_type = var_type  # VARIABLE | CONSTANT | PLACEHOLDER | ARRAY
        self._shape = shape
        self.dtype = dtype

    def eval(self, placeholders: Dict[str, Any] = None):
        return self.sd.output(placeholders or {}, [self.name])[self.name]

    def getArr(self):
        if self.var_type == "VARIABLE":
            return self.sd._variables[self.name]
        if self.var_type == "CONSTANT":
            return self.sd._constants[self.name]
        return self.eval()

    def setArray(self, arr):
        if self.var_type == "VARIABLE":
            self.sd._variables[self.name] = self.sd._as_tensor(arr)
        elif self.var_type == "CONSTANT":
            self.sd._constants[self.name] = self.sd._as_tensor(arr)
        else:
            raise ValueError(f"cannot set array on {self.var_type} "
                             f"'{self.name}'")

    @property
    def shape(self):
        return self._shape

    # ---- fluent op builders (each records a node) ----
    def _bin(self, other, op, reverse=False):
        o = self.sd._as_var(other)
        a, b = (o, self) if reverse else (self, o)
        return self.sd._record(op, [a.name, b.name])

    def add(self, o): return self._bin(o, "add")
    def sub(self, o): return self._bin(o, "subtract")
    def mul(self, o): return self._bin(o, "multiply")
    def div(self, o): return self._bin(o, "divide")
    def rsub(self, o): return self._bin(o, "subtract", reverse=True)
    def rdiv(self, o): return self._bin(o, "divide", reverse=True)
    def pow(self, o): return self._bin(o, "pow")
    __add__ = add
    __radd__ = add
    __sub__ = sub
    def __rsub__(self, o): return self.rsub(o)
    __mul__ = mul
    __rmul__ = mul
    __truediv__ = div
    def __rtruediv__(self, o): return self.rdiv(o)
    __pow__ = pow
    def __neg__(self): return self.sd._record("neg", [self.name])
    def __matmul__(self, o): return self.mmul(o)

    def mmul(self, other, transpose_a=False, transpose_b=False):
        return self.sd._record("matmul",
                               [self.name, self.sd._as_var(other).name],
                               attrs={"transpose_a": transpose_a,
                                      "transpose_b": transpose_b})

    def gt(self, o): return self._bin(o, "greater")
    def lt(self, o): return self._bin(o, "less")
    def gte(self, o): return self._bin(o, "greater_equal")
    def lte(self, o): return self._bin(o, "less_equal")
    def eq(self, o): return self._bin(o, "equals")
    def neq(self, o): return self._bin(o, "not_equals")

    def _un(self, op, **attrs):
        return self.sd._record(op, [self.name], attrs=attrs)

    def neg(self): return self._un("neg")
    def abs(self): return self._un("abs")
    def exp(self): return self._un("exp")
    def log(self): return self._un("log")
    def sqrt(self): return self._un("sqrt")
    def square(self): return self._un("square")
    def tanh(self): return self._un("tanh")
    def sigmoid(self): return self._un("sigmoid")
    def relu(self): return self._un("relu")
    def softmax(self, axis=-1): return self._un("softmax", axis=axis)

    def sum(self, *axes, keepdims=False):
        return self._un("reduce_sum", axis=list(axes) or None,
                        keepdims=keepdims)

    def mean(self, *axes, keepdims=False):
        return self._un("reduce_mean", axis=list(axes) or None,
                        keepdims=keepdims)

    def max(self, *axes, keepdims=False):
        return self._un("reduce_max", axis=list(axes) or None,
                        keepdims=keepdims)

    def min(self, *axes, keepdims=False):
        return self._un("reduce_min", axis=list(axes) or None,
                        keepdims=keepdims)

    def argmax(self, axis=None): return self._un("argmax", axis=axis)

    def norm2(self, *axes):
        return self._un("reduce_norm2", axis=list(axes) or None)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._un("reshape", shape=shape)

    def transpose(self, *perm):
        return self._un("transpose", perm=list(perm) or None)

    def castTo(self, dtype):
        return self._un("cast", dtype=op_registry.dtype_name(dtype))

    def get(self, idx):
        # basic indices (ints, slices, ellipsis, newaxis, 1-D int lists)
        # serialize; advanced ones keep a closure that save() refuses
        try:
            attrs = {"index": _encode_index(idx)}
        except TypeError:
            return self.sd._record_fn("getitem", lambda x: x[idx],
                                      [self.name])
        return self.sd._record_fn("getitem", _make_getitem_fn(attrs),
                                  [self.name], attrs=attrs,
                                  rebuild="getitem")

    __getitem__ = get

    def __repr__(self):
        return (f"SDVariable(name='{self.name}', type={self.var_type}, "
                f"shape={self._shape})")


class _Namespace:
    """Base for op namespaces: methods record registry ops."""

    def __init__(self, sd: "SameDiff"):
        self.sd = sd

    def _rec(self, op, inputs, name=None, n_out=1, **attrs):
        names = [v.name if isinstance(v, SDVariable)
                 else self.sd._as_var(v).name for v in inputs]
        return self.sd._record(op, names, name=name, n_out=n_out,
                               attrs=attrs)


class SDMath(_Namespace):
    """ref: org.nd4j.autodiff.samediff.ops.SDMath — a passthrough to
    every registry op (``sd.math.gather(x, idx, axis=0)``)."""

    def __getattr__(self, op):
        if op_registry.has(op):
            def method(*inputs, name=None, **attrs):
                return self._rec(op, list(inputs), name=name, **attrs)
            return method
        raise AttributeError(op)


class SDNN(_Namespace):
    """ref: ops.SDNN (without dropout and multi-head attention)."""

    def linear(self, x, w, b, name=None):
        return self._rec("xw_plus_b", [x, w, b], name=name)

    def reluLayer(self, x, w, b, name=None):
        return self._rec("relu_layer", [x, w, b], name=name)

    def softmax(self, x, axis=-1, name=None):
        return self._rec("softmax", [x], name=name, axis=axis)

    def logSoftmax(self, x, name=None):
        return self._rec("log_softmax", [x], name=name)

    def relu(self, x, name=None): return self._rec("relu", [x], name=name)
    def gelu(self, x, name=None): return self._rec("gelu", [x], name=name)
    def sigmoid(self, x, name=None): return self._rec("sigmoid", [x], name=name)
    def tanh(self, x, name=None): return self._rec("tanh", [x], name=name)
    def swish(self, x, name=None): return self._rec("swish", [x], name=name)

    def biasAdd(self, x, b, name=None):
        return self._rec("bias_add", [x, b], name=name)

    def layerNorm(self, x, gain, bias=None, axis=-1, name=None):
        ins = [x, gain] + ([bias] if bias is not None else [])
        return self._rec("layer_norm", ins, name=name, axis=axis)


class SDLoss(_Namespace):
    """ref: ops.SDLoss (the two logit losses)."""

    def softmaxCrossEntropy(self, labels, logits, name=None):
        return self._rec("softmax_cross_entropy_loss", [labels, logits],
                         name=name)

    def sparseSoftmaxCrossEntropy(self, labels, logits, name=None):
        return self._rec("sparse_softmax_cross_entropy_loss",
                         [labels, logits], name=name)


class TrainingConfig:
    """ref: org.nd4j.autodiff.samediff.TrainingConfig; ``to_config`` is
    the JAX package's JSON."""

    def __init__(self, updater: IUpdater = None, l1: float = 0.0,
                 l2: float = 0.0,
                 data_set_feature_mapping: Sequence[str] = ("features",),
                 data_set_label_mapping: Sequence[str] = ("labels",),
                 clip_value: float = 0.0, clip_norm: float = 0.0,
                 clip_global_norm: float = 0.0):
        self.updater = updater or upd.Adam()
        self.l1 = l1
        self.l2 = l2
        self.data_set_feature_mapping = list(data_set_feature_mapping)
        self.data_set_label_mapping = list(data_set_label_mapping)
        self.clip_value = clip_value
        self.clip_norm = clip_norm
        self.clip_global_norm = clip_global_norm

    def to_config(self):
        d = dict(self.__dict__)
        d["updater"] = self.updater.to_config()
        return d

    @staticmethod
    def from_config(d):
        d = dict(d)
        d["updater"] = IUpdater.from_config(d["updater"])
        tc = TrainingConfig.__new__(TrainingConfig)
        tc.__dict__.update(d)
        return tc


class History:
    """ref: org.nd4j.autodiff.listeners.records.History."""

    def __init__(self):
        self.loss_curve: List[float] = []

    def lossCurve(self):
        return self.loss_curve


class SameDiff:
    """The graph builder and its eager executor on one device (``cuda``
    unless the caller passes ``device="cpu"``)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._variables: Dict[str, torch.Tensor] = {}     # trainable
        self._constants: Dict[str, torch.Tensor] = {}
        self._placeholders: Dict[str, Tuple] = {}  # name -> (shape, dtype)
        self._vars: Dict[str, SDVariable] = {}
        self._nodes: List[_Node] = []
        self._producers: Dict[str, _Node] = {}
        self._loss_variables: List[str] = []
        self._name_counter: Dict[str, int] = {}
        self.training_config: Optional[TrainingConfig] = None
        self._updater_state: Optional[Dict] = None
        self._step = 0
        self.math = SDMath(self)
        self.nn = SDNN(self)
        self.loss = SDLoss(self)

    # ------------------------------------------------------------- creation
    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device)

    def _unique(self, base: str) -> str:
        if base not in self._vars and base not in self._placeholders:
            return base
        n = self._name_counter.get(base, 0)
        while True:
            n += 1
            cand = f"{base}_{n}"
            if cand not in self._vars and cand not in self._placeholders:
                self._name_counter[base] = n
                return cand

    def _as_tensor(self, value) -> torch.Tensor:
        """A tensor on the graph's device, with the dtypes jnp.asarray
        gives without x64 (float64 -> float32, int64 -> int32)."""
        if not isinstance(value, torch.Tensor):
            a = np.asarray(value)
            value = torch.from_numpy(np.array(a, copy=not a.flags.writeable))
        return value.to(self.device, _NARROW.get(value.dtype, value.dtype))

    def placeHolder(self, name: str, shape=None,
                    dtype=torch.float32) -> SDVariable:
        v = SDVariable(self, name, "PLACEHOLDER",
                       tuple(shape) if shape else None, dtype)
        self._placeholders[name] = (shape, dtype)
        self._vars[name] = v
        return v

    placeholder = placeHolder

    def var(self, name: str, value=None, shape=None, init: str = "xavier",
            generator: torch.Generator = None,
            dtype=torch.float32) -> SDVariable:
        """Trainable variable: an explicit ``value``, or ``shape`` and
        ``init`` drawn from an explicit ``torch.Generator`` (Threefry and
        Philox streams differ, so no seed matches the JAX package's)."""
        if value is None:
            value = _initialize(shape, init, generator,
                                op_registry.torch_dtype(dtype))
        arr = self._as_tensor(value)
        v = SDVariable(self, name, "VARIABLE", tuple(arr.shape), arr.dtype)
        self._variables[name] = arr
        self._vars[name] = v
        return v

    variable = var

    def constant(self, value, name: str = None) -> SDVariable:
        name = self._unique(name or "const")
        arr = self._as_tensor(value)
        v = SDVariable(self, name, "CONSTANT", tuple(arr.shape), arr.dtype)
        self._constants[name] = arr
        self._vars[name] = v
        return v

    def _as_var(self, x) -> SDVariable:
        if isinstance(x, SDVariable):
            return x
        return self.constant(x)

    # ------------------------------------------------------------ recording
    def _record(self, op: str, input_names: List[str], name: str = None,
                n_out: int = 1, attrs: Dict = None):
        # resolved now: an override installed before recording runs here
        fn = op_registry.get(op)
        return self._record_fn(op, fn, input_names, name=name, n_out=n_out,
                               attrs=attrs)

    def _record_fn(self, op: str, fn: Callable, input_names: List[str],
                   name: str = None, n_out: int = 1, attrs: Dict = None,
                   rebuild: str = None):
        attrs = attrs or {}
        base = name or op
        out_names = [self._unique(base if n_out == 1 else f"{base}:{i}")
                     for i in range(n_out)]
        node = _Node(op, fn, list(input_names), out_names, attrs,
                     rebuild=rebuild)
        self._nodes.append(node)
        outs = []
        for on in out_names:
            v = SDVariable(self, on, "ARRAY")
            self._vars[on] = v
            self._producers[on] = node
            outs.append(v)
        return outs[0] if n_out == 1 else tuple(outs)

    def _rename(self, old: str, new: str):
        """Rename a variable everywhere it appears (the TF importer aligns
        multi-output and deframed nodes' names with TF's refs)."""
        for d in (self._variables, self._constants, self._placeholders,
                  self._vars):
            if old in d:
                d[new] = d.pop(old)
        if new in self._vars:
            self._vars[new].name = new
        for node in self._nodes:
            node.inputs = [new if i == old else i for i in node.inputs]
            node.outputs = [new if o == old else o for o in node.outputs]
        if old in self._producers:
            self._producers[new] = self._producers.pop(old)
        self._loss_variables = [new if n == old else n
                                for n in self._loss_variables]

    # ------------------------------------------------------------ execution
    def _needed_nodes(self, output_names: Sequence[str]) -> List[_Node]:
        needed = set()
        stack = list(output_names)
        seen = set()
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            node = self._producers.get(n)
            if node is not None:
                needed.add(id(node))
                stack.extend(node.inputs)
        return [nd for nd in self._nodes if id(nd) in needed]

    def _exec(self, variables: Dict[str, torch.Tensor],
              placeholders: Dict[str, torch.Tensor],
              output_names: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Run the nodes the outputs need, in recorded order, eagerly on
        the graph's device."""
        env = {**variables, **self._constants, **placeholders}
        for node in self._needed_nodes(output_names):
            res = node.fn(*(env[n] for n in node.inputs), **node.attrs)
            if len(node.outputs) == 1:
                env[node.outputs[0]] = res
            else:
                env.update(zip(node.outputs, res))
        return {o: env[o] for o in output_names}

    def _feed(self, placeholders) -> Dict[str, torch.Tensor]:
        return {k: self._as_tensor(v) for k, v in (placeholders or {}).items()}

    def output(self, placeholders: Dict[str, Any], outputs: Sequence[str]
               ) -> Dict[str, torch.Tensor]:
        """ref: SameDiff.output / batchOutput (no ported op has a
        training mode, so there is no ``train`` flag yet)."""
        outputs = [o.name if isinstance(o, SDVariable) else o
                   for o in outputs]
        with torch.no_grad():
            return self._exec(self._variables, self._feed(placeholders),
                              outputs)

    def batchOutput(self):
        sd = self

        class _B:
            def __init__(self):
                self._phs = {}
                self._outs = []

            def input(self, name, arr):
                self._phs[name] = arr
                return self

            def output(self, *names):
                self._outs.extend(names)
                return self

            def execSingle(self):
                return sd.output(self._phs, self._outs)[self._outs[0]]

            def exec(self):
                return sd.output(self._phs, self._outs)
        return _B()

    # ------------------------------------------------------------ gradients
    def setLossVariables(self, *names):
        self._loss_variables = [n.name if isinstance(n, SDVariable) else n
                                for n in names]

    def convertToVariables(self, *names):
        """Promote constants to trainable variables (ref:
        SameDiff.convertToVariables): the unfreeze step of fine-tuning."""
        for n in names:
            n = n.name if isinstance(n, SDVariable) else n
            if n in self._variables:
                continue
            if n not in self._constants:
                raise ValueError(f"'{n}' is not a constant")
            self._variables[n] = self._constants.pop(n)
            self._vars[n].var_type = "VARIABLE"
        self._updater_state = None       # the set of trained leaves changed
        return self

    def convertToConstants(self, *names):
        """Freeze variables into constants (ref:
        SameDiff.convertToConstants): no gradient, no updater state."""
        for n in names:
            n = n.name if isinstance(n, SDVariable) else n
            if n in self._constants:
                continue
            if n not in self._variables:
                raise ValueError(f"'{n}' is not a variable")
            self._constants[n] = self._variables.pop(n)
            self._vars[n].var_type = "CONSTANT"
        self._updater_state = None
        return self

    def _total_loss(self, variables, placeholders) -> torch.Tensor:
        """The sum of the ``sum`` of every loss variable (the JAX
        package's ``_total_loss_fn``)."""
        names = tuple(self._loss_variables)
        if not names:
            raise ValueError("call setLossVariables first")
        outs = self._exec(variables, placeholders, names)
        return sum(outs[n].sum() for n in names)

    def calculateGradients(self, placeholders: Dict[str, Any],
                           wrt: Sequence[str] = None
                           ) -> Dict[str, torch.Tensor]:
        """ref: SameDiff.calculateGradients: d(total loss)/d(each name in
        ``wrt``), variables and floating placeholders alike (all
        variables when ``wrt`` is empty). A name the loss does not reach
        gets zeros, as ``jax.grad`` gives."""
        wrt = list(wrt) if wrt else list(self._variables)
        phs = self._feed(placeholders)
        unknown = [k for k in wrt if k not in self._variables and k not in phs]
        if unknown:
            raise ValueError(f"calculateGradients: {unknown} are neither "
                             f"variables nor provided placeholders")
        leaves = {}
        for k in wrt:
            src = self._variables if k in self._variables else phs
            if not src[k].is_floating_point():
                raise ValueError(f"calculateGradients: '{k}' is "
                                 f"{src[k].dtype}, not a floating type")
            leaves[k] = src[k].detach().requires_grad_(True)
        variables = {**self._variables,
                     **{k: v for k, v in leaves.items()
                        if k in self._variables}}
        phs.update({k: v for k, v in leaves.items() if k not in variables})
        with torch.enable_grad():
            total = self._total_loss(variables, phs)
            grads = torch.autograd.grad(total, [leaves[k] for k in wrt],
                                        allow_unused=True)
        return {k: g if g is not None else torch.zeros_like(leaves[k])
                for k, g in zip(wrt, grads)}

    # ------------------------------------------------------------- training
    def setTrainingConfig(self, cfg: TrainingConfig):
        self.training_config = cfg

    def _train_step(self, phs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One step, as the JAX package's ``_make_train_step``: loss and
        gradients of every variable, L1/L2, the three clips, then the
        updater at ``t = step`` (Adam adds the 1 itself) and AdamW's
        decoupled decay on weights of ndim >= 2. Returns the loss on the
        device."""
        cfg = self.training_config
        updater = cfg.updater
        names = list(self._variables)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self._variables.items()}
        with torch.enable_grad():
            loss = self._total_loss(leaves, phs)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                        allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(leaves[k])
                 for k, g in zip(names, grads)]
        with torch.no_grad():
            if cfg.l1 or cfg.l2:
                grads = [upd.apply_regularization(self._variables[k], g,
                                                  cfg.l1, cfg.l2)
                         for k, g in zip(names, grads)]
            if cfg.clip_value:
                grads = upd.clip_by_value(grads, cfg.clip_value)
            if cfg.clip_norm:
                grads = upd.clip_by_norm(grads, cfg.clip_norm)
            if cfg.clip_global_norm:
                grads = upd.clip_by_global_norm(grads, cfg.clip_global_norm)
            t = self._step
            lr = updater.lr_at(t)
            decay = isinstance(updater, upd.AdamW) and updater.weight_decay
            for k, g in zip(names, grads):
                p = self._variables[k]
                u, self._updater_state[k] = updater.apply(
                    g, self._updater_state[k], lr, t)
                if decay and p.dim() >= 2:
                    u = u + updater.weight_decay_update(p, lr)
                # out of place: an array the caller passed to var() stays
                self._variables[k] = p - u
        return loss.detach()

    def fit(self, data=None, epochs: int = 1, batch_size: int = None,
            iterator=None) -> History:
        """ref: SameDiff.fit. ``data``: an iterable of batches, each a
        dict ``{placeholder: array}`` or a ``(features, labels)`` pair
        mapped through the TrainingConfig's names, or a dict of full
        arrays (minibatched by ``batch_size``). The losses stay on the
        device until the end of each epoch."""
        if self.training_config is None:
            raise ValueError("setTrainingConfig first")
        cfg = self.training_config
        if self._updater_state is None:
            self._updater_state = {k: cfg.updater.init_state(v)
                                   for k, v in self._variables.items()}

        def batches():
            src = iterator if iterator is not None else data
            if isinstance(src, dict):
                n = next(iter(src.values())).shape[0]
                bs = batch_size or n
                for i in range(0, n, bs):
                    yield {k: v[i:i + bs] for k, v in src.items()}
                return
            for b in src:
                if isinstance(b, dict):
                    yield b
                    continue
                feats, labels = b
                f_list = feats if isinstance(feats, (list, tuple)) \
                    else [feats]
                l_list = labels if isinstance(labels, (list, tuple)) \
                    else [labels]
                yield {**dict(zip(cfg.data_set_feature_mapping, f_list)),
                       **dict(zip(cfg.data_set_label_mapping, l_list))}

        hist = History()
        for _ in range(epochs):
            losses = []
            for batch in batches():
                losses.append(self._train_step(self._feed(batch)))
                self._step += 1
            if losses:
                hist.loss_curve += torch.stack(losses).cpu().tolist()
        return hist

    # ---------------------------------------------------------- control flow
    def while_loop(self, cond_fn, body_fn, init_vars: Sequence[SDVariable],
                   name: str = None):
        """A loop over ``init_vars`` (ref: the interpreted Enter/Exit/Merge
        frames). ``cond_fn``/``body_fn`` are Python callables over tensors
        (the node then cannot be saved) or SameDiff subgraphs whose
        placeholders, in declaration order, are the loop carries and whose
        last-recorded outputs (or ``setOutputs``) are the result; those
        round-trip through ``save``/``load``."""
        names = [self._as_var(v).name for v in init_vars]
        n = len(names)
        if isinstance(cond_fn, SameDiff) and isinstance(body_fn, SameDiff):
            attrs = {"cond": subgraph_spec(cond_fn,
                                           cond_fn._default_outputs(1)),
                     "body": subgraph_spec(body_fn,
                                           body_fn._default_outputs(n))}
            return self._record_fn("while_loop", _make_subwhile_fn(attrs),
                                   names, name=name, n_out=n, attrs=attrs,
                                   rebuild="subwhile")

        def fn(*args):
            c = tuple(args)
            while bool(cond_fn(*c)):
                out = body_fn(*c)
                c = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            return c[0] if n == 1 else c
        return self._record_fn("while_loop", fn, names, name=name, n_out=n)

    def cond(self, pred: SDVariable, true_fn, false_fn,
             operands: Sequence[SDVariable], name: str = None,
             n_out: int = 1):
        """Run one of two branches on ``operands`` as ``pred`` says;
        branches are Python callables (not serializable) or SameDiff
        subgraphs (round-trip; see :meth:`while_loop`)."""
        names = [self._as_var(pred).name] + [self._as_var(v).name
                                             for v in operands]
        if isinstance(true_fn, SameDiff) and isinstance(false_fn, SameDiff):
            attrs = {"true": subgraph_spec(true_fn,
                                           true_fn._default_outputs(n_out)),
                     "false": subgraph_spec(false_fn,
                                            false_fn._default_outputs(n_out))}
            return self._record_fn("cond", _make_subcond_fn(attrs), names,
                                   name=name, n_out=n_out, attrs=attrs,
                                   rebuild="subcond")

        def fn(p, *args):
            return (true_fn if bool(p) else false_fn)(*args)
        return self._record_fn("cond", fn, names, name=name)

    def invoke_subgraph(self, sub: "SameDiff", inputs: Sequence[SDVariable],
                        outputs: Sequence[str] = None, name: str = None):
        """Record a whole subgraph as one node (the import of
        ``PartitionedCall`` / FunctionDef bodies). Differentiable and
        serializable."""
        names = [self._as_var(v).name for v in inputs]
        outs = list(outputs) if outputs else sub._default_outputs(1)
        attrs = {"sub": subgraph_spec(sub, outs)}
        return self._record_fn("subgraph", _make_subcall_fn(attrs), names,
                               name=name, n_out=len(outs), attrs=attrs,
                               rebuild="subcall")

    def setOutputs(self, *names):
        """Mark this graph's result variables (used when the graph serves
        as a control-flow body or a called subgraph)."""
        self._marked_outputs = [n.name if isinstance(n, SDVariable) else n
                                for n in names]
        return self

    def _default_outputs(self, n: int) -> List[str]:
        """Explicitly marked outputs, else the last n recorded outputs (the
        last n placeholders of a graph without nodes)."""
        marked = getattr(self, "_marked_outputs", None)
        if marked:
            if len(marked) != n:
                raise ValueError(f"subgraph marks {len(marked)} outputs, "
                                 f"{n} required")
            return list(marked)
        if not self._nodes:
            return list(self._placeholders)[-n:]
        return [o for node in self._nodes for o in node.outputs][-n:]

    # --------------------------------------------------------- shape report
    def infer_shapes(self, batch_size: int = 1) -> Dict[str, tuple]:
        """Static shape of every graph variable without executing anything
        (ref: each DeclarableOp's shape fn feeding SameDiff.summary()).

        Each node runs on ``meta`` tensors (the JAX package's
        ``jax.eval_shape``): shapes and dtypes propagate, no memory is
        allocated, nothing runs on a device. Placeholder ``None`` dims
        use ``batch_size``; a rank-free placeholder, and everything
        downstream of it or of a node that cannot run on ``meta`` (one
        that reads a value on the host, such as a ``while_loop``
        predicate), reports None."""
        def meta(shape, dtype):
            return torch.empty(tuple(shape), dtype=dtype, device="meta")

        env: Dict[str, Optional[torch.Tensor]] = {}
        for k, v in {**self._variables, **self._constants}.items():
            env[k] = meta(v.shape, v.dtype)
        for k, (shape, dtype) in self._placeholders.items():
            if shape is None:
                env[k] = None
                continue
            env[k] = meta([batch_size if d in (None, -1) else int(d)
                           for d in shape], op_registry.torch_dtype(dtype))
        for node in self._nodes:
            args = [env.get(n) for n in node.inputs]
            outs = None
            if all(a is not None for a in args):
                try:
                    res = node.fn(*args, **node.attrs)
                    outs = (res,) if len(node.outputs) == 1 else tuple(res)
                except (RuntimeError, NotImplementedError, TypeError,
                        ValueError, IndexError):
                    outs = None
            for i, name in enumerate(node.outputs):
                o = outs[i] if outs is not None else None
                env[name] = o if isinstance(o, torch.Tensor) else None
        return {k: (tuple(v.shape) if v is not None else None)
                for k, v in env.items()}

    def validate(self, batch_size: int = 1, **kw):
        """Static lint of the recorded op graph — shape propagation over
        the ``_Node`` list plus structural checks (E151 undefined input,
        E152 shape conflict, E153 bad loss variable, W151 dangling
        placeholder, W152 unused variable, W153 training config with no
        loss), and the layout/distribution/numerics families over the
        analysis IR. Pure-static like ``model.validate()``: no tensor is
        made, nothing runs on a device. Extra keywords pass through to
        ``analysis.analyze`` (``mesh=``, ``policy=``, ``suppress=``,
        ``severity_overrides=``)."""
        from deeplearning4j_tpu_torch.analysis import analyze
        return analyze(self, batch_size=batch_size, **kw)

    def summary(self, batch_size: int = 1) -> str:
        """Printable graph summary with per-variable shapes — from
        :meth:`infer_shapes`, not from running the graph (ref:
        SameDiff.summary())."""
        shapes = self.infer_shapes(batch_size)
        lines = [f"SameDiff: {len(self._variables)} variables, "
                 f"{len(self._placeholders)} placeholders, "
                 f"{len(self._nodes)} ops",
                 f"{'name':<28} {'kind':<12} {'op':<28} shape",
                 "-" * 80]
        for k in self._placeholders:
            lines.append(f"{k:<28} {'PLACEHOLDER':<12} {'':<28} "
                         f"{shapes.get(k)}")
        for k in self._variables:
            lines.append(f"{k:<28} {'VARIABLE':<12} {'':<28} {shapes.get(k)}")
        for k in self._constants:
            if k in self._producers:
                continue  # folded node outputs appear as ops below
            lines.append(f"{k:<28} {'CONSTANT':<12} {'':<28} {shapes.get(k)}")
        for node in self._nodes:
            for o in node.outputs:
                lines.append(f"{o:<28} {'ARRAY':<12} {node.op:<28} "
                             f"{shapes.get(o)}")
        return "\n".join(lines)

    # ------------------------------------------------------------ utilities
    def variables(self) -> List[SDVariable]:
        return [self._vars[n] for n in self._variables]

    def getVariable(self, name: str) -> SDVariable:
        return self._vars[name]

    def hasVariable(self, name: str) -> bool:
        return name in self._vars

    # ------------------------------------------------------------ save/load
    def save(self, path: str, save_updater_state: bool = True):
        """ref: SameDiff.save. The JAX package's zip: ``graph.json``
        (nodes, placeholders with numpy dtype names, loss variables, the
        step, the TrainingConfig, the updater state's tree) and
        ``arrays.npz`` (``var::``, ``const::`` and ``upd::<i>`` leaves in
        sorted-key order, as ``jax.tree_util`` flattens a dict)."""
        graph = {"nodes": [_node_to_spec(n) for n in self._nodes],
                 "placeholders": {
                     k: [list(shape) if shape else None,
                         op_registry.dtype_name(dt)]
                     for k, (shape, dt) in self._placeholders.items()},
                 "loss_variables": self._loss_variables,
                 "step": self._step}
        if self.training_config is not None:
            graph["training_config"] = self.training_config.to_config()
        arrays = {f"var::{k}": _to_numpy(v)
                  for k, v in self._variables.items()}
        arrays.update({f"const::{k}": _to_numpy(v)
                       for k, v in self._constants.items()})
        if save_updater_state and self._updater_state is not None:
            for i, leaf in enumerate(_tree_leaves(self._updater_state)):
                arrays[f"upd::{i}"] = _to_numpy(leaf)
            graph["updater_treedef"] = _treedef_to_json(self._updater_state)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("graph.json", json.dumps(graph))
            z.writestr("arrays.npz", buf.getvalue())

    @staticmethod
    def load(path: str, device=None) -> "SameDiff":
        """Load a graph either package saved; each node resolves its op
        through the registry now, overrides included."""
        sd = SameDiff(device)
        with zipfile.ZipFile(path) as z:
            graph = json.loads(z.read("graph.json"))
            arrays = np.load(io.BytesIO(z.read("arrays.npz")))
        for name, (shape, dt) in graph["placeholders"].items():
            sd.placeHolder(name, shape=tuple(shape) if shape else None,
                           dtype=op_registry.torch_dtype(dt))
        upd_leaves = {}
        for k in arrays.files:
            kind, _, name = k.partition("::")
            if kind == "var":
                sd.var(name, arrays[k])
            elif kind == "const":
                sd.constant(arrays[k], name=name)
            elif kind == "upd":
                upd_leaves[int(name)] = sd._as_tensor(arrays[k])
        for nd_spec in graph["nodes"]:
            node = _node_from_spec(nd_spec)
            sd._nodes.append(node)
            for on in node.outputs:
                sd._vars[on] = SDVariable(sd, on, "ARRAY")
                sd._producers[on] = node
        sd._loss_variables = graph.get("loss_variables", [])
        sd._step = graph.get("step", 0)
        if "training_config" in graph:
            sd.training_config = TrainingConfig.from_config(
                graph["training_config"])
        if upd_leaves and "updater_treedef" in graph:
            leaves = [upd_leaves[i] for i in range(len(upd_leaves))]
            sd._updater_state = _treedef_from_json(graph["updater_treedef"],
                                                   leaves)
        return sd


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _node_to_spec(node: _Node) -> dict:
    """JSON-able spec of one node."""
    spec = {"op": node.op, "inputs": node.inputs, "outputs": node.outputs,
            "attrs": dict(node.attrs), "rng": False}
    if node.rebuild is not None:
        spec["rebuild"] = node.rebuild
    elif not op_registry.has(node.op):
        raise ValueError(
            f"node '{node.op}' is not serializable: its body is an "
            f"arbitrary Python closure. while_loop/cond round-trip when "
            f"their bodies are SameDiff subgraphs (pass SameDiff instances "
            f"instead of Python callables)")
    return spec


def _node_from_spec(nd_spec: dict) -> _Node:
    """Rebuild a node, with its callable, from its JSON spec."""
    attrs = {k: (tuple(v) if isinstance(v, list) and k != "index" else v)
             for k, v in nd_spec["attrs"].items()}
    rebuild = nd_spec.get("rebuild")
    if nd_spec.get("rng"):
        raise NotImplementedError(
            f"node '{nd_spec['op']}' draws random numbers: RNG ops are not "
            "ported yet")
    if rebuild == "tf" and rebuild not in _FN_REBUILDERS:
        # TF-imported graphs: the importer registers its rebuilder
        import deeplearning4j_tpu_torch.modelimport.tensorflow  # noqa: F401
    if rebuild == "onnx" and rebuild not in _FN_REBUILDERS:
        import deeplearning4j_tpu_torch.modelimport.onnx  # noqa: F401
    if rebuild is not None:
        if rebuild not in _FN_REBUILDERS:
            raise NotImplementedError(
                f"node '{nd_spec['op']}' (rebuild '{rebuild}') is not "
                f"ported yet; ported closures: {sorted(_FN_REBUILDERS)}")
        fn = _FN_REBUILDERS[rebuild](attrs)
    else:
        fn = op_registry.get(nd_spec["op"])
    return _Node(nd_spec["op"], fn, nd_spec["inputs"], nd_spec["outputs"],
                 attrs, rebuild=rebuild)


def _encode_index(idx):
    """JSON-able encoding of a numpy-style index (serializable getitem)."""
    if isinstance(idx, tuple):
        return {"tuple": [_encode_index(i) for i in idx]}
    if isinstance(idx, slice):
        return {"slice": [idx.start, idx.stop, idx.step]}
    if idx is Ellipsis:
        return {"ellipsis": True}
    if idx is None:
        return {"newaxis": True}
    if isinstance(idx, (int, np.integer)) \
            and not isinstance(idx, (bool, np.bool_)):
        return int(idx)
    if isinstance(idx, list) or (isinstance(idx, np.ndarray) and idx.ndim == 1
                                 and np.issubdtype(idx.dtype, np.integer)):
        return {"list": [int(i) for i in idx]}
    raise TypeError(f"unsupported index for serializable getitem: {idx!r}")


def _decode_index(spec):
    if isinstance(spec, int):
        return spec
    if "tuple" in spec:
        return tuple(_decode_index(s) for s in spec["tuple"])
    if "slice" in spec:
        return slice(*spec["slice"])
    if "ellipsis" in spec:
        return Ellipsis
    if "newaxis" in spec:
        return None
    return list(spec["list"])


def _make_getitem_fn(attrs):
    idx = _decode_index(attrs["index"])
    return lambda x, index=None: x[idx]


# ------------------------------------------------------------- subgraphs
# A SameDiff graph can serve as the body of a control-flow node or a
# function call. It serializes to a self-contained JSON spec (arrays
# base64-inline: control-flow bodies are small), the JAX package's format,
# so control flow round-trips through save()/load() in either package.

def _arr_to_json(a) -> dict:
    a = _to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def _arr_from_json(d) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["data"]),
                         np.dtype(d["dtype"])).reshape(d["shape"]).copy()


def subgraph_spec(sub: "SameDiff", outputs: Sequence[str]) -> dict:
    """Self-contained JSON spec of ``sub``: placeholders in declared order
    (the call convention), variables folded to constants (a subgraph's
    weights are closed over, not trained), nodes and output names."""
    return {
        "ph_order": list(sub._placeholders),
        "placeholders": {k: [list(v[0]) if v[0] else None,
                             op_registry.dtype_name(v[1])]
                         for k, v in sub._placeholders.items()},
        "consts": {k: _arr_to_json(v)
                   for k, v in {**sub._constants, **sub._variables}.items()},
        "nodes": [_node_to_spec(n) for n in sub._nodes],
        "outputs": list(outputs),
        "has_rng": False,
    }


def subgraph_from_spec(spec: dict, device="cpu") -> "SameDiff":
    sub = SameDiff(device)
    for name in spec["ph_order"]:
        shp, dt = spec["placeholders"][name]
        sub.placeHolder(name, shape=tuple(shp) if shp else None,
                        dtype=op_registry.torch_dtype(dt))
    for name, d in spec["consts"].items():
        sub.constant(_arr_from_json(d), name=name)
    for nd_spec in spec["nodes"]:
        node = _node_from_spec(nd_spec)
        sub._nodes.append(node)
        for on in node.outputs:
            sub._vars[on] = SDVariable(sub, on, "ARRAY")
            sub._producers[on] = node
    return sub


def subgraph_fn(spec: dict) -> Callable:
    """A subgraph spec as ``call(*args) -> tuple(outputs)``, the args bound
    to the placeholders in declared order. The subgraph is built on the
    device of the first tensor argument when first called there."""
    outputs = tuple(spec["outputs"])
    ph_names = spec["ph_order"]
    subs: Dict[torch.device, SameDiff] = {}

    def call(*args):
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   torch.device("cpu"))
        sub = subs.get(dev)
        if sub is None:
            sub = subs[dev] = subgraph_from_spec(spec, dev)
        outs = sub._exec({}, {k: sub._as_tensor(a)
                              for k, a in zip(ph_names, args)}, outputs)
        return tuple(outs[n] for n in outputs)
    return call


def _make_subwhile_fn(attrs: dict) -> Callable:
    """A loop over subgraph bodies: a Python loop on the device, the
    predicate read on the host once an iteration."""
    cond = subgraph_fn(attrs["cond"])
    body = subgraph_fn(attrs["body"])
    n = len(attrs["body"]["outputs"])

    def fn(*args, **_kw):
        c = tuple(args)
        while bool(cond(*c)[0].reshape(())):
            c = body(*c)
        return c if n > 1 else c[0]
    return fn


def _make_subcond_fn(attrs: dict) -> Callable:
    tfn = subgraph_fn(attrs["true"])
    ffn = subgraph_fn(attrs["false"])
    n = len(attrs["true"]["outputs"])

    def fn(p, *args, **_kw):
        res = (tfn if bool(p.reshape(())) else ffn)(*args)
        return res if n > 1 else res[0]
    return fn


def _make_subcall_fn(attrs: dict) -> Callable:
    """An inline function call: one node that runs a whole subgraph
    (differentiable: autograd runs straight through)."""
    sub = subgraph_fn(attrs["sub"])
    n = len(attrs["sub"]["outputs"])

    def fn(*args, **_kw):
        res = sub(*args)
        return res if n > 1 else res[0]
    return fn


# rebuild-key -> closure builder; save() records the key, load() calls it
# (the TF importer adds "tf")
_FN_REBUILDERS = {"getitem": _make_getitem_fn,
                  "subwhile": _make_subwhile_fn,
                  "subcond": _make_subcond_fn,
                  "subcall": _make_subcall_fn}


def _tree_leaves(tree) -> list:
    """Leaves of nested dicts in sorted-key order (``jax.tree_util``'s
    flattening order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    return [tree]


def _treedef_to_json(tree):
    """Structure of nested dicts (leaves -> None) for round-tripping."""
    if isinstance(tree, dict):
        return {k: _treedef_to_json(v) for k, v in sorted(tree.items())}
    return None


def _treedef_from_json(spec, leaves, _idx=None):
    if _idx is None:
        _idx = [0]
    if spec is None:
        leaf = leaves[_idx[0]]
        _idx[0] += 1
        return leaf
    return {k: _treedef_from_json(v, leaves, _idx)
            for k, v in sorted(spec.items())}


def _initialize(shape, init: str, generator: torch.Generator,
                dtype=torch.float32):
    """Weight init (ref: org.deeplearning4j.nn.weights.WeightInit), drawn
    on the CPU from ``generator``."""
    if generator is None:
        raise ValueError("var(shape=..., init=...) needs generator=: the "
                         "port draws initial weights from an explicit "
                         "torch.Generator")
    shape = tuple(shape)
    init = init.lower()
    fan_in = shape[0] if len(shape) >= 1 else 1
    fan_out = shape[-1] if len(shape) >= 2 else 1
    if len(shape) in (4, 5):  # conv OIHW / OIDHW
        rf = int(np.prod(shape[2:]))
        fan_in, fan_out = shape[1] * rf, shape[0] * rf

    def uniform(limit):
        return (torch.rand(shape, generator=generator) * 2 - 1) * limit

    def normal(std):
        return torch.randn(shape, generator=generator) * std

    if init == "zeros":
        w = torch.zeros(shape)
    elif init == "ones":
        w = torch.ones(shape)
    elif init in ("xavier", "glorot_uniform"):
        w = uniform(float(np.sqrt(6.0 / (fan_in + fan_out))))
    elif init in ("xavier_gaussian", "glorot_normal"):
        w = normal(float(np.sqrt(2.0 / (fan_in + fan_out))))
    elif init in ("relu", "he", "he_normal"):
        w = normal(float(np.sqrt(2.0 / fan_in)))
    elif init in ("he_uniform", "relu_uniform"):
        w = uniform(float(np.sqrt(6.0 / fan_in)))
    elif init == "lecun_normal":
        w = normal(float(np.sqrt(1.0 / fan_in)))
    elif init == "uniform":
        w = uniform(float(1.0 / np.sqrt(fan_in)))
    elif init in ("normal", "gaussian"):
        w = normal(float(1.0 / np.sqrt(fan_in)))
    else:
        raise ValueError(f"unknown weight init '{init}'")
    return w.to(dtype)
