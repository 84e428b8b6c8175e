"""SameDiff graph engine: record a graph op by op, run it on the card.

The port's counterpart of ``deeplearning4j_tpu/autodiff/samediff.py``
(ref: ``org.nd4j.autodiff.samediff.SameDiff`` + ``SDVariable`` and the
op namespaces). Where the JAX package traces the recorded graph into one
XLA program, the port runs it node by node on the graph's device, each
node calling the op its name resolved to in :mod:`..ops.registry` **at
record time**, so kernels installed as platform overrides before a node
is recorded run in it. Gradients come from ``torch.autograd`` over the
same run.

Graph model, as in the JAX package: ``variable`` (trainable),
``constant``, ``placeholder`` (fed at execution) and op nodes created
through ``SDVariable`` methods and the ``math`` / ``nn`` / ``cnn`` /
``rnn`` / ``loss`` / ``random`` / ``linalg`` / ``bitwise`` / ``image``
namespaces, in topological order.

Random numbers: ``nn.dropout`` and the ``random`` namespace record RNG
nodes, rebuilt from ``(op, params)`` at ``load()`` in either package.
Where the JAX package splits a threefry key, the port draws from the
counter hash its layers use (``ops.normalization.StepKey(seed, t,
path=(node index,))``, :func:`~..ops.normalization.hash24`): ``t`` is the
graph's device step clock in ``fit`` and the Python step in ``output``.
No generator is involved, so a captured step replays fresh draws from
the clock it advances. The streams differ from threefry's, so parity is
by moments and by injected masks.

Training: ``fit`` dispatches its step (forward, backward, clips, the
updater, the clock) through :class:`~..nn.compilecache.CachedDispatch`,
one captured CUDA graph for each placeholder signature (scope
``"samediff:fit"``). The step updates the variables, the updater state
and the device clock ``_t_dev`` in place, and the first ``fit`` copies
the variables once, as the JAX fit does, so an array the caller passed
to ``var()`` survives. Losses stay on the card until each epoch ends.

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
iteration. Such a node is marked when it is recorded, and a graph whose
loss needs one trains eagerly on the card by design (counted in
``compilecache.cache_stats()["eager_by_design"]``): a captured graph
cannot read a value on the host.

Static analysis: ``infer_shapes`` (on ``meta`` tensors), ``validate``
(the ``analysis`` package's SameDiff lints) and ``summary``.

The native backend: ``setExecBackend("native")`` runs ``output()`` /
``batchOutput()`` through the C++ runtime over the CUDA driver
(:mod:`..native`): each (outputs, placeholder signature, train) key is
compiled once (the graph's spec with its variables, constants,
placeholders and step clock as inputs, captured on the card and
instantiated by the library), then every call executes it with the
graph's own arrays and returns host arrays, as the JAX native path does.
A graph on the CPU, or one whose outputs need a node that reads the host,
raises ``NativeRuntimeError``: nothing falls back to the eager path.
"""

from __future__ import annotations

import base64
import io
import json
import os
import weakref
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.ops import normalization as norm_ops
from deeplearning4j_tpu_torch.ops import registry as op_registry
from deeplearning4j_tpu_torch.train import updaters as upd
from deeplearning4j_tpu_torch.train.updaters import IUpdater

#: the 64-bit dtypes jnp.asarray narrows without x64 (Python and numpy
#: defaults): the port feeds the graph the dtypes the JAX package does
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _narrowed(value) -> torch.Tensor:
    """``value`` as a tensor where it lies (anything not a tensor on the
    host), with the dtypes jnp.asarray gives without x64 (float64 ->
    float32, int64 -> int32)."""
    if not isinstance(value, torch.Tensor):
        a = np.asarray(value)
        value = torch.from_numpy(np.array(a, copy=not a.flags.writeable))
    return value.to(dtype=_NARROW.get(value.dtype, value.dtype))


#: nodes that read a value on the host (a loop predicate, a branch): the
#: recorded op, the rebuild key, or the TF importer's op
_HOST_OPS = frozenset({"while_loop", "cond"})
_HOST_REBUILDS = frozenset({"subwhile", "subcond"})
_HOST_TF_OPS = frozenset({"While", "StatelessWhile", "If", "StatelessIf"})


class _Node:
    __slots__ = ("op", "fn", "inputs", "outputs", "attrs", "rebuild",
                 "host")

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
        # decided when the node is recorded: it reads a value on the host
        self.host = (op in _HOST_OPS or rebuild in _HOST_REBUILDS
                     or attrs.get("tf_op") in _HOST_TF_OPS)


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

    def rename(self, new_name: str) -> "SDVariable":
        self.sd._rename(self.name, new_name)
        self.name = new_name
        return self

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

    def std(self, *axes): return self.sd.math.std(self, *axes)
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
    every registry op (``sd.math.gather(x, idx, axis=0)``), with ``std``
    and ``variance`` (Bessel-corrected, as ``jnp.std(ddof=1)``)."""

    def __getattr__(self, op):
        if op_registry.has(op):
            def method(*inputs, name=None, **attrs):
                return self._rec(op, list(inputs), name=name, **attrs)
            return method
        raise AttributeError(op)

    def std(self, x, *axes, name=None):
        return self.sd._record_fn(
            "std", _make_std_fn({}), [x.name], name=name,
            attrs={"axis": tuple(axes) or None}, rebuild="std")

    def variance(self, x, *axes, name=None):
        return self.sd._record_fn(
            "variance", _make_variance_fn({}), [x.name], name=name,
            attrs={"axis": tuple(axes) or None}, rebuild="variance")


class SDNN(_Namespace):
    """ref: ops.SDNN."""

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

    def batchNorm(self, x, mean, var, gamma, beta, eps=1e-5, axis=1,
                  name=None):
        return self._rec("batchnorm_sd", [x, mean, var, gamma, beta],
                         name=name, eps=eps, axis=axis)

    def dropout(self, x, rate, name=None):
        """Inverted dropout at drop probability ``rate``, drawn from the
        graph's step key; the identity unless the run trains (``fit``, or
        ``output(..., train=True)``)."""
        sd = self.sd
        return sd._record_rng("dropout", [sd._as_var(x).name], name=name,
                              params={"rate": rate})

    def multiHeadDotProductAttention(self, q, kv, wq, wk, wv, wo,
                                     num_heads, mask=None, name=None):
        ins = [q, kv, wq, wk, wv, wo] + ([mask] if mask is not None else [])
        attrs = {"num_heads": num_heads, "has_mask": mask is not None}
        return self.sd._record_fn("multi_head_dot_product_attention",
                                  _make_mha_fn(attrs),
                                  [self.sd._as_var(v).name for v in ins],
                                  name=name, attrs=attrs,
                                  rebuild="multi_head_dot_product_attention")


class SDCNN(_Namespace):
    """ref: ops.SDCNN."""

    def conv2d(self, x, w, b=None, name=None, **attrs):
        ins = [x, w] + ([b] if b is not None else [])
        return self._rec("conv2d", ins, name=name, **attrs)

    def conv1d(self, x, w, b=None, name=None, **attrs):
        ins = [x, w] + ([b] if b is not None else [])
        return self._rec("conv1d", ins, name=name, **attrs)

    def deconv2d(self, x, w, b=None, name=None, **attrs):
        ins = [x, w] + ([b] if b is not None else [])
        return self._rec("deconv2d", ins, name=name, **attrs)

    def depthWiseConv2d(self, x, w, b=None, name=None, **attrs):
        ins = [x, w] + ([b] if b is not None else [])
        return self._rec("depthwise_conv2d", ins, name=name, **attrs)

    def separableConv2d(self, x, wd, wp, b=None, name=None, **attrs):
        ins = [x, wd, wp] + ([b] if b is not None else [])
        return self._rec("sconv2d", ins, name=name, **attrs)

    def maxPooling2d(self, x, name=None, **attrs):
        return self._rec("maxpool2d", [x], name=name, **attrs)

    def avgPooling2d(self, x, name=None, **attrs):
        return self._rec("avgpool2d", [x], name=name, **attrs)

    def upsampling2d(self, x, scale=2, name=None):
        return self._rec("upsampling2d", [x], name=name, scale=scale)

    def im2Col(self, x, name=None, **attrs):
        return self._rec("im2col", [x], name=name, **attrs)

    def spaceToDepth(self, x, block, name=None):
        return self._rec("space_to_depth", [x], name=name, block_size=block)

    def depthToSpace(self, x, block, name=None):
        return self._rec("depth_to_space", [x], name=name, block_size=block)


class SDRNN(_Namespace):
    """ref: ops.SDRNN (time-major [T, N, C] inputs)."""

    def lstmLayer(self, x_tnc, w_ih, w_hh, b, name=None):
        return self._rec("lstmLayer_out", [x_tnc, w_ih, w_hh, b], name=name)

    def gru(self, x_tnc, w_ih, w_hh, b_ih, b_hh, name=None):
        return self._rec("gru_out", [x_tnc, w_ih, w_hh, b_ih, b_hh],
                         name=name)


class SDLoss(_Namespace):
    """ref: ops.SDLoss."""

    def mse(self, labels, preds, name=None):
        return self._rec("mean_sqerr_loss", [labels, preds], name=name)

    def meanSquaredError(self, labels, preds, name=None):
        return self._rec("mean_sqerr_loss", [labels, preds], name=name)

    def softmaxCrossEntropy(self, labels, logits, name=None):
        return self._rec("softmax_cross_entropy_loss", [labels, logits],
                         name=name)

    def sigmoidCrossEntropy(self, labels, logits, name=None):
        return self._rec("sigmoid_cross_entropy_loss", [labels, logits],
                         name=name)

    def sparseSoftmaxCrossEntropy(self, labels, logits, name=None):
        return self._rec("sparse_softmax_cross_entropy_loss",
                         [labels, logits], name=name)

    def absoluteDifference(self, labels, preds, name=None):
        return self._rec("absolute_difference_loss", [labels, preds],
                         name=name)

    def cosineDistance(self, labels, preds, name=None):
        return self._rec("cosine_distance_loss", [labels, preds], name=name)

    def hingeLoss(self, labels, preds, name=None):
        return self._rec("hinge_loss", [labels, preds], name=name)

    def huberLoss(self, labels, preds, delta=1.0, name=None):
        return self._rec("huber_loss", [labels, preds], name=name,
                         delta=delta)

    def logLoss(self, labels, preds, name=None):
        return self._rec("log_loss", [labels, preds], name=name)

    def l2Loss(self, x, name=None):
        return self._rec("l2_loss", [x], name=name)


class SDRandom(_Namespace):
    """ref: ops.SDRandom — draws from the graph's step key (module
    doc)."""

    def _rng_op(self, opname, shape, name=None, **attrs):
        return self.sd._record_rng(opname, [], name=name,
                                   params={"shape": tuple(shape), **attrs})

    def uniform(self, low, high, shape, name=None):
        return self._rng_op("random_uniform", shape, name=name, minval=low,
                            maxval=high)

    def normal(self, mean, stddev, shape, name=None):
        return self._rng_op("random_normal", shape, name=name, mean=mean,
                            stddev=stddev)

    def bernoulli(self, p, shape, name=None):
        return self._rng_op("random_bernoulli", shape, name=name, p=p)


class SDLinalg(_Namespace):
    """ref: ops.SDLinalg."""

    def mmul(self, a, b, name=None):
        return self._rec("matmul", [a, b], name=name)

    def cholesky(self, a, name=None): return self._rec("cholesky", [a], name=name)
    def qr(self, a, name=None): return self._rec("qr", [a], name=name, n_out=2)
    def svd(self, a, name=None): return self._rec("svd", [a], name=name, n_out=3)
    def inverse(self, a, name=None): return self._rec("matrix_inverse", [a], name=name)
    def det(self, a, name=None): return self._rec("matrix_determinant", [a], name=name)
    def solve(self, a, b, name=None): return self._rec("solve", [a, b], name=name)


class SDBitwise(_Namespace):
    """ref: ops.SDBitwise."""

    def and_(self, a, b, name=None): return self._rec("bitwise_and", [a, b], name=name)
    def or_(self, a, b, name=None): return self._rec("bitwise_or", [a, b], name=name)
    def xor(self, a, b, name=None): return self._rec("bitwise_xor", [a, b], name=name)
    def leftShift(self, a, b, name=None): return self._rec("left_shift", [a, b], name=name)
    def rightShift(self, a, b, name=None): return self._rec("right_shift", [a, b], name=name)


class SDImage(_Namespace):
    """ref: ops.SDImage."""

    def resizeBiLinear(self, x, h, w, name=None):
        return self._rec("resize_bilinear", [x], name=name, size=(h, w))

    def resizeNearestNeighbor(self, x, h, w, name=None):
        return self._rec("resize_nearest_neighbor", [x], name=name,
                         size=(h, w))

    def nonMaxSuppression(self, boxes, scores, max_out, iou_threshold=0.5,
                          name=None):
        return self._rec("non_max_suppression", [boxes, scores], name=name,
                         max_out=max_out, iou_threshold=iou_threshold)


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
        self._listeners: List[Any] = []
        #: the seed of the graph's RNG nodes' step keys (the JAX fit's
        #: PRNGKey(0))
        self._seed = 0
        self._t_dev: Optional[torch.Tensor] = None   # the device clock
        #: the fit's dispatches by placeholder names, and the state
        #: tensors they were captured over (held, so none is freed)
        self._fit_dispatch: Dict[tuple, cc.CachedDispatch] = {}
        self._fit_owned: Optional[List[torch.Tensor]] = None
        self._fit_eager = False     # the loss needs a host-control node
        self._exec_backend = "torch"
        #: the native backend's executables by (outputs, placeholder
        #: signature, train), released with the graph
        self._native_cache: Dict[tuple, Any] = {}
        self._native_t: Optional[torch.Tensor] = None
        weakref.finalize(self, _release_native, self._native_cache)
        self.math = SDMath(self)
        self.nn = SDNN(self)
        self.cnn = SDCNN(self)
        self.rnn = SDRNN(self)
        self.loss = SDLoss(self)
        self.random = SDRandom(self)
        self.linalg = SDLinalg(self)
        self.bitwise = SDBitwise(self)
        self.image = SDImage(self)

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
        """A tensor on the graph's device, narrowed as :func:`_narrowed`
        narrows it."""
        return _narrowed(value).to(self.device)

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
        self._invalidate()
        outs = []
        for on in out_names:
            v = SDVariable(self, on, "ARRAY")
            self._vars[on] = v
            self._producers[on] = node
            outs.append(v)
        return outs[0] if n_out == 1 else tuple(outs)

    def _record_rng(self, op: str, input_names: List[str],
                    name: str = None, params: Dict = None):
        """Record an op that takes the step key and the train flag. Its
        callable is rebuilt from ``(op, params)``, here and at ``load()``,
        so RNG nodes serialize as the JAX package's do."""
        params = params or {}
        return self._record_fn(op, _make_rng_fn(op, params), input_names,
                               name=name, attrs={"__rng__": True, **params})

    def _invalidate(self):
        """Drop the fit's captured steps: the graph, its losses or its
        training configuration changed."""
        self._fit_dispatch = {}
        self._fit_owned = None
        _release_native(self._native_cache)

    def _rename(self, old: str, new: str):
        """Rename a variable everywhere it appears (``SDVariable.rename``;
        the TF importer aligns multi-output and deframed nodes' names with
        TF's refs)."""
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
        self._invalidate()

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
              output_names: Sequence[str], train: bool = False,
              t=None, key: "norm_ops.StepKey" = None
              ) -> Dict[str, torch.Tensor]:
        """Run the nodes the outputs need, in recorded order, on the
        graph's device. An RNG node ``i`` draws from ``key.fold(i)``,
        ``key`` by default ``StepKey(seed, t)`` with ``t`` the step clock
        (the Python step when None); ``train`` switches dropout on."""
        env = {**variables, **self._constants, **placeholders}
        if key is None:
            key = norm_ops.StepKey(self._seed,
                                   self._step if t is None else t)
        index = None
        for node in self._needed_nodes(output_names):
            args = [env[n] for n in node.inputs]
            if node.attrs.get("__rng__"):
                if index is None:
                    index = {id(nd): i for i, nd in enumerate(self._nodes)}
                res = node.fn(*args, key.fold(index[id(node)]), train,
                              self.device)
            else:
                res = node.fn(*args, **node.attrs)
            if len(node.outputs) == 1:
                env[node.outputs[0]] = res
            else:
                env.update(zip(node.outputs, res))
        return {o: env[o] for o in output_names}

    def _feed(self, placeholders) -> Dict[str, torch.Tensor]:
        return {k: self._as_tensor(v) for k, v in (placeholders or {}).items()}

    def output(self, placeholders: Dict[str, Any], outputs: Sequence[str],
               train: bool = False) -> Dict[str, torch.Tensor]:
        """ref: SameDiff.output / batchOutput; ``train=True`` runs dropout
        in training mode."""
        outputs = [o.name if isinstance(o, SDVariable) else o
                   for o in outputs]
        if self._exec_backend == "native":
            return self._exec_native(placeholders or {}, outputs, train)
        with torch.no_grad():
            return self._exec(self._variables, self._feed(placeholders),
                              outputs, train=train)

    # ------------------------------------------------------ native backend
    def setExecBackend(self, backend: str):
        """Execution backend for ``output()``/``batchOutput()``: ``"torch"``
        (the default, eager on the graph's device, where the JAX package's
        default is ``"jax"``) or ``"native"``, the C++ runtime over the
        CUDA driver (module doc)."""
        if backend not in ("torch", "native"):
            raise ValueError(f"unknown backend '{backend}'")
        self._exec_backend = backend
        return self

    def native_executables(self) -> list:
        """The native backend's executables (one a compiled key)."""
        return list(self._native_cache.values())

    def _native_feed(self, value) -> torch.Tensor:
        """A placeholder value as the native program takes it, narrowed
        as :func:`_narrowed` narrows it: a tensor stays where it is (on
        the card: copied device to device), anything else becomes a host
        tensor (copied host to device)."""
        return _narrowed(value).detach()

    def _native_device(self) -> torch.device:
        """The card the native programs of this graph capture and run
        on (``cuda`` without an index: the current one)."""
        if self.device.type == "cuda" and self.device.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return self.device

    def _native_program(self, outputs: Sequence[str], phs: Dict[str, Any],
                        train: bool) -> bytes:
        """The ``fmt="samediff"`` program of one key: every node, with the
        variables, the constants, the placeholders (at this call's shapes
        and dtypes) and the step clock as its inputs, in that order, and
        the device it captures on. Two graphs of one structure, signature
        and device give the same bytes."""
        def sig(t):
            return [list(t.shape), op_registry.dtype_name(t.dtype)]
        inputs = {**{k: sig(v) for k, v in self._variables.items()},
                  **{k: sig(v) for k, v in self._constants.items()},
                  **{k: sig(v) for k, v in phs.items()},
                  _NATIVE_STEP: [[], "int32"]}
        spec = {"ph_order": list(inputs), "placeholders": inputs,
                "consts": {}, "nodes": [_node_to_spec(n) for n in self._nodes],
                "outputs": list(outputs), "train": bool(train),
                "seed": self._seed, "device": str(self._native_device())}
        return json.dumps(spec, sort_keys=True).encode()

    def _exec_native(self, placeholders, outputs: List[str], train: bool):
        from deeplearning4j_tpu_torch.native import runtime as native_rt
        if self.device.type != "cuda":
            raise native_rt.NativeRuntimeError(
                f"the native backend runs on the card: this graph is on "
                f"{self.device} (SameDiff.create(device='cuda'), or the "
                "default eager backend)")
        phs = {k: self._native_feed(placeholders[k])
               for k in sorted(placeholders)}
        dev = self._native_device()
        key = (tuple(outputs), tuple((k, tuple(v.shape), str(v.dtype))
                                     for k, v in phs.items()), bool(train),
               dev)
        if self._native_t is None or self._native_t.device != dev:
            self._native_t = torch.zeros((), dtype=torch.int32, device=dev)
        self._native_t.fill_(self._step)
        inputs = [*self._variables.values(), *self._constants.values(),
                  *phs.values(), self._native_t]
        exe = self._native_cache.get(key)
        if exe is None or exe.released:
            exe = self._native_cache[key] = native_rt.get_runtime().compile(
                self._native_program(outputs, phs, train), "samediff",
                inputs=inputs)
        return dict(zip(outputs, exe(*inputs)))

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
        self._invalidate()

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
        self._invalidate()
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
        self._invalidate()
        return self

    def _total_loss(self, variables, placeholders, train: bool = False,
                    t=None) -> torch.Tensor:
        """The sum of the ``sum`` of every loss variable (the JAX
        package's ``_total_loss_fn``)."""
        names = tuple(self._loss_variables)
        if not names:
            raise ValueError("call setLossVariables first")
        outs = self._exec(variables, placeholders, names, train=train, t=t)
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
        self._invalidate()

    def setListeners(self, *listeners):
        """Listeners whose ``iterationDone(sd, step, loss)`` runs after
        each fit step (``loss`` on the device)."""
        self._listeners = list(listeners)

    def _train_step(self, phs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One step, as the JAX package's ``_make_train_step``: loss and
        gradients of every variable (dropout on, the RNG nodes keyed by
        the device clock), L1/L2, the three clips, then the updater at
        ``t`` = the clock and AdamW's decoupled decay on weights of ndim
        >= 2. The variables, the updater state and the clock change in
        place, so the step can be captured. Returns the loss on the
        device."""
        cfg = self.training_config
        updater = cfg.updater
        names = list(self._variables)
        t = self._t_dev
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self._variables.items()}
        with torch.enable_grad():
            loss = self._total_loss(leaves, phs, train=True, t=t)
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
            lr = updater.lr_at(t)
            decay = isinstance(updater, upd.AdamW) and updater.weight_decay
            for k, g in zip(names, grads):
                p = self._variables[k]
                state = self._updater_state[k]
                u, s2 = updater.apply(g, state, lr, t)
                if decay and p.dim() >= 2:
                    u = u + updater.weight_decay_update(p, lr)
                p.sub_(u)
                for sk, sv in s2.items():
                    if sv is not state[sk]:
                        state[sk].copy_(sv)
            t.add_(1)
        return loss.detach()

    def _fit_state(self) -> List[torch.Tensor]:
        """What the fit's step writes: the variables, the updater state
        and the device clock."""
        return cc.state_tensors(self._variables, self._updater_state,
                                self._t_dev)

    def _prepare_fit(self) -> None:
        """Once per fit: the updater state, the clock at the Python step,
        and (the first time, or after a caller replaced an array) the
        variables copied into storage the fit owns; the captured steps
        are dropped whenever that storage changed."""
        cfg = self.training_config
        if self._updater_state is None:
            self._updater_state = {k: cfg.updater.init_state(v)
                                   for k, v in self._variables.items()}
        if self._t_dev is None:
            self._t_dev = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        self._t_dev.fill_(self._step)
        owned = self._fit_owned
        state = self._fit_state()
        if owned is None or len(owned) != len(state) \
                or any(a is not b for a, b in zip(owned, state)):
            # an array the caller passed to var() (or set) must survive
            # the in-place updates: the fit trains copies of its own
            self._variables = {k: v.detach().clone()
                               for k, v in self._variables.items()}
            self._fit_dispatch = {}
            self._fit_owned = self._fit_state()
        self._fit_eager = bool(self.host_control_nodes())

    def host_control_nodes(self) -> List[str]:
        """The nodes the loss needs that read a value on the host (marked
        when recorded): a graph with any trains eagerly by design."""
        return [n.outputs[0] for n in self._needed_nodes(
            tuple(self._loss_variables)) if n.host]

    def _fit_step(self, phs: Dict[str, torch.Tensor]) -> torch.Tensor:
        names = tuple(sorted(phs))
        if self._fit_eager:
            cc.note_eager_by_design()
            return self._train_step(phs)
        d = self._fit_dispatch.get(names)
        if d is None:
            def step(*args):
                return self._train_step(dict(zip(names, args)))
            d = self._fit_dispatch[names] = cc.CachedDispatch(
                step, "samediff:fit", state=self._fit_state,
                always_capture=True)
        return d(*(phs[n] for n in names))

    def fit_dispatches(self) -> List[cc.CachedDispatch]:
        """The fit's dispatches (one a placeholder-name set), for their
        captures and the launches recorded into them."""
        return list(self._fit_dispatch.values())

    def fit(self, data=None, epochs: int = 1, batch_size: int = None,
            iterator=None) -> History:
        """ref: SameDiff.fit. ``data``: an iterable of batches, each a
        dict ``{placeholder: array}`` or a ``(features, labels)`` pair
        mapped through the TrainingConfig's names, or a dict of full
        arrays (minibatched by ``batch_size``). Each step is one replay
        of the captured step for its placeholder signature on the card
        (eagerly on the CPU, and by design for a graph with host control
        flow). The losses stay on the device until the end of each
        epoch."""
        if self.training_config is None:
            raise ValueError("setTrainingConfig first")
        cfg = self.training_config
        self._prepare_fit()

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
                loss = self._fit_step(self._feed(batch))
                losses.append(loss)
                self._step += 1
                for lst in self._listeners:
                    if hasattr(lst, "iterationDone"):
                        lst.iterationDone(self, self._step, loss)
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
            if _sub_has_rng(attrs["cond"], attrs["body"]):
                attrs["__rng__"] = True
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
            if _sub_has_rng(attrs["true"], attrs["false"]):
                attrs["__rng__"] = True
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
        if _sub_has_rng(attrs["sub"]):
            attrs["__rng__"] = True
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
                    if node.attrs.get("__rng__"):
                        res = node.fn(*args, norm_ops.StepKey(0, 0), False,
                                      torch.device("meta"))
                    else:
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


#: the native program's last input: the step clock its RNG nodes draw from
_NATIVE_STEP = "__native_step__"


def _release_native(cache: Dict[tuple, Any]) -> None:
    """Release a graph's native executables (its captures' memory goes
    with the last handle on each)."""
    for exe in cache.values():
        exe.release()
    cache.clear()


def _node_to_spec(node: _Node) -> dict:
    """JSON-able spec of one node."""
    spec = {"op": node.op, "inputs": node.inputs, "outputs": node.outputs,
            "attrs": {k: v for k, v in node.attrs.items() if k != "__rng__"},
            "rng": bool(node.attrs.get("__rng__"))}
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
        if nd_spec.get("rng"):
            # control-flow nodes whose bodies hold RNG ops take the key too
            attrs["__rng__"] = True
    elif nd_spec.get("rng"):
        fn = _make_rng_fn(nd_spec["op"], attrs)
        attrs["__rng__"] = True
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
        # the containing node passes (key, train) on when True, so
        # dropout and draws inside control-flow bodies stay live
        "has_rng": any(n.attrs.get("__rng__") for n in sub._nodes),
    }


def subgraph_from_spec(spec: dict, device=None) -> "SameDiff":
    """The graph of a :func:`subgraph_spec` on ``device`` (``cuda``
    unless the caller names another)."""
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
    """A subgraph spec as ``call(*args, key=None, train=False) ->
    tuple(outputs)``, the args bound to the placeholders in declared
    order; RNG nodes inside draw from ``key`` folded with their index.
    The subgraph is built on the device of the first tensor argument
    when first called there (``cuda`` when no argument is a tensor)."""
    outputs = tuple(spec["outputs"])
    ph_names = spec["ph_order"]
    subs: Dict[torch.device, SameDiff] = {}

    def call(*args, key=None, train=False):
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   None) or resolve_device(None)
        sub = subs.get(dev)
        if sub is None:
            sub = subs[dev] = subgraph_from_spec(spec, dev)
        outs = sub._exec({}, {k: sub._as_tensor(a)
                              for k, a in zip(ph_names, args)}, outputs,
                         train=train, key=key)
        return tuple(outs[n] for n in outputs)
    return call


def _sub_has_rng(*specs) -> bool:
    return any(s.get("has_rng") for s in specs)


def _with_rng(run: Callable, rng: bool) -> Callable:
    """A control-flow node's callable: with RNG bodies the executor
    appends ``(key, train, device)`` to its arguments."""
    if rng:
        def fn(*all_args, **_kw):
            *args, key, train, _device = all_args
            return run(args, key, train)
        return fn
    return lambda *args, **_kw: run(args, None, False)


def _make_subwhile_fn(attrs: dict) -> Callable:
    """A loop over subgraph bodies: a Python loop on the device, the
    predicate read on the host once an iteration."""
    cond = subgraph_fn(attrs["cond"])
    body = subgraph_fn(attrs["body"])
    n = len(attrs["body"]["outputs"])

    def run(args, key, train):
        c = tuple(args)
        while bool(cond(*c, key=key, train=train)[0].reshape(())):
            c = body(*c, key=key, train=train)
        return c if n > 1 else c[0]
    return _with_rng(run, _sub_has_rng(attrs["cond"], attrs["body"]))


def _make_subcond_fn(attrs: dict) -> Callable:
    tfn = subgraph_fn(attrs["true"])
    ffn = subgraph_fn(attrs["false"])
    n = len(attrs["true"]["outputs"])

    def run(args, key, train):
        p, *rest = args
        res = (tfn if bool(p.reshape(())) else ffn)(*rest, key=key,
                                                    train=train)
        return res if n > 1 else res[0]
    return _with_rng(run, _sub_has_rng(attrs["true"], attrs["false"]))


def _make_subcall_fn(attrs: dict) -> Callable:
    """An inline function call: one node that runs a whole subgraph
    (differentiable: autograd runs straight through)."""
    sub = subgraph_fn(attrs["sub"])
    n = len(attrs["sub"]["outputs"])

    def run(args, key, train):
        res = sub(*args, key=key, train=train)
        return res if n > 1 else res[0]
    return _with_rng(run, _sub_has_rng(attrs["sub"]))


def _uniform01(key, shape, device) -> torch.Tensor:
    """fp32 uniforms in [0, 1) on a 2^-24 grid from ``key`` alone."""
    n = 1
    for d in shape:
        n *= int(d)
    u = norm_ops.hash24(key, n, device).float() * (2.0 ** -24)
    return u.reshape(tuple(shape))


def _draw_uniform(key, shape, device, minval=0.0, maxval=1.0):
    return minval + (maxval - minval) * _uniform01(key, shape, device)


def _draw_normal(key, shape, device, mean=0.0, stddev=1.0):
    return mean + stddev * norm_ops.normal_draw(key, shape, device)


def _draw_bernoulli(key, shape, device, p=0.5):
    return _uniform01(key, shape, device) < p


#: the SDRandom ops as counter draws (module doc)
_COUNTER_DRAWS = {"random_uniform": _draw_uniform,
                  "random_normal": _draw_normal,
                  "random_bernoulli": _draw_bernoulli}


def _make_rng_fn(op: str, params: Dict) -> Callable:
    """The callable of an RNG node from its serializable params, at record
    time and at ``load()``: ``fn(*inputs, key, train, device)``."""
    params = {k: v for k, v in params.items() if k != "__rng__"}
    if op == "dropout":
        rate = float(params["rate"])
        return lambda x, key, train, _device=None: norm_ops.dropout(
            x, rate, key, train=train)
    draw = _COUNTER_DRAWS.get(op)
    if draw is None:
        raise NotImplementedError(
            f"RNG node '{op}': the port draws dropout and "
            f"{sorted(_COUNTER_DRAWS)}")
    shape = tuple(int(d) for d in params.pop("shape"))
    return lambda key, train, device: draw(key, shape, device, **params)


def _dims(axis):
    return None if axis is None else tuple(axis) \
        if isinstance(axis, (tuple, list)) else (int(axis),)


def _make_std_fn(attrs):
    return lambda v, axis=None: torch.std(v, dim=_dims(axis), correction=1)


def _make_variance_fn(attrs):
    return lambda v, axis=None: torch.var(v, dim=_dims(axis), correction=1)


def _make_mha_fn(attrs):
    """The multiHeadDotProductAttention closure; a recorded mask is a
    graph input, passed positionally after the six weights."""
    inner = op_registry.get("multi_head_dot_product_attention")
    if attrs.get("has_mask"):
        def fn(q, kv, wq, wk, wv, wo, m, num_heads=None, has_mask=True):
            return inner(q, kv, wq, wk, wv, wo, num_heads=num_heads, mask=m)
    else:
        def fn(q, kv, wq, wk, wv, wo, num_heads=None, has_mask=False):
            return inner(q, kv, wq, wk, wv, wo, num_heads=num_heads)
    return fn


# rebuild-key -> closure builder; save() records the key, load() calls it
# (the TF importer adds "tf")
_FN_REBUILDERS = {"getitem": _make_getitem_fn,
                  "std": _make_std_fn,
                  "variance": _make_variance_fn,
                  "multi_head_dot_product_attention": _make_mha_fn,
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
