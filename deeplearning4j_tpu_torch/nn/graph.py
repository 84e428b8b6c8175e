"""ComputationGraph — DAG networks with graph vertices (the port of
``deeplearning4j_tpu/nn/graph.py``).

The JAX package traces the whole step into one compiled program; the
port runs the shared step of :mod:`.network`: one forward,
``torch.autograd.grad`` of the loss, gradient normalization and the
updater in place on the fp32 master params, eager or captured as a CUDA
graph (K steps a dispatch with ``fit(steps_per_dispatch=K)``). The forward (``_forward``) follows the JAX one node for
node, including the input preprocessors, the NHWC compute layout, the
per-layer dropout keys, the fused BN + activation epilogue with its
conv-bias fold, the re-biased copy of a folded conv that has other
consumers, and the fp32/bf16 alignment at vertices. ``evaluate``,
``summary``, ``save``/``load`` (the JAX package's archive and JSON) and
``clone`` are the reference's. uint8 inputs (image bytes from the staged
pipeline) are cast on the device: to fp32 when no compute dtype is set,
as JAX graph.py:474-476 does, and to the policy's dtype at the first
layer otherwise (``layers.policy_cast``). ``fit`` also takes
``MultiDataSet`` batches (every graph input and output), one step or K
steps a dispatch.

Every vertex of the JAX package is here; ElementWise, Scale and Shift
keep an NHWC activation when all their inputs are NHWC, every other
vertex is handed NCHW, as in the JAX forward.

A DataSet's ``features_mask`` ([N, T]) reaches the mask-aware layers
(``_MASK_AWARE``) in training and in ``score``; ``output()`` and
``feedForward`` (every node's activation, for naming the first layer
where two forwards part) take none, as in the JAX package. (The JAX graph's own
train step passes none to its forward; the port's passes it, as the
sequential network's does.) The graph has no truncated BPTT and no
``rnnTimeStep``, in either package.

The fit's surroundings are :mod:`.network`'s: listeners, the
``train.resilience`` session, dynamic loss scaling, and the device
augmentation, which runs on every 4-D graph input (others pass through,
as in the JAX graph) and hands the forward fp32, so the uint8 cast above
does not run again.

Not ported yet (ROADMAP.md): sharding, the compile cache's disk tier.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import preprocessors as pp
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.network import BaseNetwork
from deeplearning4j_tpu_torch.ops.normalization import StepKey, dtype_scalar
from deeplearning4j_tpu_torch.profiler import devicetime as _dt


class GraphVertex:
    """Non-layer DAG node (ref: org.deeplearning4j.nn.conf.graph.*Vertex)."""

    def apply(self, *inputs):
        raise NotImplementedError

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def to_config(self):
        d = {"@class": type(self).__name__}
        d.update({k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in self.__dict__.items()})
        return d

    @classmethod
    def from_config(cls, d):
        obj = cls.__new__(cls)
        for k, v in d.items():
            if k != "@class":
                setattr(obj, k, v)
        return obj


class MergeVertex(GraphVertex):
    """Concat along the channel/feature axis (ref: MergeVertex)."""

    def apply(self, *inputs):
        axis = 1 if inputs[0].dim() >= 3 else -1
        return torch.cat(inputs, dim=axis)

    def output_type(self, *its: InputType) -> InputType:
        it = its[0]
        if it.kind == "cnn":
            return InputType.convolutional(it.height, it.width,
                                           sum(i.channels for i in its))
        return InputType.feedForward(sum(i.arrayElementsPerExample()
                                         for i in its))


class ElementWiseVertex(GraphVertex):
    """Add/Product/Subtract/Average/Max of same-shape inputs
    (ref: ElementWiseVertex). The ResNet residual add."""

    def __init__(self, op: str = "Add"):
        self.op = op.lower()

    def apply(self, *inputs):
        if self.op == "add":
            out = inputs[0]
            for i in inputs[1:]:
                out = out + i
            return out
        if self.op == "product":
            out = inputs[0]
            for i in inputs[1:]:
                out = out * i
            return out
        if self.op == "subtract":
            return inputs[0] - inputs[1]
        if self.op == "average":
            return sum(inputs) / len(inputs)
        if self.op == "max":
            out = inputs[0]
            for i in inputs[1:]:
                out = torch.maximum(out, i)
            return out
        raise ValueError(self.op)


class DotProductVertex(GraphVertex):
    """Per-example dot product of two [N, C] inputs, optionally of their
    L2-normalized rows (norms at least 1e-12); [N, 1] out (the Keras
    ``Dot`` merge)."""

    def __init__(self, normalize: bool = False):
        self.normalize = normalize

    def apply(self, a, b):
        if a.dim() != 2 or b.dim() != 2:
            raise ValueError(
                f"DotProductVertex supports rank-2 [N, C] inputs (got ranks "
                f"{a.dim()}/{b.dim()})")
        if self.normalize:
            a = a / torch.clamp_min(
                torch.linalg.vector_norm(a, dim=-1, keepdim=True), 1e-12)
            b = b / torch.clamp_min(
                torch.linalg.vector_norm(b, dim=-1, keepdim=True), 1e-12)
        return (a * b).sum(dim=-1, keepdim=True)

    def output_type(self, *its: InputType) -> InputType:
        return InputType.feedForward(1)


class SubsetVertex(GraphVertex):
    """Channels (features) ``frm`` to ``to`` inclusive (ref: SubsetVertex)."""

    def __init__(self, frm: int, to: int):
        self.frm, self.to = frm, to

    def apply(self, x):
        return x[:, self.frm:self.to + 1]

    def output_type(self, it: InputType) -> InputType:
        n = self.to - self.frm + 1
        if it.kind == "cnn":
            return InputType.convolutional(it.height, it.width, n)
        if it.kind == "rnn":
            return InputType.recurrent(n, it.dims.get("timesteps", -1))
        return InputType.feedForward(n)


class L2NormalizeVertex(GraphVertex):
    """Each example divided by its L2 norm over every other axis, the norm
    at least ``eps`` (ref: L2NormalizeVertex; FaceNet's embedding)."""

    def __init__(self, eps: float = 1e-8):
        self.eps = eps

    def apply(self, x):
        flat = x.reshape(x.shape[0], -1)
        n = torch.sqrt((flat * flat).sum(dim=1, keepdim=True))
        return (flat / torch.clamp_min(n, self.eps)).reshape(x.shape)


class ScaleVertex(GraphVertex):
    """``x * scale`` (ref: ScaleVertex), the scalar rounded to x's dtype
    first as jnp rounds a weakly typed one."""

    def __init__(self, scale: float):
        self.scale = scale

    def apply(self, x):
        return x * dtype_scalar(self.scale, x.dtype)


class ShiftVertex(GraphVertex):
    """``x + shift`` (ref: ShiftVertex), rounded as ScaleVertex's."""

    def __init__(self, shift: float):
        self.shift = shift

    def apply(self, x):
        return x + dtype_scalar(self.shift, x.dtype)


class StackVertex(GraphVertex):
    """Inputs stacked along the batch axis (ref: StackVertex)."""

    def apply(self, *inputs):
        return torch.cat(inputs, dim=0)


class UnstackVertex(GraphVertex):
    """Slice ``frm`` of ``stack_size`` equal batch slices (ref:
    UnstackVertex)."""

    def __init__(self, frm: int, stack_size: int):
        self.frm, self.stack_size = frm, stack_size

    def apply(self, x):
        n = x.shape[0] // self.stack_size
        return x[self.frm * n:(self.frm + 1) * n]


class PreprocessorVertex(GraphVertex):
    """An input preprocessor as a vertex (ref: PreprocessorVertex). Its
    JSON names a class of :mod:`.preprocessors` and its attributes."""

    def __init__(self, preproc):
        self.preproc = preproc

    def apply(self, x):
        return self.preproc(x)

    def output_type(self, it: InputType) -> InputType:
        return self.preproc.output_type(it)

    def to_config(self):
        return {"@class": "PreprocessorVertex",
                "preproc_class": type(self.preproc).__name__,
                "preproc_args": dict(self.preproc.__dict__)}

    @classmethod
    def from_config(cls, d):
        pc = getattr(pp, d["preproc_class"])
        obj = pc.__new__(pc)
        obj.__dict__.update(d["preproc_args"])
        return PreprocessorVertex(obj)


_VERTEX_CLASSES = {c.__name__: c for c in (
    MergeVertex, ElementWiseVertex, SubsetVertex, DotProductVertex,
    L2NormalizeVertex, ScaleVertex, ShiftVertex, StackVertex, UnstackVertex,
    PreprocessorVertex)}

#: layers that take the feature mask (the JAX package's tuple; GRU is not
#: one)
_MASK_AWARE = (L.LSTM, L.SimpleRnn, L.Bidirectional, L.LastTimeStep,
               L.GlobalPoolingLayer, L.SelfAttentionLayer,
               L.RecurrentAttentionLayer)

#: vertices that keep NHWC when every input is NHWC (elementwise); every
#: other vertex is handed NCHW (JAX nn/graph.py:537-558)
_LAYOUT_TRANSPARENT_VERTICES = (ElementWiseVertex, ScaleVertex, ShiftVertex)


class _GraphNode:
    def __init__(self, name: str, kind: str, obj, inputs: List[str]):
        self.name = name
        self.kind = kind      # 'layer' | 'vertex'
        self.obj = obj
        self.inputs = inputs


class GraphBuilder:
    """ref: ComputationGraphConfiguration.GraphBuilder."""

    def __init__(self, base: NeuralNetConfiguration):
        self.base = base
        self.nodes: List[_GraphNode] = []
        self.graph_inputs: List[str] = []
        self.graph_outputs: List[str] = []
        self.input_types: Dict[str, InputType] = {}

    def addInputs(self, *names):
        self.graph_inputs.extend(names)
        return self

    def setInputTypes(self, *types):
        for name, t in zip(self.graph_inputs, types):
            self.input_types[name] = t
        return self

    def addLayer(self, name: str, layer, *inputs):
        layer.name = name
        self.nodes.append(_GraphNode(name, "layer", layer, list(inputs)))
        return self

    def addVertex(self, name: str, vertex: GraphVertex, *inputs):
        self.nodes.append(_GraphNode(name, "vertex", vertex, list(inputs)))
        return self

    def setOutputs(self, *names):
        self.graph_outputs = list(names)
        return self

    def build(self) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration(self)

    def validate(self, batch_size: int = None, data_devices: int = None,
                 **kw):
        """Static lint of the (possibly not-yet-buildable) graph — unlike
        ``build()``, a cyclic or dangling graph comes back as E002/E003
        diagnostics instead of a ValueError. Extra keywords pass through
        to ``analysis.analyze`` (``mesh=``, ``suppress=``, ...)."""
        from deeplearning4j_tpu_torch.analysis import analyze
        return analyze(self, batch_size=batch_size,
                       data_devices=data_devices, **kw)


class ComputationGraphConfiguration:
    """ref: org.deeplearning4j.nn.conf.ComputationGraphConfiguration, with
    input preprocessors inserted by node name while types propagate and
    the JAX package's JSON (``to_json``/``from_json``)."""

    def __init__(self, builder: GraphBuilder):
        self.base = builder.base
        self.nodes = builder.nodes
        self.graph_inputs = builder.graph_inputs
        self.graph_outputs = builder.graph_outputs
        self.input_types = builder.input_types
        self.preprocessors: Dict[str, Any] = {}
        self.node_by_name = {n.name: n for n in self.nodes}
        self._toposort()
        if self.input_types:
            self._propagate_types()

    def validate(self, batch_size: int = None, data_devices: int = None,
                 **kw):
        """Static lint — see ``deeplearning4j_tpu_torch.analysis.analyze``."""
        from deeplearning4j_tpu_torch.analysis import analyze
        return analyze(self, batch_size=batch_size,
                       data_devices=data_devices, **kw)

    def _toposort(self):
        order, seen = [], set(self.graph_inputs)
        remaining = list(self.nodes)
        while remaining:
            progressed = False
            for n in list(remaining):
                if all(i in seen for i in n.inputs):
                    order.append(n)
                    seen.add(n.name)
                    remaining.remove(n)
                    progressed = True
            if not progressed:
                missing = {i for n in remaining for i in n.inputs
                           if i not in seen}
                raise ValueError(f"graph has unresolved inputs/cycle: "
                                 f"{missing}")
        self.topo = order

    def _propagate_types(self):
        types: Dict[str, InputType] = dict(self.input_types)
        for node in self.topo:
            in_types = [types[i] for i in node.inputs]
            if node.kind == "layer":
                layer = node.obj
                pre = pp.preprocessor_for(in_types[0], layer)
                if pre is not None:
                    self.preprocessors[node.name] = pre
                    in_types[0] = pre.output_type(in_types[0])
                layer.set_defaults(self.base)
                layer.infer_nin(in_types[0])
                types[node.name] = layer.output_type(in_types[0])
            else:
                types[node.name] = node.obj.output_type(*in_types)
        self.types = types

    def to_json(self) -> str:
        return json.dumps({
            "base": self.base.to_config(),
            "inputs": self.graph_inputs,
            "outputs": self.graph_outputs,
            "input_types": {k: v.to_config()
                            for k, v in self.input_types.items()},
            "nodes": [{"name": n.name, "kind": n.kind,
                       "inputs": n.inputs, "conf": n.obj.to_config()}
                      for n in self.nodes],
        })

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)
        b = GraphBuilder(NeuralNetConfiguration.from_config(d["base"]))
        b.addInputs(*d["inputs"])
        b.input_types = {k: InputType.from_config(v)
                         for k, v in d["input_types"].items()}
        for nd in d["nodes"]:
            if nd["kind"] == "layer":
                b.addLayer(nd["name"], L.layer_from_config(nd["conf"]),
                           *nd["inputs"])
                continue
            name = nd["conf"]["@class"]
            if name not in _VERTEX_CLASSES:
                raise NotImplementedError(
                    f"vertex class {name!r} is not ported (known: "
                    f"{sorted(_VERTEX_CLASSES)})")
            b.addVertex(nd["name"], _VERTEX_CLASSES[name].from_config(
                nd["conf"]), *nd["inputs"])
        b.setOutputs(*d["outputs"])
        return ComputationGraphConfiguration(b)


class ComputationGraph(BaseNetwork):
    """DAG network (ref: org.deeplearning4j.nn.graph.ComputationGraph)."""

    def __init__(self, conf: ComputationGraphConfiguration):
        super().__init__(conf)
        self._params: Dict[str, Dict[str, torch.Tensor]] = {}
        self._states: Dict[str, Dict[str, torch.Tensor]] = {}
        self._epilogue_shared = None
        fmt = getattr(conf.base, "compute_layout", None)
        if fmt and fmt != "NCHW":
            self.setComputeLayout(fmt)

    def _layers(self):
        return [(n.name, n.obj) for n in self.conf.topo if n.kind == "layer"]

    def _leaf_keys(self):
        """Node names sorted, then param names sorted (the JAX pytree's
        leaf order)."""
        return [(n, k) for n in sorted(self._params)
                for k in sorted(self._params[n])]

    def init(self, seed: int = None, device=None,
             strict: bool = False) -> "ComputationGraph":
        """Initialize params (from a seeded ``torch.Generator``; the
        draws differ from the JAX package's, see :meth:`params_from_jax`)
        and layer states on ``device``: the card unless the caller names
        another; without a card and without ``device`` this raises.
        ``strict=True`` runs the static analyzer first and raises
        ``ModelValidationError`` on any E-code diagnostic, before any
        parameter is allocated."""
        if strict:
            self.validate().raise_if_errors()
        self._device = resolve_device(device)
        seed = self.conf.base.seed if seed is None else seed
        gen = torch.Generator().manual_seed(int(seed))
        self._params, self._states = {}, {}
        for node in self.conf.topo:
            if node.kind == "layer":
                p, s = node.obj.initialize(gen)
                self._params[node.name] = {
                    k: v.to(self._device).requires_grad_(True)
                    for k, v in p.items()}
                self._states[node.name] = {k: v.to(self._device)
                                           for k, v in s.items()}
        self._reset_training_state()
        self._initialized = True
        return self

    def params_from_jax(self, params, states, device=None
                        ) -> "ComputationGraph":
        """Carry the JAX package's ``{node: {"W", "b", "gamma", "beta"}}``
        params and ``{node: {"mean", "var"}}`` states over (each leaf
        through ``np.asarray``, as fp32) into this graph on ``device``.
        The updater state and the iteration count start afresh."""
        self._device = resolve_device(device)
        self._adopt_jax(params, states)
        return self

    # --------------------------------------------------------------- forward
    def _forward(self, params, states, inputs: Dict[str, Any], train,
                 key: Optional[StepKey] = None, fmask=None, visit=None):
        """The forward; ``key`` is the train step's dropout key: the k-th
        layer node in topological order draws from ``key.fold(k)`` (the
        JAX forward splits its key once a layer node, vertices take
        none); ``fmask`` goes to the mask-aware layers.
        ``visit(name, node_obj, cast_params_or_None, out)``, when given,
        sees every node's output in topological order (a folded
        activation with its BN's output, a vertex with no params): the
        sanitizer's eager walk. While ``profiler.devicetime`` records,
        each node at topological position i runs in its scope
        ``dl4j_L<i>_<name>``."""
        rec = _dt.recorder()
        cdt = self._compute_dtype()
        nhwc = self._compute_layout == "NHWC"
        plan = self._ensure_epilogue_plan() if self._fuse_epilogues else {}
        fused_act = {act: bn for bn, (act, _c, _a) in plan.items()}
        fused_conv = {c for _a, c, _al in plan.values() if c}
        shared = self._epilogue_shared if self._fuse_epilogues else set()
        env = {k: (v.float() if cdt is None and v.dtype == torch.uint8
                   else v)
               for k, v in inputs.items()}    # on-device image-byte cast
        fmt = {k: False for k in env}        # node name -> output is NHWC
        pending_bias: Dict[str, Any] = {}    # fused conv name -> cast bias
        # shared folded convs: env[] holds the BIAS-LESS output (what the
        # fused BN wants); every other consumer reads this re-biased copy
        biased: Dict[str, Any] = {}

        def read(name, consumer=None):
            if name in biased:
                if consumer is not None and consumer in plan \
                        and plan[consumer][1] == name:
                    return env[name]     # the anchor BN folds the bias
                return biased[name]
            return env[name]

        new_states = {}
        ordinal = self._layer_ordinals()
        for ti, node in enumerate(self.conf.topo):
            if node.name in fused_act:
                # folded into its BN's scale_shift_act epilogue
                env[node.name] = env[fused_act[node.name]]
                fmt[node.name] = fmt[fused_act[node.name]]
                new_states[node.name] = states[node.name]
                if visit is not None:
                    visit(node.name, node.obj, None, env[node.name])
                continue
            if node.kind == "layer":
                x = read(node.inputs[0], node.name)
                cur_nhwc = fmt[node.inputs[0]]
                if node.name in self.conf.preprocessors:
                    if cur_nhwc:
                        x, cur_nhwc = L.to_nchw(x), False
                    x = self.conf.preprocessors[node.name](x)
                x, cur_nhwc = L.layout_step(node.obj, x, cur_nhwc, nhwc)
                sub = None if key is None else key.fold(ordinal[node.name])
                with _dt.layer_scope(rec, ti, node.name):
                    p = params[node.name]
                    if cdt is not None:
                        p, x = L.policy_cast(node.obj, p, x, cdt)
                    if node.name in plan:          # BN anchoring a fusion
                        _act, conv_name, alpha = plan[node.name]
                        out, ns = L.fused_bn_act(
                            node.obj, p, states[node.name], x, train, alpha,
                            bias=pending_bias.pop(conv_name, None))
                    elif node.name in fused_conv:  # bias folds into the BN
                        out, ns = node.obj.apply(p, states[node.name], x,
                                                 train, sub, skip_bias=True)
                        pending_bias[node.name] = p.get("b")
                        if node.name in shared:
                            biased[node.name] = L.conv_bias_add(
                                node.obj, out, p.get("b"))
                    elif isinstance(node.obj, _MASK_AWARE):
                        out, ns = node.obj.apply(p, states[node.name], x,
                                                 train, sub, mask=fmask)
                    else:
                        out, ns = node.obj.apply(p, states[node.name], x,
                                                 train, sub)
                new_states[node.name] = ns
                fmt[node.name] = cur_nhwc and out.dim() == 4
            else:
                p = None
                xs = [read(i) for i in node.inputs]
                in_fmts = [fmt[i] for i in node.inputs]
                if isinstance(node.obj, _LAYOUT_TRANSPARENT_VERTICES) \
                        and any(in_fmts) and all(in_fmts):
                    out_nhwc = True                # elementwise: keep NHWC
                else:
                    xs = [L.to_nchw(a) if f else a
                          for a, f in zip(xs, in_fmts)]
                    out_nhwc = False
                if cdt is not None and len(xs) > 1 \
                        and any(a.dtype == torch.bfloat16 for a in xs):
                    # align mixed fp32/bf16 inputs (a BN branch meeting a
                    # conv branch)
                    xs = [a.to(torch.bfloat16) if a.dtype == torch.float32
                          else a for a in xs]
                with _dt.layer_scope(rec, ti, node.name):
                    out = node.obj.apply(*xs)
                fmt[node.name] = out_nhwc and out.dim() == 4
            env[node.name] = out
            if visit is not None:
                visit(node.name, node.obj, p, out)
        return [L.to_nchw(read(o)) if fmt.get(o) else read(o)
                for o in self.conf.graph_outputs], new_states

    def feedForward(self, inputs, train: bool = False
                    ) -> Dict[str, torch.Tensor]:
        """Every node's activation by name, in the public NCHW layout
        (ref: ComputationGraph.feedForward): unfused, no mask, the k-th
        layer node in topological order drawing dropout from
        ``StepKey(0, 0).fold(k)``, as the JAX one splits its fixed key."""
        self._require_init()
        env = self._as_input_dict(inputs)
        nhwc = self._compute_layout == "NHWC"
        fmt = {k: False for k in env}
        key, ordinal = StepKey(0, 0), self._layer_ordinals()
        acts: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for node in self.conf.topo:
                if node.kind == "layer":
                    x, cur_nhwc = env[node.inputs[0]], fmt[node.inputs[0]]
                    if node.name in self.conf.preprocessors:
                        if cur_nhwc:
                            x, cur_nhwc = L.to_nchw(x), False
                        x = self.conf.preprocessors[node.name](x)
                    x, cur_nhwc = L.layout_step(node.obj, x, cur_nhwc, nhwc)
                    out, _ = node.obj.apply(
                        self._params[node.name], self._states[node.name], x,
                        train, key.fold(ordinal[node.name]))
                    fmt[node.name] = cur_nhwc and out.dim() == 4
                else:
                    out = node.obj.apply(*[L.to_nchw(env[i]) if fmt[i]
                                           else env[i] for i in node.inputs])
                    fmt[node.name] = False
                env[node.name] = out
                acts[node.name] = L.to_nchw(out) if fmt[node.name] else out
        return acts

    def _layer_ordinals(self) -> Dict[str, int]:
        """Each layer node's position among the layer nodes in topological
        order (its dropout key's fold)."""
        names = [n.name for n in self.conf.topo if n.kind == "layer"]
        return {name: k for k, name in enumerate(names)}

    def _as_input_dict(self, inputs) -> Dict[str, torch.Tensor]:
        if isinstance(inputs, dict):
            return {k: self._to_device(v) for k, v in inputs.items()}
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        return {name: self._to_device(a)
                for name, a in zip(self.conf.graph_inputs, inputs)}

    def output(self, *inputs, train: bool = False):
        """ref: ComputationGraph.output — the output tensor(s), on the
        graph's device (a list if the graph has several outputs)."""
        self._require_init()
        ins = self._as_input_dict(inputs[0] if len(inputs) == 1
                                  else list(inputs))
        with torch.no_grad():
            outs, _ = self._forward(self._params, self._states, ins, train,
                                    StepKey(0, 0))
        return outs[0] if len(outs) == 1 else outs

    # ------------------------------------------------------------------ loss
    def _output_layers(self):
        outs = []
        for name in self.conf.graph_outputs:
            node = self.conf.node_by_name[name]
            if node.kind != "layer" or \
                    not isinstance(node.obj, L.BaseOutputLayer):
                raise ValueError(f"graph output '{name}' must be an output "
                                 "layer")
            outs.append(node.obj)
        return outs

    def _loss_and_reg(self, params, states, ins, labels: List, train,
                      lmasks: Optional[List], key=None, fmask=None):
        outs, new_states = self._forward(params, states, ins, train, key,
                                         fmask)
        loss = 0.0
        for i, (ol, out) in enumerate(zip(self._output_layers(), outs)):
            lm = lmasks[i] if lmasks is not None else None
            loss = loss + ol.compute_loss(labels[i], out, mask=lm)
        reg = self._regularization(
            (layer, params.get(name) or {}) for name, layer in self._layers())
        return loss + reg, new_states

    def _pack(self, x, y, lmask, train: bool):
        """The first graph input's features, the labels and, in training,
        the label mask (the graph's score, as the JAX one, reads none)."""
        masks = [lmask] if train and lmask is not None else None
        return {self.conf.graph_inputs[0]: x}, [y], masks

    def _multi_step(self, n_in: int, n_out: int, masked: bool):
        """The train step on a MultiDataSet's flat arguments: ``n_in``
        features (the graph's inputs, in order), ``n_out`` labels, then a
        label mask an output when ``masked``."""
        def step(*flat):
            ins = dict(zip(self.conf.graph_inputs, flat[:n_in]))
            labels = list(flat[n_in:n_in + n_out])
            masks = list(flat[n_in + n_out:]) if masked else None
            return self._step_on(ins, labels, masks)
        return step

    def score(self, ds=None) -> float:
        """As :meth:`BaseNetwork.score`; a MultiDataSet feeds every graph
        input and output (no label masks, as the JAX graph's score)."""
        if not isinstance(ds, MultiDataSet):
            return super().score(ds)
        self._require_init()
        ins = self._as_input_dict(list(ds.features))
        labels = [self._to_device(a) for a in ds.labels]
        with torch.no_grad():
            loss, _ = self._loss_and_reg(self._params, self._states, ins,
                                         labels, False, None)
        return float(loss)

    def getLayer(self, name: str):
        return self.conf.node_by_name[name].obj

    def summary(self) -> str:
        lines = ["=" * 78,
                 f"{'Name (Type)':<38}{'In':<20}{'Params':<10}", "=" * 78]
        total = 0
        for node in self.conf.topo:
            n = sum(v.numel() for v in self._params.get(node.name,
                                                         {}).values())
            total += n
            lines.append(f"{f'{node.name} ({type(node.obj).__name__})':<38}"
                         f"{','.join(node.inputs):<20}{n:<10}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)

    # ------------------------------------------------------------ save / load
    def save(self, path: str, save_updater: bool = True):
        """The JAX package's archive (``train.serializer``), written
        atomically."""
        from deeplearning4j_tpu_torch.train import serializer as ser
        self._require_init()
        meta, arrays = ser.archive_arrays(
            self, lambda kind, n, name: f"{kind}::{n}::{name}", save_updater)
        ser.write_model_zip(path, self.conf.to_json(), meta, arrays)

    @staticmethod
    def load(path: str, load_updater: bool = True,
             device=None) -> "ComputationGraph":
        """An archive of either package, on ``device`` (the card unless the
        caller names another). Raises ``serializer.CorruptModelError``
        naming the bad entry of a damaged archive."""
        from deeplearning4j_tpu_torch.train import serializer as ser
        conf_json, meta, arrays = ser.read_model_zip(path)
        try:
            conf = ComputationGraphConfiguration.from_json(conf_json)
        except Exception as e:
            raise ser.CorruptModelError(
                path, "conf.json", f"unparseable configuration ({e})") from e
        net = ComputationGraph(conf).init(device=device)
        ser.restore_into(net, path, meta, arrays,
                         ser._archive_entries(net, arrays), load_updater)
        return net

    def clone(self) -> "ComputationGraph":
        """The same configuration, copies of the params and states on the
        same device; the updater state starts afresh."""
        return self._copy_into(ComputationGraph(self.conf))

    # --------------------------------------------------------- configuration
    def _ensure_epilogue_plan(self):
        """``{bn_node: (act_node, folded_conv_node | None, alpha)}``, built
        once from the graph topology, with ``self._epilogue_shared``: the
        folded convs whose output has consumers besides the anchoring BN.
        A fusion anchors at a BatchNormalization node whose ONLY consumer
        is a relu/leaky ActivationLayer node; a conv feeding it folds its
        bias (other consumers of that conv read a bit-identical re-biased
        copy)."""
        if self._epilogue_plan is not None \
                and self._epilogue_shared is not None:
            return self._epilogue_plan
        conf = self.conf
        consumers: Dict[str, List[str]] = {}
        for node in conf.topo:
            for inp in node.inputs:
                consumers.setdefault(inp, []).append(node.name)
        for out in conf.graph_outputs:
            consumers.setdefault(out, []).append("__output__")
        plan: Dict[str, tuple] = {}
        folded: set = set()          # convs already claimed by an earlier BN
        shared: set = set()          # folded convs with extra consumers
        by_name = conf.node_by_name
        for node in conf.topo:
            if node.kind != "layer" or not L.fusable_bn(node.obj):
                continue
            cons = consumers.get(node.name, [])
            if len(cons) != 1 or cons[0] == "__output__":
                continue
            act_node = by_name[cons[0]]
            if act_node.kind != "layer" or len(act_node.inputs) != 1:
                continue
            alpha = L.activation_alpha(act_node.obj)
            if alpha is None:
                continue
            conv_name = None
            src = by_name.get(node.inputs[0]) if node.inputs else None
            # a conv folds into at most one BN (first in topo order); any
            # other consumer reads the re-biased copy
            if (src is not None and src.kind == "layer"
                    and L.fusable_conv(src.obj) and src.obj.has_bias
                    and src.name not in folded):
                conv_name = src.name
                folded.add(src.name)
                if len(consumers.get(src.name, [])) > 1:
                    shared.add(src.name)
            plan[node.name] = (act_node.name, conv_name, alpha)
        self._epilogue_plan = plan
        self._epilogue_shared = shared
        return plan
