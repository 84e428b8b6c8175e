"""Distribution analyzer — static sharding/mesh/pipeline lints (E1xx/W10x),
the port of ``deeplearning4j_tpu/analysis/distribution.py``.

The costliest misconfigurations on a multi-chip mesh are *distribution*
mistakes — a batch that does not divide the data axis, a sharding rule
naming an axis the mesh lacks, a replicated giant that eats HBM on every
device, a pipeline whose slowest stage gates every tick. All of them are
statically decidable from the model config plus the mesh declaration
(the weight-update-sharding observation: sharding is a property of
shapes and axis sizes, not of runtime state), so this pass runs them
ahead of any capture and with no device — the declarations here are
plain-data mirrors of the JAX package's ``parallel/`` runtime objects
(:class:`MeshSpec` ~ ``parallel.mesh.DeviceMesh``, sharding-rule dicts ~
``parallel.mesh.ShardingRule``, :class:`PipelineSpec` ~
``parallel.pipeline``), which the port has yet to gain; the lints need
no second card.

Codes (documented in :mod:`analysis.diagnostics`):

- ``E101`` batch not divisible by the data axis
- ``E102`` named mesh axis absent / sized differently than declared
- ``E103`` pipeline stage boundary splits a weight-tied pair
- ``E104`` per-device parameter footprint exceeds the HBM budget
- ``W104`` replicated parameter tensor above threshold with a model axis idle
- ``W105`` pipeline stage FLOP imbalance beyond tolerance
- ``W106`` per-device shard below one Hopper GEMM tile after splitting
- ``W107`` per-layer gradient-collective bytes per step above threshold
- ``W109`` data-parallel mesh with fully-replicated optimizer state
  above threshold and no ZeRO plan declared (declare
  ``zero=`` — the runtime mirror is ``distributed.zero.ZeroPlan``)

Entry points: ``analyze(conf, mesh=...)`` / ``conf.validate(mesh=...)``
(the lints run from :mod:`analysis.analyzer`), and the CLI's ``--mesh``
flag. The per-layer shape/FLOP facts come from the static declared-
shape hooks on the layer configs (``Layer.param_shapes()``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from deeplearning4j_tpu_torch.analysis.layout import GEMM_TILE_N, WGMMA_K

#: W104 only flags tensors at least this large (bytes) — small replicated
#: params are the normal, correct layout.
REPLICATED_BYTES_THRESHOLD = 16 * 1024 * 1024
#: W107 threshold on one layer's estimated per-step gradient allreduce
#: payload (ring allreduce sends ~2(N-1)/N of the tensor per device).
COLLECTIVE_BYTES_THRESHOLD = 1024 ** 3
#: Default E104 per-device HBM budget (GiB) — an H100's 80 GB
#: (``chipspec`` ``h100-sxm``). Params
#: only; the message reminds that optimizer state multiplies it.
DEFAULT_HBM_GB = 74.5
#: W109 only fires when the replicated per-device optimizer state
#: exceeds this (small state is the normal, correct layout).
OPT_REPLICATED_BYTES_THRESHOLD = 64 * 1024 * 1024

#: Per-updater optimizer-state size factor (state bytes = factor x param
#: bytes) — the static mirror of ``train.updaters`` ``init_state``
#: shapes, keyed by config class name.
UPDATER_STATE_FACTORS = {
    "Sgd": 0, "NoOp": 0,
    "Nesterovs": 1, "RmsProp": 1, "AdaGrad": 1,
    "Adam": 2, "AdamW": 2, "Nadam": 2, "AdaMax": 2, "AdaDelta": 2,
    "AMSGrad": 3,
}


def updater_state_factor(updater) -> int:
    """Optimizer-state bytes per parameter byte for an updater config
    (instance, class, or name string). Unknown stateful updaters
    default to 2 (the Adam-family shape); stateless to 0."""
    if updater is None:
        return 0
    name = updater if isinstance(updater, str) \
        else type(updater).__name__ if not isinstance(updater, type) \
        else updater.__name__
    if name in UPDATER_STATE_FACTORS:
        return UPDATER_STATE_FACTORS[name]
    return 2 if getattr(updater, "has_state", True) else 0

_DTYPE_BYTES = {"float64": 8, "double": 8, "f64": 8,
                "float32": 4, "float": 4, "f32": 4,
                "bfloat16": 2, "bf16": 2,
                "float16": 2, "half": 2, "f16": 2,
                "int8": 1, "uint8": 1}


def dtype_bytes(dtype) -> int:
    return _DTYPE_BYTES.get(str(dtype or "float32").lower(), 4)


def _prod(shape: Sequence[int]) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


class PipelineSpec:
    """Static declaration of a GPipe-style pipeline split (the static
    mirror of ``parallel.pipeline``): ``stages`` contiguous stages over
    the layer list, either evenly split or at explicit ``boundaries``
    (stage-start layer indices, first must be 0), sharded over mesh axis
    ``axis``."""

    def __init__(self, stages: int, axis: str = "pipe",
                 boundaries: Optional[Sequence[int]] = None,
                 flop_tolerance: float = 0.25):
        self.stages = int(stages)
        self.axis = axis
        self.boundaries = list(boundaries) if boundaries is not None else None
        self.flop_tolerance = float(flop_tolerance)

    @staticmethod
    def coerce(obj) -> Optional["PipelineSpec"]:
        if obj is None or isinstance(obj, PipelineSpec):
            return obj
        if isinstance(obj, int):
            return PipelineSpec(obj)
        if isinstance(obj, dict):
            return PipelineSpec(**obj)
        raise TypeError(f"cannot interpret {obj!r} as a pipeline spec "
                        "(use PipelineSpec, an int stage count, or a dict)")

    def stage_of(self, n_layers: int) -> List[int]:
        """Stage index per layer. Raises ValueError on bad boundaries."""
        if self.stages < 1:
            raise ValueError(f"pipeline stages must be >= 1, got {self.stages}")
        if self.boundaries is not None:
            b = list(self.boundaries)
            if len(b) != self.stages or b != sorted(b) or (b and b[0] != 0) \
                    or len(set(b)) != len(b) or (b and b[-1] >= max(n_layers, 1)):
                raise ValueError(
                    f"pipeline boundaries {b} must be {self.stages} strictly "
                    f"increasing stage-start indices beginning at 0 and "
                    f"below {n_layers}")
            out, stage = [], 0
            for i in range(n_layers):
                while stage + 1 < len(b) and i >= b[stage + 1]:
                    stage += 1
                out.append(stage)
            return out
        per = max(1, -(-n_layers // self.stages))       # ceil
        return [min(i // per, self.stages - 1) for i in range(n_layers)]


class StageProfile:
    """A measured per-layer device-time profile for the W105 stage-balance
    lint (the ROADMAP carry: judge imbalance on MEASURED time when a
    profile exists, FLOP model only as fallback).

    ``rows``: forward-order ``{"layer": name, "device_ms": float}`` dicts
    — exactly what :class:`profiler.devicetime.LayerTime.as_dict` emits
    and what ``DeviceTimeTable`` rows serialize to.  ``source`` names
    where the numbers came from (a trace path, ``"measured"``, ...) and
    is quoted in the diagnostic message.
    """

    def __init__(self, rows: Sequence[Dict], source: str = "measured"):
        self.rows = [dict(r) for r in rows]
        self.source = str(source)

    @staticmethod
    def coerce(obj) -> Optional["StageProfile"]:
        """StageProfile | DeviceTimeTable (duck-typed ``.rows``) | a list
        of row dicts | {"rows": [...]} | a JSON trace file path."""
        if obj is None or isinstance(obj, StageProfile):
            return obj
        if isinstance(obj, str):
            if not os.path.exists(obj):
                raise ValueError(f"profile file {obj!r} does not exist")
            with open(obj) as fh:
                data = json.load(fh)
            if isinstance(data, dict):
                return StageProfile(data.get("rows", []),
                                    source=data.get("source", obj))
            return StageProfile(data, source=obj)
        rows = getattr(obj, "rows", None)
        if rows is not None and not isinstance(obj, dict):
            rows = [r.as_dict() if hasattr(r, "as_dict") else dict(r)
                    for r in rows]
            return StageProfile(rows,
                                source=getattr(obj, "source", "measured"))
        if isinstance(obj, dict):
            return StageProfile(obj.get("rows", []),
                                source=obj.get("source", "measured"))
        if isinstance(obj, (list, tuple)):
            return StageProfile(obj)
        raise TypeError(f"cannot interpret {obj!r} as a device-time "
                        "profile (use profiler.devicetime.DeviceTimeTable, "
                        "a list of row dicts, or a JSON trace path)")

    def time_per_entry(self, entries) -> Optional[List[float]]:
        """Measured device-ms per ``(loc, layer, it, out)`` entry — name
        match against the devicetime layer-naming convention
        (``name or cls.lower()_{i}``) first, positional fallback when the
        row count matches, else None (caller falls back to FLOPs)."""
        by_name: Dict[str, float] = {}
        for r in self.rows:
            name = r.get("layer")
            ms = r.get("device_ms")
            if name is not None and ms is not None:
                by_name[str(name)] = by_name.get(str(name), 0.0) + float(ms)
        out: List[Optional[float]] = []
        for i, (_loc, layer, _it, _o) in enumerate(entries):
            lname = getattr(layer, "name", None) \
                or f"{type(layer).__name__.lower()}_{i}"
            out.append(by_name.get(str(lname)))
        if all(v is not None for v in out) and out:
            return [float(v) for v in out]
        if len(self.rows) == len(entries):
            try:
                return [float(r.get("device_ms", 0.0)) for r in self.rows]
            except (TypeError, ValueError):
                return None
        return None


class MeshSpec:
    """Device-mesh declaration for the static pass.

    ``axes``: ordered {name: size} (the ``parallel.mesh.DeviceMesh``
    convention: ``data``/``model``/``seq``/``pipe``). ``sharding``: a
    ``parallel.mesh.ShardingRule``-shaped declaration — {param-name-regex:
    partition-spec-tuple} (or a ShardingRule instance; entries may be an
    axis name, ``None``, or a tuple of axis names per dim). ``pipeline``:
    a :class:`PipelineSpec`. ``hbm_gb``: per-device parameter budget for
    E104 (``None`` disables). ``devices``: the physical device count,
    when known — declares the axes-product-vs-hardware consistency
    check (E102), which the elastic shrink revalidation relies on."""

    def __init__(self, axes: Dict[str, int], data_axis: str = "data",
                 sharding=None, pipeline=None, hbm_gb: float = DEFAULT_HBM_GB,
                 devices: Optional[int] = None, zero=None):
        self.axes = {str(k): int(v) for k, v in dict(axes).items()}
        for name, size in self.axes.items():
            if size < 1:
                raise ValueError(f"mesh axis {name!r} has size {size}")
        self.data_axis = data_axis
        self.sharding = sharding
        self.pipeline = PipelineSpec.coerce(pipeline)
        self.hbm_gb = hbm_gb
        # ZeRO declaration: the static mirror of
        # ``distributed.zero.ZeroPlan`` — {"axis": ..., "min_bytes": ...}.
        # When declared, E104 counts updater state at 1/axis-size and
        # W109 stays quiet.
        self.zero = self._coerce_zero(zero)
        # optional PHYSICAL device count: when declared (DeviceMesh.spec()
        # does, and the elastic shrink revalidation does), _lint_axes
        # checks the axes product against it (E102) — a mesh declaration
        # that no longer matches the surviving hardware is exactly the
        # misconfiguration an elastic resume must catch before replicating
        self.devices = None if devices is None else int(devices)

    def _coerce_zero(self, zero) -> Optional[Dict[str, Any]]:
        if zero is None or zero is False:
            return None
        if zero is True:
            return {"axis": self.data_axis, "min_bytes": 65536}
        if isinstance(zero, str):
            return {"axis": zero, "min_bytes": 65536}
        if isinstance(zero, dict):
            return {"axis": str(zero.get("axis", self.data_axis)),
                    "min_bytes": int(zero.get("min_bytes", 65536))}
        # duck-typed runtime ZeroPlan (never imported: stays static)
        axis = getattr(zero, "axis", None)
        if axis is not None:
            return {"axis": str(axis),
                    "min_bytes": int(getattr(zero, "min_bytes", 65536))}
        raise TypeError(f"cannot interpret {zero!r} as a ZeRO declaration "
                        "(use True, an axis name, or a dict)")

    @staticmethod
    def parse(text: str) -> "MeshSpec":
        """``"data=8,model=2"`` -> MeshSpec (the CLI ``--mesh`` syntax)."""
        axes: Dict[str, int] = {}
        for part in str(text).split(","):
            part = part.strip()
            if not part:
                continue
            name, eq, size = part.partition("=")
            if not eq or not name.strip():
                raise ValueError(f"bad mesh axis {part!r}: expected "
                                 f"name=size[,name=size...]")
            try:
                axes[name.strip()] = int(size)
            except ValueError:
                raise ValueError(f"bad mesh axis size in {part!r}") from None
        if not axes:
            raise ValueError(f"empty mesh declaration {text!r}")
        return MeshSpec(axes)

    @staticmethod
    def coerce(obj) -> Optional["MeshSpec"]:
        """MeshSpec | axes dict | "data=8,..." string | a runtime
        ``DeviceMesh`` (duck-typed via its ``.shape`` mapping, or its
        ``.mesh``'s)."""
        if obj is None or isinstance(obj, MeshSpec):
            return obj
        if isinstance(obj, str):
            return MeshSpec.parse(obj)
        if isinstance(obj, dict):
            return MeshSpec(obj)
        inner = getattr(obj, "mesh", None)
        shape = getattr(inner, "shape", None) or getattr(obj, "shape", None)
        if shape is not None and hasattr(shape, "items"):
            return MeshSpec(dict(shape))
        raise TypeError(f"cannot interpret {obj!r} as a mesh declaration "
                        "(use MeshSpec, {axis: size}, 'data=8,model=2', or "
                        "a parallel.mesh.DeviceMesh)")

    def size(self, axis: str, default: int = 1) -> int:
        return self.axes.get(axis, default)

    def model_axes(self) -> List[str]:
        """Axes a parameter tensor could shard over (size > 1): excludes
        the data axis (shards the batch), the declared pipeline axis
        (shards by stage assignment, not by spec), and ``seq`` (sequence
        parallelism shards activations — params stay replicated)."""
        skip = {self.data_axis, "seq"}
        if self.pipeline is not None:
            skip.add(self.pipeline.axis)
        else:
            skip.add("pipe")
        return [a for a, n in self.axes.items() if a not in skip and n > 1]

    def __repr__(self):
        body = ", ".join(f"{k}={v}" for k, v in self.axes.items())
        return f"MeshSpec({body})"


# ----------------------------------------------------------- sharding rules

def _normalize_rules(sharding) -> List[Tuple[Any, Tuple]]:
    """-> [(compiled regex, spec tuple)]. Accepts a
    ``parallel.mesh.ShardingRule`` (has ``.rules``), a {pattern: spec}
    dict, an already-normalized list, or None."""
    if sharding is None:
        return []
    rules = getattr(sharding, "rules", sharding)
    if isinstance(rules, dict):
        rules = [(re.compile(k), tuple(v)) for k, v in rules.items()]
    out = []
    for pat, spec in rules:
        if isinstance(pat, str):
            pat = re.compile(pat)
        out.append((pat, tuple(spec)))
    return out


def _spec_for(rules, name: str, ndim: int) -> Tuple:
    """Partition spec for one named param, padded to ``ndim`` (missing
    trailing dims replicate — PartitionSpec semantics)."""
    for pat, spec in rules:
        if pat.search(name):
            spec = tuple(spec)[:ndim]
            return spec + (None,) * (ndim - len(spec))
    return (None,) * ndim


def _dim_axes(entry) -> Tuple[str, ...]:
    """One spec entry -> the tuple of axis names it shards over."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _spec_axes(spec) -> List[str]:
    return [a for entry in spec for a in _dim_axes(entry)]


def _shard_divisor(entry, mesh: MeshSpec) -> int:
    div = 1
    for a in _dim_axes(entry):
        div *= mesh.size(a)
    return div


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB"):
        if abs(n) < 1024:
            return f"{n:.0f} {unit}"
        n /= 1024
    return f"{n:.2f} GiB" if n >= 100 else f"{n:.1f} GiB"


# ------------------------------------------------------------- layer facts

class _ParamFact:
    """One parameter tensor's static facts under the mesh. ``idx`` is the
    owning entry's position (the pipeline stage assignment keys off it)."""

    __slots__ = ("idx", "location", "name", "shape", "spec", "bytes_total",
                 "bytes_per_device")

    def __init__(self, idx, location, name, shape, spec, itemsize, mesh):
        self.idx = idx
        self.location = location
        self.name = name
        self.shape = tuple(int(d) for d in shape)
        self.spec = spec
        self.bytes_total = _prod(self.shape) * itemsize
        div = 1
        for entry in spec:
            div *= _shard_divisor(entry, mesh)
        self.bytes_per_device = self.bytes_total / max(div, 1)


def _param_facts(entries, mesh: MeshSpec, itemsize: int) -> List[_ParamFact]:
    rules = _normalize_rules(mesh.sharding)
    facts = []
    for idx, (loc, layer, _it, _out) in enumerate(entries):
        shapes = getattr(layer, "param_shapes", lambda: {})()
        lname = getattr(layer, "name", None) or type(layer).__name__
        qualified = getattr(layer, "qualified_params", False)
        for pname, shape in shapes.items():
            if not shape or any(not d or d < 0 for d in shape):
                continue                       # unresolved nIn/nOut: skip
            # graphir's fact bundles carry already-qualified tensor names
            # (the sharding regexes must see the graph's own names)
            full = pname if qualified else f"{lname}/{pname}"
            spec = _spec_for(rules, full, len(shape))
            facts.append(_ParamFact(idx, loc, full, shape, spec, itemsize,
                                    mesh))
    return facts


def _stage_assignment(mesh: MeshSpec, n_entries: int) -> Optional[List[int]]:
    """Stage index per entry when a VALID pipeline is declared (axis
    present, sized to the stage count, boundaries well-formed) — else
    None. Invalid declarations are _lint_axes/_lint_pipeline's E102."""
    pipe = mesh.pipeline
    if pipe is None or mesh.size(pipe.axis) != pipe.stages:
        return None
    try:
        return pipe.stage_of(n_entries)
    except ValueError:
        return None


def _approx_flops(layer, it, out_it) -> int:
    """Per-example forward FLOP estimate from declared shapes: 2*W for
    every matmul-bearing weight, times spatial positions for conv output
    maps, times timesteps for recurrent input.  Attention layers add
    their score/context matmuls (2 x T^2 x E MACs each) — without that
    term a transformer stage's FLOPs read as just its projections and
    the W105 stage-balance lint undercounts it (the carried
    follow-up; same for conv-LSTM, whose gate convs now come from
    ``ConvLSTM2D.param_shapes``)."""
    hook = getattr(layer, "approx_flops", None)
    if hook is not None:     # declared-fact hook (graphir's IR entries)
        try:
            return int(hook())
        except Exception:
            return 0
    shapes = getattr(layer, "param_shapes", lambda: {})()
    w = sum(_prod(s) for s in shapes.values() if len(s) >= 2)
    mult = 1
    if out_it is not None and getattr(out_it, "kind", None) == "cnn":
        mult = max(int(out_it.dims.get("height", 1)), 1) * \
            max(int(out_it.dims.get("width", 1)), 1)
    elif it is not None and getattr(it, "kind", None) == "rnn":
        t = int(it.dims.get("timesteps", -1) or -1)
        mult = t if t > 0 else 1
    flops = 2 * w * mult
    flops += _attention_flops(layer, it)
    return flops


def _attention_flops(layer, it) -> int:
    """Score + context matmul FLOPs for attention layers: QK^T is
    T_q x T_k x E MACs, attn x V the same again — 2 FLOPs per MAC.
    Needs a statically-declared timestep count; degrades to 0 (the old
    undercount) when T is unknown."""
    n_heads = getattr(layer, "n_heads", None)
    if not n_heads:
        return 0
    if it is None or getattr(it, "kind", None) != "rnn":
        return 0
    t_k = int(it.dims.get("timesteps", -1) or -1)
    if t_k <= 0:
        return 0
    head_size = getattr(layer, "head_size", None)
    e = int(n_heads) * int(head_size) if head_size \
        else int(getattr(layer, "nIn", 0) or 0)
    if not e:
        return 0
    # LearnedSelfAttention queries from n_queries learned vectors;
    # RecurrentAttention queries once per output step (T_q = T_k)
    t_q = int(getattr(layer, "n_queries", 0) or 0) or t_k
    return 2 * 2 * t_q * t_k * e


def _propagate_types(conf):
    """Best-effort InputType per layer for the sequential config: (input,
    output) pairs, None where propagation is impossible or fails (the
    structural analyzer already reported that as its own diagnostic)."""
    layers = list(conf.layers)
    out: List[Tuple] = [(None, None)] * len(layers)
    cur = getattr(conf, "input_type", None)
    if cur is None:
        return out
    preprocessors = dict(getattr(conf, "preprocessors", {}) or {})
    try:
        from deeplearning4j_tpu_torch.nn import preprocessors as pp
    except ImportError:      # no layer stack: skip type refinement
        return out
    for i, layer in enumerate(layers):
        if cur is None:
            break
        try:
            pre = preprocessors.get(i)
            if pre is None:
                pre = pp.preprocessor_for(cur, layer)
            if pre is not None:
                cur = pre.output_type(cur)
            nxt = layer.output_type(cur)
        except Exception:
            out[i] = (cur, None)
            break
        out[i] = (cur, nxt)
        cur = nxt
    return out


# -------------------------------------------------------------- the checks

def lint_multilayer(conf, mesh: MeshSpec, batch_size: Optional[int],
                    profile=None) -> List[Diagnostic]:
    from deeplearning4j_tpu_torch.analysis.analyzer import _layer_loc
    layers = list(conf.layers)
    types = _propagate_types(conf)
    entries = [(_layer_loc(i, l), l, types[i][0], types[i][1])
               for i, l in enumerate(layers)]
    diags = lint_entries(entries, mesh, batch_size,
                         getattr(getattr(conf, "base", None), "dtype", None),
                         updater=getattr(getattr(conf, "base", None),
                                         "updater", None))
    diags.extend(_lint_pipeline(entries, mesh, profile=profile))
    return diags


def lint_graph(conf, mesh: MeshSpec, batch_size: Optional[int],
               profile=None) -> List[Diagnostic]:
    """Graph configs get every per-tensor/mesh check. InputTypes
    propagate through vertices, so the
    type-dependent checks (W105 stage balance from real per-layer FLOPs,
    W106 geometry, W107 collectives) see the same facts the sequential
    path does; the pipeline pass runs over the topological layer order —
    the one linearization a DAG stage split could use."""
    from deeplearning4j_tpu_torch.analysis.analyzer import _node_loc
    types = _propagate_graph_types(conf)
    entries = []
    for n in _graph_layer_order(conf):
        it, out = types.get(n.name, (None, None))
        entries.append((_node_loc(n), n.obj, it, out))
    diags = lint_entries(entries, mesh, batch_size,
                         getattr(getattr(conf, "base", None), "dtype", None),
                         updater=getattr(getattr(conf, "base", None),
                                         "updater", None))
    diags.extend(_lint_pipeline(entries, mesh, profile=profile))
    return diags


def _graph_layer_order(conf) -> List:
    """Layer nodes in topological order (declaration order breaks ties /
    cycles — the structural analyzer owns reporting those)."""
    return [n for n in _graph_order_all(conf, list(conf.nodes))
            if n.kind == "layer"]


def _propagate_graph_types(conf) -> Dict[str, Tuple]:
    """Best-effort (in_type, out_type) per graph node, propagated through
    layer nodes AND vertices in topological order. Unknown inputs or a
    failing hook stop that path only — downstream nodes get (None, None)
    and the checks degrade exactly as they always did."""
    out: Dict[str, Tuple] = {}
    input_types = dict(getattr(conf, "input_types", {}) or {})
    if not input_types:
        return out
    try:
        from deeplearning4j_tpu_torch.nn import preprocessors as pp
    except ImportError:      # no layer stack: skip refinement
        return out
    preprocessors = dict(getattr(conf, "preprocessors", {}) or {})
    types = dict(input_types)
    nodes = list(conf.nodes)
    for n in _graph_order_all(conf, nodes):
        in_types = [types.get(r) for r in n.inputs]
        if any(t is None for t in in_types) or not in_types:
            continue
        try:
            if n.kind == "layer":
                it = in_types[0]
                pre = preprocessors.get(n.name)
                if pre is None:
                    pre = pp.preprocessor_for(it, n.obj)
                if pre is not None:
                    it = pre.output_type(it)
                nxt = n.obj.output_type(it)
                out[n.name] = (it, nxt)
                types[n.name] = nxt
            else:
                types[n.name] = n.obj.output_type(*in_types)
        except Exception:
            continue          # structural analyzer reports this path
    return out


def _graph_order_all(conf, nodes) -> List:
    """All nodes (layers + vertices) topologically, same tie-breaking as
    :func:`_graph_layer_order`."""
    seen = set(getattr(conf, "graph_inputs", ()) or ())
    names = {n.name for n in nodes}
    order, remaining = [], list(nodes)
    progressed = True
    while remaining and progressed:
        progressed = False
        for n in list(remaining):
            if all(r in seen or r not in names for r in n.inputs):
                order.append(n)
                seen.add(n.name)
                remaining.remove(n)
                progressed = True
    order.extend(remaining)
    return order


def lint_entries(entries, mesh: MeshSpec, batch_size: Optional[int],
                 dtype, updater=None) -> List[Diagnostic]:
    """Mesh-wide checks over ``(location, layer, in_type, out_type)``
    entries — shared by the sequential and graph paths. ``updater``
    (the config's IUpdater, when known) feeds the optimizer-state
    accounting: the ZeRO-aware E104 and the W109 replicated-state
    warning."""
    diags: List[Diagnostic] = []
    diags.extend(_lint_batch(mesh, batch_size))
    diags.extend(_lint_axes(mesh))
    facts = _param_facts(entries, mesh, dtype_bytes(dtype))
    diags.extend(_lint_hbm(facts, mesh,
                           _stage_assignment(mesh, len(entries)),
                           updater=updater))
    diags.extend(_lint_replicated(facts, mesh))
    diags.extend(_lint_opt_replication(facts, mesh, updater,
                                       _stage_assignment(mesh,
                                                         len(entries))))
    diags.extend(_lint_shard_geometry(facts, mesh))
    diags.extend(_lint_collectives(facts, mesh))
    return diags


def _lint_batch(mesh: MeshSpec, batch_size) -> List[Diagnostic]:
    n = mesh.size(mesh.data_axis)
    if not batch_size or n <= 1 or batch_size % n == 0:
        return []
    return [Diagnostic(
        "DL4J-E101", Severity.ERROR, "mesh",
        f"global batch {batch_size} does not divide the "
        f"'{mesh.data_axis}' axis ({n} devices) — per-device batches "
        f"would be ragged and the sharded dispatch will pad or fail",
        fix_hint=f"use a global batch that is a multiple of {n} "
                 f"(e.g. {((batch_size // n) + 1) * n})")]


def _lint_axes(mesh: MeshSpec) -> List[Diagnostic]:
    diags = []
    if mesh.devices is not None:
        product = 1
        for n in mesh.axes.values():
            product *= n
        if product != mesh.devices:
            diags.append(Diagnostic(
                "DL4J-E102", Severity.ERROR, "mesh",
                f"mesh axes {dict(mesh.axes)} multiply to {product} "
                f"device(s) but {mesh.devices} are declared — the mesh "
                f"cannot be built on this device set",
                fix_hint="resize an axis so the product matches the "
                         "physical device count (after an elastic shrink, "
                         "the data axis must equal the survivor count)"))
    missing = []
    for _pat, spec in _normalize_rules(mesh.sharding):
        missing.extend(a for a in _spec_axes(spec) if a not in mesh.axes)
    for axis in sorted(set(missing)):
        diags.append(Diagnostic(
            "DL4J-E102", Severity.ERROR, "sharding rules",
            f"partition spec names mesh axis '{axis}' but the declared "
            f"mesh has axes {sorted(mesh.axes)} — placement would fail at "
            f"the first device_put",
            fix_hint=f"add '{axis}' to the mesh (DeviceMesh.create / "
                     f"--mesh {axis}=N) or fix the rule's axis name"))
    pipe = mesh.pipeline
    if pipe is not None:
        if pipe.axis not in mesh.axes:
            diags.append(Diagnostic(
                "DL4J-E102", Severity.ERROR, "pipeline",
                f"pipeline declares mesh axis '{pipe.axis}' but the mesh "
                f"has axes {sorted(mesh.axes)}",
                fix_hint=f"declare the axis (--mesh {pipe.axis}="
                         f"{pipe.stages}) or drop the pipeline spec"))
        elif mesh.size(pipe.axis) != pipe.stages:
            diags.append(Diagnostic(
                "DL4J-E102", Severity.ERROR, "pipeline",
                f"pipeline declares {pipe.stages} stages but mesh axis "
                f"'{pipe.axis}' has size {mesh.size(pipe.axis)} — one "
                f"device per stage is the parallel/pipeline contract",
                fix_hint="make the stage count equal the pipe-axis size"))
    return diags


def _lint_pipeline(entries, mesh: MeshSpec, profile=None) -> List[Diagnostic]:
    pipe = mesh.pipeline
    if pipe is None or pipe.axis not in mesh.axes \
            or mesh.size(pipe.axis) != pipe.stages:
        return []                     # E102 already covers the mismatch
    diags = []
    try:
        stage_of = pipe.stage_of(len(entries))
    except ValueError as e:
        return [Diagnostic("DL4J-E102", Severity.ERROR, "pipeline", str(e),
                           fix_hint="fix the stage boundaries")]
    # E103: weight-tied pairs must live on one stage (a tie across stages
    # means the 'shared' tensor is two tensors on two devices, kept in
    # sync only by luck)
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for i, (loc, layer, _it, _out) in enumerate(entries):
        tie = getattr(layer, "tied_with", None)
        if tie:
            groups.setdefault(str(tie), []).append((i, loc))
    for tie, members in sorted(groups.items()):
        stages = {stage_of[i] for i, _ in members}
        if len(stages) > 1:
            locs = ", ".join(loc for _, loc in members)
            diags.append(Diagnostic(
                "DL4J-E103", Severity.ERROR, locs,
                f"weight-tie group '{tie}' is split across pipeline "
                f"stages {sorted(stages)} — tied parameters on different "
                f"stages are physically distinct tensors and silently "
                f"diverge",
                fix_hint="move the stage boundary so every layer of the "
                         "tie group lands on one stage (or break the tie)"))
    # W105: stage balance — the pipeline advances at the slowest stage's
    # pace, so imbalance is pure bubble on every other device. MEASURED
    # per-layer device time (analyze(profile=...) / --profile) when a
    # profile maps onto the layers, the FLOP model as fallback — the
    # message names which source judged it.
    measured = None
    if profile is not None:
        prof = StageProfile.coerce(profile)
        measured = prof.time_per_entry(entries)
    if measured is not None:
        cost = [0.0] * pipe.stages
        for i in range(len(entries)):
            cost[stage_of[i]] += measured[i]
        unit, src = "device-ms/step", \
            f"measured per-stage device time (source: {prof.source})"
        fmt = [f"stage {s}: {c:.2f}" for s, c in enumerate(cost)]
    else:
        cost = [0.0] * pipe.stages
        for i, (_loc, layer, it, out) in enumerate(entries):
            cost[stage_of[i]] += _approx_flops(layer, it, out)
        unit, src = "GFLOP/example", "the static FLOP model"
        fmt = [f"stage {s}: {c / 1e9:.2f}" for s, c in enumerate(cost)]
    total = sum(cost)
    if total > 0:
        mean = total / pipe.stages
        worst = max(range(pipe.stages), key=lambda s: cost[s])
        if cost[worst] > mean * (1.0 + pipe.flop_tolerance):
            diags.append(Diagnostic(
                "DL4J-W105", Severity.WARNING, "pipeline",
                f"stage imbalance (judged on {src}): stage {worst} "
                f"carries {cost[worst] / mean:.2f}x the mean "
                f"({unit}: {', '.join(fmt)}) — every lighter stage idles "
                f"the difference each tick",
                fix_hint="move the stage boundaries toward an even "
                         "split (boundaries=[...]), not an even layer "
                         "count"))
    return diags


def _zero_state_divisor(f: "_ParamFact", mesh: MeshSpec) -> int:
    """How many ways the declared ZeRO plan splits this param's updater
    state — the static mirror of ``ZeroPlan.state_spec``: the data-axis
    size when the tensor is big enough and has a free dim the axis
    divides, else 1 (state keeps the param's sharding)."""
    zero = mesh.zero
    if zero is None:
        return 1
    n = mesh.size(zero["axis"])
    if n <= 1 or f.bytes_total < zero["min_bytes"]:
        return 1
    spec = tuple(f.spec) + (None,) * (len(f.shape) - len(f.spec))
    if zero["axis"] in _spec_axes(spec):
        # the param spec already shards over the ZeRO axis (FSDP-style):
        # bytes_per_device is already divided by it — dividing again
        # would under-count E104's state bytes n-fold
        return 1
    for dim, entry in zip(f.shape, spec):
        if entry is None and dim >= n and dim % n == 0:
            return n
    return 1


def _opt_bytes_per_device(f: "_ParamFact", mesh: MeshSpec,
                          factor: int) -> float:
    return f.bytes_per_device * factor / _zero_state_divisor(f, mesh)


def _lint_hbm(facts, mesh: MeshSpec,
              stages: Optional[List[int]] = None,
              updater=None) -> List[Diagnostic]:
    if mesh.hbm_gb is None or not facts:
        return []
    budget = float(mesh.hbm_gb) * 1024 ** 3
    # E104 counts updater state only under a declared ZeRO plan: each
    # state tensor at 1/data-axis of its replicated size. The
    # no-ZeRO replicated-optimizer hazard is W109's, keeping E104's
    # params-only baseline stable for existing budgets.
    factor = updater_state_factor(updater) if mesh.zero is not None else 0

    def per_device(f):
        return f.bytes_per_device + _opt_bytes_per_device(f, mesh, factor)

    if stages is not None:
        # pipeline: a device holds only its own stage's layers — budget
        # the heaviest stage, not the whole model
        per_stage: Dict[int, float] = {}
        for f in facts:
            per_stage[stages[f.idx]] = per_stage.get(stages[f.idx], 0.0) \
                + per_device(f)
        worst = max(per_stage, key=per_stage.get)
        total = per_stage[worst]
        location = f"pipeline stage {worst}"
        facts = [f for f in facts if stages[f.idx] == worst]
    else:
        total = sum(per_device(f) for f in facts)
        location = "mesh"
    if total <= budget:
        return []
    top = sorted(facts, key=lambda f: -f.bytes_per_device)[:3]
    biggest = "; ".join(f"{f.name} {f.shape} {_fmt_bytes(f.bytes_per_device)}"
                        f"/device" for f in top)
    if factor:
        accounting = (f"params + ZeRO-sharded updater state over "
                      f"{mesh.size(mesh.zero['axis'])} "
                      f"'{mesh.zero['axis']}' shards")
    else:
        accounting = "params only — optimizer state multiplies this 2-3x"
    return [Diagnostic(
        "DL4J-E104", Severity.ERROR, location,
        f"per-device parameter footprint {_fmt_bytes(total)} exceeds the "
        f"{mesh.hbm_gb:g} GiB HBM budget ({accounting}). "
        f"Biggest shards: {biggest}",
        fix_hint="shard the large tensors over a model axis (ShardingRule"
                 "), raise the budget (--hbm-gb), or shrink the model")]


def _lint_opt_replication(facts, mesh: MeshSpec, updater,
                          stages: Optional[List[int]] = None
                          ) -> List[Diagnostic]:
    """W109: a data-parallel mesh training with fully-replicated
    optimizer state above threshold and NO ZeRO plan declared — every
    extra replica burns ``factor x params`` HBM that cross-replica
    weight-update sharding would reclaim (PAPERS.md). Stage-aware like
    E104: under a pipeline, a device replicates only its own stage's
    state."""
    if mesh.zero is not None or not facts:
        return []
    n = mesh.size(mesh.data_axis)
    if n <= 1:
        return []
    factor = updater_state_factor(updater)
    if factor < 1:
        return []
    if stages is not None:
        per_stage: Dict[int, float] = {}
        for f in facts:
            per_stage[stages[f.idx]] = per_stage.get(stages[f.idx], 0.0) \
                + f.bytes_per_device
        opt_bytes = max(per_stage.values()) * factor
    else:
        opt_bytes = sum(f.bytes_per_device for f in facts) * factor
    if opt_bytes <= OPT_REPLICATED_BYTES_THRESHOLD:
        return []
    return [Diagnostic(
        "DL4J-W109", Severity.WARNING, "mesh",
        f"fully-replicated optimizer state: "
        f"{type(updater).__name__ if updater is not None else 'the updater'}"
        f" keeps {_fmt_bytes(opt_bytes)} of state on EVERY of the {n} "
        f"'{mesh.data_axis}' replicas — sharding it across the data axis "
        f"(ZeRO-style cross-replica weight-update sharding) cuts that to "
        f"~{_fmt_bytes(opt_bytes / n)} per device with identical math",
        fix_hint="declare zero= on the mesh (MeshSpec(zero=True)) and "
                 "train with ShardedTrainingPlan(mesh, "
                 "zero=ZeroPlan()) — distributed.zero")]


def _lint_replicated(facts, mesh: MeshSpec) -> List[Diagnostic]:
    model_axes = mesh.model_axes()
    if not model_axes:
        return []
    diags = []
    for f in facts:
        if f.bytes_total < REPLICATED_BYTES_THRESHOLD:
            continue
        if any(a in mesh.axes and mesh.size(a) > 1
               for a in _spec_axes(f.spec)):
            continue                   # sharded over something real
        diags.append(Diagnostic(
            "DL4J-W104", Severity.WARNING, f.location,
            f"parameter {f.name} {f.shape} ({_fmt_bytes(f.bytes_total)}) "
            f"is replicated on every device although the mesh declares "
            f"model axes {model_axes} — each replica burns the full "
            f"tensor (and its updater state) in HBM",
            fix_hint="add a ShardingRule entry partitioning it over "
                     f"'{model_axes[0]}' (weight-update "
                     "sharding: see PAPERS.md cross-replica sharding)"))
    return diags


def _lint_shard_geometry(facts, mesh: MeshSpec) -> List[Diagnostic]:
    diags = []
    for f in facts:
        if len(f.shape) < 2:
            continue
        for dim_idx, entry in enumerate(f.spec):
            axes = [a for a in _dim_axes(entry) if mesh.size(a) > 1]
            if not axes:
                continue
            div = _shard_divisor(entry, mesh)
            dim = f.shape[dim_idx]
            minor = dim_idx == len(f.shape) - 1
            tile = GEMM_TILE_N if minor else WGMMA_K
            per_dev = dim / div
            if dim % div != 0:
                diags.append(Diagnostic(
                    "DL4J-W106", Severity.WARNING, f.location,
                    f"{f.name} dim {dim_idx} ({dim}) does not divide its "
                    f"shard factor {div} over {axes} — the sharding pads "
                    f"every shard to {-(-dim // div)}",
                    fix_hint=f"pick a dim that is a multiple of {div}"))
            elif dim >= tile and per_dev < tile:
                kind = (f"N dim (the {GEMM_TILE_N}-wide Hopper GEMM tile)"
                        if minor else
                        f"K dim (one {WGMMA_K}-element wgmma step)")
                diags.append(Diagnostic(
                    "DL4J-W106", Severity.WARNING, f.location,
                    f"{f.name} dim {dim_idx} ({dim}) shards over {axes} "
                    f"to {per_dev:.0f}/device — below one tile in the "
                    f"{kind}, so every device pads back up to {tile} and "
                    f"most of each MAC is dead",
                    fix_hint=f"shard a larger dim, or keep per-device "
                             f"extent >= {tile} (dim >= {tile * div} "
                             f"here)"))
    return diags


def collective_payload_estimates(facts, mesh: MeshSpec) -> Dict[str, float]:
    """The W107 scaling model: per-layer estimated gradient-allreduce
    payload in bytes per device per step — ring allreduce moves
    ~``2(N-1)/N`` of each per-device gradient shard over the data axis.
    Returns {} on a 1-wide data axis (no gradient collective at all)."""
    n = mesh.size(mesh.data_axis)
    if n <= 1:
        return {}
    ring = 2.0 * (n - 1) / n
    per_layer: Dict[str, float] = {}
    for f in facts:
        per_layer[f.location] = per_layer.get(f.location, 0.0) \
            + f.bytes_per_device
    return {loc: b * ring for loc, b in per_layer.items()}


def estimate_gradient_collectives(conf, mesh) -> Dict[str, float]:
    """Public entry for the collective-volume characterization
    (``benchmarks/probe_collectives.py``): the SAME per-layer estimate
    the W107 lint thresholds, for a sequential configuration under any
    mesh declaration. Static — the JAX package measures its counterpart
    from the compiled HLO."""
    from deeplearning4j_tpu_torch.analysis.analyzer import _layer_loc
    mesh = MeshSpec.coerce(mesh)
    entries = [(_layer_loc(i, l), l, None, None)
               for i, l in enumerate(conf.layers)]
    facts = _param_facts(entries, mesh, dtype_bytes(
        getattr(getattr(conf, "base", None), "dtype", None)))
    return collective_payload_estimates(facts, mesh)


def _lint_collectives(facts, mesh: MeshSpec) -> List[Diagnostic]:
    """Per-layer gradient-allreduce estimate from the SHARDED facts: the
    gradient carries the parameter's sharding, so model-sharding a tensor
    shrinks its allreduce payload — following W104/W107's own fix hint
    clears the warning."""
    diags = []
    n = mesh.size(mesh.data_axis)
    for loc, payload in collective_payload_estimates(facts, mesh).items():
        if payload > COLLECTIVE_BYTES_THRESHOLD:
            diags.append(Diagnostic(
                "DL4J-W107", Severity.WARNING, loc,
                f"estimated gradient allreduce for this layer moves "
                f"{_fmt_bytes(payload)} per device per step (ring "
                f"allreduce of its {_fmt_bytes(payload * n / (2.0 * (n - 1)))}"
                f" per-device grad shard over {n} '{mesh.data_axis}' "
                f"devices) — likely the step's communication bottleneck",
                fix_hint="shard the tensor over a model axis, keep grads "
                         "in bf16 for the allreduce, or shrink the layer"))
    return diags
