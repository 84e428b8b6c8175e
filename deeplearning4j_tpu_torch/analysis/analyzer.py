"""Static model analyzer — ahead-of-init shape/dtype inference and graph
diagnostics (the port of ``deeplearning4j_tpu/analysis/analyzer.py``).

Walks a ``MultiLayerConfiguration`` / ``ComputationGraphConfiguration``
(or their builders, or a built network) without touching a tensor: InputTypes
propagate layer-by-layer / vertex-by-vertex through the same pure
``output_type`` / ``expected_nin`` hooks the build path uses, and every
finding comes back as a structured :class:`Diagnostic` instead of an
opaque shape error three layers deep in a forward pass.

Entry points: :func:`analyze` (any config/builder/network),
``conf.validate()`` / ``model.validate()`` (thin wrappers), and the
``python -m deeplearning4j_tpu_torch.analysis`` CLI.

Nothing is allocated: preprocessor selection and the layer classes are
resolved lazily off the objects being analyzed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.analysis import distribution as _dist
from deeplearning4j_tpu_torch.analysis import layout as _layout
from deeplearning4j_tpu_torch.analysis import numerics as _numerics
from deeplearning4j_tpu_torch.analysis.diagnostics import (
    Diagnostic, Severity, ValidationReport)
from deeplearning4j_tpu_torch.analysis.distribution import MeshSpec

#: Loss functions that assume unbounded/regression outputs — pairing one
#: with softmax collapses the gradient signal (ref: DL4J's
#: OutputLayerUtil.validateOutputLayer warning of the same shape).
_REGRESSION_LOSSES = {"mse", "l2", "l1", "mae", "squaredloss", "huber"}


def analyze(target, batch_size: Optional[int] = None,
            data_devices: Optional[int] = None, mesh=None, sharding=None,
            pipeline=None, hbm_gb: Optional[float] = None, zero=None,
            input_pipeline=None, policy=None, data_range=None,
            cost=None, profile=None,
            suppress=None, severity_overrides=None) -> ValidationReport:
    """Analyze a configuration, builder, network, or SameDiff graph.

    ``batch_size``/``data_devices`` feed the W103 mesh-divisibility lint
    (both optional — pass the planned global batch and the size of the
    ``parallel/`` data axis when known). ``mesh`` (a
    :class:`~deeplearning4j_tpu_torch.analysis.distribution.MeshSpec`, an
    ``{axis: size}`` dict, a ``"data=8,model=2"`` string, or a runtime
    ``DeviceMesh``) switches on the E1xx/W10x distribution lints;
    ``sharding`` (``ShardingRule`` or {regex: spec}), ``pipeline``
    (``PipelineSpec``/stage count), ``hbm_gb``, and ``zero`` (a ZeRO
    updater-state-sharding declaration: ``True``, an axis name, a
    dict, or a runtime ``distributed.zero.ZeroPlan`` — E104 then
    counts updater state at 1/data-axis and W109 stays quiet) refine
    them.
    ``input_pipeline`` (an
    :class:`~deeplearning4j_tpu_torch.analysis.pipeline.InputPipelineSpec`,
    dict, or ``"workers=8,batch=256,decode_ms=1.3"`` string) switches on
    the W108 can-this-host-feed-this-chip check.
    ``policy`` (a :class:`~deeplearning4j_tpu_torch.nn.precision.
    PrecisionPolicy` or a dtype string like ``"bf16"``) and
    ``data_range`` (a :class:`~deeplearning4j_tpu_torch.analysis.numerics.
    DataRangeSpec`, ``"0..255"``, or ``(lo, hi)``) refine the E3xx/W30x
    numerics lints — with neither, the pass still runs under the policy
    implied by the config's ``dataType`` (or the network's attached
    ``setPrecisionPolicy``).
    ``cost`` (a :class:`~deeplearning4j_tpu_torch.analysis.cost.CostSpec`,
    ``True``, a chip name like ``"h100-sxm"``, or a dict) switches on the
    E12x/W12x static cost-model lints: liveness-aware step-peak HBM,
    roofline step-time/MFU, serving-bucket peak, and fleet capacity.
    ``profile`` (a ``profiler.devicetime.DeviceTimeTable``, a list of
    ``{"layer": ..., "device_ms": ...}`` rows, or a JSON trace path)
    makes the W105 pipeline-balance lint judge on MEASURED per-stage
    device time instead of the FLOP model (needs ``mesh=`` with a
    pipeline declared).
    ``suppress``/``severity_overrides`` shape the report per code
    (:meth:`ValidationReport.apply_config`).
    The layout lint (W101) judges row alignment under the resolved
    policy's compute dtype, and flags an NCHW conv stack only on a
    network whose parameters ``init`` put on the card.
    """
    conf = getattr(target, "conf", target)
    mesh_spec = _mesh_spec(mesh, sharding, pipeline, hbm_gb, zero)
    if profile is not None and mesh_spec is None:
        raise ValueError("the measured-profile W105 lint (profile=) needs "
                         "a mesh declaration — pass mesh=... as well")
    if hasattr(conf, "_nodes") and hasattr(conf, "_placeholders"):
        if input_pipeline is not None:
            raise ValueError(
                "the input-pipeline lint (input_pipeline=) applies to "
                "layer configurations, not SameDiff graphs")
        from deeplearning4j_tpu_torch.analysis.samediff import analyze_samediff
        report = analyze_samediff(conf, batch_size=batch_size or 1)
        report.extend(_samediff_lints(conf, batch_size, data_devices,
                                      mesh_spec, policy, data_range,
                                      profile=profile))
    elif hasattr(conf, "graph_inputs") and hasattr(conf, "nodes"):
        report = _analyze_graph(conf, batch_size, data_devices, mesh_spec,
                                _device_type(target),
                                _compute_dtype(target, conf, policy),
                                profile=profile)
    elif hasattr(conf, "layers") and hasattr(conf, "base"):
        report = _analyze_multilayer(conf, batch_size, data_devices,
                                     mesh_spec, _device_type(target),
                                     _compute_dtype(target, conf, policy),
                                     profile=profile)
    else:
        raise TypeError(f"cannot analyze {type(target).__name__}: expected a "
                        "MultiLayerConfiguration, ComputationGraph"
                        "Configuration, one of their builders, a network, "
                        "or a SameDiff graph")
    if input_pipeline is not None:
        from deeplearning4j_tpu_torch.analysis.pipeline import \
            lint_input_pipeline
        report.extend(lint_input_pipeline(conf, input_pipeline))
    if hasattr(conf, "layers") or hasattr(conf, "graph_inputs"):
        report.extend(_numerics.lint_numerics(
            conf, policy=policy, data_range=data_range,
            model=target if target is not conf else None))
    if cost is not None:
        from deeplearning4j_tpu_torch.analysis import cost as _cost
        report.extend(_cost.lint_cost(conf, cost, mesh=mesh_spec,
                                      batch_size=batch_size, policy=policy))
        # The liveness plan counts params + grads + masters + updater
        # state exactly (ZeRO-aware) against the DECLARED chip's HBM, so
        # the params-only-era heuristics are subsumed: E104's budget
        # check and W109's replicated-state advice would double-report
        # (against a different, default budget) what E120 already
        # decides — its message names updater state when it dominates.
        report.diagnostics = [d for d in report.diagnostics
                              if d.code not in ("DL4J-E104", "DL4J-W109")]
    if target is not conf:                       # a network: add model-level
        report.extend(_model_checks(target))
    for holder in (target, conf):       # importer-attached findings (E16x)
        imported = getattr(holder, "import_report", None)
        if imported is not None:
            report.extend(imported.diagnostics)
            break
    return report.apply_config(suppress, severity_overrides)


def _samediff_lints(sd, batch_size, data_devices, mesh_spec, policy,
                    data_range, profile=None) -> List[Diagnostic]:
    """Full lint parity for recorded graphs: lower the SameDiff to the
    analysis IR (:mod:`~deeplearning4j_tpu_torch.analysis.graphir`) and run the
    same layout/distribution/numerics families native configs get, plus
    the W162 frozen-weight check."""
    from deeplearning4j_tpu_torch.analysis import graphir as _gir
    from deeplearning4j_tpu_torch.analysis import imports as _imports
    ir = _gir.from_samediff(sd, batch_size=batch_size or 1)
    diags: List[Diagnostic] = []
    diags.extend(_gir.lint_ir_layout(
        ir, batch_size,
        data_devices if mesh_spec is None else None))
    if mesh_spec is not None:
        diags.extend(_gir.lint_ir_distribution(ir, mesh_spec, batch_size,
                                               profile=profile))
    diags.extend(_gir.lint_ir_numerics(ir, policy=policy,
                                       data_range=data_range))
    diags.extend(_imports.lint_frozen_constants(sd))
    return diags


def _mesh_spec(mesh, sharding, pipeline, hbm_gb,
               zero=None) -> Optional[MeshSpec]:
    spec = MeshSpec.coerce(mesh)
    if spec is None:
        if sharding is not None or pipeline is not None \
                or hbm_gb is not None or zero is not None:
            raise ValueError("sharding/pipeline/hbm_gb/zero lints need a "
                             "mesh declaration — pass mesh=... as well")
        return None
    if sharding is not None or pipeline is not None or hbm_gb is not None \
            or zero is not None:
        spec = MeshSpec(
            spec.axes, data_axis=spec.data_axis,
            sharding=sharding if sharding is not None else spec.sharding,
            pipeline=pipeline if pipeline is not None else spec.pipeline,
            hbm_gb=hbm_gb if hbm_gb is not None else spec.hbm_gb,
            devices=spec.devices,   # keep the E102 axes-vs-devices lint
            zero=zero if zero is not None else spec.zero)
    return spec


def _compute_dtype(target, conf, policy) -> str:
    """The compute dtype the layout lint judges row alignment under: the
    policy the numerics lints resolve (``policy=``, a network's attached
    policy, then the config's ``dataType``)."""
    model = target if target is not conf else None
    return _numerics.resolve_policy(conf, policy, model).compute


def _device_type(target) -> Optional[str]:
    """The type of the device an initialised network's parameters live
    on (the ``_device`` that ``init`` sets), or None for a configuration
    or a network before ``init``. Read, not probed: no tensor is made."""
    dev = getattr(target, "_device", None)
    return None if dev is None else getattr(dev, "type", None)


def _model_checks(net) -> List[Diagnostic]:
    """Network-level findings: frozen-layer/updater pairing (W003) and any
    recompile-churn diagnostics the runtime detector accumulated for this
    model (W201)."""
    from deeplearning4j_tpu_torch.analysis.churn import get_churn_detector
    diags: List[Diagnostic] = []
    frozen = getattr(net, "_frozen_layers", None)
    updater = getattr(getattr(net.conf, "base", None), "updater", None)
    if frozen and updater is not None and _updater_is_stateful(updater):
        diags.append(Diagnostic(
            "DL4J-W003", Severity.WARNING,
            f"layers {sorted(frozen)}",
            f"frozen layers are trained with a stateful updater "
            f"({type(updater).__name__}) — moment/state buffers are "
            f"allocated and carried for params that never update",
            fix_hint="use Sgd/NoOp for fully-frozen fine-tuning, or drop "
                     "the frozen prefix via TransferLearningHelper so no "
                     "updater state is allocated for it"))
    diags.extend(get_churn_detector().diagnostics_for(net))
    return diags


def _updater_is_stateful(updater) -> bool:
    """Stateful = the class overrides IUpdater.init_state (Adam & family);
    Sgd/NoOp inherit the empty base implementation."""
    base = None
    for cls in type(updater).__mro__:
        if cls.__name__ == "IUpdater":
            base = cls
            break
    if base is None:
        return False
    return type(updater).init_state is not base.init_state


# --------------------------------------------------------------- multilayer
def _layer_loc(i: int, layer) -> str:
    cls = type(layer).__name__
    name = getattr(layer, "name", None)
    if name and name != cls:
        return f"layer {i} ({cls} '{name}')"
    return f"layer {i} ({cls})"


def _analyze_multilayer(conf, batch_size, data_devices,
                        mesh: Optional[MeshSpec] = None,
                        device_type: Optional[str] = None,
                        compute_dtype: str = "float32",
                        profile=None) -> ValidationReport:
    report = ValidationReport(subject="MultiLayerConfiguration")
    layers = list(conf.layers)
    preprocessors = dict(getattr(conf, "preprocessors", {}) or {})

    _check_duplicate_names(
        [( _layer_loc(i, l), getattr(l, "name", None), type(l).__name__)
         for i, l in enumerate(layers)], report)

    if not layers:
        report.add(Diagnostic("DL4J-E008", Severity.ERROR, "config",
                              "configuration has no layers",
                              fix_hint="add at least one layer ending in an "
                                       "output/loss layer"))
        return report

    last = layers[-1]
    if not hasattr(last, "compute_loss"):
        report.add(Diagnostic(
            "DL4J-E008", Severity.ERROR, _layer_loc(len(layers) - 1, last),
            f"last layer {type(last).__name__} is not an output/loss layer "
            f"— fit() has no loss to optimize",
            fix_hint="end the network with OutputLayer / RnnOutputLayer / "
                     "LossLayer (or a subclass)"))
    for i, layer in enumerate(layers):
        if hasattr(layer, "compute_loss"):
            report.extend(_pairing_lints(layer, _layer_loc(i, layer)))

    _check_tbptt(conf, layers, report)

    if getattr(conf, "input_type", None) is None:
        _analyze_without_input_type(layers, preprocessors, report)
    else:
        _propagate_multilayer(conf, layers, preprocessors, report)

    located = [(_layer_loc(i, l), l) for i, l in enumerate(layers)]
    layout_fmt = getattr(conf.base, "compute_layout", "NCHW")
    report.extend(_layout.lint_layers(located, compute_layout=layout_fmt,
                                      compute_dtype=compute_dtype))
    report.extend(_layout.lint_conv_stack(located, layout_fmt, device_type))
    report.extend(_layout.lint_dtype(
        getattr(conf.base, "dtype", None)))
    if mesh is not None:
        report.extend(_dist.lint_multilayer(conf, mesh, batch_size,
                                            profile=profile))
    else:
        report.extend(_layout.lint_batch_mesh(batch_size, data_devices))
    return report


def _check_duplicate_names(entries: Sequence[Tuple[str, Optional[str], str]],
                           report: ValidationReport,
                           explicit_only: bool = True) -> None:
    """E004 over (location, name, class_name) triples. For sequential nets
    only explicitly-set names count (the default name IS the class name,
    which legitimately repeats); graph callers pass explicit_only=False."""
    seen: Dict[str, str] = {}
    for loc, name, cls in entries:
        if not name:
            continue
        if explicit_only and name == cls:
            continue
        if name in seen:
            report.add(Diagnostic(
                "DL4J-E004", Severity.ERROR, loc,
                f"name '{name}' already used at {seen[name]}",
                fix_hint="give every layer/vertex a unique name"))
        else:
            seen[name] = loc


def _check_tbptt(conf, layers, report: ValidationReport) -> None:
    bp = str(getattr(conf, "backprop_type", "standard") or "standard").lower()
    if bp not in ("tbptt", "truncatedbptt", "truncated_bptt"):
        return
    if any(getattr(l, "input_kind", None) == "rnn" for l in layers):
        return
    report.add(Diagnostic(
        "DL4J-W002", Severity.WARNING, "config",
        "backpropType is truncated BPTT but the network has no recurrent "
        "layers — the time-segmentation is a no-op (or will fail on "
        "non-sequence input)",
        fix_hint="drop backpropType('tbptt') or add recurrent layers "
                 "(LSTM/GRU/SimpleRnn/...)"))


def _pairing_lints(layer, loc: str) -> List[Diagnostic]:
    """W001: loss/activation pairings that silently cripple training."""
    act = str(getattr(layer, "activation", "") or "").lower()
    loss = str(getattr(layer, "loss_fn", "") or "").lower()
    n_out = getattr(layer, "nOut", None)
    diags = []
    if act == "softmax" and loss in _REGRESSION_LOSSES:
        diags.append(Diagnostic(
            "DL4J-W001", Severity.WARNING, loc,
            f"softmax activation paired with regression loss '{loss}' — "
            f"gradients through softmax+{loss} are tiny and training "
            f"crawls",
            fix_hint="use lossFunction='mcxent' with softmax, or switch "
                     "the activation to identity for a regression head"))
    if act == "sigmoid" and loss == "mcxent" and (n_out or 0) > 1:
        diags.append(Diagnostic(
            "DL4J-W001", Severity.WARNING, loc,
            f"sigmoid activation with multiclass cross-entropy over "
            f"nOut={n_out} — rows are not a distribution, so mcxent is "
            f"miscalibrated",
            fix_hint="use softmax+mcxent for 1-of-N classification, or "
                     "sigmoid+xent for independent multi-label targets"))
    return diags


def _analyze_without_input_type(layers, preprocessors,
                                report: ValidationReport) -> None:
    """No ``setInputType``: propagation never ran, so check the things
    that must then be explicit — E005 (cnn->dense with no flatten) and
    E001 (weight layers whose nIn is unresolvable)."""
    for i in range(1, len(layers)):
        prev, cur = layers[i - 1], layers[i]
        if (getattr(prev, "input_kind", None) == "cnn"
                and getattr(cur, "input_kind", None) == "ff"
                and i not in preprocessors):
            report.add(Diagnostic(
                "DL4J-E005", Severity.ERROR, _layer_loc(i, cur),
                f"{type(cur).__name__} consumes the 4-D feature map of "
                f"{type(prev).__name__} with no CnnToFeedForward flatten "
                f"in between",
                fix_hint="call setInputType(InputType.convolutional(...)) "
                         "so the preprocessor is inserted automatically"))
    for i, layer in enumerate(layers):
        if getattr(layer, "has_params", False) and \
                getattr(layer, "nIn", None) is None:
            report.add(Diagnostic(
                "DL4J-E001", Severity.ERROR, _layer_loc(i, layer),
                f"{type(layer).__name__}.nIn is unset and cannot be "
                f"inferred because the configuration declares no InputType",
                fix_hint="set nIn explicitly or call setInputType(...) on "
                         "the builder"))


def _propagate_multilayer(conf, layers, preprocessors,
                          report: ValidationReport) -> None:
    from deeplearning4j_tpu_torch.nn import preprocessors as pp
    cur = conf.input_type
    for i, layer in enumerate(layers):
        loc = _layer_loc(i, layer)
        pre = preprocessors.get(i)
        if pre is None:
            try:
                pre = pp.preprocessor_for(cur, layer)
            except ValueError as e:
                report.add(Diagnostic(
                    "DL4J-E005", Severity.ERROR, loc, str(e),
                    fix_hint="declare the input as InputType."
                             "convolutionalFlat(h, w, c) (or insert the "
                             "preprocessor explicitly)"))
                return
        if pre is not None:
            cur = pre.output_type(cur)
        diag, cur = _step_layer(layer, cur, loc)
        if diag is not None:
            report.add(diag)
        if cur is None:
            return


def _step_layer(layer, it, loc: str):
    """Check one layer against its propagated InputType and return
    (diagnostic_or_None, output_type_or_None). A None output type stops
    propagation (shapes downstream would be garbage)."""
    try:
        expected = layer.expected_nin(it) \
            if hasattr(layer, "expected_nin") else None
    except Exception as e:
        return Diagnostic(
            "DL4J-E007", Severity.ERROR, loc,
            f"shape inference failed: {e}",
            fix_hint="fix the layer geometry named in the message"), None
    declared = getattr(layer, "nIn", None)
    if declared is not None and expected is not None \
            and int(declared) != int(expected):
        return Diagnostic(
            "DL4J-E001", Severity.ERROR, loc,
            f"declared nIn={declared} but the upstream layer produces "
            f"{expected} ({it.kind} input {it.dims})",
            fix_hint=f"set nIn={expected} or leave nIn unset so "
                     f"propagation fills it in"), None
    try:
        out = layer.output_type(it)
    except Exception as e:
        return Diagnostic(
            "DL4J-E007", Severity.ERROR, loc,
            f"output shape inference failed: {e}",
            fix_hint="set nOut (and check kernel/stride/padding geometry)"
        ), None
    bad = _invalid_dims(out)
    if bad:
        return Diagnostic(
            "DL4J-E007", Severity.ERROR, loc,
            f"output type {out!r} has non-positive/unset dims {bad}",
            fix_hint="set nOut, and check that kernels/strides fit the "
                     "spatial input (no dimension may shrink below 1)"), None
    return None, out


def _invalid_dims(it) -> Dict[str, Any]:
    bad = {}
    for k, v in it.dims.items():
        if k == "timesteps":        # -1 = variable length, legal
            continue
        if v is None or (isinstance(v, (int, float)) and v <= 0):
            bad[k] = v
    return bad


# -------------------------------------------------------------------- graph
def _node_loc(node) -> str:
    return f"'{node.name}' ({type(node.obj).__name__})"


def _analyze_graph(conf, batch_size, data_devices,
                   mesh: Optional[MeshSpec] = None,
                   device_type: Optional[str] = None,
                   compute_dtype: str = "float32",
                   profile=None) -> ValidationReport:
    report = ValidationReport(subject="ComputationGraphConfiguration")
    nodes = list(conf.nodes)
    inputs = list(conf.graph_inputs)
    outputs = list(conf.graph_outputs)
    input_types = dict(getattr(conf, "input_types", {}) or {})
    preprocessors = dict(getattr(conf, "preprocessors", {}) or {})

    _check_duplicate_names(
        [(_node_loc(n), n.name, None) for n in nodes] +
        [(f"graph input '{i}'", i, None) for i in inputs],
        report, explicit_only=False)

    defined = set(inputs) | {n.name for n in nodes}
    structurally_sound = True
    for node in nodes:
        for ref in node.inputs:
            if ref not in defined:
                structurally_sound = False
                report.add(Diagnostic(
                    "DL4J-E003", Severity.ERROR, _node_loc(node),
                    f"references undefined input '{ref}'",
                    fix_hint="add the missing layer/vertex or fix the "
                             "input name"))
    node_names = {n.name for n in nodes}
    for out in outputs:
        if out not in node_names:
            structurally_sound = False
            report.add(Diagnostic(
                "DL4J-E003", Severity.ERROR, f"graph output '{out}'",
                "output references an undefined node",
                fix_hint="setOutputs(...) must name existing layers"))
    if not outputs:
        report.add(Diagnostic(
            "DL4J-E008", Severity.ERROR, "config",
            "graph declares no outputs",
            fix_hint="call setOutputs(...) with at least one output layer"))

    topo = _graph_toposort(nodes, inputs, defined, report)
    if topo is None:
        structurally_sound = False

    if structurally_sound:
        _check_reachability(nodes, outputs, report)

    by_name = {n.name: n for n in nodes}
    for out in outputs:
        node = by_name.get(out)
        if node is not None and (node.kind != "layer"
                                 or not hasattr(node.obj, "compute_loss")):
            report.add(Diagnostic(
                "DL4J-E008", Severity.ERROR, _node_loc(node),
                "graph output is not an output/loss layer — fit() has no "
                "loss to optimize at this head",
                fix_hint="route the output through OutputLayer / LossLayer"))
    for node in nodes:
        if node.kind == "layer" and hasattr(node.obj, "compute_loss"):
            report.extend(_pairing_lints(node.obj, _node_loc(node)))

    if structurally_sound and topo is not None and inputs and \
            all(i in input_types for i in inputs):
        _propagate_graph(topo, input_types, preprocessors, report)

    located = [(_node_loc(n), n.obj) for n in nodes if n.kind == "layer"]
    layout_fmt = getattr(conf.base, "compute_layout", "NCHW")
    report.extend(_layout.lint_layers(located, compute_layout=layout_fmt,
                                      compute_dtype=compute_dtype))
    report.extend(_layout.lint_conv_stack(located, layout_fmt, device_type))
    report.extend(_layout.lint_dtype(getattr(conf.base, "dtype", None)))
    if mesh is not None:
        report.extend(_dist.lint_graph(conf, mesh, batch_size,
                                       profile=profile))
    else:
        report.extend(_layout.lint_batch_mesh(batch_size, data_devices))
    return report


def _graph_toposort(nodes, inputs, defined, report: ValidationReport):
    """Kahn's algorithm; returns topological order or None after adding an
    E002 when the leftover nodes form a cycle (all their refs exist but
    none can ever become ready)."""
    order, seen = [], set(inputs)
    remaining = [n for n in nodes if all(r in defined for r in n.inputs)]
    progressed = True
    while remaining and progressed:
        progressed = False
        for n in list(remaining):
            if all(r in seen for r in n.inputs):
                order.append(n)
                seen.add(n.name)
                remaining.remove(n)
                progressed = True
    if remaining:
        cyc = sorted(n.name for n in remaining)
        report.add(Diagnostic(
            "DL4J-E002", Severity.ERROR, ", ".join(cyc),
            f"dependency cycle through {len(cyc)} node(s): {cyc}",
            fix_hint="break the cycle — a feedback connection must go "
                     "through a recurrent layer's state, not a graph edge"))
        return None
    return order


def _check_reachability(nodes, outputs, report: ValidationReport) -> None:
    """E003 (warning flavor): nodes no output depends on still execute
    every step — and their params would train on zero gradient."""
    by_name = {n.name: n for n in nodes}
    needed, stack = set(), [o for o in outputs if o in by_name]
    while stack:
        name = stack.pop()
        if name in needed:
            continue
        needed.add(name)
        stack.extend(r for r in by_name[name].inputs if r in by_name)
    for node in nodes:
        if node.name not in needed:
            report.add(Diagnostic(
                "DL4J-E003", Severity.WARNING, _node_loc(node),
                "dangling vertex: no graph output depends on it (it still "
                "executes every step, and its params get no gradient)",
                fix_hint="wire it toward an output or remove it"))


def _propagate_graph(topo, input_types, preprocessors,
                     report: ValidationReport) -> None:
    from deeplearning4j_tpu_torch.nn import preprocessors as pp
    types = dict(input_types)
    for node in topo:
        loc = _node_loc(node)
        in_types = []
        for ref in node.inputs:
            t = types.get(ref)
            if t is None:           # upstream already failed; stop here
                return
            in_types.append(t)
        if node.kind == "layer":
            it = in_types[0]
            pre = preprocessors.get(node.name)
            if pre is None:
                try:
                    pre = pp.preprocessor_for(it, node.obj)
                except ValueError as e:
                    report.add(Diagnostic("DL4J-E005", Severity.ERROR, loc,
                                          str(e)))
                    return
            if pre is not None:
                it = pre.output_type(it)
            diag, out = _step_layer(node.obj, it, loc)
            if diag is not None:
                report.add(diag)
            if out is None:
                return
            types[node.name] = out
        else:
            diag = _vertex_shape_conflicts(node, in_types, loc)
            if diag is not None:
                report.add(diag)
                return
            try:
                types[node.name] = node.obj.output_type(*in_types)
            except Exception as e:
                report.add(Diagnostic(
                    "DL4J-E007", Severity.ERROR, loc,
                    f"vertex output shape inference failed: {e}"))
                return


def _vertex_shape_conflicts(node, in_types, loc: str) -> Optional[Diagnostic]:
    """E006 for the multi-input vertices (merge/elementwise/stack/dot)."""
    if len(in_types) < 2:
        return None
    cls = type(node.obj).__name__
    kinds = {t.kind for t in in_types}
    if len(kinds) > 1:
        return Diagnostic(
            "DL4J-E006", Severity.ERROR, loc,
            f"{cls} mixes input kinds {sorted(kinds)}: "
            f"{[repr(t) for t in in_types]}",
            fix_hint="insert preprocessors so every branch produces the "
                     "same kind before merging")
    first = in_types[0]
    if cls in ("ElementWiseVertex", "StackVertex", "DotProductVertex"):
        for t in in_types[1:]:
            if t != first:
                return Diagnostic(
                    "DL4J-E006", Severity.ERROR, loc,
                    f"{cls} needs identical input shapes, got "
                    f"{[repr(t) for t in in_types]}",
                    fix_hint="match the branch shapes (1x1 conv / dense "
                             "projection on the smaller branch is the "
                             "usual fix)")
    elif cls == "MergeVertex":
        if first.kind == "cnn":
            hw = {(t.height, t.width) for t in in_types}
            if len(hw) > 1:
                return Diagnostic(
                    "DL4J-E006", Severity.ERROR, loc,
                    f"MergeVertex concatenates channels but spatial dims "
                    f"differ across branches: {sorted(hw)}",
                    fix_hint="align strides/padding so every branch "
                             "reaches the merge at the same HxW")
        elif first.kind == "rnn":
            ts = {t.dims.get("timesteps", -1) for t in in_types}
            if len(ts - {-1}) > 1:
                return Diagnostic(
                    "DL4J-E006", Severity.ERROR, loc,
                    f"MergeVertex branches disagree on sequence length: "
                    f"{sorted(ts)}",
                    fix_hint="crop/pad the sequences to one length before "
                             "merging")
    return None
