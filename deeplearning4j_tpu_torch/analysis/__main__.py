"""CLI: lint zoo models / user modules ahead of any capture (the port of
``deeplearning4j_tpu/analysis/__main__.py``).

Usage::

    python -m deeplearning4j_tpu_torch.analysis --zoo            # every zoo model
    python -m deeplearning4j_tpu_torch.analysis LeNet ResNet50   # named zoo models
    python -m deeplearning4j_tpu_torch.analysis my.module        # module attrs
    python -m deeplearning4j_tpu_torch.analysis my.module:build  # one attribute
    python -m deeplearning4j_tpu_torch.analysis --samediff my.module:sd
    python -m deeplearning4j_tpu_torch.analysis --onnx model.onnx
    python -m deeplearning4j_tpu_torch.analysis --concurrency   # this package
    python -m deeplearning4j_tpu_torch.analysis --zoo --mesh data=8 --cost \\
        --chip h100-sxm                    # E12x/W12x cost model

A module target is scanned for ZooModel subclasses, configurations, and
networks; a ``module:attr`` target names one such object (callables are
called with no args first). Exit status is 0 only when every target is
clean — warnings count as failures unless ``--warnings-ok``.

Building zoo configs imports the layer stack (and therefore torch), but
no parameter is allocated and nothing runs on a device — the analysis
itself stays static.
"""

from __future__ import annotations

import argparse
import importlib
import sys
from typing import List, Tuple

from deeplearning4j_tpu_torch.analysis.analyzer import analyze
from deeplearning4j_tpu_torch.analysis.diagnostics import (ValidationReport,
                                                           _normalize_severity,
                                                           normalize_code)


def _zoo_registry():
    from deeplearning4j_tpu_torch.models import zoo
    return zoo.ZOO_MODELS


def _coerce_target(name: str, obj) -> List[Tuple[str, object]]:
    """Turn one resolved object into [(label, analyzable)] pairs."""
    if isinstance(obj, type):
        from deeplearning4j_tpu_torch.models.zoo import ZooModel
        if issubclass(obj, ZooModel):
            return [(name, obj().conf_builder())]
        obj = obj()
    if callable(obj) and not hasattr(obj, "conf") \
            and not hasattr(obj, "layers") and not hasattr(obj, "nodes"):
        obj = obj()
    return [(name, obj)]


def _resolve(target: str) -> List[Tuple[str, object]]:
    registry = _zoo_registry()
    if target in registry:
        return _coerce_target(target, registry[target])
    mod_name, _, attr = target.partition(":")
    try:
        module = importlib.import_module(mod_name)
    except ImportError:
        # maybe a dotted attribute path: pkg.mod.Attr
        if not attr and "." in target:
            mod_name, _, attr = target.rpartition(".")
            module = importlib.import_module(mod_name)
        else:
            raise
    if attr:
        return _coerce_target(target, getattr(module, attr))
    from deeplearning4j_tpu_torch.models.zoo import ZooModel
    found = []
    for aname in sorted(vars(module)):
        obj = vars(module)[aname]
        if isinstance(obj, type) and issubclass(obj, ZooModel) \
                and obj is not ZooModel \
                and obj.__module__ == module.__name__:
            found.extend(_coerce_target(f"{target}:{aname}", obj))
        elif hasattr(obj, "layers") and hasattr(obj, "base") \
                or hasattr(obj, "nodes") and hasattr(obj, "graph_inputs"):
            found.extend(_coerce_target(f"{target}:{aname}", obj))
    if not found:
        raise SystemExit(f"no zoo models or configurations found in "
                         f"{target!r}")
    return found


def _resolve_onnx(path: str):
    """An .onnx target: SameDiff when every op imports, otherwise the
    E161 pre-scan report (importing would just raise). The graph is read
    into CPU tensors: linting it needs no card."""
    from deeplearning4j_tpu_torch.analysis import imports as _imp
    from deeplearning4j_tpu_torch.modelimport import onnx_proto as op_
    try:
        model = op_.load_model(path)
    except (OSError, ValueError) as e:
        raise SystemExit(f"--onnx {path}: {e}")
    pre = _imp.lint_onnx_model(model)
    if any(d.code == "DL4J-E161" for d in pre.diagnostics):
        return pre
    from deeplearning4j_tpu_torch.modelimport.onnx import OnnxGraphImport
    return OnnxGraphImport.importOnnxModel(model, device="cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis",
        description="Static model linter: shape/dtype propagation, graph "
                    "diagnostics, and Hopper layout lints — no capture, "
                    "no device.")
    ap.add_argument("targets", nargs="*",
                    help="zoo model name (e.g. LeNet), module, or "
                         "module:attr")
    ap.add_argument("--zoo", action="store_true",
                    help="lint every model-zoo architecture")
    ap.add_argument("--samediff", action="append", default=[],
                    metavar="MODULE:ATTR",
                    help="lint a recorded SameDiff graph: module:attr "
                         "naming a SameDiff (or a no-arg callable "
                         "returning one) — runs the full layout/"
                         "distribution/numerics parity passes plus any "
                         "attached import_report (repeatable)")
    ap.add_argument("--onnx", action="append", default=[], metavar="PATH",
                    help="lint an .onnx file: the E16x/W16x "
                         "pre-scan, then (when every op imports) the "
                         "full analyzer over the imported graph "
                         "(repeatable)")
    ap.add_argument("--concurrency", metavar="PATH_OR_MODULE",
                    action="append", default=[], nargs="?",
                    const="deeplearning4j_tpu_torch",
                    help="run the E2xx/W21x thread-safety lints over a "
                         "source file, directory, or importable module "
                         "name (pure AST — nothing is imported or "
                         "executed; repeatable; with no value, this "
                         "package)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="planned global batch size (enables the W103 "
                         "mesh-divisibility lint, or E101 with --mesh)")
    ap.add_argument("--devices", type=int, default=None,
                    help="data-parallel mesh axis size for W103")
    ap.add_argument("--mesh", default=None, metavar="AXES",
                    help="declared device mesh, e.g. 'data=8' or "
                         "'data=4,model=2' — enables the E1xx/W10x "
                         "distribution lints")
    ap.add_argument("--zero", action="store_true",
                    help="declare ZeRO updater-state sharding over the "
                         "data axis: E104 counts optimizer "
                         "state at 1/data-axis and W109 stays quiet")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="per-device HBM budget in GiB for the E104 "
                         "parameter-footprint check (default 74.5, an "
                         "H100's)")
    ap.add_argument("--policy", default=None, metavar="POLICY",
                    help="precision policy for the E3xx/W30x numerics "
                         "lints: a compute dtype ('bf16', 'fp16', "
                         "'fp32') or 'compute=fp16,params=fp32,"
                         "loss_scale=32768' (loss_scale=dynamic + "
                         "loss_scale_init=/growth_interval=/... for the "
                         "grow/backoff automaton) — without it the pass "
                         "runs under each config's own dataType")
    ap.add_argument("--data-range", default=None, metavar="LO..HI",
                    help="declared input value range for the range-"
                         "dependent numerics lints (E303/W303), e.g. "
                         "'0..255' or '-1..1,normalized'")
    ap.add_argument("--pipeline", default=None, metavar="SPEC",
                    help="declared input pipeline for the W108 can-this-"
                         "host-feed-this-chip check, e.g. 'workers=8,"
                         "batch=256,decode_ms=1.3,h2d_mbps=6.2,hw=224"
                         "[,dtype=uint8][,mfu=0.3][,device_img_s=2184]'")
    ap.add_argument("--cost", action="store_true",
                    help="run the E12x/W12x whole-program cost model: "
                         "liveness-based step-peak HBM plan, roofline "
                         "step-time/MFU estimate, capacity planner "
                         "(default chip h100-sxm; supersedes the params-"
                         "only E104/W109 heuristics)")
    ap.add_argument("--chip", default=None, metavar="NAME",
                    help="chip to cost against (h100-sxm, cpu) — "
                         "implies --cost")
    ap.add_argument("--qps", type=float, default=None,
                    help="target aggregate serving QPS for the E122 "
                         "capacity check — implies --cost")
    ap.add_argument("--p99-ms", type=float, default=None,
                    help="target p99 latency budget in ms for E122 — "
                         "implies --cost")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="measured per-stage device-time profile (JSON "
                         "from profiler/devicetime.py) — W105 stage "
                         "imbalance is judged on measured time instead "
                         "of the FLOP model (needs --mesh)")
    ap.add_argument("--stages", type=int, default=None, metavar="N",
                    help="declare an N-stage pipeline split for the "
                         "per-stage lints (needs --mesh)")
    ap.add_argument("--suppress", action="append", default=[],
                    metavar="CODES",
                    help="suppress diagnostic codes (comma-separated or "
                         "repeated), e.g. --suppress W101,DL4J-W107 — the "
                         "'# dl4j: noqa=W101' equivalent for the CLI")
    ap.add_argument("--severity", action="append", default=[],
                    metavar="CODE=LEVEL",
                    help="override a code's severity, e.g. --severity "
                         "W104=error or --severity E101=warning "
                         "(levels: info, warning, error; repeatable)")
    ap.add_argument("--warnings-ok", action="store_true",
                    help="exit 0 even when warnings (W-codes) were found")
    args = ap.parse_args(argv)

    # validate the per-code config up front — a typo'd code must be a
    # clean usage error, not a traceback halfway through a --zoo run
    try:
        suppress = [normalize_code(c) for chunk in args.suppress
                    for c in chunk.split(",") if c]
    except ValueError as e:
        ap.error(f"--suppress: {e}")
    overrides = {}
    for spec in args.severity:
        code, eq, level = spec.partition("=")
        if not eq or not code or not level:
            ap.error(f"--severity expects CODE=LEVEL, got {spec!r}")
        try:
            overrides[normalize_code(code)] = _normalize_severity(level)
        except ValueError as e:
            ap.error(f"--severity: {e}")
    if args.hbm_gb is not None and not args.mesh:
        ap.error("--hbm-gb needs a mesh declaration: pass --mesh as well")
    if args.zero and not args.mesh:
        ap.error("--zero needs a mesh declaration: pass --mesh as well")
    if args.profile and not args.mesh:
        ap.error("--profile needs a mesh declaration: pass --mesh as well")
    if args.stages is not None and not args.mesh:
        ap.error("--stages needs a mesh declaration: pass --mesh as well")
    cost_spec = None
    if args.cost or args.chip or args.qps is not None \
            or args.p99_ms is not None:
        from deeplearning4j_tpu_torch.analysis.cost import CostSpec
        try:
            cost_spec = CostSpec(chip=args.chip or "h100-sxm", qps=args.qps,
                                 p99_ms=args.p99_ms)
        except ValueError as e:
            ap.error(f"--chip: {e}")
    profile_spec = None
    if args.profile:
        from deeplearning4j_tpu_torch.analysis.distribution import StageProfile
        try:
            profile_spec = StageProfile.coerce(args.profile)
        except (OSError, ValueError) as e:
            ap.error(f"--profile: {e}")
    policy_spec = None
    if args.policy:
        from deeplearning4j_tpu_torch.nn.precision import PrecisionPolicy
        try:
            if "=" in args.policy:
                kv = {}
                for part in args.policy.split(","):
                    k, eq, v = part.partition("=")
                    if not eq:
                        raise ValueError(f"expected key=value, got {part!r}")
                    k = k.strip()
                    if k == "loss_scale":
                        # 'dynamic' = the grow/backoff automaton; any
                        # other spelling must be a static float
                        v = v.strip()
                        kv[k] = v if v.lower() == "dynamic" else float(v)
                    elif k in ("loss_scale_init", "growth_factor",
                               "backoff_factor", "min_loss_scale",
                               "max_loss_scale"):
                        kv[k] = float(v)
                    elif k == "growth_interval":
                        kv[k] = int(v)
                    elif k in ("compute", "params"):
                        kv[k] = v.strip()
                    else:
                        raise ValueError(f"unknown policy key {k!r}")
                policy_spec = PrecisionPolicy(**kv)
            else:
                policy_spec = PrecisionPolicy.coerce(args.policy)
        except (ValueError, TypeError) as e:
            ap.error(f"--policy: {e}")
    range_spec = None
    if args.data_range:
        from deeplearning4j_tpu_torch.analysis.numerics import DataRangeSpec
        try:
            range_spec = DataRangeSpec.parse(args.data_range)
        except ValueError as e:
            ap.error(f"--data-range: {e}")
    pipeline_spec = None
    if args.pipeline:
        from deeplearning4j_tpu_torch.analysis.pipeline import \
            InputPipelineSpec
        try:
            pipeline_spec = InputPipelineSpec.parse(args.pipeline)
        except ValueError as e:
            ap.error(f"--pipeline: {e}")

    if args.concurrency:
        if args.targets or args.zoo:
            ap.error("--concurrency lints source, not models: pass either "
                     "--concurrency targets or model targets, not both")
        # source-level lints: resolved without importing the target (and
        # without importing the model/zoo stack at all)
        from deeplearning4j_tpu_torch.analysis.concurrency import \
            analyze_concurrency
        failed = 0
        for target in args.concurrency:
            try:
                report = analyze_concurrency(target, suppress=suppress,
                                             severity_overrides=overrides)
            except FileNotFoundError as e:
                ap.error(f"--concurrency: {e}")
            print(report.format())
            if not report.ok(warnings_as_errors=not args.warnings_ok):
                failed += 1
        return 1 if failed else 0

    targets: List[Tuple[str, object]] = []
    if args.zoo:
        targets.extend((name, cls().conf_builder())
                       for name, cls in _zoo_registry().items())
    for t in args.targets:
        targets.extend(_resolve(t))
    for t in args.samediff:
        targets.extend(_resolve(t))
    for path in args.onnx:
        targets.append((path, _resolve_onnx(path)))
    if not targets:
        ap.print_usage()
        print("nothing to lint: pass --zoo and/or target names")
        return 2

    failed = 0
    total = ValidationReport()
    for name, obj in targets:
        if isinstance(obj, ValidationReport):   # unimportable .onnx: the
            report = obj.apply_config(suppress, overrides)   # pre-scan IS
        else:                                                # the report
            report = analyze(obj, batch_size=args.batch_size,
                             data_devices=args.devices, mesh=args.mesh,
                             pipeline=args.stages,
                             hbm_gb=args.hbm_gb,
                             zero=True if args.zero else None,
                             input_pipeline=pipeline_spec,
                             policy=policy_spec, data_range=range_spec,
                             cost=cost_spec, profile=profile_spec,
                             suppress=suppress,
                             severity_overrides=overrides)
        report.subject = name
        total.extend(report.diagnostics)
        print(report.format())
        if not report.ok(warnings_as_errors=not args.warnings_ok):
            failed += 1
    print(f"\n{len(targets)} model(s) linted: {len(targets) - failed} clean, "
          f"{failed} with findings ({len(total.errors())} error(s), "
          f"{len(total.warnings())} warning(s))")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
