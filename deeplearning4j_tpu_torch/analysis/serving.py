"""Serving-config lint: batch buckets x mesh x HBM — validate a
deployment before it captures or takes traffic (the port of
``deeplearning4j_tpu/analysis/serving.py``).

The model server pads coalesced batches to a fixed bucket ladder and
captures every bucket's forward on the serving card. This module makes
the three ways that configuration goes wrong statically checkable (no
device — same contract as the rest of ``analysis``):

- ``DL4J-E110``: a bucket does not divide the mesh's data axis — the
  sharded dispatch cannot place it and the first request fails at
  staging, after warmup already burned the captures.
- ``DL4J-E111``: per-device HBM estimate (replicated params + the
  largest bucket's activation working set) exceeds the budget — the
  server OOMs under exactly the biggest coalesced batch, i.e. at peak
  load.
- ``DL4J-W110``: a pathological bucket ladder (duplicates, or more
  buckets than :data:`BUCKET_COUNT_THRESHOLD`) — every bucket x shape
  is one captured graph held in the graph pool, and warmup
  time scales with the product.
- ``DL4J-W111``: a registry roll planned onto a version without warmed
  buckets — the first post-roll request at an unwarmed (bucket, shape)
  captures under live traffic, exactly the cold-start the zero-drop
  hot-swap exists to avoid.
- ``DL4J-W112``: a serving/registry warmup running without a persistent
  compile cache. The port's ``nn.compilecache`` has only its memory tier
  (its disk tier is still to come), so :func:`lint_compile_cache`
  always reports it, and ``lint_serving`` runs it only on behalf of an
  actual warmup (``check_cache=True``): ``validate()`` stays silent so
  config linting is environment-independent.

Entry points: :func:`lint_serving` (what ``ModelServer.validate()`` /
``warmup(strict=True)`` call) — accepts a network, or a bare
configuration, plus the bucket ladder and an optional mesh / HBM
budget — and :func:`lint_registry_roll` (what
``ModelRegistry.validate_roll()`` / ``roll(strict=True)`` call),
duck-typed over server objects.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from deeplearning4j_tpu_torch.analysis.diagnostics import (
    Diagnostic, Severity, ValidationReport)
from deeplearning4j_tpu_torch.analysis.distribution import (
    MeshSpec, _fmt_bytes, _param_facts, _propagate_types, _prod, dtype_bytes)

#: W110 fires past this many buckets: each bucket x input shape is one
#: captured graph (warm-up and capture at warmup, graph-pool HBM after).
BUCKET_COUNT_THRESHOLD = 8


def _entries(model_or_conf):
    """(location, layer) pairs from a network, a sequential config, or a
    graph config — mirrors distribution's entry building, duck-typed."""
    conf = getattr(model_or_conf, "conf", model_or_conf)
    if hasattr(conf, "layers"):
        from deeplearning4j_tpu_torch.analysis.analyzer import _layer_loc
        return conf, [(_layer_loc(i, l), l, None, None)
                      for i, l in enumerate(conf.layers)]
    if hasattr(conf, "nodes"):
        from deeplearning4j_tpu_torch.analysis.analyzer import _node_loc
        return conf, [(_node_loc(n), n.obj, None, None)
                      for n in conf.nodes if n.kind == "layer"]
    return conf, []


def _activation_bytes_per_example(conf, shapes, itemsize: int) -> float:
    """Per-example forward working-set estimate: the summed declared
    layer output sizes (InputType propagation) when available, else the
    raw feature size — deliberately coarse, this is a budget lint, not
    an allocator."""
    total = 0
    try:
        for _in_t, out_t in _propagate_types(conf):
            if out_t is None:
                continue
            dims = [int(v) for v in getattr(out_t, "dims", {}).values()
                    if isinstance(v, (int, float)) and v > 0]
            if dims:
                total += _prod(dims)
    except Exception:
        total = 0
    if total == 0 and shapes:
        total = max(_prod([int(d) for d in s]) for s in shapes if s)
    return float(total) * itemsize


def lint_compile_cache(context: str = "serving warmup") -> List[Diagnostic]:
    """The DL4J-W112 check: is the compile cache's disk tier (its
    warm-signature manifests) configured and writable?"""
    from deeplearning4j_tpu_torch.nn.compilecache import (ENV_DIR,
                                                          cache_dir_status)
    directory, writable = cache_dir_status()
    if directory is None:
        return [Diagnostic(
            "DL4J-W112", Severity.WARNING, context,
            "no persistent compile cache is configured — every fresh "
            "process, rollout, and hot-swap staging learns its signatures "
            "from traffic, and captures the ones an earlier run already "
            "captured only when they arrive",
            fix_hint=f"set {ENV_DIR}=/path/shared/by/your/fleet (or call "
                     "nn.compilecache.configure(dir)) so warmup replays "
                     "the manifests of previously-seen (model, bucket, "
                     "policy) signatures before traffic")]
    if not writable:
        return [Diagnostic(
            "DL4J-W112", Severity.WARNING, context,
            f"persistent compile cache directory {directory!r} is not "
            "writable — warmup can neither populate nor refresh its "
            "manifests, so rollouts on new (model, bucket, policy) "
            "signatures still start cold",
            fix_hint="fix the directory permissions (or point "
                     f"{ENV_DIR} at a writable path)")]
    return []


def lint_serving(model_or_conf, buckets: Sequence[int], mesh=None,
                 shapes: Optional[Iterable[Sequence[int]]] = None,
                 hbm_gb: Optional[float] = None, input_dtype=None,
                 check_cache: bool = False,
                 extra: Iterable[Diagnostic] = ()) -> ValidationReport:
    """Static serving-config report for ``buckets`` on ``mesh``.

    ``mesh`` coerces like everywhere else (MeshSpec, dict, string, or a
    runtime DeviceMesh); ``shapes`` are per-request feature shapes (the
    ``warmup()`` argument) for the activation estimate; ``hbm_gb``
    enables E111 (None skips it — CPU tests have no HBM to budget);
    ``extra`` folds pre-existing diagnostics (the server's W201 churn
    findings) into the report; ``check_cache=True`` (the warmup path)
    adds the DL4J-W112 persistent-compile-cache check."""
    spec = MeshSpec.coerce(mesh) if mesh is not None else None
    buckets = [int(b) for b in buckets]
    diags: List[Diagnostic] = list(extra)
    if check_cache:
        diags.extend(lint_compile_cache())

    data_width = spec.size(spec.data_axis) if spec is not None else 1
    if data_width > 1:
        for b in buckets:
            if b % data_width != 0:
                diags.append(Diagnostic(
                    "DL4J-E110", Severity.ERROR, "serving buckets",
                    f"bucket {b} does not divide the '{spec.data_axis}' "
                    f"axis ({data_width} devices) — the sharded dispatch "
                    "cannot place it and the first request at this bucket "
                    "fails AFTER warmup captured it",
                    fix_hint=f"use bucket sizes that are multiples of "
                             f"{data_width} (ModelServer.buckets() derives "
                             "a correct ladder from the mesh)"))

    if len(set(buckets)) != len(buckets):
        diags.append(Diagnostic(
            "DL4J-W110", Severity.WARNING, "serving buckets",
            f"duplicate bucket sizes in {sorted(buckets)} — each entry "
            "costs one warmup capture per input shape for the same "
            "graph",
            fix_hint="deduplicate the bucket ladder"))
    elif len(buckets) > BUCKET_COUNT_THRESHOLD:
        diags.append(Diagnostic(
            "DL4J-W110", Severity.WARNING, "serving buckets",
            f"{len(buckets)} buckets (threshold "
            f"{BUCKET_COUNT_THRESHOLD}) — every bucket x input shape is "
            "one captured graph: warmup time and graph-pool footprint "
            "scale with the product",
            fix_hint="coarsen the ladder (power-of-two steps from the "
                     "mesh data width to batch_limit is the default)"))

    if hbm_gb is not None and buckets:
        conf, entries = _entries(model_or_conf)
        itemsize = dtype_bytes(input_dtype
                               if input_dtype is not None
                               else getattr(getattr(conf, "base", None),
                                            "dtype", None))
        pspec = spec if spec is not None else MeshSpec({"data": 1})
        facts = _param_facts(entries, pspec, itemsize)
        param_bytes = sum(f.bytes_per_device for f in facts)
        act = _activation_bytes_per_example(conf, shapes or (), itemsize)
        biggest = max(buckets)
        act_bytes = act * biggest / max(data_width, 1)
        budget = float(hbm_gb) * 1024 ** 3
        if param_bytes + act_bytes > budget:
            diags.append(Diagnostic(
                "DL4J-E111", Severity.ERROR, "serving memory",
                f"per-device serving footprint "
                f"{_fmt_bytes(param_bytes + act_bytes)} (params "
                f"{_fmt_bytes(param_bytes)} + bucket-{biggest} activations "
                f"~{_fmt_bytes(act_bytes)}) exceeds the {hbm_gb:g} GiB HBM "
                "budget — the server OOMs at peak coalesced load",
                fix_hint="lower batch_limit (the largest bucket), shard "
                         "the model over a model axis, or raise hbm_gb"))

    return ValidationReport(diags, subject="serving config")


def lint_registry_roll(model_name: str, target, active=None
                       ) -> ValidationReport:
    """Pre-roll lint for a multi-model registry version swap: ``target``
    (and optionally the currently ``active`` version) are server-like
    objects exposing ``_warmed`` / ``_warm_shapes`` / ``buckets()`` —
    duck-typed, so the check runs before any traffic moves.

    - ``DL4J-W111`` when the target was never warmed at all, or when
      shapes the active version serves warm are missing from the
      target's warmed set (those requests are refused as unwarmed right
      after the roll).
    """
    diags: List[Diagnostic] = []
    loc = f"registry roll -> {model_name}"
    warmed = bool(getattr(target, "_warmed", False))
    t_shapes = [tuple(s) for s in getattr(target, "_warm_shapes", [])]
    if not warmed:
        diags.append(Diagnostic(
            "DL4J-W111", Severity.WARNING, loc,
            "roll planned onto a version with NO warmed buckets — every "
            "post-roll request runs uncaptured under live traffic (the "
            "cold start a zero-drop hot-swap must not pay)",
            fix_hint="warmup([...]) the new version on the serving card "
                     "BEFORE roll() (ModelRegistry.load does this when "
                     "shapes are known)"))
    elif active is not None:
        a_shapes = [tuple(s) for s in getattr(active, "_warm_shapes", [])]
        missing = [s for s in a_shapes if s not in t_shapes]
        if missing:
            diags.append(Diagnostic(
                "DL4J-W111", Severity.WARNING, loc,
                f"active version serves warmed shapes {missing} the roll "
                "target never captured — those requests are refused as "
                "unwarmed shapes right after the swap",
                fix_hint="warm the target with the active version's full "
                         "shape set before rolling"))
    return ValidationReport(diags, subject="registry roll")
