"""Hopper layout lints (W1xx) — static checks against tensor-core and
mesh geometry (the port of ``deeplearning4j_tpu/analysis/layout.py``,
whose rules were written for the TPU's 8x128 MXU tile).

On Hopper a warpgroup MMA (``wgmma``) multiplies a 64-row tile of A by
an N-wide tile of B, N a multiple of 8 up to 256, over a K step of 32
bytes (16 bf16/fp16 values). A GEMM kernel tiles its output into CTA
tiles of two 64-row warpgroups by 128 columns (CUTLASS's sm90 default,
``m64n128k16`` per warpgroup), so a GEMM whose N dim sits just past a
multiple of 128 pads its last column of tiles: nOut=300 runs as 384
columns, 22% of every MAC dead (the rule keeps the MXU's 128-lane
width). Under a 16-bit compute dtype an N that is not a multiple of 8
also breaks the 16-byte row alignment that TMA copies need, and that
costs more: ``chip_smoke.py`` phase 33 (e) times a bf16 matmul at N =
296, 300, 304, 384, 424, 425 and 512 and YOLO2's 1x1 head conv at 424,
425 and 432 channels beside the verdicts this module gives. dtypes:
float16 runs at the bf16 rate on the tensor cores and is not flagged;
float64 has no bf16-rate path. The data-parallel mesh check (a global
batch that does not divide the data axis leaves ragged per-device
shards) is the JAX package's.

These lints read only declared config shapes — no tensor, no trace.
Thresholds are deliberately conservative (dim >= 256, and > 20% padding
waste or misaligned 16-bit rows) so realistic published architectures
(NASNet's 44-filter cells, Xception's 728) stay clean while wasteful
layouts get flagged. YOLO2's 425-channel head is flagged under a bf16
or fp16 policy: the card runs it several times slower than 424 or 432.
"""

from __future__ import annotations

from typing import List, Optional

from deeplearning4j_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from deeplearning4j_tpu_torch.nn.precision import LOW_PRECISION

#: rows of one Hopper ``wgmma`` tile (the MXU's 8 sublanes' role)
WGMMA_M = 64
#: ``wgmma``'s N is a multiple of this (up to 256)
WGMMA_N_STEP = 8
#: the K step of one ``wgmma``, in bytes (16 bf16/fp16 values)
WGMMA_K_BYTES = 32
#: the K step in 2-byte elements: a K (contraction) dim sharded below it
#: pads every per-device GEMM back up (W106)
WGMMA_K = WGMMA_K_BYTES // 2
#: the N width of a Hopper GEMM's CTA tile — the width an N dim pads to
GEMM_TILE_N = 128
#: Only lint N dims at least this large — below it the whole operand
#: fits one tile and alignment is noise next to launch overhead.
MIN_LINT_DIM = 256
#: Padding-waste fraction above which W101 fires.
WASTE_THRESHOLD = 0.20

#: dtypes with no tensor-core path at the bf16 rate on Hopper (float16
#: has one, at the bf16 rate, and is not flagged)
NON_NATIVE_DTYPES = {"float64", "double", "f64"}


def padding_waste(dim: int, tile: int = GEMM_TILE_N) -> float:
    """Fraction of a padded tile row that is dead: (ceil-pad - dim)/pad."""
    padded = ((int(dim) + tile - 1) // tile) * tile
    return (padded - dim) / padded


def padded_dim(dim: int, tile: int = GEMM_TILE_N) -> int:
    """``dim`` rounded up to the tile width."""
    return ((int(dim) + tile - 1) // tile) * tile


def _is_conv(layer) -> bool:
    """4-D spatial conv-family check without importing nn.layers (this
    module stays static): the conv classes all carry kernel+stride
    geometry.  Convolution1D/3D are excluded — the NHWC compute-layout
    seam only stamps the 2-D family, so the layout-aware W101 text
    would prescribe (or claim) a fix that never applies to them."""
    name = type(layer).__name__
    return (("Convolution" in name or "Deconvolution" in name)
            and not name.endswith(("1D", "3D"))
            and hasattr(layer, "kernel") and hasattr(layer, "stride"))


def lint_lane_dim(dim: int, location: str, *, conv: bool = False,
                  compute_layout: str = "NCHW",
                  compute_dtype: str = "float32") -> Optional[Diagnostic]:
    """W101 when a GEMM's N dim pads wastefully on the Hopper CTA tile,
    or, under a 16-bit compute dtype, is not a multiple of
    ``WGMMA_N_STEP``.

    The second is the larger cost on the card (``chip_smoke.py`` phase
    33 (e)): bf16 rows that miss the 16-byte TMA alignment send the
    library GEMMs and convolutions to slower kernels, so a bf16 matmul at
    N=425 runs several times N=424's, and so does YOLO2's 425-channel
    head conv, while N=296 and 304 run as fast as N=384 despite their
    padding. fp32 (TF32 off) runs on the CUDA cores, off the TMA path.

    For conv layers the finding is layout-aware: under the default NCHW
    compute layout the fix hint points at the NHWC seam
    (``setComputeLayout("NHWC")`` / ``computeLayout("NHWC")``) as well as
    the channel rounding; when the NHWC layout is active the message
    says so — the remaining waste is pure tile padding, and only the
    channel count can recover it."""
    if not dim or dim < MIN_LINT_DIM:
        return None
    waste = padding_waste(dim)
    misaligned = compute_dtype in LOW_PRECISION and dim % WGMMA_N_STEP != 0
    if waste <= WASTE_THRESHOLD and not misaligned:
        return None
    padded = padded_dim(dim)
    aligned = padded_dim(dim, WGMMA_N_STEP)
    tail = (f"{dim} is not a multiple of {WGMMA_N_STEP}, so its "
            f"{compute_dtype} rows miss the 16-byte alignment TMA copies "
            f"need and the GEMM runs on a slower kernel")
    if waste > WASTE_THRESHOLD:
        msg = (f"GEMM N dim {dim} pads to {padded} on the {WGMMA_M * 2}x"
               f"{GEMM_TILE_N} Hopper tensor-core CTA tile — {waste:.0%} "
               f"of every MAC in this matmul is dead padding")
        if misaligned:
            msg += f"; {tail}"
        hint = (f"round the feature/channel count to a multiple of "
                f"{GEMM_TILE_N} (e.g. {padded} or "
                f"{max(GEMM_TILE_N, padded - GEMM_TILE_N)})")
    else:
        msg = f"GEMM N dim {dim}: {tail}"
        hint = (f"round the feature/channel count to a multiple of "
                f"{WGMMA_N_STEP} (e.g. {aligned - WGMMA_N_STEP} or "
                f"{aligned}); a width the loss fixes (a detection head's "
                f"anchors x (5 + classes), a vocabulary) can be padded and "
                f"the extra outputs ignored")
    if conv:
        if compute_layout == "NHWC":
            msg += (" (NHWC compute layout is active — the remaining "
                    "waste is tile padding, not layout)")
        else:
            hint += ("; for conv stacks also enable the NHWC compute "
                     "layout (setComputeLayout('NHWC') / builder "
                     ".computeLayout('NHWC')) so channels sit on the "
                     "GEMM's N axis natively")
    return Diagnostic("DL4J-W101", Severity.WARNING, location, msg,
                      fix_hint=hint)


def lint_layers(located_layers, compute_layout: str = "NCHW",
                compute_dtype: str = "float32") -> List[Diagnostic]:
    """W101 over ``(location, layer)`` pairs using each layer's
    ``gemm_lane_dims()`` declared-shape hook. ``compute_layout`` is the
    model's active conv compute layout — it shapes the conv findings'
    text (see ``lint_lane_dim``) without changing when they fire;
    ``compute_dtype`` is the precision policy's compute dtype."""
    diags = []
    for location, layer in located_layers:
        dims = getattr(layer, "gemm_lane_dims", None)
        if dims is None:
            continue
        conv = _is_conv(layer)
        # a per-layer ``data_format`` stamp (the networks' NHWC seam —
        # an INSTANCE attribute; the class default is not a stamp) wins
        # over the config-level declaration
        fmt = getattr(layer, "__dict__", {}).get("data_format") \
            or compute_layout
        for d in dims():
            diag = lint_lane_dim(d, location, conv=conv,
                                 compute_layout=fmt,
                                 compute_dtype=compute_dtype)
            if diag is not None:
                diags.append(diag)
    return diags


#: Device types whose convolutions want channels minor-most: cuDNN's
#: Hopper tensor-core convolutions run NHWC, and an NCHW stack pays a
#: transpose at every layer. CPU is excluded: oneDNN re-layouts
#: internally either way, so the NCHW default is not a predictable loss
#: there.
CHANNELS_LAST_DEVICES = frozenset({"cuda"})

#: Minimum run of NCHW convs before the stack lint fires — a single
#: conv's relayout cost is launch noise; a stack compounds it.
MIN_CONV_STACK = 2


def lint_conv_stack(located_layers, compute_layout: str,
                    device_type: Optional[str]) -> List[Diagnostic]:
    """Proactive W101: an NCHW conv stack on a channels-last device is
    flagged before any training step runs — the per-layer lint only
    fires on padding waste, but a stack of NCHW convs pays relayout even
    with perfectly aligned channels. ``device_type`` is the type of the
    device an initialised network's parameters live on (``"cuda"``), or
    None for a configuration or a network before ``init``: the analysis
    reads that, and probes no device. Layers carrying an NHWC
    ``data_format`` instance stamp (the ``setComputeLayout`` seam) don't
    count."""
    if device_type not in CHANNELS_LAST_DEVICES:
        return []
    convs = []
    for location, layer in located_layers:
        if not _is_conv(layer):
            continue
        fmt = getattr(layer, "__dict__", {}).get("data_format") \
            or compute_layout
        if fmt != "NHWC":
            convs.append(location)
    if len(convs) < MIN_CONV_STACK:
        return []
    first, last = convs[0], convs[-1]
    return [Diagnostic(
        "DL4J-W101", Severity.WARNING, first,
        f"{len(convs)} conv layers ({first} .. {last}) run in the NCHW "
        f"compute layout on a '{device_type}' device — every conv pays "
        f"transpose/relayout overhead instead of keeping channels on the "
        f"GEMM's N axis",
        fix_hint='enable the NHWC compute seam before training: '
                 'setComputeLayout("NHWC") (or builder '
                 '.computeLayout("NHWC")), or let the autotuner pick the '
                 'layout: python -m deeplearning4j_tpu_torch.tune <model>')]


def lint_dtype(dtype, location: str = "config") -> List[Diagnostic]:
    """W102 for dtypes with no bf16-rate tensor-core path on Hopper."""
    if dtype is None:
        return []
    name = str(dtype).lower()
    if name not in NON_NATIVE_DTYPES:
        return []
    return [Diagnostic(
        "DL4J-W102", Severity.WARNING, location,
        f"dtype {dtype!r} has no bf16-rate tensor-core path on Hopper "
        f"(float64 runs at a fraction of the bf16 rate)",
        fix_hint="use float32 (or dataType('bfloat16') for the "
                 "mixed-precision policy); float16 and bfloat16 both run "
                 "at the tensor cores' full rate")]


def lint_batch_mesh(batch_size: Optional[int], data_devices: Optional[int],
                    location: str = "config") -> List[Diagnostic]:
    """W103 when the global batch does not divide the data-mesh axis."""
    if not batch_size or not data_devices or data_devices <= 1:
        return []
    if batch_size % data_devices == 0:
        return []
    return [Diagnostic(
        "DL4J-W103", Severity.WARNING, location,
        f"batch size {batch_size} does not divide the data-parallel mesh "
        f"axis ({data_devices} devices) — per-device shards would be "
        f"ragged and the sharded dispatch will pad or fail",
        fix_hint=f"use a global batch that is a multiple of {data_devices} "
                 f"(e.g. {((batch_size // data_devices) + 1) * data_devices})")]
