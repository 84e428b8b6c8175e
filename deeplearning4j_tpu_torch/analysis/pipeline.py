"""Input-pipeline feasibility lint (DL4J-W108): can this host feed this
chip? (The port of ``deeplearning4j_tpu/analysis/pipeline.py``.)

The failure mode this catches: an input pipeline whose single-core decode
rate or host-to-device link bounds the feed far below the rate the card
could train at. Both bounds are *statically
decidable* from the declared pipeline configuration — worker count,
per-core decode cost, batch geometry, transfer dtype — before any
worker spawns or any capture runs:

    host_bound = min(workers / decode_s_per_img,  H2D_Bps / img_bytes)

compared against the model's estimated device rate (FLOP model at an
assumed MFU, or a measured ``device_img_per_sec``). ``host_bound <
device rate`` means the chip starves no matter how well the stages
overlap — W108 names the binding stage and the fix (more workers /
uint8 megabatch staging).

Static like the rest of ``analysis``; wired into ``analyze(...,
input_pipeline=...)``, ``conf.validate(input_pipeline=...)``, and the
CLI ``--pipeline workers=8,batch=256,decode_ms=1.3,h2d_mbps=6.2``.
"""

from __future__ import annotations

from typing import List, Optional

from deeplearning4j_tpu_torch.analysis.chipspec import CHIP_REGISTRY
from deeplearning4j_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from deeplearning4j_tpu_torch.analysis.distribution import (_approx_flops,
                                                            _propagate_types,
                                                            dtype_bytes)

#: the H100's dense bf16 peak (``chipspec`` ``h100-sxm``), TFLOP/s: the
#: default for the estimate
PEAK_TFLOPS = CHIP_REGISTRY["h100-sxm"].peak_flops / 1e12


class InputPipelineSpec:
    """Static declaration of an input pipeline for the W108 lint.

    ``decode_ms_per_img`` is the measured single-core decode+resize cost
    (the data-pipeline bench prints it); ``h2d_mbps`` the measured
    host->device bandwidth. ``dtype`` is what crosses the link
    (``"uint8"`` = on-device cast/augment, 1/4 the bytes of float32).
    ``device_img_per_sec`` overrides the FLOP-model estimate with a
    measured rate (required for graph configs, whose static FLOP
    propagation is sequential-only); ``assumed_mfu`` scales the
    estimate when no measurement exists."""

    def __init__(self, workers: int, batch_size: int,
                 decode_ms_per_img: Optional[float] = None,
                 h2d_mbps: Optional[float] = None,
                 height: Optional[int] = None, width: Optional[int] = None,
                 channels: int = 3, dtype: str = "uint8",
                 steps_per_dispatch: int = 1,
                 device_img_per_sec: Optional[float] = None,
                 assumed_mfu: float = 0.3,
                 peak_tflops: float = PEAK_TFLOPS):
        self.workers = int(workers)
        self.batch_size = int(batch_size)
        self.decode_ms_per_img = \
            None if decode_ms_per_img is None else float(decode_ms_per_img)
        self.h2d_mbps = None if h2d_mbps is None else float(h2d_mbps)
        self.height = None if height is None else int(height)
        self.width = None if width is None else int(width)
        self.channels = int(channels)
        self.dtype = str(dtype)
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.device_img_per_sec = \
            None if device_img_per_sec is None else float(device_img_per_sec)
        self.assumed_mfu = float(assumed_mfu)
        self.peak_tflops = float(peak_tflops)
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")

    _PARSE_KEYS = {
        "workers": ("workers", int),
        "batch": ("batch_size", int),
        "batch_size": ("batch_size", int),
        "decode_ms": ("decode_ms_per_img", float),
        "h2d_mbps": ("h2d_mbps", float),
        "hw": (None, int),                       # height = width = hw
        "height": ("height", int),
        "width": ("width", int),
        "channels": ("channels", int),
        "dtype": ("dtype", str),
        "steps": ("steps_per_dispatch", int),
        "mfu": ("assumed_mfu", float),
        "device_img_s": ("device_img_per_sec", float),
        "peak_tflops": ("peak_tflops", float),
    }

    @staticmethod
    def parse(text: str) -> "InputPipelineSpec":
        """``"workers=8,batch=256,decode_ms=1.3,h2d_mbps=6.2,hw=224"`` ->
        spec (the CLI ``--pipeline`` format)."""
        kw = {}
        for part in str(text).split(","):
            part = part.strip()
            if not part:
                continue
            key, eq, val = part.partition("=")
            key = key.strip().lower()
            if not eq or key not in InputPipelineSpec._PARSE_KEYS:
                known = ", ".join(sorted(InputPipelineSpec._PARSE_KEYS))
                raise ValueError(f"bad pipeline spec entry {part!r} "
                                 f"(known keys: {known})")
            field, conv = InputPipelineSpec._PARSE_KEYS[key]
            if field is None:           # hw shorthand
                kw["height"] = kw["width"] = int(val)
            else:
                kw[field] = conv(val.strip())
        if "workers" not in kw or "batch_size" not in kw:
            raise ValueError("pipeline spec needs at least workers= and "
                             "batch= entries")
        return InputPipelineSpec(**kw)

    @staticmethod
    def coerce(obj) -> Optional["InputPipelineSpec"]:
        if obj is None or isinstance(obj, InputPipelineSpec):
            return obj
        if isinstance(obj, str):
            return InputPipelineSpec.parse(obj)
        if isinstance(obj, dict):
            return InputPipelineSpec(**obj)
        raise TypeError(f"cannot coerce {type(obj).__name__} to "
                        "InputPipelineSpec (pass a spec, a dict, or a "
                        "'workers=8,batch=256,...' string)")

    def __repr__(self):
        return (f"InputPipelineSpec(workers={self.workers}, "
                f"batch={self.batch_size}, dtype={self.dtype!r})")


def _image_dims(conf, spec: InputPipelineSpec):
    """(C, H, W) crossing the link: the spec's declaration, else the
    config's convolutional InputType."""
    if spec.height is not None and spec.width is not None:
        return spec.channels, spec.height, spec.width
    it = getattr(conf, "input_type", None)
    if it is not None and getattr(it, "kind", None) == "cnn":
        d = it.dims
        return (int(d.get("channels", spec.channels)),
                int(d.get("height", 0)), int(d.get("width", 0)))
    return None


def _estimate_device_rate(conf, spec: InputPipelineSpec) -> Optional[float]:
    """img/s the device could train at: measured override, else
    FLOP-model estimate (fwd FLOPs x3 for training) at ``assumed_mfu`` —
    sequential configs only (graph FLOP propagation is not static)."""
    if spec.device_img_per_sec is not None:
        return spec.device_img_per_sec
    layers = getattr(conf, "layers", None)
    if layers is None or not hasattr(conf, "base"):
        return None
    types = _propagate_types(conf)
    fwd = sum(_approx_flops(layer, it, out)
              for layer, (it, out) in zip(layers, types))
    if fwd <= 0:
        return None
    return spec.assumed_mfu * spec.peak_tflops * 1e12 / (3.0 * fwd)


def lint_input_pipeline(conf, spec) -> List[Diagnostic]:
    """The W108 check: host-bound input img/s (decode and H2D bounds
    from the declared pipeline) vs the model's estimated device img/s —
    a pipeline that cannot feed the chip is a configuration bug no
    amount of stage overlap fixes."""
    spec = InputPipelineSpec.coerce(spec)
    if spec is None:
        return []
    diags: List[Diagnostic] = []
    dims = _image_dims(conf, spec)
    bounds = {}
    if spec.decode_ms_per_img:
        bounds["decode"] = spec.workers * 1000.0 / spec.decode_ms_per_img
    if spec.h2d_mbps and dims is not None and all(dims):
        img_bytes = dims[0] * dims[1] * dims[2] * dtype_bytes(spec.dtype)
        bounds["h2d"] = spec.h2d_mbps * 1e6 / img_bytes
    if not bounds:
        return diags                     # nothing declared to bound on
    host_bound = min(bounds.values())
    binder = min(bounds, key=bounds.get)
    device = _estimate_device_rate(conf, spec)
    if device is None or host_bound >= device:
        return diags
    hints = []
    if "decode" in bounds and bounds["decode"] < device \
            and spec.decode_ms_per_img:
        need = int(-(-device * spec.decode_ms_per_img // 1000.0))
        hints.append(f"raise decode workers to >= {need}")
    if "h2d" in bounds and bounds["h2d"] < device:
        if dtype_bytes(spec.dtype) > 1:
            hints.append("ship uint8 and cast/augment on device "
                         "(4x fewer H2D bytes than float32)")
        if spec.steps_per_dispatch <= 1:
            hints.append("stage megabatches (steps_per_dispatch=K ships "
                         "ONE [K,B,...] transfer per dispatch)")
    detail = " / ".join(f"{k} ~{v:,.0f} img/s" for k, v in sorted(bounds.items()))
    diags.append(Diagnostic(
        "DL4J-W108", Severity.WARNING, "input pipeline",
        f"this host cannot feed this chip: host-bound input rate "
        f"~{host_bound:,.0f} img/s ({binder}-bound; {detail}) is below the "
        f"device's estimated ~{device:,.0f} img/s "
        f"({host_bound / device:.0%} of device rate) — the accelerator "
        f"idles no matter how well the pipeline stages overlap",
        fix_hint="; ".join(hints) or
                 "raise the binding stage's throughput or lower the "
                 "device demand (smaller model / larger host)"))
    return diags
