"""Chip capability registry for the static cost model (the port of
``deeplearning4j_tpu/analysis/chipspec.py``).

A :class:`ChipSpec` is the hardware half of the cost model's inputs: the
peak matmul throughput, HBM capacity and bandwidth, and interconnect
bandwidth that :mod:`analysis.cost` roofs its predictions against. The
registry carries the card the port runs on, ``h100-sxm`` (the default),
and a deliberately small ``cpu`` entry for tests; everything is plain
Python, so the module imports without a card.

Numbers are per card and intentionally round: the cost model is a
planning oracle, not a benchmark. ``peak_flops`` is the dense bf16/fp16
tensor-core peak. On Hopper fp32 is not "half the bf16 rate" (the MXU's
rule): with TF32 off, fp32 runs on the CUDA cores at 67 TFLOP/s against
989 for bf16 on the tensor cores, so each spec carries its own fp32
peak (``fp32_peak_flops``) and :meth:`ChipSpec.peak_for` reads it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Union

#: fp32 spellings :meth:`ChipSpec.peak_for` maps to the fp32 peak
_FP32_NAMES = ("float32", "fp32", "f32")


@dataclass(frozen=True)
class ChipSpec:
    """Per-card hardware capabilities used by the roofline/liveness model.

    :param name: registry key (``"h100-sxm"``) or a free-form label for
        custom specs.
    :param peak_flops: dense bf16/fp16 matmul peak, FLOP/s per card.
    :param hbm_gb: HBM capacity per card in GiB.
    :param hbm_gbps: HBM bandwidth, GB/s per card.
    :param ici_gbps: card-to-card interconnect bandwidth (NVLink), GB/s
        per card each way (the divisor for gradient-collective bytes).
    :param host_gbps: host <-> card (PCIe) bandwidth, GB/s — used for
        prefetch/staging feasibility, not the step-time roofline.
    :param fp32_peak_flops: fp32 matmul peak, FLOP/s per card, with TF32
        off; None means the card has no separate fp32 rate and runs fp32
        at ``peak_flops``.
    """

    name: str
    peak_flops: float
    hbm_gb: float
    hbm_gbps: float
    ici_gbps: float
    host_gbps: float = 16.0
    fp32_peak_flops: Optional[float] = None

    def peak_for(self, dtype: str = "bf16") -> float:
        """Matmul peak for a compute dtype: the spec's own fp32 peak for
        fp32, the tensor-core peak for bf16 and fp16."""
        d = (dtype or "bf16").lower()
        if d in _FP32_NAMES and self.fp32_peak_flops is not None:
            return self.fp32_peak_flops
        return self.peak_flops

    @property
    def hbm_bytes(self) -> float:
        return self.hbm_gb * (1 << 30)

    def with_hbm_gb(self, hbm_gb: float) -> "ChipSpec":
        return replace(self, hbm_gb=hbm_gb)

    @classmethod
    def coerce(cls, obj: Union["ChipSpec", str, Dict, None],
               default: str = "h100-sxm") -> "ChipSpec":
        """Accept a ChipSpec, a registry name, a dict of fields, or None
        (-> the default card). Unknown names raise with the known list.
        """
        if obj is None:
            return CHIP_REGISTRY[default]
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, str):
            key = obj.lower()
            if key not in CHIP_REGISTRY:
                raise ValueError(
                    "unknown chip %r — known chips: %s"
                    % (obj, ", ".join(sorted(CHIP_REGISTRY))))
            return CHIP_REGISTRY[key]
        if isinstance(obj, dict):
            d = dict(obj)
            d.setdefault("name", "custom")
            return cls(**d)
        raise TypeError("cannot coerce %r to a ChipSpec" % (obj,))


#: Published per-card numbers. ``h100-sxm``: NVIDIA's H100 SXM data sheet
#: (dense, no sparsity): 989 TFLOP/s bf16/fp16 on the tensor cores,
#: 67 TFLOP/s fp32 on the CUDA cores (TF32 off), 80 GB (74.5 GiB) of HBM3
#: at 3,350 GB/s, NVLink 900 GB/s all to all (450 each way), PCIe 5 x16
#: to the host (64 GB/s).
CHIP_REGISTRY: Dict[str, ChipSpec] = {
    "h100-sxm": ChipSpec("h100-sxm", peak_flops=989e12, hbm_gb=74.5,
                         hbm_gbps=3350.0, ici_gbps=450.0, host_gbps=64.0,
                         fp32_peak_flops=67e12),
    # Test/dev stand-in: small enough that fixtures can overflow it (the
    # JAX package's entry, fp32 at half its bf16 rate)
    "cpu": ChipSpec("cpu", peak_flops=0.5e12, hbm_gb=4.0,
                    hbm_gbps=50.0, ici_gbps=10.0, host_gbps=8.0,
                    fp32_peak_flops=0.25e12),
}


def chip_names() -> tuple:
    return tuple(sorted(CHIP_REGISTRY))
