"""Data types (the port of ``deeplearning4j_tpu/linalg/dtypes.py``).

Reference parity: ``org.nd4j.linalg.api.buffer.DataType`` (the enum every
INDArray carries). FLOAT is the default storage type, BFLOAT16 the
preferred compute type on the tensor cores.

The JAX package runs without x64: an array asked for as DOUBLE, INT64 or
UINT64 comes out float32, int32 or uint32 there. :func:`canonical` is
that rule for torch dtypes; the eager ``NDArray`` applies it to every
buffer it holds, so its observable dtypes are the JAX package's.
``.torch`` is the dtype as asked; the registry's float64 gradient checks
build their tensors from it directly.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class DataType(enum.Enum):
    DOUBLE = "float64"
    FLOAT = "float32"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    INT64 = "int64"
    INT32 = "int32"
    INT16 = "int16"
    INT8 = "int8"
    UINT64 = "uint64"
    UINT32 = "uint32"
    UINT16 = "uint16"
    UINT8 = "uint8"
    BOOL = "bool"

    @property
    def torch(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def np(self):
        if self is DataType.BFLOAT16:
            raise TypeError("numpy has no bfloat16")
        return np.dtype(self.value)

    def is_fp(self) -> bool:
        return self in (DataType.DOUBLE, DataType.FLOAT, DataType.HALF, DataType.BFLOAT16)

    def is_int(self) -> bool:
        return self in (
            DataType.INT64, DataType.INT32, DataType.INT16, DataType.INT8,
            DataType.UINT64, DataType.UINT32, DataType.UINT16, DataType.UINT8,
        )

    @staticmethod
    def from_dtype(dt) -> "DataType":
        if isinstance(dt, torch.dtype):
            name = str(dt).split(".")[-1]
        else:
            name = np.dtype(dt).name
        for member in DataType:
            if member.value == name:
                return member
        raise ValueError(f"Unsupported dtype: {dt}")


#: the JAX package's dtypes without x64: 64-bit types narrow to 32 bits
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32, torch.complex128: torch.complex64}


def canonical(dt: torch.dtype) -> torch.dtype:
    """The dtype the JAX package gives an array asked for as ``dt``."""
    return _NARROW.get(dt, dt)


# Type-promotion order used by pairwise ops (ref: ND4J's
# Nd4j.defaultFloatingPointType + DataTypeUtil promotion rules; torch's
# promotion matches in practice for the supported set).
DEFAULT_FLOAT = DataType.FLOAT
