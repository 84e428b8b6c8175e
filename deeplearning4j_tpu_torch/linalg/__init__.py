"""Eager arrays (the port of ``deeplearning4j_tpu/linalg``): ``NDArray``
(ND4J's ``INDArray``) over a ``torch.Tensor``, the ``nd`` factory
(``Nd4j``), ``DataType``, ``Conditions``/``BooleanIndexing`` and
``Transforms``. Arrays made from host data go to ``cuda`` unless the
call names another device."""

from deeplearning4j_tpu_torch.linalg.dtypes import DataType  # noqa: F401
from deeplearning4j_tpu_torch.linalg.ndarray import NDArray  # noqa: F401
from deeplearning4j_tpu_torch.linalg import factory as nd  # noqa: F401
from deeplearning4j_tpu_torch.linalg.conditions import (  # noqa: F401
    BooleanIndexing,
    Condition,
    Conditions,
)
from deeplearning4j_tpu_torch.linalg import transforms as Transforms  # noqa: F401
