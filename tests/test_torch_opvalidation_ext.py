"""The port's OpValidation cases of ``validation_ext.build_ext_cases``
against the JAX package's (see tests/test_torch_opvalidation.py): the
port's harness on the CPU, then the outputs against the JAX op on the
same seeded args at the case's tolerance."""

import pytest
import torch

from deeplearning4j_tpu.ops.validation_ext import build_ext_cases as jax_cases
from deeplearning4j_tpu_torch.ops.validation_ext import build_ext_cases
from test_torch_opvalidation import check_case

torch.set_num_threads(2)

TCASES = build_ext_cases()
JCASES = jax_cases()


def test_case_lists_line_up():
    assert [c.op for c in TCASES] == [c.op for c in JCASES]


@pytest.mark.parametrize("i", range(len(TCASES)),
                         ids=[c.op for c in TCASES])
def test_op(i):
    check_case(TCASES[i], JCASES[i])
