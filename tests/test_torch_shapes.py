"""The port's shape functions against the JAX package's (the port of
``tests/test_shapes.py``'s table cases): the same shapes and the same
``OpShapeError`` messages from both packages; for every OpValidation case
whose JAX ``infer_shape`` answers, the port answers the same; an op whose
output shape depends on the data raises on both sides; and
``infer_shape`` makes tensors on ``meta`` only (no memory on a real
device, no kernel)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax.numpy as jnp

from deeplearning4j_tpu.ops import convolution as jconv
from deeplearning4j_tpu.ops import registry as JR
from deeplearning4j_tpu.ops import shapes as JS
from deeplearning4j_tpu_torch.ops import convolution as tconv
from deeplearning4j_tpu_torch.ops import registry as TR
from deeplearning4j_tpu_torch.ops import shapes as TS
from deeplearning4j_tpu_torch.ops import validation as TV

SIDES = [pytest.param(JS, id="jax"), pytest.param(TS, id="torch")]

#: (op, arg shapes, kwargs, expected) — tests/test_shapes.py's table
TABLE = [
    ("conv2d", [(2, 3, 32, 32), (16, 3, 3, 3)], {"pad": 1}, (2, 16, 32, 32)),
    ("conv2d", [(2, 3, 32, 32), (16, 3, 3, 3)], {"stride": 2, "pad": 1},
     (2, 16, 16, 16)),
    ("conv2d", [(2, 32, 32, 3), (16, 3, 3, 3)],
     {"mode": "same", "data_format": "NHWC"}, (2, 32, 32, 16)),
    ("conv1d", [(2, 3, 10), (8, 3, 3)], {"pad": 1}, (2, 8, 10)),
    ("conv3d", [(1, 2, 8, 8, 8), (4, 2, 3, 3, 3)], {"pad": 1},
     (1, 4, 8, 8, 8)),
    ("maxpool2d", [(2, 8, 16, 16)], {"kernel": 2}, (2, 8, 8, 8)),
    ("deconv2d", [(1, 8, 8, 8), (4, 8, 2, 2)], {"stride": 2}, (1, 4, 16, 16)),
    ("matmul", [(4, 5), (5, 7)], {}, (4, 7)),
    ("matmul", [(2, 4, 5), (2, 5, 7)], {}, (2, 4, 7)),
    ("matmul", [(4, 5), (7, 5)], {"transpose_b": True}, (4, 7)),
    ("lstmLayer", [(10, 2, 8), (8, 16), (4, 16), (16,)], {},
     ((10, 2, 4), ((2, 4), (2, 4)))),
    ("gru", [(5, 3, 6), (6, 12), (4, 12), (12,), (12,)], {},
     ((5, 3, 4), (3, 4))),
    ("cholesky", [(4, 4)], {}, (4, 4)),
    ("solve", [(4, 4), (4, 2)], {}, (4, 2)),
    ("svd", [(6, 4)], {}, ((6, 4), (4,), (4, 4))),
    ("xw_plus_b", [(3, 4), (4, 5), (5,)], {}, (3, 5)),
    ("batchnorm", [(2, 3, 4, 4), (3,), (3,)], {}, (2, 3, 4, 4)),
    # the fallback: the generic op on meta tensors / jax.eval_shape
    ("softplus", [(3, 4)], {}, (3, 4)),
    ("reduce_sum", [(3, 4)], {"axis": 1}, (3,)),
    ("transpose", [(2, 5)], {}, (5, 2)),
]

#: (op, arg shapes, kwargs, error class, message regex) — the same
#: messages from both packages
ERRORS = [
    ("conv2d", [(3, 32, 32), (16, 3, 3, 3)], {}, "OpShapeError",
     r"Conv2D: expected NCHW \[N,C,H,W\], got rank 3"),
    ("conv2d", [(2, 4, 8, 8), (16, 3, 3, 3)], {}, "OpShapeError",
     "4 channels but weights"),
    ("conv2d", [(1, 3, 2, 2), (8, 3, 5, 5)], {}, "ValueError",
     "cannot be applied"),
    ("conv3d", [(1, 2, 8, 8), (4, 2, 3, 3, 3)], {}, "OpShapeError",
     "Conv3D"),
    ("maxpool2d", [(8, 16, 16)], {"kernel": 2}, "OpShapeError", "MaxPool2D"),
    ("matmul", [(4, 5), (6, 7)], {}, "OpShapeError", "inner dims mismatch"),
    ("lstmLayer", [(10, 8), (8, 16), (4, 16), (16,)], {}, "OpShapeError",
     "LstmLayer"),
    ("cholesky", [(4, 5)], {}, "OpShapeError", "square"),
    ("xw_plus_b", [(3, 4), (5, 5), (5,)], {}, "OpShapeError", "XwPlusB"),
]


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("op,shapes,kw,want", TABLE,
                         ids=[f"{t[0]}-{i}" for i, t in enumerate(TABLE)])
def test_table(side, op, shapes, kw, want):
    assert side.infer_shape(op, *shapes, **kw) == want


@pytest.mark.parametrize("op,shapes,kw,err,msg", ERRORS,
                         ids=[f"{t[0]}-{i}" for i, t in enumerate(ERRORS)])
def test_same_errors_with_the_same_messages(op, shapes, kw, err, msg):
    caught = []
    for side in (JS, TS):
        cls = side.OpShapeError if err == "OpShapeError" else ValueError
        with pytest.raises(cls, match=msg) as e:
            side.infer_shape(op, *shapes, **kw)
        caught.append(str(e.value))
    assert caught[0] == caught[1]


def test_real_conv_calls_raise_the_shape_error():
    with pytest.raises(JS.OpShapeError, match="got rank 3"):
        jconv.conv2d(jnp.ones((3, 8, 8)), jnp.ones((4, 3, 3, 3)))
    with pytest.raises(TS.OpShapeError, match="got rank 3"):
        tconv.conv2d(torch.ones(3, 8, 8), torch.ones(4, 3, 3, 3))
    with pytest.raises(TS.OpShapeError, match="Conv1D"):
        tconv.conv1d(torch.ones(1, 3, 8), torch.ones(6, 2, 3))


def test_conv_contract_checked_once_per_distinct_call(monkeypatch):
    """A conv call's contract is checked the first time its shapes and
    settings are seen; a repeat skips it, a call that breaks it raises
    every time."""
    calls = []
    check = TS.check_call
    monkeypatch.setattr(TS, "check_call",
                        lambda *a, **k: calls.append(a[0]) or check(*a, **k))
    monkeypatch.setattr(tconv, "_CHECKED", set())
    x, w = torch.ones(1, 3, 9, 9), torch.ones(4, 3, 3, 3)
    for _ in range(3):
        tconv.conv2d(x, w, stride=2)
    tconv.conv2d(x, w, stride=1)
    assert calls == ["conv2d", "conv2d"]
    for _ in range(2):
        with pytest.raises(TS.OpShapeError, match="got rank 3"):
            tconv.conv2d(torch.ones(3, 9, 9), w)
    assert len(calls) == 4 and len(tconv._CHECKED) == 2


def test_grouped_conv1d_passes_shape_check():
    out = tconv.conv1d(torch.ones(1, 4, 8), torch.ones(6, 2, 3), groups=2)
    assert tuple(out.shape) == (1, 6, 6)
    assert TS.check_call("conv1d", torch.ones(1, 4, 8), torch.ones(6, 2, 3),
                         None, groups=2) == (1, 6, 6)
    assert TS.check_call("softplus", torch.ones(2)) is None


def test_lstm_layer_cell_clip_honors_mask():
    rng = np.random.RandomState(0)
    T, N, C, H = 6, 2, 3, 4
    x = torch.from_numpy(rng.randn(T, N, C).astype(np.float32))
    wi = torch.from_numpy(rng.randn(C, 4 * H).astype(np.float32) * 0.4)
    wh = torch.from_numpy(rng.randn(H, 4 * H).astype(np.float32) * 0.4)
    b = torch.zeros(4 * H)
    mask = torch.tensor([[1, 1], [1, 1], [1, 1],
                         [0, 1], [0, 1], [0, 1]], dtype=torch.float32)
    out, _ = TR.get("lstmLayer")(x, wi, wh, b, mask_tn=mask, cell_clip=5.0)
    # masked steps (batch item 0, t>=3) must emit zeros
    assert float(torch.sum(torch.abs(out[3:, 0]))) == 0.0
    assert float(torch.sum(torch.abs(out[3:, 1]))) > 0.0
    jout, _ = JR.get("lstmLayer")(jnp.asarray(x.numpy()),
                                  jnp.asarray(wi.numpy()),
                                  jnp.asarray(wh.numpy()), jnp.zeros(4 * H),
                                  mask_tn=jnp.asarray(mask.numpy()),
                                  cell_clip=5.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------- every OpValidation case
def _arg_shapes(case):
    args = case.args(np.random.RandomState(0))
    if not args or not all(isinstance(a, np.ndarray) for a in args):
        return None
    return [a.shape for a in args]


def _jax_shape(case, shapes):
    try:
        return JS.infer_shape(case.op, *shapes, **case.kwargs)
    except Exception:
        return None


CASES = [c for c in TV.all_cases() if _arg_shapes(c) is not None]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c.op for c in CASES])
def test_case_shapes_match_where_jax_answers(i):
    case = CASES[i]
    shapes = _arg_shapes(case)
    want = _jax_shape(case, shapes)
    if want is None:
        return                  # the JAX side cannot answer: nothing to hold
    assert TS.infer_shape(case.op, *shapes, **case.kwargs) == want


def test_most_cases_are_answered():
    answered = sum(_jax_shape(c, _arg_shapes(c)) is not None for c in CASES)
    assert answered >= 200, answered


@pytest.mark.parametrize("op", ["where", "unique_with_counts", "listdiff",
                                "boolean_mask"])
def test_data_dependent_shapes_raise_on_both_sides(op):
    shapes = [(5,)] * (2 if op in ("listdiff", "boolean_mask") else 1)
    with pytest.raises(Exception):
        JS.infer_shape(op, *shapes)
    with pytest.raises(Exception):
        TS.infer_shape(op, *shapes)


def test_unique_answers_its_static_padded_shape_on_both_sides():
    """``unique`` pads to the input's size (the JAX op's ``size=x.size``),
    so both sides answer it."""
    assert JS.infer_shape("unique", (5,)) == TS.infer_shape("unique", (5,)) \
        == ((5,), (5,))


class _Devices(TorchDispatchMode):
    """Records the device of every tensor an aten op makes."""

    def __init__(self):
        super().__init__()
        self.seen = set()
        self.where = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.seen.add(t.device.type)
                if t.device.type != "meta":
                    self.where.append((str(func), tuple(t.shape)))
        return out


def test_infer_shape_makes_tensors_on_meta_only():
    """Every tensor that the fallback makes, across all cases it answers,
    is a meta tensor: nothing lands in memory on a real device."""
    rec = _Devices()
    answered = 0
    todo = [(case, _arg_shapes(case)) for case in CASES]
    with rec:
        for case, shapes in todo:
            try:
                TS.infer_shape(case.op, *shapes, **case.kwargs)
                answered += 1
            except Exception:
                pass
    assert answered >= 200
    assert rec.seen <= {"meta"}, rec.where


def test_infer_shape_never_takes_a_platform_override():
    """A platform override (a CUDA kernel) is skipped: the shape is the
    generic op's, run on meta."""
    calls = []

    def override(x, scale, shift, *, alpha=0.0, axis=1):
        calls.append(1)
        raise AssertionError("the override ran")

    TR.register_platform_override("scale_shift_act", override)
    try:
        assert TS.infer_shape("scale_shift_act", (4, 6), (6,), (6,),
                              axis=-1) == (4, 6)
    finally:
        TR.clear_platform_override("scale_shift_act")
    assert not calls
