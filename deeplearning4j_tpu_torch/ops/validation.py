"""OpValidation — per-op validation harness with a coverage gate (the port
of ``deeplearning4j_tpu/ops/validation.py``, case for case).

Reference parity: ``org.nd4j.autodiff.validation.OpValidation`` — the
reference's test CENTERPIECE: every declarable op is exercised through
(a) a forward check against an independent golden where one exists, (b) a
gradient check for differentiable ops, and (c) the registry coverage
report that FAILS when ops are added without validation
(``OpValidationSuite`` "coverage" gate).

The harness runs a case on a device (``cuda`` unless the caller names
another): the case's numpy args go to that device as tensors with the JAX
package's dtypes (float64 and int64 narrow to 32 bits, as ``jnp.asarray``
does without x64), every output tensor must come back on it, and the
golden runs on the host over the numpy args. A :class:`Key` arg becomes a
``torch.Generator`` on the device (the JAX cases pass a Threefry key
there). The gradient check is ``torch.autograd.gradcheck`` in float64 on
the case's floating args named by ``grad_arg_idx`` (the JAX package
checks central differences in fp32); the random ops are held to the
JAX harness's statistics and to the port's own moment checks.

Usage:

    for case in all_cases():        # one OpCase per registered op usage
        run_case(case, device="cpu")
    report = coverage_report()      # .uncovered must stay empty
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ops import registry as R
from deeplearning4j_tpu_torch.ops.normalization import StepKey
from deeplearning4j_tpu_torch.ops.registry_r5 import TensorList


@dataclass
class OpCase:
    op: str
    args: Callable[[np.random.RandomState], tuple]
    kwargs: Dict[str, Any] = field(default_factory=dict)
    golden: Optional[Callable] = None     # numpy impl over the same args
    grad: bool = False                    # float64 gradcheck
    grad_arg_idx: Tuple[int, ...] = (0,)  # which args get grad-checked
    rtol: float = 1e-4
    atol: float = 1e-5
    note: str = ""


@dataclass(frozen=True)
class Key:
    """A random op's key arg: a ``torch.Generator`` seeded with ``seed``
    on the device the case runs on."""
    seed: int


# --------------------------------------------------------------------------
# host <-> device
# --------------------------------------------------------------------------
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def to_device(x, device, float64: bool = False):
    """Case args on ``device``: numpy arrays as tensors (64-bit types
    narrowed as ``jnp.asarray`` narrows them without x64, or every float
    as float64 with ``float64``), numpy scalars as Python numbers, keys as
    generators, TensorLists with their arrays moved."""
    if isinstance(x, np.ndarray):
        if float64 and np.issubdtype(x.dtype, np.floating):
            a = x.astype(np.float64)
        else:
            a = x.astype(_NARROW.get(x.dtype, x.dtype), copy=False)
        return torch.as_tensor(a).to(device)
    if isinstance(x, torch.Tensor):
        t = x.to(device)
        return t.double() if float64 and t.is_floating_point() else t
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, Key):
        return torch.Generator(device=device).manual_seed(x.seed)
    if isinstance(x, TensorList):
        return TensorList([to_device(a, device, float64) for a in x.arrays])
    if isinstance(x, list):
        return [to_device(v, device, float64) for v in x]
    if isinstance(x, tuple):
        return tuple(to_device(v, device, float64) for v in x)
    return x


def to_host(x):
    """Op outputs as numpy (bf16 as fp32), containers kept."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if isinstance(x, TensorList):
        return TensorList([to_host(a) for a in x.arrays])
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def host_op(name: str):
    """The registered op as a function of numpy args on the CPU (what the
    goldens that call an op use)."""
    def run(*args, **kwargs):
        return to_host(R.get(name)(*to_device(args, "cpu"), **kwargs))
    return run


def _takes_device(fn) -> bool:
    try:
        return "device" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _kwargs(case: "OpCase", fn, dev) -> dict:
    """The case's kwargs, with ``device=`` for an op that takes one."""
    kwargs = dict(case.kwargs)
    if _takes_device(fn) and "device" not in kwargs:
        kwargs["device"] = dev
    return kwargs


def call(case: "OpCase", args, device):
    """Run the case's op on ``device`` over host ``args``."""
    dev = torch.device(device)
    fn = R.get(case.op)
    return fn(*to_device(args, dev), **_kwargs(case, fn, dev))


# --------------------------------------------------------------------------
# case table, bucket by bucket
# --------------------------------------------------------------------------

def _r(*shape):
    def gen(rng):
        return (rng.randn(*shape).astype(np.float32),)
    return gen


def _rpos(*shape):
    def gen(rng):
        return (rng.rand(*shape).astype(np.float32) + 0.5,)
    return gen


def _runit(*shape):
    """open interval (-0.95, 0.95) — domains of atanh/asin/acos/erfinv."""
    def gen(rng):
        return ((rng.rand(*shape).astype(np.float32) - 0.5) * 1.9,)
    return gen


def _r2(*shape):
    def gen(rng):
        return (rng.randn(*shape).astype(np.float32),
                rng.randn(*shape).astype(np.float32))
    return gen


def _r2pos(*shape):
    def gen(rng):
        return (rng.rand(*shape).astype(np.float32) + 0.5,
                rng.rand(*shape).astype(np.float32) + 0.5,)
    return gen


def _ints(*shape, hi=10):
    def gen(rng):
        return (rng.randint(0, hi, shape).astype(np.int32),)
    return gen


def _ints2(*shape, hi=8):
    def gen(rng):
        return (rng.randint(0, hi, shape).astype(np.int32),
                rng.randint(0, hi, shape).astype(np.int32))
    return gen


def _bools2(*shape):
    def gen(rng):
        return (rng.rand(*shape) > 0.5, rng.rand(*shape) > 0.5)
    return gen


# --------------------------------------------------------------------------
# case table, bucket by bucket
# --------------------------------------------------------------------------

def sp_linalg_expm(a):
    import scipy.linalg
    return scipy.linalg.expm(a.astype(np.float64)).astype(np.float32)


def _np_rgb_to_hsv(x):
    """matplotlib.colors.rgb_to_hsv in numpy."""
    arr = np.asarray(x, np.float64)
    out = np.zeros_like(arr)
    mx = arr.max(-1)
    delta = mx - arr.min(-1)
    s = np.where(mx > 0, delta / np.where(mx > 0, mx, 1.0), 0.0)
    safe = np.where(delta > 0, delta, 1.0)
    h = np.zeros_like(mx)
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    for cond, val in (((r == mx) & (delta > 0), (g - b) / safe),
                      ((g == mx) & (delta > 0), 2.0 + (b - r) / safe),
                      ((b == mx) & (delta > 0), 4.0 + (r - g) / safe)):
        h = np.where(cond, val, h)
    out[..., 0] = (h / 6.0) % 1.0
    out[..., 1] = s
    out[..., 2] = mx
    return out.astype(np.float32)


def _np_roundtrip_check(x, fwd: str, inv: str):
    """Golden for invertible-pair ops: the expected value of fwd(x) is
    whatever value satisfies inv(fwd(x)) == x; we compute fwd(x) with the
    op itself and ASSERT the inverse recovers x, then return it."""
    y = host_op(fwd)(x)
    back = host_op(inv)(y)
    np.testing.assert_allclose(back, x, rtol=1e-3, atol=1e-3,
                               err_msg=f"{inv}({fwd}(x)) != x")
    return y


def _np_scatter(x, idx, upd, mode):
    out = x.copy()
    for j, i in enumerate(idx):
        if mode == "set":
            out[i] = upd[j]
        elif mode == "add":
            out[i] += upd[j]
        elif mode == "sub":
            out[i] -= upd[j]
        elif mode == "max":
            out[i] = np.maximum(out[i], upd[j])
        elif mode == "min":
            out[i] = np.minimum(out[i], upd[j])
    return out


def _build_cases() -> List[OpCase]:
    import scipy.special as sp
    C: List[OpCase] = []

    def add(op, args, golden=None, grad=False, **kw):
        C.append(OpCase(op=op, args=args, golden=golden, grad=grad, **kw))

    # ---- elementwise float (golden = numpy/scipy) ----
    ew = {
        "abs": np.abs, "neg": np.negative, "exp": np.exp, "expm1": np.expm1,
        "square": np.square, "cube": lambda x: x ** 3, "ceil": np.ceil,
        "floor": np.floor, "rint": np.rint, "round": np.round,
        "sign": np.sign, "sin": np.sin, "cos": np.cos, "tan": np.tan,
        "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
        "asinh": np.arcsinh, "atan": np.arctan, "erf": sp.erf,
        "erfc": sp.erfc, "sigmoid": lambda x: 1 / (1 + np.exp(-x)),
        "softplus": lambda x: np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0),
        "softsign": lambda x: x / (1 + np.abs(x)),
        "relu": lambda x: np.maximum(x, 0),
        "relu6": lambda x: np.clip(x, 0, 6),
        "elu": lambda x: np.where(x > 0, x, np.exp(x) - 1),
        "selu": lambda x: 1.0507009873554805 * np.where(
            x > 0, x, 1.6732632423543772 * (np.exp(x) - 1)),
        "swish": lambda x: x / (1 + np.exp(-x)),
        "mish": lambda x: x * np.tanh(np.log1p(np.exp(x))),
        "gelu": lambda x: 0.5 * x * (1 + np.tanh(
            np.sqrt(2 / np.pi) * (x + 0.044715 * x ** 3))),
        "leakyrelu": lambda x: np.where(x >= 0, x, 0.01 * x),
        "hardsigmoid": lambda x: np.clip(0.2 * x + 0.5, 0, 1),
        "hard_sigmoid": lambda x: np.clip(0.2 * x + 0.5, 0, 1),
        "hardtanh": lambda x: np.clip(x, -1, 1),
        "hard_tanh": lambda x: np.clip(x, -1, 1),
        "log_sigmoid": lambda x: -(np.log1p(np.exp(-np.abs(x)))
                                   + np.maximum(-x, 0)),
        "lgamma": sp.gammaln, "digamma": sp.digamma,
        "identity": lambda x: x,
        "sigmoid_derivative": lambda x: (1 / (1 + np.exp(-x)))
        * (1 - 1 / (1 + np.exp(-x))),
    }
    for op, g in ew.items():
        add(op, _r(3, 4), golden=g,
            grad=op not in ("sign", "ceil", "floor", "rint", "round"))
    for op in ("rationaltanh", "rational_tanh", "rectifiedtanh",
               "rectified_tanh"):
        add(op, _r(3, 4), grad=True)      # formula-defined; smoke + grad
    add("thresholdedrelu", _r(3, 4),
        golden=lambda x: np.where(x > 1.0, x, 0.0))
    add("prelu", lambda rng: (rng.randn(3, 4).astype(np.float32),
                              np.float32(0.25)),
        golden=lambda x, a: np.where(x >= 0, x, a * x), grad=True)

    # positive / restricted domains
    pos = {"log": np.log, "log1p": np.log1p, "log2": np.log2,
           "log10": np.log10, "sqrt": np.sqrt, "rsqrt": lambda x: x ** -0.5,
           "reciprocal": np.reciprocal}
    for op, g in pos.items():
        add(op, _rpos(3, 4), golden=g, grad=True)
    add("acosh", lambda rng: (rng.rand(3, 4).astype(np.float32) + 1.5,),
        golden=np.arccosh, grad=True)
    for op, g in (("asin", np.arcsin), ("acos", np.arccos),
                  ("atanh", np.arctanh), ("erfinv", sp.erfinv)):
        add(op, _runit(3, 4), golden=g, grad=True)
    add("isnan", lambda rng: (np.asarray([1.0, np.nan, np.inf], np.float32),),
        golden=np.isnan)
    add("isinf", lambda rng: (np.asarray([1.0, np.nan, np.inf], np.float32),),
        golden=np.isinf)
    add("isfinite", lambda rng: (np.asarray([1.0, np.nan, np.inf], np.float32),),
        golden=np.isfinite)

    # ---- pairwise ----
    pw = {"add": np.add, "subtract": np.subtract, "multiply": np.multiply,
          "maximum": np.maximum, "minimum": np.minimum,
          "squared_subtract": lambda a, b: (a - b) ** 2,
          "reversesubtract": lambda a, b: b - a,
          "atan2": np.arctan2}
    for op, g in pw.items():
        add(op, _r2(3, 4), golden=g, grad=True)
    add("divide", _r2pos(3, 4), golden=np.divide, grad=True)
    add("reversedivide", _r2pos(3, 4), golden=lambda a, b: b / a, grad=True)
    add("pow", _r2pos(3, 4), golden=np.power, grad=True)
    add("mod", _r2pos(3, 4), golden=np.mod)
    add("fmod", _r2pos(3, 4), golden=np.fmod)
    add("floordiv", _r2pos(3, 4), golden=np.floor_divide)
    add("igamma", _r2pos(3, 4), golden=sp.gammainc)
    add("igammac", _r2pos(3, 4), golden=sp.gammaincc)
    add("betainc", lambda rng: (rng.rand(3).astype(np.float32) + 0.5,
                                rng.rand(3).astype(np.float32) + 0.5,
                                rng.rand(3).astype(np.float32) * 0.9 + 0.05),
        golden=sp.betainc)
    add("zeta", lambda rng: (rng.rand(3).astype(np.float32) + 1.5,
                             rng.rand(3).astype(np.float32) + 0.5),
        golden=lambda x, q: sp.zeta(x, q), rtol=1e-3)
    add("polygamma", lambda rng: (np.asarray([1, 2, 3], np.int32),
                                  rng.rand(3).astype(np.float32) + 1.0),
        golden=lambda n, x: sp.polygamma(n, x), rtol=1e-3)

    # ---- comparisons / boolean / bitwise ----
    for op, g in (("equals", np.equal), ("not_equals", np.not_equal),
                  ("greater", np.greater), ("greater_equal", np.greater_equal),
                  ("less", np.less), ("less_equal", np.less_equal)):
        add(op, _ints2(3, 4), golden=g)
    for op, g in (("boolean_and", np.logical_and),
                  ("boolean_or", np.logical_or),
                  ("boolean_xor", np.logical_xor)):
        add(op, _bools2(3, 4), golden=g)
    add("not", lambda rng: (rng.rand(3, 4) > 0.5,), golden=np.logical_not)
    for op, g in (("bitwise_and", np.bitwise_and),
                  ("bitwise_or", np.bitwise_or),
                  ("bitwise_xor", np.bitwise_xor)):
        add(op, _ints2(3, 4, hi=64), golden=g)
    add("left_shift", lambda rng: (rng.randint(0, 8, (4,)).astype(np.int32),
                                   rng.randint(0, 4, (4,)).astype(np.int32)),
        golden=np.left_shift)
    add("right_shift", lambda rng: (rng.randint(0, 64, (4,)).astype(np.int32),
                                    rng.randint(0, 4, (4,)).astype(np.int32)),
        golden=np.right_shift)

    # ---- reductions ----
    red = {"reduce_sum": np.sum, "reduce_mean": np.mean, "reduce_max": np.max,
           "reduce_min": np.min, "reduce_prod": np.prod,
           "reduce_norm1": lambda x, axis=None: np.sum(np.abs(x), axis=axis),
           "reduce_norm2": lambda x, axis=None: np.sqrt(np.sum(x * x, axis=axis)),
           "reduce_sqnorm": lambda x, axis=None: np.sum(x * x, axis=axis),
           "reduce_norm_max": lambda x, axis=None: np.max(np.abs(x), axis=axis)}
    for op, g in red.items():
        add(op, _r(3, 4), kwargs={"axis": 1}, golden=lambda x, axis=1, _g=g:
            _g(x, axis=axis), grad=op not in ())
    add("reduce_logsumexp", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: sp.logsumexp(x, axis=axis), grad=True)
    add("logsumexp", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: sp.logsumexp(x, axis=axis), grad=True)
    add("all", lambda rng: (rng.rand(3, 4) > 0.2,), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.all(x, axis=axis))
    add("any", lambda rng: (rng.rand(3, 4) > 0.8,), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.any(x, axis=axis))
    add("count_nonzero", lambda rng: (rng.randint(0, 2, (3, 4)).astype(np.float32),),
        golden=lambda x: np.count_nonzero(x))
    add("count_zero", lambda rng: (rng.randint(0, 2, (3, 4)).astype(np.float32),),
        golden=lambda x: x.size - np.count_nonzero(x))
    for op, g in (("argmax", np.argmax), ("argmin", np.argmin)):
        add(op, _r(3, 4), kwargs={"axis": 1},
            golden=lambda x, axis=1, _g=g: _g(x, axis=axis))
    add("argamax", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.argmax(np.abs(x), axis=axis))
    add("argamin", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.argmin(np.abs(x), axis=axis))
    add("norm", _r(3, 4), golden=lambda x: np.linalg.norm(x), grad=True)
    add("moments", _r(3, 4), kwargs={"axis": 0},
        golden=lambda x, axis=0: (np.mean(x, axis), np.var(x, axis)))
    add("standardize", _r(3, 4), kwargs={"axis": 1}, grad=True,
        golden=lambda x, axis=1: (x - x.mean(axis, keepdims=True))
        / x.std(axis, keepdims=True))
    add("median", _r(3, 4), golden=np.median)
    add("percentile", _r(3, 4), kwargs={"q": 30.0},
        golden=lambda x, q=30.0: np.percentile(x, q))

    # ---- reduce3 / distances ----
    add("cosine_similarity", _r2(8,), golden=lambda x, y: np.dot(x, y)
        / (np.linalg.norm(x) * np.linalg.norm(y)), grad=True)
    add("cosine_distance", _r2(8,), golden=lambda x, y: 1 - np.dot(x, y)
        / (np.linalg.norm(x) * np.linalg.norm(y)))
    add("euclidean_distance", _r2(8,),
        golden=lambda x, y: np.linalg.norm(x - y), grad=True)
    add("manhattan_distance", _r2(8,),
        golden=lambda x, y: np.sum(np.abs(x - y)))
    add("hamming_distance", _ints2(8,),
        golden=lambda x, y: np.sum(x != y).astype(np.float32))
    add("jaccard_distance", _r2pos(8,),
        golden=lambda x, y: 1 - np.sum(np.minimum(x, y))
        / np.sum(np.maximum(x, y)))
    add("dot", _r2(8,), golden=np.dot, grad=True)
    add("square_distance", _r2(8,),
        golden=lambda x, y: np.sum((x - y) ** 2), grad=True)

    # ---- shape ops ----
    add("reshape", _r(3, 4), kwargs={"shape": (4, 3)},
        golden=lambda x, shape=(4, 3): x.reshape(shape), grad=True)
    add("transpose", _r(3, 4), golden=lambda x: x.T, grad=True)
    add("permute", _r(2, 3, 4), kwargs={"perm": (2, 0, 1)},
        golden=lambda x, perm=(2, 0, 1): np.transpose(x, perm))
    add("expand_dims", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.expand_dims(x, axis))
    add("squeeze", lambda rng: (rng.randn(3, 1, 4).astype(np.float32),),
        kwargs={"axis": 1}, golden=lambda x, axis=1: np.squeeze(x, axis))
    add("concat", lambda rng: ([rng.randn(2, 3).astype(np.float32),
                                rng.randn(2, 3).astype(np.float32)],),
        kwargs={"axis": 0},
        golden=lambda xs, axis=0: np.concatenate(xs, axis))
    add("stack", lambda rng: ([rng.randn(2, 3).astype(np.float32),
                               rng.randn(2, 3).astype(np.float32)],),
        kwargs={"axis": 0}, golden=lambda xs, axis=0: np.stack(xs, axis))
    add("unstack", _r(3, 4), kwargs={"axis": 0},
        golden=lambda x, axis=0: [x[i] for i in range(x.shape[axis])])
    add("split", _r(4, 6), kwargs={"num": 2, "axis": 1},
        golden=lambda x, num=2, axis=1: np.split(x, num, axis))
    add("split_v", _r(4, 6), kwargs={"sizes": (2, 4), "axis": 1},
        golden=lambda x, sizes=(2, 4), axis=1: np.split(x, [2], axis))
    add("tile", _r(2, 3), kwargs={"reps": (2, 2)},
        golden=lambda x, reps=(2, 2): np.tile(x, reps))
    add("repeat", _r(2, 3), kwargs={"n": 2, "axis": 1},
        golden=lambda x, n=2, axis=1: np.repeat(x, n, axis))
    add("flip", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.flip(x, axis))
    add("reverse", _r(3, 4), kwargs={"axis": 0},
        golden=lambda x, axis=0: np.flip(x, axis))
    add("roll", _r(3, 4), kwargs={"shift": 2, "axis": 1},
        golden=lambda x, shift=2, axis=1: np.roll(x, shift, axis))
    add("slice", _r(4, 6), kwargs={"begin": (1, 2), "size": (2, 3)},
        golden=lambda x, begin=(1, 2), size=(2, 3): x[1:3, 2:5])
    add("strided_slice", _r(4, 6),
        kwargs={"begin": (0, 1), "end": (4, 6), "strides": (2, 2)},
        golden=lambda x, **k: x[0:4:2, 1:6:2])
    add("gather", lambda rng: (rng.randn(5, 3).astype(np.float32),
                               np.asarray([0, 2, 4], np.int32)),
        golden=lambda x, i: x[i], grad=True)
    add("gather_nd", lambda rng: (rng.randn(4, 3).astype(np.float32),
                                  np.asarray([[0, 1], [2, 2]], np.int32)),
        golden=lambda x, i: x[i[:, 0], i[:, 1]])
    add("boolean_mask", lambda rng: (rng.randn(5,).astype(np.float32),
                                     np.asarray([1, 0, 1, 0, 1], bool)),
        golden=lambda x, m: x[m])
    add("where", lambda rng: (rng.rand(3, 4) > 0.5,
                              rng.randn(3, 4).astype(np.float32),
                              rng.randn(3, 4).astype(np.float32)),
        golden=np.where)
    add("pad", _r(2, 3), kwargs={"paddings": ((1, 1), (0, 2))},
        golden=lambda x, paddings=((1, 1), (0, 2)): np.pad(x, paddings))
    add("one_hot", _ints(4, hi=5), kwargs={"depth": 5},
        golden=lambda i, depth=5: np.eye(depth, dtype=np.float32)[i])
    add("eye", lambda rng: (4,), golden=lambda n: np.eye(n))
    add("fill", lambda rng: ((2, 3), 7.0),
        golden=lambda s, v: np.full(s, v, np.float32))
    add("linspace", lambda rng: (0.0, 1.0, 5),
        golden=lambda a, b, n: np.linspace(a, b, n))
    add("range", lambda rng: (0, 10, 2),
        golden=lambda a, b, s: np.arange(a, b, s))
    add("zeros_like", _r(3, 4), golden=np.zeros_like)
    add("ones_like", _r(3, 4), golden=np.ones_like)
    add("shape_of", _r(3, 4), golden=lambda x: np.asarray(x.shape))
    add("rank", _r(3, 4), golden=lambda x: x.ndim)
    add("size", _r(3, 4), golden=lambda x: x.size)
    add("cast", _r(3, 4), kwargs={"dtype": np.int32},
        golden=lambda x, dtype=np.int32: x.astype(dtype))
    add("assign", _r2(3, 4), golden=lambda a, b: b)
    add("diag", _r(4,), golden=np.diag)
    add("diag_part", _r(4, 4), golden=np.diag)
    add("matrix_diag", _r(4,), golden=np.diag)
    add("tril", _r(4, 4), golden=np.tril)
    add("triu", _r(4, 4), golden=np.triu)
    add("trace", _r(4, 4), golden=np.trace, grad=True)
    add("cross", _r2(3,), golden=np.cross)
    add("outer", _r2(4,), golden=np.outer, grad=True)
    add("matrix_band_part", _r(5, 5), kwargs={"num_lower": 1, "num_upper": 2},
        golden=lambda x, num_lower=1, num_upper=2: np.where(
            (np.arange(5)[:, None] - np.arange(5)[None, :] <= num_lower)
            & (np.arange(5)[None, :] - np.arange(5)[:, None] <= num_upper),
            x, 0.0))
    add("sequence_mask", lambda rng: (np.asarray([1, 3, 2], np.int32),),
        kwargs={"maxlen": 4},
        golden=lambda l, maxlen=4: np.arange(maxlen)[None, :] < l[:, None])
    add("reverse_sequence",
        lambda rng: (rng.randn(2, 4).astype(np.float32),
                     np.asarray([2, 4], np.int32)),
        golden=lambda x, l: np.stack(
            [np.concatenate([x[i, :l[i]][::-1], x[i, l[i]:]])
             for i in range(x.shape[0])]))
    add("embedding_lookup", lambda rng: (rng.randn(6, 3).astype(np.float32),
                                         np.asarray([1, 4], np.int32)),
        golden=lambda t, i: t[i])
    add("top_k", _r(8,), kwargs={"k": 3},
        golden=lambda x, k=3: (np.sort(x)[::-1][:k],
                               np.argsort(-x)[:k]))
    add("in_top_k", lambda rng: (rng.randn(3, 5).astype(np.float32),
                                 np.asarray([0, 1, 2], np.int32)),
        kwargs={"k": 2},
        golden=lambda p, t, k=2: np.asarray(
            [t[i] in np.argsort(-p[i])[:k] for i in range(len(t))]))
    add("unique", lambda rng: (np.asarray([3, 1, 3, 2, 1], np.int32),),
        golden=lambda x: (np.pad(np.unique(x), (0, x.size - np.unique(x).size)),
                          np.unique(x, return_inverse=True)[1]))
    add("is_max", _r(6,), golden=lambda x: (x == x.max()).astype(x.dtype))
    add("nth_element", _r(7,), kwargs={"n": 2},
        golden=lambda x, n=2: np.sort(x)[n])
    add("meshgrid", lambda rng: (np.arange(3, dtype=np.float32),
                                 np.arange(2, dtype=np.float32)),
        golden=lambda a, b: np.meshgrid(a, b))
    add("listdiff", lambda rng: (np.asarray([1, 2, 3, 4], np.int32),
                                 np.asarray([2, 4], np.int32)),
        golden=lambda x, y: np.setdiff1d(x, y, assume_unique=True))
    add("dynamic_partition",
        lambda rng: (rng.randn(4, 2).astype(np.float32),
                     np.asarray([0, 1, 0, 1], np.int32), 2),
        note="masked-copies form (static shapes); validated structurally")
    add("dynamic_stitch",
        lambda rng: ([np.asarray([0, 2], np.int32),
                      np.asarray([1, 3], np.int32)],
                     [np.asarray([[1.], [3.]], np.float32),
                      np.asarray([[2.], [4.]], np.float32)]),
        golden=lambda i, d: np.asarray([[1.], [2.], [3.], [4.]], np.float32))
    sc_args = lambda rng: (rng.randn(6, 2).astype(np.float32),
                           np.asarray([1, 3], np.int32),
                           rng.randn(2, 2).astype(np.float32))
    add("scatter_update", sc_args,
        golden=lambda x, i, u: _np_scatter(x, i, u, "set"))
    add("scatter_add", sc_args,
        golden=lambda x, i, u: _np_scatter(x, i, u, "add"), grad=True)
    add("scatter_sub", sc_args,
        golden=lambda x, i, u: _np_scatter(x, i, u, "sub"))
    add("scatter_max", sc_args,
        golden=lambda x, i, u: _np_scatter(x, i, u, "max"))
    add("scatter_min", sc_args,
        golden=lambda x, i, u: _np_scatter(x, i, u, "min"))
    add("cumsum", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.cumsum(x, axis), grad=True)
    add("cumprod", _rpos(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.cumprod(x, axis), grad=True)
    add("histogram", _r(64,), kwargs={"bins": 8},
        golden=lambda x, bins=8: np.histogram(x, bins)[0])
    add("histogram_fixed_width", _r(64,), kwargs={"lo": -2.0, "hi": 2.0,
                                                  "bins": 8},
        golden=lambda x, lo=-2.0, hi=2.0, bins=8:
        np.histogram(x, bins, (lo, hi))[0])
    add("bincount", _ints(20, hi=6),
        golden=lambda x: np.bincount(x))
    add("confusion_matrix",
        lambda rng: (np.asarray([0, 1, 2, 1], np.int32),
                     np.asarray([0, 2, 2, 1], np.int32)),
        kwargs={"num_classes": 3},
        golden=lambda t, p, num_classes=3: np.asarray(
            [[1, 0, 0], [0, 1, 1], [0, 0, 1]]))
    add("clip_by_value", _r(3, 4), kwargs={"lo": -0.5, "hi": 0.5},
        golden=lambda x, lo=-0.5, hi=0.5: np.clip(x, lo, hi), grad=True)
    add("clip_by_norm", _r(3, 4), kwargs={"clip_norm": 1.0},
        golden=lambda x, clip_norm=1.0: x * min(1.0, clip_norm
                                                / np.linalg.norm(x)))
    add("clip_by_global_norm",
        lambda rng: ([rng.randn(3).astype(np.float32),
                      rng.randn(2).astype(np.float32)],),
        kwargs={"clip_norm": 1.0})

    # ---- segment ----
    seg_args = lambda rng: (rng.randn(6, 2).astype(np.float32),
                            np.asarray([0, 0, 1, 1, 2, 2], np.int32))
    for op, g in (("segment_sum", np.add.reduceat),):
        pass
    add("segment_sum", seg_args, golden=lambda d, i: np.stack(
        [d[i == k].sum(0) for k in range(3)]), grad=True)
    add("segment_mean", seg_args, golden=lambda d, i: np.stack(
        [d[i == k].mean(0) for k in range(3)]))
    add("segment_max", seg_args, golden=lambda d, i: np.stack(
        [d[i == k].max(0) for k in range(3)]))
    add("segment_min", seg_args, golden=lambda d, i: np.stack(
        [d[i == k].min(0) for k in range(3)]))
    add("segment_prod", seg_args, golden=lambda d, i: np.stack(
        [d[i == k].prod(0) for k in range(3)]))
    for nm in ("sum", "mean", "max", "min", "prod"):
        add(f"unsorted_segment_{nm}",
            lambda rng: (rng.randn(6, 2).astype(np.float32),
                         np.asarray([2, 0, 1, 1, 2, 0], np.int32)),
            kwargs={"num_segments": 3})

    # ---- linalg ----
    add("matmul", _r2(4, 4), golden=np.matmul, grad=True)
    add("mmul", _r2(4, 4), golden=np.matmul, grad=True)
    add("batched_gemm", lambda rng: (rng.randn(2, 3, 4).astype(np.float32),
                                     rng.randn(2, 4, 5).astype(np.float32)),
        golden=np.matmul, grad=True)
    add("tensordot", lambda rng: (rng.randn(3, 4).astype(np.float32),
                                  rng.randn(4, 5).astype(np.float32)),
        kwargs={"axes": 1},
        golden=lambda a, b, axes=1: np.tensordot(a, b, axes))
    add("xw_plus_b", lambda rng: (rng.randn(2, 3).astype(np.float32),
                                  rng.randn(3, 4).astype(np.float32),
                                  rng.randn(4).astype(np.float32)),
        golden=lambda x, w, b: x @ w + b, grad=True)
    add("linear", _r(3, 4), golden=lambda x: x)   # identity activation
    add("relu_layer", lambda rng: (rng.randn(2, 3).astype(np.float32),
                                   rng.randn(3, 4).astype(np.float32),
                                   rng.randn(4).astype(np.float32)),
        golden=lambda x, w, b: np.maximum(x @ w + b, 0))

    def spd(rng, n=3):
        a = rng.randn(n, n).astype(np.float32)
        return (a @ a.T + n * np.eye(n, dtype=np.float32),)
    add("matrix_determinant", spd, golden=np.linalg.det, rtol=1e-3)
    add("log_matrix_determinant", spd,
        golden=lambda a: np.log(np.abs(np.linalg.det(a))), rtol=1e-3)
    add("matrix_inverse", spd, golden=np.linalg.inv, rtol=1e-3)
    add("cholesky", spd, golden=np.linalg.cholesky, rtol=1e-3)
    add("qr", _r(4, 3), note="orthonormal columns; checked structurally")
    add("svd", _r(4, 3), note="reconstruction checked structurally")
    add("solve", lambda rng: spd(rng) + (rng.randn(3, 2).astype(np.float32),),
        golden=np.linalg.solve, rtol=1e-3)
    add("triangular_solve",
        lambda rng: (np.tril(rng.randn(3, 3).astype(np.float32))
                     + 3 * np.eye(3, dtype=np.float32),
                     rng.randn(3, 2).astype(np.float32)),
        kwargs={"lower": True},
        golden=lambda a, b, lower=True:
        np.linalg.solve(a, b), rtol=1e-3)
    add("lstsq", lambda rng: (rng.randn(5, 3).astype(np.float32),
                              rng.randn(5, 2).astype(np.float32)),
        golden=lambda a, b: np.linalg.lstsq(a, b, rcond=None)[0], rtol=1e-2)
    add("l2_loss", _r(3, 4), golden=lambda x: 0.5 * np.sum(x * x), grad=True)

    # ---- r3 additions: decompositions, image, quantization, losses ----
    add("eigh", spd, note="eigenpairs checked structurally (finite)")
    add("lu", _r(4, 4), note="P@L@U reconstruction is structural")
    add("pinv", _r(4, 3), golden=np.linalg.pinv, rtol=1e-3, atol=1e-4)
    add("matrix_rank", lambda rng: (np.eye(4, dtype=np.float32) * 2.0,),
        golden=lambda a: np.linalg.matrix_rank(a))
    add("kron", lambda rng: (rng.randn(2, 2).astype(np.float32),
                             rng.randn(3, 3).astype(np.float32)),
        golden=np.kron)
    add("slogdet", spd, golden=lambda a: tuple(np.linalg.slogdet(a)),
        rtol=1e-3)
    add("expm", lambda rng: (rng.randn(3, 3).astype(np.float32) * 0.1,),
        golden=lambda a: sp_linalg_expm(a), rtol=1e-3, atol=1e-4)
    add("l2_normalize", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: x / np.maximum(
            np.sqrt((x * x).sum(axis, keepdims=True)), 1e-12), grad=True)
    add("unsorted_segment_sqrt_n",
        lambda rng: (rng.randn(6, 2).astype(np.float32),
                     np.asarray([0, 0, 1, 1, 2, 2], np.int32)),
        kwargs={"num_segments": 3},
        golden=lambda d, i, num_segments=3: np.stack(
            [d[i == k].sum(0) / np.sqrt((i == k).sum())
             for k in range(num_segments)]))
    img = lambda rng: (rng.rand(2, 4, 4, 3).astype(np.float32),)
    add("adjust_contrast", img, kwargs={"factor": 2.0},
        golden=lambda x, factor=2.0:
        (x - x.mean((-3, -2), keepdims=True)) * factor
        + x.mean((-3, -2), keepdims=True))
    add("adjust_brightness", img, kwargs={"delta": 0.1},
        golden=lambda x, delta=0.1: x + delta, grad=True)
    add("adjust_gamma", img, kwargs={"gamma": 2.0},
        golden=lambda x, gamma=2.0, gain=1.0: gain * x ** gamma)
    add("rgb_to_grayscale", img,
        golden=lambda x: (x * np.asarray([0.2989, 0.587, 0.114])).sum(
            -1, keepdims=True), rtol=1e-5)
    add("rgb_to_yuv", img,
        golden=lambda x: _np_roundtrip_check(x, "rgb_to_yuv", "yuv_to_rgb"))
    add("yuv_to_rgb", img,
        golden=lambda x: _np_roundtrip_check(x, "yuv_to_rgb", "rgb_to_yuv"))
    add("rgb_to_hsv", img, golden=lambda x: _np_rgb_to_hsv(x), rtol=1e-4,
        atol=1e-5)
    add("hsv_to_rgb", lambda rng: (np.stack([
        rng.rand(2, 3, 3), rng.rand(2, 3, 3), rng.rand(2, 3, 3)],
        axis=-1).astype(np.float32),),
        golden=lambda x: _np_roundtrip_check(x, "hsv_to_rgb", "rgb_to_hsv"))
    add("extract_image_patches", lambda rng:
        (rng.randn(1, 4, 4, 2).astype(np.float32),),
        kwargs={"ksize": 2, "stride": 2},
        golden=lambda x, ksize=2, stride=2: np.concatenate(
            [x[:, di:di + 2 * 2:2, dj:dj + 2 * 2:2, :]
             for di in range(2) for dj in range(2)], axis=-1))
    def _np_fake_quant(x, min_v=-1.0, max_v=1.0, num_bits=8):
        levels = (1 << num_bits) - 1
        scale = (max_v - min_v) / levels
        zp = np.clip(np.round(-min_v / scale), 0, levels)
        nmin, nmax = -zp * scale, (levels - zp) * scale
        return (np.round((np.clip(x, nmin, nmax) - nmin) / scale) * scale
                + nmin)
    add("fake_quant_with_min_max", _r(4, 4),
        kwargs={"min_v": -1.0, "max_v": 1.0, "num_bits": 8},
        golden=_np_fake_quant)
    add("fake_quant_with_min_max", _rpos(4, 4),
        kwargs={"min_v": 0.1, "max_v": 1.1, "num_bits": 8},
        golden=_np_fake_quant, note="asymmetric range exercises the nudge")
    add("quantize", _r(8,), kwargs={"scale": 0.1},
        golden=lambda x, scale=0.1: np.clip(np.round(x / scale), -128,
                                            127).astype(np.int8))
    add("dequantize",
        lambda rng: (rng.randint(-128, 127, (8,)).astype(np.int8),),
        kwargs={"scale": 0.1},
        golden=lambda q, scale=0.1: q.astype(np.float32) * scale)
    add("weighted_cross_entropy_with_logits",
        lambda rng: ((rng.rand(4, 3) > 0.5).astype(np.float32),
                     rng.randn(4, 3).astype(np.float32), 2.0),
        golden=lambda t, lg, w: (1 - t) * lg + (1 + (w - 1) * t)
        * (np.log1p(np.exp(-np.abs(lg))) + np.maximum(-lg, 0)),
        grad=True, grad_arg_idx=(1,))
    add("log_poisson_loss",
        lambda rng: (rng.randint(0, 5, (4,)).astype(np.float32),
                     rng.randn(4).astype(np.float32)),
        golden=lambda t, li: np.exp(li) - li * t, grad=True,
        grad_arg_idx=(1,))
    add("log_poisson_loss",
        lambda rng: (np.asarray([0.0, 1.0, 3.0], np.float32),
                     rng.randn(3).astype(np.float32)),
        kwargs={"compute_full_loss": True},
        golden=lambda t, li, compute_full_loss=True:
        np.exp(li) - li * t + np.where(
            t > 1, t * np.log(np.maximum(t, 1.0)) - t
            + 0.5 * np.log(2 * np.pi * np.maximum(t, 1.0)), 0.0))
    add("batch_gather",
        lambda rng: (rng.randn(2, 5, 3).astype(np.float32),
                     np.asarray([[0, 2], [1, 4]], np.int32)),
        golden=lambda p, i: np.take_along_axis(
            p, np.broadcast_to(i[:, :, None], i.shape + (3,)), axis=1))
    add("mirror_pad", _r(3, 4), kwargs={"paddings": ((1, 1), (2, 2))},
        golden=lambda x, paddings=((1, 1), (2, 2)):
        np.pad(x, paddings, mode="reflect"))

    return C



def _build_nn_cases() -> List[OpCase]:
    """conv/pool/norm/attention/rnn/loss/random/image cases — structural
    checks (shape/finiteness/invariants) with goldens where a compact
    independent formulation exists."""
    C: List[OpCase] = []

    def add(op, args, golden=None, grad=False, **kw):
        C.append(OpCase(op=op, args=args, golden=golden, grad=grad, **kw))

    x_img = lambda rng: (rng.randn(2, 3, 8, 8).astype(np.float32),)
    w_img = lambda rng: (rng.randn(2, 3, 8, 8).astype(np.float32),
                         rng.randn(4, 3, 3, 3).astype(np.float32) * 0.2)

    add("conv2d", w_img, grad=True, grad_arg_idx=(0, 1))
    add("conv1d", lambda rng: (rng.randn(2, 3, 10).astype(np.float32),
                               rng.randn(4, 3, 3).astype(np.float32) * 0.2),
        grad=True)
    add("conv3d", lambda rng: (rng.randn(1, 2, 4, 4, 4).astype(np.float32),
                               rng.randn(3, 2, 2, 2, 2).astype(np.float32)))
    add("conv3dnew", lambda rng: (rng.randn(1, 2, 4, 4, 4).astype(np.float32),
                                  rng.randn(3, 2, 2, 2, 2).astype(np.float32)))
    add("deconv2d", lambda rng: (rng.randn(1, 3, 4, 4).astype(np.float32),
                                 rng.randn(4, 3, 2, 2).astype(np.float32)),
        kwargs={"stride": 2})
    add("depthwise_conv2d", lambda rng: (rng.randn(1, 3, 6, 6).astype(np.float32),
                                         rng.randn(2, 3, 3, 3).astype(np.float32)))
    add("sconv2d", lambda rng: (rng.randn(1, 3, 6, 6).astype(np.float32),
                                rng.randn(2, 3, 3, 3).astype(np.float32),
                                rng.randn(4, 6, 1, 1).astype(np.float32)))
    add("maxpool2d", x_img, kwargs={"kernel": 2, "stride": 2},
        golden=lambda x, kernel=2, stride=2:
        x.reshape(2, 3, 4, 2, 4, 2).max(axis=(3, 5)))
    add("avgpool2d", x_img, kwargs={"kernel": 2, "stride": 2},
        golden=lambda x, kernel=2, stride=2:
        x.reshape(2, 3, 4, 2, 4, 2).mean(axis=(3, 5)), grad=True)
    add("pnormpool2d", x_img, kwargs={"kernel": 2, "stride": 2, "pnorm": 2})
    add("maxpool3dnew", lambda rng: (rng.randn(1, 2, 4, 4, 4).astype(np.float32),),
        kwargs={"kernel": 2, "stride": 2})
    add("avgpool3dnew", lambda rng: (rng.randn(1, 2, 4, 4, 4).astype(np.float32),),
        kwargs={"kernel": 2, "stride": 2})
    add("upsampling2d", lambda rng: (rng.randn(1, 2, 3, 3).astype(np.float32),),
        kwargs={"scale": 2},
        golden=lambda x, scale=2: x.repeat(2, -1).repeat(2, -2))
    add("im2col", lambda rng: (rng.randn(1, 2, 4, 4).astype(np.float32),),
        kwargs={"kernel": 2})
    add("resize_bilinear", lambda rng: (rng.randn(1, 2, 4, 4).astype(np.float32),),
        kwargs={"size": (8, 8)})
    add("resize_nearest_neighbor",
        lambda rng: (rng.randn(1, 2, 4, 4).astype(np.float32),),
        kwargs={"size": (8, 8), "data_format": "NCHW"},
        golden=lambda x, size=(8, 8), data_format="NCHW":
        x.repeat(2, -1).repeat(2, -2))
    add("space_to_depth", lambda rng: (rng.randn(1, 2, 4, 4).astype(np.float32),),
        kwargs={"block_size": 2})
    add("depth_to_space", lambda rng: (rng.randn(1, 8, 2, 2).astype(np.float32),),
        kwargs={"block_size": 2})
    add("space_to_batch", lambda rng: (rng.randn(1, 4, 4, 2).astype(np.float32),),
        kwargs={"block_size": 2})
    add("batch_to_space", lambda rng: (rng.randn(4, 2, 2, 2).astype(np.float32),),
        kwargs={"block_size": 2})

    # norms
    add("batchnorm", lambda rng: (rng.randn(4, 3).astype(np.float32),
                                  np.ones(3, np.float32),
                                  np.zeros(3, np.float32),
                                  np.zeros(3, np.float32),
                                  np.ones(3, np.float32)),
        golden=lambda x, g, b, m, v, axis=-1:
        (x - m) / np.sqrt(v + 1e-5) * g + b,
        kwargs={"axis": -1})
    add("batchnorm_sd", lambda rng: (rng.randn(4, 3).astype(np.float32),
                                     np.ones(3, np.float32),
                                     np.zeros(3, np.float32),
                                     np.zeros(3, np.float32),
                                     np.ones(3, np.float32)))
    add("layer_norm", lambda rng: (rng.randn(4, 6).astype(np.float32),
                                   np.ones(6, np.float32)),
        golden=lambda x, g: (x - x.mean(-1, keepdims=True))
        / np.sqrt(x.var(-1, keepdims=True) + 1e-5) * g, grad=True)
    add("rms_norm", lambda rng: (rng.randn(4, 6).astype(np.float32),
                                 np.ones(6, np.float32)),
        golden=lambda x, g: x / np.sqrt((x * x).mean(-1, keepdims=True)
                                        + 1e-6) * g)
    add("lrn", lambda rng: (rng.randn(1, 4, 3, 3).astype(np.float32),))
    add("scale_shift_act", lambda rng: (rng.randn(4, 6).astype(np.float32),
                                        rng.randn(6).astype(np.float32),
                                        rng.randn(6).astype(np.float32)),
        golden=lambda x, sc, sh, alpha=0.01, axis=-1:
        np.where(x * sc + sh >= 0, x * sc + sh, alpha * (x * sc + sh)),
        kwargs={"alpha": 0.01, "axis": -1}, grad=True)
    add("bias_add", lambda rng: (rng.randn(2, 3).astype(np.float32),
                                 rng.randn(3).astype(np.float32)),
        golden=lambda x, b: x + b, grad=True)
    add("softmax", _r(3, 4), golden=lambda x: np.exp(x - x.max(-1, keepdims=True))
        / np.exp(x - x.max(-1, keepdims=True)).sum(-1, keepdims=True),
        grad=True)
    for nm in ("log_softmax", "logsoftmax"):
        add(nm, _r(3, 4), golden=lambda x: x - x.max(-1, keepdims=True)
            - np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1,
                                                              keepdims=True)),
            grad=True)

    # losses: golden formulas
    yp = lambda rng: (rng.rand(4, 3).astype(np.float32) * 0.8 + 0.1,
                      np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)])
    add("log_loss", yp, note="clipped BCE; structural + grad", grad=True)
    add("mean_sqerr_loss",
        lambda rng: (rng.randn(4, 3).astype(np.float32),
                     rng.randn(4, 3).astype(np.float32)), grad=True)
    add("absolute_difference_loss",
        lambda rng: (rng.randn(4, 3).astype(np.float32),
                     rng.randn(4, 3).astype(np.float32)))
    add("huber_loss", lambda rng: (rng.randn(4, 3).astype(np.float32),
                                   rng.randn(4, 3).astype(np.float32)),
        grad=True)
    add("hinge_loss", lambda rng: (rng.randn(4, 3).astype(np.float32),
                                   np.sign(rng.randn(4, 3)).astype(np.float32)))
    add("cosine_distance_loss",
        lambda rng: (rng.randn(4, 3).astype(np.float32),
                     rng.randn(4, 3).astype(np.float32)))
    add("sigmoid_cross_entropy_loss",
        lambda rng: (rng.randn(4, 3).astype(np.float32),
                     (rng.rand(4, 3) > 0.5).astype(np.float32)), grad=True)
    add("softmax_cross_entropy_loss",
        lambda rng: (rng.randn(4, 3).astype(np.float32),
                     np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]),
        grad=True)
    add("sparse_softmax_cross_entropy_loss",
        lambda rng: (rng.randint(0, 3, 4).astype(np.int32),
                     rng.randn(4, 3).astype(np.float32)),
        grad=True, grad_arg_idx=(1,))

    # attention / rnn (structural; parity is covered by dedicated suites)
    add("dot_product_attention",
        lambda rng: tuple(rng.randn(2, 4, 2, 8).astype(np.float32)
                          for _ in range(3)))
    add("multi_head_dot_product_attention",
        lambda rng: tuple([rng.randn(2, 5, 8).astype(np.float32),
                           rng.randn(2, 5, 8).astype(np.float32)]
                          + [rng.randn(8, 8).astype(np.float32)
                             for _ in range(4)]),
        kwargs={"num_heads": 2})
    add("flash_attention",
        lambda rng: tuple(rng.randn(2, 2, 8, 4).astype(np.float32)
                          for _ in range(3)))
    H = 4
    add("lstmCell", lambda rng: (rng.randn(2, 3).astype(np.float32),
                                 rng.randn(2, H).astype(np.float32),
                                 rng.randn(2, H).astype(np.float32),
                                 rng.randn(3, 4 * H).astype(np.float32),
                                 rng.randn(H, 4 * H).astype(np.float32),
                                 rng.randn(4 * H).astype(np.float32)))
    add("gruCell", lambda rng: (rng.randn(2, 3).astype(np.float32),
                                rng.randn(2, H).astype(np.float32),
                                rng.randn(3, 3 * H).astype(np.float32),
                                rng.randn(H, 3 * H).astype(np.float32),
                                rng.randn(3 * H).astype(np.float32),
                                rng.randn(3 * H).astype(np.float32)))
    add("sruCell", lambda rng: (rng.randn(2, 3).astype(np.float32),
                                rng.randn(2, 3).astype(np.float32),
                                rng.randn(3, 3).astype(np.float32),
                                rng.randn(3, 3).astype(np.float32),
                                rng.randn(3).astype(np.float32),
                                rng.randn(3, 3).astype(np.float32),
                                rng.randn(3).astype(np.float32)))
    seq = lambda rng: (rng.randn(5, 2, 3).astype(np.float32),
                       rng.randn(3, 4 * H).astype(np.float32),
                       rng.randn(H, 4 * H).astype(np.float32),
                       rng.randn(4 * H).astype(np.float32))
    add("lstmLayer", seq, grad=True, grad_arg_idx=(1,))
    add("lstmLayer_out", seq)
    gseq = lambda rng: (rng.randn(5, 2, 3).astype(np.float32),
                        rng.randn(3, 3 * H).astype(np.float32),
                        rng.randn(H, 3 * H).astype(np.float32),
                        rng.randn(3 * H).astype(np.float32),
                        rng.randn(3 * H).astype(np.float32))
    add("gru", gseq)
    add("gru_out", gseq)
    add("simple_rnn", lambda rng: (rng.randn(5, 2, 3).astype(np.float32),
                                   rng.randn(3, H).astype(np.float32),
                                   rng.randn(H, H).astype(np.float32),
                                   rng.randn(H).astype(np.float32)))
    add("sru", lambda rng: (rng.randn(5, 2, 3).astype(np.float32),
                            rng.randn(3, 3).astype(np.float32),
                            rng.randn(3, 3).astype(np.float32),
                            rng.randn(3).astype(np.float32),
                            rng.randn(3, 3).astype(np.float32),
                            rng.randn(3).astype(np.float32)))

    # random ops: shape/dtype + coarse moments (ref: RandomOpValidation)
    key_args = lambda rng: (Key(0), (400,))
    add("random_uniform", key_args, note="moments checked in runner")
    add("random_normal", key_args, note="moments checked in runner")
    add("random_bernoulli", lambda rng: (Key(0), (400,)),
        kwargs={"p": 0.3})
    add("random_exponential", key_args, kwargs={"lam": 2.0})
    add("random_gamma", key_args, kwargs={"alpha": 2.0})
    add("random_poisson", key_args, kwargs={"lam": 3.0})
    add("random_multinomial",
        lambda rng: (Key(0),
                     np.log(np.asarray([[0.2, 0.3, 0.5]], np.float32)), 40))
    add("random_shuffle", lambda rng: (Key(0),
                                       np.arange(10, dtype=np.float32)))
    add("dropout", lambda rng: (rng.randn(100,).astype(np.float32), 0.5,
                                StepKey(0, 0)),
        kwargs={"train": True})
    add("dropout_inverted", lambda rng: (rng.randn(100,).astype(np.float32),
                                         0.5, StepKey(0, 0)),
        kwargs={"train": True})
    add("non_max_suppression",
        lambda rng: (np.asarray([[0, 0, 2, 2], [0.1, 0.1, 2, 2], [3, 3, 4, 4]],
                                np.float32),
                     np.asarray([0.9, 0.8, 0.7], np.float32)),
        kwargs={"max_out": 2})
    return C


def all_cases() -> List[OpCase]:
    from deeplearning4j_tpu_torch.ops.validation_ext import build_ext_cases
    from deeplearning4j_tpu_torch.ops.validation_r5 import build_r5_cases
    return _build_cases() + _build_nn_cases() + build_ext_cases() \
        + build_r5_cases()


# --------------------------------------------------------------------------
# runner + coverage
# --------------------------------------------------------------------------

#: ops that draw from a generator or a dropout key: values not compared
#: with another implementation, only their statistics
RANDOM_OPS = frozenset({
    "random_uniform", "random_normal", "random_bernoulli",
    "random_exponential", "random_gamma", "random_poisson",
    "random_multinomial", "random_shuffle", "multinomial", "dropout",
    "dropout_inverted", "alpha_dropout", "gaussian_dropout",
    "gaussian_noise", "random_crop", "truncated_normal",
    "random_truncated_normal", "binomial", "random_binomial", "log_normal",
    "random_lognormal"})


def run_case(case: OpCase, seed: int = 0, device=None, grad: bool = True):
    """One case on ``device`` (``cuda`` unless named): finite outputs, all
    on the device, the golden, the structural and random checks, and the
    float64 gradcheck. Returns the op's outputs."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    args = case.args(rng)
    out = call(case, args, dev)
    _check_device(case.op, out, dev)
    _check_finite(case.op, out)
    if case.golden is not None:
        want = case.golden(*args, **{k: v for k, v in case.kwargs.items()})
        _compare(case.op, out, want, case.rtol, case.atol)
    _check_structure(case.op, args, out)
    if case.op in RANDOM_OPS:
        _check_random(case, out)
    if case.grad and grad:
        grad_check(case, args, dev)
    return out


def leaves(x) -> list:
    """The tensors and numbers of an output (TensorLists by their
    arrays)."""
    if isinstance(x, TensorList):
        x = x.arrays
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in leaves(e)]
    return [x]


def _check_device(op, out, dev):
    for t in R.tensor_leaves(out):
        assert t.device.type == dev.type, \
            f"{op}: output on {t.device}, want {dev}"


def _check_finite(op, out):
    for t in R.tensor_leaves(out):
        if t.is_floating_point():
            assert bool(torch.all(torch.isfinite(t))), \
                f"{op}: non-finite output"


def _compare(op, got, want, rtol, atol):
    g_leaves = leaves(to_host(got))
    w_leaves = leaves(want)
    assert len(g_leaves) == len(w_leaves), \
        f"{op}: {len(g_leaves)} outputs vs golden {len(w_leaves)}"
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=rtol, atol=atol, err_msg=op)


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _check_structure(op, args, out):
    """The decompositions are defined up to sign or phase: their factors
    are held to the input they reconstruct (the JAX package names these
    cases "checked structurally")."""
    if op not in ("qr", "svd", "eigh", "lu", "dynamic_partition"):
        return
    a = np.asarray(args[0], np.float64)
    o = [np.asarray(v, np.float64) for v in leaves(to_host(out))]
    if op == "qr":
        q, r = o
        _close(q @ r, a)
        _close(q.T @ q, np.eye(q.shape[1]))
    elif op == "svd":
        u, s, vh = o
        k = s.shape[-1]
        _close(u[:, :k] * s @ vh[:k], a)
    elif op == "eigh":
        w, v = o
        _close(a @ v, v * w, 1e-3)
    elif op == "lu":
        p, lo, up = o
        _close(p @ lo @ up, a)
    elif op == "dynamic_partition":
        _close(sum(o), a)


def _check_random(case, out):
    arr = np.asarray(to_host(leaves(out)[0]), np.float64)
    op = case.op
    # the JAX harness's statistics
    if op == "random_uniform":
        assert 0.3 < arr.mean() < 0.7 and arr.min() >= 0 and arr.max() <= 1
    elif op == "random_normal":
        assert abs(arr.mean()) < 0.3 and 0.7 < arr.std() < 1.3
    elif op == "random_bernoulli":
        assert 0.15 < arr.mean() < 0.45
    elif op.startswith("dropout"):
        zeros = (arr == 0).mean()
        assert 0.3 < zeros < 0.7, f"{op}: dropout rate off ({zeros})"
    # the port's own moment checks on its samplers (4 sigma or wider)
    elif op == "random_exponential":
        assert abs(arr.mean() - 0.5) < 0.1 and arr.min() >= 0
    elif op == "random_gamma":
        assert abs(arr.mean() - 2.0) < 0.3 and arr.min() > 0
    elif op == "random_poisson":
        assert abs(arr.mean() - 3.0) < 0.4 and np.all(arr == np.round(arr))
    elif op in ("random_multinomial", "multinomial"):
        n = arr.size
        assert set(np.unique(arr)) <= {0.0, 1.0, 2.0}
        assert abs((arr == 2).mean() - 0.5) < 4 * np.sqrt(0.25 / n)
    elif op == "random_shuffle":
        assert sorted(arr.tolist()) == list(range(10))
    elif op in ("truncated_normal", "random_truncated_normal"):
        assert np.all(np.abs(arr) < 2.0) and abs(arr.mean()) < 0.2
    elif op in ("binomial", "random_binomial"):
        n, p = case.args(np.random.RandomState(0))[2:4]
        assert arr.min() >= 0 and arr.max() <= n
        assert abs(arr.mean() - n * p) < 4 * np.sqrt(n * p * (1 - p)
                                                     / arr.size)
    elif op in ("log_normal", "random_lognormal"):
        assert arr.min() > 0 and abs(np.log(arr).mean()) < 0.5
    elif op == "gaussian_noise":
        assert abs(arr.std() - 1.0) < 0.05
    elif op == "alpha_dropout":
        assert abs(arr.mean()) < 0.1
    elif op == "gaussian_dropout":
        assert 0.9 < arr.std() < 1.4
    elif op == "random_crop":
        assert arr.shape == (4, 4, 3)


def grad_check(case: OpCase, args, device):
    """``torch.autograd.gradcheck`` in float64 of the op's floating
    outputs against each floating ndarray arg in ``grad_arg_idx`` (ref:
    GradCheckUtil.checkGradients): the whole Jacobian, central
    differences against autograd."""
    dev = torch.device(device)
    fn = R.get(case.op)
    kwargs = _kwargs(case, fn, dev)
    base = list(to_device(args, dev, float64=True))
    for ai in case.grad_arg_idx:
        if not isinstance(args[ai], np.ndarray) or \
                not np.issubdtype(args[ai].dtype, np.floating):
            continue

        def f(x, _ai=ai):
            a = list(base)
            a[_ai] = x
            outs = [t for t in R.tensor_leaves(fn(*a, **kwargs))
                    if t.is_floating_point()]
            return tuple(outs)

        x0 = base[ai].detach().clone().requires_grad_(True)
        # nondet_tol: the card's atomic scatter-adds sum in any order
        torch.autograd.gradcheck(f, (x0,), eps=1e-6, atol=1e-5, rtol=1e-3,
                                 nondet_tol=1e-10)


# ops validated by dedicated suites or structurally non-comparable;
# every entry must carry a pointer (the reference's IGNORE set equivalent)
EXEMPT: Dict[str, str] = {
    "multi_head_dot_product_attention":
        "parity against the JAX op in tests/test_torch_ops_ext.py (the "
        "mha cases)",
}


@dataclass
class CoverageReport:
    total: int
    covered: int
    exempt: int
    uncovered: List[str]

    @property
    def pct(self) -> float:
        return 100.0 * (self.covered + self.exempt) / max(self.total, 1)


def coverage_report(cases: Optional[List[OpCase]] = None) -> CoverageReport:
    cases = cases if cases is not None else all_cases()
    covered = {c.op for c in cases}
    ops = set(R.all_ops())
    uncovered = sorted(ops - covered - set(EXEMPT))
    return CoverageReport(total=len(ops),
                          covered=len(ops & covered),
                          exempt=len((set(EXEMPT) & ops) - covered),
                          uncovered=uncovered)
