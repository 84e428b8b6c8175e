"""The port's eager NDArray against the JAX package's: every behaviour of
``tests/test_linalg.py``, case for case, run through both packages on the
same inputs, each side's asserts checked and its returned values compared
(values at 1e-5, dtypes exactly). The RNG cases check determinism and
save/restore within the port (its streams are not Threefry's). Then the
inventory gate against ``dir(deeplearning4j_tpu.linalg.ndarray.NDArray)``
and one test per aliasing trap (torch's ``reshape``/``permute``/``expand``
alias a buffer; JAX arrays never do) on both sides."""

import functools

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.linalg import DataType as JDataType
from deeplearning4j_tpu.linalg import NDArray as JNDArray
from deeplearning4j_tpu.linalg import conditions as jcond
from deeplearning4j_tpu.linalg import nd as jnd
from deeplearning4j_tpu.linalg import transforms as jtr
from deeplearning4j_tpu_torch.linalg import DataType as TDataType
from deeplearning4j_tpu_torch.linalg import NDArray as TNDArray
from deeplearning4j_tpu_torch.linalg import conditions as tcond
from deeplearning4j_tpu_torch.linalg import nd as tnd
from deeplearning4j_tpu_torch.linalg import transforms as ttr

#: the factory functions that take ``device=``
_CREATORS = {"create", "zeros", "ones", "valueArrayOf", "full", "eye",
             "arange", "linspace", "scalar", "empty", "rand", "randn",
             "randint", "bernoulli", "oneHot"}


class _CpuND:
    """The port's ``nd`` with ``device="cpu"`` on every creation call."""

    def __getattr__(self, name):
        f = getattr(tnd, name)
        return functools.partial(f, device="cpu") if name in _CREATORS else f


class Side:
    def __init__(self, name, nd, NDArray, DataType, cond, tr):
        self.name, self.nd, self._NDArray = name, nd, NDArray
        self.DataType, self.cond, self.tr = DataType, cond, tr

    def NDArray(self, v):
        if self.name == "torch":
            return self._NDArray(v, device="cpu")
        return self._NDArray(v)


JAX = Side("jax", jnd, JNDArray, JDataType, jcond, jtr)
TORCH = Side("torch", _CpuND(), TNDArray, TDataType, tcond, ttr)

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


# ------------------------------------------------------------ TestFactory
@case
def zeros_ones(S):
    z = S.nd.zeros(2, 3)
    assert z.shape == (2, 3)
    assert z.sumNumber() == 0.0
    o = S.nd.ones(4)
    assert o.sumNumber() == 4.0
    return {"z": z.numpy(), "o": o.numpy(), "dt": z.dtype.name}


@case
def create_reshape(S):
    a = S.nd.create([1, 2, 3, 4, 5, 6], shape=(2, 3))
    assert a.shape == (2, 3)
    assert a.getDouble(1, 2) == 6.0
    return {"a": a.numpy(), "dt": a.dtype.name}


@case
def arange_linspace(S):
    assert S.nd.arange(5).numpy().tolist() == [0, 1, 2, 3, 4]
    ls = S.nd.linspace(0, 1, 5)
    np.testing.assert_allclose(ls.numpy(), [0, 0.25, 0.5, 0.75, 1.0],
                               atol=1e-6)
    return {"ar": S.nd.arange(5).numpy(), "ls": ls.numpy(),
            "dt": S.nd.arange(5).dtype.name}


@case
def one_hot(S):
    oh = S.nd.oneHot([0, 2], 3)
    np.testing.assert_allclose(oh.numpy(), [[1, 0, 0], [0, 0, 1]])
    return {"oh": oh.numpy(), "dt": oh.dtype.name}


# --------------------------------------------------------- TestNDArrayOps
@case
def add_broadcast(S):
    a = S.nd.ones(2, 3)
    b = S.nd.create([1, 2, 3])
    c = a.add(b)
    np.testing.assert_allclose(c.numpy(), [[2, 3, 4], [2, 3, 4]])
    return {"c": c.numpy()}


@case
def inplace_mutation_visible(S):
    a = S.nd.ones(2, 2)
    alias = a
    a.addi(1.0)
    assert alias.sumNumber() == 8.0
    return {"a": a.numpy()}


@case
def mmul(S):
    a = S.nd.create([[1, 2], [3, 4]])
    b = S.nd.create([[5, 6], [7, 8]])
    c = a.mmul(b)
    np.testing.assert_allclose(c.numpy(), [[19, 22], [43, 50]])
    return {"c": c.numpy()}


@case
def mmul_transpose_flags(S):
    rng = np.random.RandomState(0)
    a = S.nd.create(rng.randn(3, 4))
    b = S.nd.create(rng.randn(3, 5))
    c = a.mmul(b, transpose_a=True)
    np.testing.assert_allclose(c.numpy(), a.numpy().T @ b.numpy(), atol=1e-5)
    return {"c": c.numpy()}


@case
def reductions(S):
    a = S.nd.create([[1.0, 2.0], [3.0, 4.0]])
    assert a.sumNumber() == 10.0
    np.testing.assert_allclose(a.sum(0).numpy(), [4, 6])
    np.testing.assert_allclose(a.mean(1).numpy(), [1.5, 3.5])
    assert a.maxNumber() == 4.0
    assert int(a.argMax(1).numpy()[0]) == 1
    return {"s": a.sum(0).numpy(), "m": a.mean(1).numpy(),
            "am": a.argMax(1).numpy(), "amdt": a.argMax(1).dtype.name}


@case
def std_is_sample_std(S):
    a = S.nd.create([1.0, 2.0, 3.0, 4.0])
    assert abs(float(a.std().numpy()) - np.std([1, 2, 3, 4], ddof=1)) < 1e-6
    return {"s": a.std().numpy(), "v": a.var().numpy()}


@case
def norms(S):
    a = S.nd.create([3.0, -4.0])
    assert a.norm2Number() == pytest.approx(5.0)
    assert a.norm1Number() == pytest.approx(7.0)
    return {"n2": a.norm2Number(), "n1": a.norm1Number()}


@case
def view_writeback(S):
    a = S.nd.zeros(3, 3)
    row = a.getRow(1)
    row.assign(S.nd.ones(3))
    np.testing.assert_allclose(a.numpy()[1], [1, 1, 1])
    assert a.sumNumber() == 3.0
    return {"a": a.numpy(), "view": row.isView()}


@case
def putscalar_getrow(S):
    a = S.nd.zeros(2, 2)
    a.putScalar(0, 1, 5.0)
    assert a.getDouble(0, 1) == 5.0
    return {"a": a.numpy()}


@case
def setitem(S):
    a = S.nd.zeros(4)
    a[1:3] = 7.0
    np.testing.assert_allclose(a.numpy(), [0, 7, 7, 0])
    return {"a": a.numpy()}


@case
def dup_detaches(S):
    a = S.nd.ones(2)
    b = a.dup()
    b.addi(1.0)
    assert a.sumNumber() == 2.0
    assert b.sumNumber() == 4.0
    return {"a": a.numpy(), "b": b.numpy()}


@case
def cast(S):
    a = S.nd.create([1.7, 2.3])
    b = a.castTo(S.DataType.INT32)
    assert b.dtype == S.DataType.INT32
    assert b.numpy().tolist() == [1, 2]
    return {"b": b.numpy(), "dt": b.dtype.name}


@case
def transpose_permute(S):
    a = S.nd.zeros(2, 3, 4)
    assert a.permute(2, 0, 1).shape == (4, 2, 3)
    # no-args transpose reverses ALL dims (ref: INDArray.transpose)
    assert a.transpose().shape == (4, 3, 2)
    return {"p": a.permute(2, 0, 1).shape, "t": a.transpose().shape}


@case
def view_reads_through_base_mutation(S):
    a = S.nd.zeros(3, 3)
    row = a.getRow(1)
    a.addi(1.0)
    np.testing.assert_allclose(row.numpy(), [1, 1, 1])
    row.addi(1.0)  # must compute from fresh base data
    np.testing.assert_allclose(a.numpy()[1], [2, 2, 2])
    np.testing.assert_allclose(a.numpy()[0], [1, 1, 1])
    return {"a": a.numpy(), "row": row.numpy()}


@case
def sibling_views_no_clobber(S):
    a = S.nd.zeros(2, 2)
    r0, r1 = a.getRow(0), a.getRow(1)
    r0.assign(S.nd.ones(2))
    r1.assign(S.nd.create([2.0, 2.0]))
    np.testing.assert_allclose(a.numpy(), [[1, 1], [2, 2]])
    np.testing.assert_allclose(r0.numpy(), [1, 1])
    return {"a": a.numpy()}


@case
def argmax_multi_dims(S):
    a = S.nd.arange(24).reshape(2, 3, 4)
    am = a.argMax(1, 2)
    assert am.shape == (2,)
    assert am.numpy().tolist() == [11, 11]
    return {"am": am.numpy(), "dt": am.dtype.name}


@case
def inplace_shape_mismatch_raises(S):
    a = S.nd.ones(1, 3)
    with pytest.raises(ValueError, match="cannot change shape"):
        a.addi(S.nd.ones(2, 3))
    return {"a": a.numpy()}


@case
def concat_stack(S):
    a, b = S.nd.ones(2, 2), S.nd.zeros(2, 2)
    assert S.nd.concat(0, a, b).shape == (4, 2)
    assert S.nd.concat(1, a, b).shape == (2, 4)
    assert S.nd.stack(0, a, b).shape == (2, 2, 2)
    return {"c": S.nd.concat(1, a, b).numpy(),
            "v": S.nd.vstack(a, b).numpy(), "h": S.nd.hstack(a, b).numpy()}


@case
def comparisons(S):
    a = S.nd.create([1.0, 5.0, 3.0])
    mask = a.gt(2.0)
    assert mask.dtype == S.DataType.BOOL
    assert mask.numpy().tolist() == [False, True, True]
    return {"m": mask.numpy()}


@case
def tensor_along_dimension(S):
    a = S.nd.arange(24).reshape(2, 3, 4)
    t = a.tensorAlongDimension(0, 1, 2)
    assert t.shape == (3, 4)
    np.testing.assert_allclose(t.numpy(), a.numpy()[0])
    return {"t": t.numpy(), "view": t.isView()}


@case
def operator_overloads(S):
    a = S.nd.create([2.0, 4.0])
    np.testing.assert_allclose((a + 1).numpy(), [3, 5])
    np.testing.assert_allclose((1 - a).numpy(), [-1, -3])
    np.testing.assert_allclose((a / 2).numpy(), [1, 2])
    np.testing.assert_allclose((a @ S.nd.create([[1.0], [1.0]])).numpy(), [6])
    return {"p": (a ** 2).numpy(), "n": (-a).numpy()}


# ----------------------------------------------------- TestWidenedSurface
@case
def row_column_vector_ops(S):
    a = S.nd.create(np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_allclose(a.addRowVector([10, 20, 30]).numpy(),
                               [[10, 21, 32], [13, 24, 35]])
    np.testing.assert_allclose(a.mulColumnVector([2, 3]).numpy(),
                               [[0, 2, 4], [9, 12, 15]])
    b = S.nd.create(np.ones((2, 3), np.float32))
    b.subiRowVector([1, 1, 1])
    np.testing.assert_allclose(b.numpy(), np.zeros((2, 3)))
    return {"d": a.divColumnVector([2, 4]).numpy(), "b": b.numpy()}


@case
def inplace_through_view(S):
    a = S.nd.create(np.zeros((3, 3), np.float32))
    row = a.getRow(1)
    row.addiRowVector([1, 2, 3])
    np.testing.assert_allclose(a.numpy()[1], [1, 2, 3])
    np.testing.assert_allclose(a.numpy()[0], 0)
    return {"a": a.numpy()}


@case
def distances_and_entropy(S):
    a = S.nd.create(np.asarray([3.0, 4.0], np.float32))
    b = S.nd.create(np.asarray([0.0, 0.0], np.float32))
    assert a.distance2(b) == pytest.approx(5.0)
    assert a.distance1(b) == pytest.approx(7.0)
    assert a.squaredDistance(b) == pytest.approx(25.0)
    p = S.nd.create(np.asarray([0.5, 0.5], np.float32))
    assert p.shannonEntropy() == pytest.approx(1.0, abs=1e-5)
    return {"e": p.entropy(), "le": p.logEntropy()}


@case
def abs_reductions_and_sort(S):
    a = S.nd.create(np.asarray([[-5.0, 2.0], [3.0, -1.0]], np.float32))
    assert a.amaxNumber() == 5.0
    assert a.aminNumber() == 1.0
    np.testing.assert_allclose(a.sort(dim=1).numpy(), [[-5, 2], [-1, 3]])
    np.testing.assert_allclose(a.sort(dim=1, ascending=False).numpy(),
                               [[2, -5], [3, -1]])
    assert a.maxIndex() == 2
    return {"am": a.amean(0).numpy(), "amn": a.ameanNumber()}


@case
def conditions_and_boolean_indexing(S):
    BI, C = S.cond.BooleanIndexing, S.cond.Conditions
    a = S.nd.create(np.asarray([1.0, -2.0, 3.0, np.nan], np.float32))
    assert BI.countOccurrences(a, C.greaterThan(0.0)) == 2
    assert BI.firstIndex(a, C.isNan()) == 3
    a.replaceWhere(0.0, C.isNan())
    np.testing.assert_allclose(a.numpy(), [1, -2, 3, 0])
    a.replaceWhere(9.0, C.lessThan(0.0) | C.equals(3.0))
    np.testing.assert_allclose(a.numpy(), [1, 9, 9, 0])
    return {"a": a.numpy(), "last": BI.lastIndex(a, C.greaterThan(5.0)),
            "and": BI.and_(a, C.isFinite()), "or": BI.or_(a, ~C.isFinite())}


@case
def transforms_statics(S):
    T = S.tr
    x = S.nd.create(np.asarray([-1.0, 0.0, 1.0], np.float32))
    np.testing.assert_allclose(T.relu(x).numpy(), [0, 0, 1])
    np.testing.assert_allclose(T.sigmoid(x).numpy(),
                               1 / (1 + np.exp([1.0, 0.0, -1.0])), rtol=1e-5)
    assert T.cosineSim(x, x) == pytest.approx(1.0)
    u = T.unitVec(S.nd.create(np.asarray([3.0, 4.0], np.float32)))
    np.testing.assert_allclose(u.numpy(), [0.6, 0.8], rtol=1e-6)
    d = T.allEuclideanDistances(S.nd.create(np.eye(2, dtype=np.float32)),
                                S.nd.create(np.eye(2, dtype=np.float32)))
    np.testing.assert_allclose(np.diag(d.numpy()), 0, atol=1e-6)
    assert T.Transforms.euclideanDistance(S.nd.create([0, 0]),
                                          S.nd.create([3, 4])) == 5.0
    return {"sm": T.softmax(x).numpy(), "lsm": T.logSoftmax(x).numpy(),
            "gelu": T.gelu(x).numpy(), "hs": T.hardSigmoid(x).numpy(),
            "acs": T.allCosineSimilarities(d, d).numpy(),
            "jac": T.jaccardDistance(u, u), "pow": T.pow(u, 2).numpy(),
            "mx": T.max(x, 0.5).numpy()}


@case
def conversions_and_layout_shims(S):
    a = S.nd.create(np.arange(4, dtype=np.float32).reshape(2, 2))
    assert a.toIntVector().tolist() == [0, 1, 2, 3]
    assert a.toDoubleMatrix().dtype == np.float64
    assert a.ordering() == "c"
    assert a.stride() == (2, 1)
    return {"l": a.toLongMatrix(), "b": a.toByteVector()}


# ------------------------------------------------------------ TestR4Surface
@case
def new_unaries_and_inplace(S):
    x = S.NDArray(np.asarray([0.25, 0.5], np.float32))
    np.testing.assert_allclose(_np(x.asin()), np.arcsin([0.25, 0.5]),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(x.oneMinus()), [0.75, 0.5])
    y = S.NDArray(np.asarray([4.0, 9.0], np.float32))
    y.rsqrti()
    np.testing.assert_allclose(_np(y), [0.5, 1 / 3], rtol=1e-6)
    z = S.NDArray(np.asarray([-1.5, -0.2, 0.3, 2.7], np.float32))
    return {name: _np(getattr(z, name)()) for name in (
        "cbrt", "frac", "trunc", "rint", "softplus", "softsign", "elu",
        "selu", "gelu", "swish", "mish", "hardSigmoid", "hardTanh",
        "leakyRelu", "erf", "erfc", "cube", "square", "expm1")}


@case
def rsub_rdiv_vectors(S):
    m = S.NDArray(np.asarray([[2.0, 4.0], [8.0, 16.0]], np.float32))
    r = m.rdivRowVector(np.asarray([2.0, 4.0], np.float32))
    np.testing.assert_allclose(_np(r), [[1.0, 1.0], [0.25, 0.25]])
    c = m.rsubColumnVector(np.asarray([1.0, 2.0], np.float32))
    np.testing.assert_allclose(_np(c), [[-1.0, -3.0], [-6.0, -14.0]])
    return {"r": _np(r), "c": _np(c)}


@case
def inplace_comparisons(S):
    x = S.NDArray(np.asarray([1.0, 5.0, 3.0], np.float32))
    x.gti(2.0)
    np.testing.assert_allclose(_np(x), [0.0, 1.0, 1.0])
    assert x.dtype.name.lower().startswith("float")
    return {"x": _np(x), "dt": x.dtype.name}


@case
def matrix_and_stats(S):
    m = S.NDArray(np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32))
    assert m.trace() == 5.0
    np.testing.assert_allclose(_np(m.diag()), [1.0, 4.0])
    v = S.NDArray(np.asarray([1.0, 2.0], np.float32))
    np.testing.assert_allclose(_np(v.outer(v)), [[1.0, 2.0], [2.0, 4.0]])
    rng = np.random.RandomState(0)
    z = S.NDArray(rng.randn(1000).astype(np.float32))
    assert abs(float(z.skewness().numpy())) < 0.3
    assert abs(float(z.kurtosis().numpy())) < 0.5
    return {"sk": _np(z.skewness()), "ku": _np(z.kurtosis()),
            "lse": _np(m.logSumExp(1)), "med": _np(m.median(0)),
            "pct": _np(m.percentile(30, 1))}


@case
def shape_and_views(S):
    x = S.NDArray(np.arange(6, dtype=np.float32))
    x.reshapei(2, 3)
    assert x.shape == (2, 3)
    x.transposei()
    assert x.shape == (3, 2)
    assert x.moveAxis(0, 1).shape == (2, 3)
    assert x.repmat(2, 2).shape == (6, 4)
    assert x.broadcastTo(5, 3, 2).shape == (5, 3, 2)
    m = S.NDArray(np.arange(12, dtype=np.float32).reshape(3, 4))
    np.testing.assert_allclose(_np(m.getRows(0, 2)), _np(m)[[0, 2]])
    np.testing.assert_allclose(_np(m.getColumns(1, 3)), _np(m)[:, [1, 3]])
    m.putSlice(1, np.zeros(4, np.float32))
    assert float(m.sumNumber()) == float(np.arange(12).sum()
                                         - (4 + 5 + 6 + 7))
    return {"x": _np(x), "m": _np(m)}


@case
def where_and_argsort(S):
    x = S.NDArray(np.asarray([3.0, -1.0, 5.0, 0.0], np.float32))
    got = _np(x.getWhere(None, S.cond.Conditions.greaterThan(0)))
    np.testing.assert_allclose(got, [3.0, 5.0])
    masked = x.putWhereWithMask(np.asarray([1, 0, 1, 0], np.float32),
                                np.zeros(4, np.float32))
    np.testing.assert_allclose(_np(masked), [0.0, -1.0, 0.0, 0.0])
    np.testing.assert_allclose(_np(x.argsort()), [1, 3, 0, 2])
    np.testing.assert_allclose(_np(x.argsort(descending=True)), [2, 0, 3, 1])
    return {"as": _np(x.argsort()), "dt": x.argsort().dtype.name}


@case
def alloc_alikes_and_workspace_identities(S):
    x = S.NDArray(np.ones((2, 3), np.float32))
    assert x.like().shape == (2, 3)
    assert float(x.like().sumNumber()) == 0.0
    assert x.detach() is x and x.leverage() is x and x.migrate() is x
    return {"u": _np(x.ulike())}


# ----------------------------------------------------- TestR5SurfaceCompletion
@case
def r5_new_methods(S):
    C = S.cond.Conditions
    a = S.nd.create(np.asarray([[1., -2., 3.], [4., -5., 6.]], np.float32))
    assert float(np.asarray(a.asum().numpy())) == 21.0
    assert a.normmaxNumber() == 6.0
    assert abs(a.percentileNumber(50) - 2.0) < 1e-5
    b = S.nd.create(np.asarray([[1., -2., 3.], [4., -5., 6.]], np.float32))
    assert a.cosineSim(b) > 0.999
    assert bool(np.asarray(a.eps(b).numpy()).all())
    np.testing.assert_allclose(np.asarray(a.slice(1).numpy()), [4., -5., 6.])
    np.testing.assert_allclose(np.asarray(a.slice(0, dim=1).numpy()),
                               [1., 4.])
    assert a.subArray((0, 1), (2, 2)).shape == (2, 2)
    assert a.tensorsAlongDimension(1) == 2
    assert a.vectorsAlongDimension(0) == 3
    m = a.cond(C.greaterThan(0))
    assert float(np.asarray(m.numpy()).sum()) == 4.0
    assert float(np.asarray(a.negative().numpy())[0, 0]) == -1.0
    a2 = S.nd.create(np.ones((2, 2), np.float32))
    a2.negativei()
    assert float(np.asarray(a2.numpy())[0, 0]) == -1.0
    assert a.close() is None
    np.testing.assert_allclose(np.asarray(a.sumAlongDimension(0).numpy()),
                               [5., -7., 9.])
    np.testing.assert_allclose(np.asarray(a.meanAlongDimension(1).numpy()),
                               [2 / 3, 5 / 3], rtol=1e-5)
    return {"m": m.numpy(), "pn": a.percentileNumber(30),
            "med": a.medianNumber(), "cp": a.cumprod(1).numpy(),
            "cs": a.cumsum(0).numpy(), "norms": (a.norm1(0).numpy(),
                                                  a.norm2(1).numpy(),
                                                  a.normMax(0).numpy()),
            "prod": a.prod(0).numpy(), "prodn": a.prodNumber(),
            "stdn": a.stdNumber(), "varn": a.varNumber(),
            "rev": a.reverse().numpy(), "isMax": a.isMax().numpy(),
            "fm": a.fmod(4.0).numpy(), "rem": a.remainder(4.0).numpy()}


@case
def integer_dtypes_without_x64(S):
    """The JAX package's dtypes without x64: int sums and argmax int32,
    a DOUBLE/INT64 array float32/int32, bool sums int32."""
    i = S.nd.create(np.asarray([[1, 2], [3, 4]]), dtype=S.DataType.INT32)
    d = S.nd.create([1.0, 2.0], dtype=S.DataType.DOUBLE)
    l = S.nd.create([1, 2], dtype=S.DataType.INT64)
    b = i.gt(1)
    return {"sum": i.sum(0).dtype.name, "mean": i.mean().dtype.name,
            "am": i.argMax().dtype.name, "d": d.dtype.name,
            "l": l.dtype.name, "bsum": b.sum().dtype.name,
            "cast": i.castTo(S.DataType.DOUBLE).dtype.name,
            "np64": S.NDArray(np.ones(2)).dtype.name,
            "cs": i.cumsum(1).dtype.name, "prod": i.prod(0).dtype.name}


def _run(side, name):
    return CASES[name](side)


def _assert_same(j, t, path="out"):
    if isinstance(j, dict):
        assert set(j) == set(t), path
        for k in j:
            _assert_same(j[k], t[k], f"{path}.{k}")
    elif isinstance(j, (tuple, list)) and not np.isscalar(j):
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(j, (str, bool, type(None))):
        assert j == t, f"{path}: jax {j!r} torch {t!r}"
    else:
        ja, ta = np.asarray(j), np.asarray(t)
        assert ja.shape == ta.shape, f"{path}: {ja.shape} vs {ta.shape}"
        np.testing.assert_allclose(ta.astype(np.float64),
                                   ja.astype(np.float64), rtol=1e-5,
                                   atol=1e-5, err_msg=path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_jax(name):
    want = _run(JAX, name)
    got = _run(TORCH, name)
    _assert_same(want, got)


# ------------------------------------------------------------- RNG (port)
def test_rng_determinism():
    tnd.setSeed(42)
    a = tnd.randn(3, 3, device="cpu")
    tnd.setSeed(42)
    b = tnd.randn(3, 3, device="cpu")
    assert a.equals(b)
    c = tnd.randn(3, 3, device="cpu")
    assert not b.equals(c)


def test_rng_state_save_restore():
    rng = tnd.Random(7)
    _ = tnd.rand(2, 2, rng=rng, device="cpu")
    state = rng.getState()
    a = tnd.rand(2, 2, rng=rng, device="cpu")
    rng.setState(state)
    b = tnd.rand(2, 2, rng=rng, device="cpu")
    assert a.equals(b)
    assert state == {"seed": 7, "counter": 1}


def test_rng_streams_and_shuffle():
    r1, r2 = tnd.Random(3), tnd.Random(4)
    a = tnd.rand(1000, rng=r1, device="cpu")
    assert 0.0 <= a.minNumber() and a.maxNumber() < 1.0
    assert abs(a.meanNumber() - 0.5) < 0.05
    assert not a.equals(tnd.rand(1000, rng=r2, device="cpu"))
    n = tnd.randn(4000, rng=r1, device="cpu")
    assert abs(n.meanNumber()) < 0.1 and abs(n.stdNumber() - 1) < 0.1
    ri = tnd.randint(0, 5, (100,), rng=r1, device="cpu")
    assert ri.dtype == TDataType.INT32 and 0 <= ri.minNumber() \
        and ri.maxNumber() <= 4
    bern = tnd.bernoulli(0.3, (4000,), rng=r1, device="cpu")
    assert abs(bern.meanNumber() - 0.3) < 0.05
    s = tnd.arange(16, device="cpu").reshape(8, 2)
    before = s.numpy().copy()
    assert tnd.shuffle(s, rng=tnd.Random(1)) is s
    assert sorted(s.numpy()[:, 0].tolist()) == sorted(before[:, 0].tolist())
    s2 = tnd.arange(16, device="cpu").reshape(8, 2)
    tnd.shuffle(s2, rng=tnd.Random(1))
    np.testing.assert_array_equal(s.numpy(), s2.numpy())


def test_shuffle_inplace_both_sides():
    for nd_ in (jnd, _CpuND()):
        a = nd_.arange(16).reshape(8, 2)
        before = a.numpy().copy()
        ret = nd_.shuffle(a)
        assert ret is a
        assert sorted(a.numpy()[:, 0].tolist()) == sorted(
            before[:, 0].tolist())


# ---------------------------------------------------------- inventory gate
def test_public_names_are_a_superset_of_the_jax_class():
    jax_names = {m for m in dir(JNDArray) if not m.startswith("_")}
    port_names = {m for m in dir(TNDArray) if not m.startswith("_")}
    missing = jax_names - port_names
    assert not missing, f"the port's NDArray lacks {sorted(missing)}"
    assert len(port_names) >= 260


def test_factory_and_transforms_names_cover_the_jax_modules():
    for jmod, tmod in ((jnd, tnd), (jtr, ttr), (jcond.Conditions,
                                                tcond.Conditions),
                       (jcond.BooleanIndexing, tcond.BooleanIndexing)):
        want = {n for n in dir(jmod) if not n.startswith("_")
                and callable(getattr(jmod, n))}
        want -= {"jax", "jnp", "np", "Optional", "InstrumentedLock"}
        have = {n for n in dir(tmod) if not n.startswith("_")}
        assert not want - have, sorted(want - have)


# ----------------------------------------------------- aliasing traps
ALIASES = {
    "reshape": lambda a: a.reshape(3, 2),
    "ravel": lambda a: a.ravel(),
    "flatten": lambda a: a.flatten(),
    "transpose": lambda a: a.transpose(),
    "permute": lambda a: a.permute(1, 0),
    "broadcast": lambda a: a.broadcast(4, 2, 3),
    "castTo": lambda a: a.castTo(type(a.dtype).FLOAT),
    "dup": lambda a: a.dup(),
    "swapAxes": lambda a: a.swapAxes(0, 1),
    "expandDims": lambda a: a.expandDims(0),
    "tensorAlongDimension": lambda a: a.tensorAlongDimension(0, 1),
    "slice": lambda a: a.slice(0),
}


@pytest.mark.parametrize("method", sorted(ALIASES))
@pytest.mark.parametrize("side", [JAX, TORCH], ids=["jax", "torch"])
def test_derived_arrays_are_detached(side, method):
    """``reshape`` & co. return arrays of their own: an ``addi`` on the
    result leaves the source alone, and one on the source leaves the
    result alone (torch's reshape/permute/expand would alias a buffer
    written in place; ``broadcast``'s expand would even refuse it)."""
    src = side.nd.create(np.arange(6, dtype=np.float32).reshape(2, 3))
    out = ALIASES[method](src)
    before_out = out.numpy().copy()
    out.addi(100.0)
    np.testing.assert_array_equal(src.numpy(),
                                  np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(out.numpy(), before_out + 100.0)
    out2 = ALIASES[method](src)
    kept = out2.numpy().copy()
    src.addi(1.0)
    np.testing.assert_array_equal(out2.numpy(), kept)
    assert not out.isView()


VIEWS = {
    "getRow": lambda a: a.getRow(1),
    "getColumn": lambda a: a.getColumn(2),
    "slice_": lambda a: a.slice_(1),
    "getitem": lambda a: a[1, 1:],
}


def test_jax_slice_view_is_broken_and_the_port_keeps_it():
    """The JAX class's ``slice_`` raises TypeError: its module-level
    ``slice`` method shadows the builtin that ``slice_`` calls. The port
    keeps the method the reference means, a write-back view along
    ``dim`` (ROADMAP Queue 3, kept on purpose)."""
    with pytest.raises(TypeError):
        JAX.nd.create(np.zeros((2, 3), np.float32)).slice_(1)
    a = TORCH.nd.create(np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_array_equal(a.slice_(2, dim=1).numpy(), [2, 5])
    a.slice_(0).assign(0.0)
    np.testing.assert_array_equal(a.numpy(), [[0, 0, 0], [3, 4, 5]])


@pytest.mark.parametrize("side,method", [
    pytest.param(side, m, id=f"{side.name}-{m}") for side in (JAX, TORCH)
    for m in sorted(VIEWS)
    # the JAX class's slice_ raises (the test above)
    if not (side is JAX and m == "slice_")])
def test_write_back_views_write_and_read_through(side, method):
    src = side.nd.create(np.arange(6, dtype=np.float32).reshape(2, 3))
    v = VIEWS[method](src)
    assert v.isView()
    v.addi(10.0)
    want = np.arange(6, dtype=np.float32).reshape(2, 3)
    region = {"getRow": (1,), "getColumn": (slice(None), 2),
              "slice_": (1,), "getitem": (1, slice(1, None))}[method]
    want[region] += 10.0
    np.testing.assert_array_equal(src.numpy(), want)
    src.muli(2.0)                   # the view reads the new base
    np.testing.assert_array_equal(v.numpy(), (want * 2.0)[region])


@pytest.mark.parametrize("side", [JAX, TORCH], ids=["jax", "torch"])
def test_buffer_handed_out_is_not_written_later(side):
    """``a.jax()`` (the port's ``tensor()``) is the buffer at that moment;
    an ``addi`` afterwards installs a new buffer and leaves it as it was."""
    a = side.nd.create([1.0, 2.0])
    t = a.jax()
    snap = np.asarray(t if side is JAX else t.numpy()).copy()
    a.addi(5.0)
    a[0] = 9.0
    np.testing.assert_array_equal(np.asarray(t if side is JAX
                                             else t.numpy()), snap)


@pytest.mark.parametrize("side", [JAX, TORCH], ids=["jax", "torch"])
def test_inplace_on_a_broadcast_result(side):
    """The JAX ``addi`` on a broadcast array works (a new buffer of the
    broadcast shape); torch's in-place add on an expanded tensor would
    raise."""
    b = side.nd.create([1.0, 2.0, 3.0]).broadcast(2, 3)
    b.addi(1.0)
    np.testing.assert_array_equal(b.numpy(), [[2, 3, 4], [2, 3, 4]])
    with pytest.raises(ValueError, match="cannot change shape"):
        b.addi(side.nd.ones(4, 2, 3))


# ------------------------------------------------------------ device rule
def test_factory_runs_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **k: tnd.zeros(3, **k), lambda **k: tnd.create(
            [1.0], **k), lambda **k: tnd.rand(2, **k),
            lambda **k: TNDArray(np.ones(2), **k)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu").device.type == "cpu"


def test_operands_follow_the_array():
    a = tnd.create([1.0, 2.0], device="cpu")
    assert a.add(np.ones(2)).device.type == "cpu"
    assert a.add(np.ones(2)).dtype == TDataType.FLOAT
    t = torch.ones(2, dtype=torch.float64)
    assert TNDArray(t).dtype == TDataType.FLOAT
