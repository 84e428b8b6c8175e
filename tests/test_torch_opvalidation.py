"""The port's OpValidation suite against the JAX package's (the port of
``tests/test_opvalidation.py``): one parametrised test per port OpCase of
``validation._build_cases`` and ``_build_nn_cases`` (the extension and
round-5 builders have their own files), each running the port's harness
on the CPU (golden, finite outputs on the device, random statistics, the
float64 gradcheck) and holding the outputs against the JAX op on the same
seeded args at the case's rtol/atol (default 1e-4 / 1e-5), dtypes exact;
random ops by shape and dtype, decompositions by reconstruction. Then
the gates: the same 505 op names, full coverage, the exemptions, the
softmax against the JAX Pallas kernel in interpret mode, a SameDiff
save/load of registry ops, ``exec_op``'s profiling modes (as
``tests/test_observability.py``'s JAX cases), and the divergence traps
(ties, bit patterns, data-dependent outputs)."""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu.ops import registry as JR
from deeplearning4j_tpu.ops import validation as JV
from deeplearning4j_tpu.ops.registry_r5 import TensorList as JTensorList
from deeplearning4j_tpu_torch import profiler
from deeplearning4j_tpu_torch.linalg import Transforms, nd
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import registry as TR
from deeplearning4j_tpu_torch.ops import validation as TV
from deeplearning4j_tpu_torch.ops.registry_r5 import TensorList
from deeplearning4j_tpu_torch.profiler import ProfilingMode
from deeplearning4j_tpu_torch.utils.environment import NumericsPanicError

torch.set_num_threads(2)


# ------------------------------------------- the parity check of one case
# (tests/test_torch_opvalidation_{ext,r5}.py import it from here)
#: JAX and port outputs held by what they reconstruct: factors defined up
#: to sign or phase
STRUCTURAL = ("qr", "svd", "eigh", "lu")


def _np_leaves(x):
    if isinstance(x, (TensorList, JTensorList)):
        x = x.arrays
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _np_leaves(e)]
    return [x]


def _same_inputs(targs, jargs):
    """The port case and the JAX case build the same numpy inputs."""
    t, j = _np_leaves(targs), _np_leaves(jargs)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, np.asarray(b))


def _reconstruct(op, leaves):
    f = [np.asarray(v, np.float64) for v in leaves]
    if op == "qr":
        return [f[0] @ f[1]]
    if op == "svd":
        k = f[1].shape[-1]
        return [f[0][:, :k] * f[1] @ f[2][:k], f[1]]
    if op == "eigh":
        w, v = f
        return [w, (v * w) @ v.T]
    return [f[0] @ f[1] @ f[2]]


def _dtype_name(x):
    if isinstance(x, (bool, int, float)):
        return None
    return np.asarray(x).dtype.name


def check_case(tcase, jcase, device="cpu"):
    """The port's run_case (golden, finite, device, random statistics,
    float64 gradcheck), then the outputs against the JAX op's."""
    assert tcase.op == jcase.op and set(tcase.kwargs) == set(jcase.kwargs)
    out = TV.run_case(tcase, device=device)
    targs = tcase.args(np.random.RandomState(0))
    jargs = jcase.args(np.random.RandomState(0))
    _same_inputs(targs, jargs)
    jout = JR.get(jcase.op)(*jargs, **jcase.kwargs)
    got = _np_leaves(TV.to_host(out))
    want = [np.asarray(v) if isinstance(v, jax.Array) else v
            for v in _np_leaves(jout)]
    assert len(got) == len(want), f"{tcase.op}: {len(got)} vs {len(want)}"
    if tcase.op in TV.RANDOM_OPS:
        # streams differ (Philox against Threefry): shapes and dtypes
        for g, w in zip(got, want):
            assert np.shape(g) == np.shape(w), tcase.op
            assert _dtype_name(g) == _dtype_name(w), tcase.op
        return
    if tcase.op in STRUCTURAL:
        got, want = _reconstruct(tcase.op, got), _reconstruct(tcase.op,
                                                              want)
    for i, (g, w) in enumerate(zip(got, want)):
        msg = f"{tcase.op} output {i}"
        assert np.shape(g) == np.shape(w), \
            f"{msg}: shape {np.shape(g)} vs JAX {np.shape(w)}"
        if tcase.op not in STRUCTURAL:
            assert _dtype_name(g) == _dtype_name(w), \
                f"{msg}: dtype {_dtype_name(g)} vs JAX {_dtype_name(w)}"
        np.testing.assert_allclose(
            np.asarray(g, np.float64), np.asarray(w, np.float64),
            rtol=tcase.rtol, atol=tcase.atol, err_msg=msg)



TCASES = TV._build_cases() + TV._build_nn_cases()
JCASES = JV._build_cases() + JV._build_nn_cases()


@pytest.mark.parametrize("i", range(len(TCASES)),
                         ids=[c.op for c in TCASES])
def test_op(i):
    check_case(TCASES[i], JCASES[i])


def test_the_same_cases_as_the_jax_suite():
    every = TV.all_cases()
    jevery = JV.all_cases()
    assert [c.op for c in every] == [c.op for c in jevery]
    assert len(every) == 514
    assert sum(c.golden is not None for c in every) == 407
    assert sum(c.grad for c in every) == 151


def test_registry_names_equal_the_jax_registry():
    assert set(TR.all_ops()) == set(JR.all_ops())
    assert len(TR.all_ops()) == 505
    assert TR.summary().startswith("505 ops registered")


def test_coverage_gate():
    """The reference's coverage report: no registered op may be silently
    unvalidated."""
    rep = TV.coverage_report()
    assert rep.uncovered == [], rep.uncovered
    assert rep.pct == 100.0 and rep.total == 505


def test_exemptions_point_somewhere_and_are_the_jax_ones():
    assert set(TV.EXEMPT) <= set(JV.EXEMPT)
    for op, reason in TV.EXEMPT.items():
        assert TR.has(op), f"exempt op '{op}' is not even registered"
        assert len(reason) > 10, f"exemption for '{op}' has no pointer"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_against_the_pallas_kernel_in_interpret_mode(dtype):
    """The softmax case's op on the JAX Pallas kernel's own gate (rows a
    multiple of 8, D a multiple of 128), run in interpret mode as
    tests/test_pallas.py runs it: the port's generic op, its CUDA
    override's plain path and the NDArray softmax agree with it."""
    import jax.numpy as jnp
    x = (np.random.RandomState(3).randn(32, 128) * 5).astype(np.float32)
    want = np.asarray(pk._softmax_fwd_pallas(jnp.asarray(x, dtype),
                                             True).astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    override = ck.make_softmax_override()
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=2 ** -7)
    for got in (TR.generic("softmax")(xt), override(xt),
                Transforms.softmax(nd.create(xt, dtype=nd.DataType.FLOAT
                                             if dtype == "float32"
                                             else nd.DataType.BFLOAT16,
                                             device="cpu")).tensor()):
        np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_serialization_roundtrip_of_registry_ops():
    """Registry ops recorded in a SameDiff graph survive save/load
    (the per-op serialization leg of OpValidation)."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    sd = SameDiff.create(device="cpu")
    x = sd.placeHolder("x", shape=(2, 3), dtype=np.float32)
    h = x.add(1.0).mul(2.0)
    out = h.sub(0.5)
    sd.output({"x": np.zeros((2, 3), np.float32)}, [out.name])
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ops.sdz")
        sd.save(p)
        sd2 = SameDiff.load(p, device="cpu")
        xv = np.random.RandomState(0).randn(2, 3).astype(np.float32)
        a = np.asarray(sd.output({"x": xv}, [out.name])[out.name])
        b = np.asarray(sd2.output({"x": xv}, [out.name])[out.name])
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, (xv + 1.0) * 2.0 - 0.5, rtol=1e-6)


# ------------------------------------------------ exec_op profiling modes
@pytest.fixture()
def mode_reset():
    yield
    profiler.set_profiling_mode(None)
    profiler.disable_tracing()


def test_basic_mode_counts_dispatches(mode_reset):
    reg = profiler.get_registry()
    profiler.set_profiling_mode(ProfilingMode.BASIC)
    c = reg.get("dl4j_op_dispatch_total")
    before = c.labels(op="abs").value if c is not None else 0
    TR.exec_op("abs", torch.tensor([-1.0, 2.0]))
    TR.exec_op("abs", torch.tensor([3.0]))
    after = reg.get("dl4j_op_dispatch_total").labels(op="abs").value
    assert after - before == 2
    lat = reg.get("dl4j_op_dispatch_seconds")
    assert lat is not None and lat.labels(op="abs").count >= 2
    assert 'dl4j_op_dispatch_total{op="abs"}' in reg.exposition()


@pytest.mark.parametrize("mode,op,x,word", [
    (ProfilingMode.NAN_PANIC, "log", -1.0, "NaN"),
    (ProfilingMode.INF_PANIC, "reciprocal", 0.0, "Inf")])
def test_op_panics_name_the_op_as_the_jax_package(mode_reset, mode, op, x,
                                                  word):
    from deeplearning4j_tpu import profiler as jprof
    from deeplearning4j_tpu.utils.environment import \
        NumericsPanicError as JPanic
    jprof.set_profiling_mode(jprof.ProfilingMode(mode.value))
    try:
        with pytest.raises(JPanic) as jerr:
            JR.exec_op(op, np.array([x], np.float32))
    finally:
        jprof.set_profiling_mode(None)
    profiler.set_profiling_mode(mode)
    with pytest.raises(NumericsPanicError) as terr:
        TR.exec_op(op, torch.tensor([x]))
    assert str(terr.value) == str(jerr.value)
    assert f"op '{op}'" in str(terr.value) and word in str(terr.value)


def test_panic_ignores_integer_outputs_and_scans_containers(mode_reset):
    profiler.set_profiling_mode(ProfilingMode.NAN_PANIC)
    assert TR.exec_op("argmax", torch.tensor([1.0, 3.0])).item() == 1
    with pytest.raises(NumericsPanicError, match="op 'moments'"):
        TR.exec_op("moments", torch.tensor([1.0, float("nan")]))


def test_off_mode_is_uninstrumented(mode_reset):
    assert profiler.get_profiling_mode() is ProfilingMode.OFF
    t = profiler.get_tracer()
    t.clear()
    out = TR.exec_op("neg", torch.tensor([1.0]))
    assert float(out[0]) == -1.0
    assert len(t) == 0
    # OFF: a NaN passes through, as in the JAX package
    assert torch.isnan(TR.exec_op("log", torch.tensor([-1.0])))[0]


def test_op_spans_when_tracing(mode_reset):
    profiler.get_tracer().clear()
    profiler.enable_tracing()
    TR.exec_op("square", torch.tensor([2.0]))
    assert any(e["name"] == "op:square"
               for e in profiler.get_tracer().events())


# ------------------------------------------------ divergence traps, pinned
def _both(op, *args, **kw):
    """The op on both packages over the same numpy args."""
    from deeplearning4j_tpu_torch.ops.validation import host_op
    j = JR.get(op)(*args, **kw)
    t = host_op(op)(*args, **kw)
    return j, t


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _flat(e)]
    return [np.asarray(x)]


TIES = {
    "top_k": ((np.asarray([3.0, 1.0, 3.0, 2.0, 3.0, 1.0], np.float32),),
              {"k": 4}),
    "unique": ((np.asarray([2, 0, 2, 1, 0, 2], np.int32),), {}),
    "nth_element": ((np.asarray([[5.0, 1.0, 5.0, 1.0, 3.0]], np.float32),),
                    {"n": 2, "reverse": True}),
    "non_max_suppression": ((np.asarray([[0, 0, 1, 1], [0, 0, 1, 1],
                                         [2, 2, 3, 3], [2, 2, 3, 3]],
                                        np.float32),
                             np.asarray([0.5, 0.5, 0.5, 0.5], np.float32)),
                            {"max_out": 4}),
    "choose": ((np.asarray([1.0, 4.0, 4.0, 0.0, 4.0], np.float32), 2.0),
               {"mode": "gte"}),
    "encode_threshold": ((np.asarray([0.5, -2.0, 2.0, -2.0], np.float32),
                          1.0), {}),
    "in_top_k": ((np.asarray([[1.0, 1.0, 1.0, 0.0]], np.float32),
                  np.asarray([2], np.int32)), {"k": 2}),
}


@pytest.mark.parametrize("op", sorted(TIES))
def test_tie_order_matches_jax(op):
    """Stable orders: among equal values the lower index comes first
    (``lax.top_k``, ``jnp.argsort``), as ``torch.sort(stable=True)``."""
    args, kw = TIES[op]
    j, t = _both(op, *args, **kw)
    for a, b in zip(_flat(j), _flat(t)):
        np.testing.assert_array_equal(b, a)


BITS = {
    "cyclic_shift_bits": (np.asarray([-1, -2 ** 31, 123456789, -7],
                                     np.int32), 5),
    "cyclic_rshift_bits": (np.asarray([-1, -2 ** 31, 123456789, -7],
                                      np.int32), 31),
    "toggle_bits": (np.asarray([-1, 0, 2 ** 31 - 1], np.int32),),
    "bits_hamming_distance": (np.asarray([-1, 5, -2 ** 31], np.int32),
                              np.asarray([0, -5, 2 ** 31 - 1], np.int32)),
    "hashcode": (np.asarray([-1.5, 2.25, 1e30, -0.0], np.float32),),
    "right_shift": (np.asarray([-16, -1, 16], np.int32),
                    np.asarray([2, 3, 2], np.int32)),
    "round": (np.asarray([0.5, 1.5, 2.5, -0.5, -2.5], np.float32),),
    "rint": (np.asarray([0.5, 1.5, 2.5, -0.5, -2.5], np.float32),),
}


@pytest.mark.parametrize("op", sorted(BITS))
def test_bit_patterns_and_rounding_match_jax(op):
    """int32 bit patterns (torch's ``>>`` is arithmetic: the rotations
    and popcounts shift the unsigned pattern), and half-to-even
    rounding."""
    j, t = _both(op, *BITS[op])
    for a, b in zip(_flat(j), _flat(t)):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == a.dtype


def test_data_dependent_outputs_stay_on_the_device_they_came_from():
    x = torch.tensor([3, 1, 3, 2])
    for op, args in (("unique", (x,)), ("where", (x > 1,)),
                     ("boolean_mask", (x, x > 1)),
                     ("listdiff", (x, torch.tensor([3]))),
                     ("unique_with_counts", (x,))):
        out = TR.get(op)(*args)
        for t in TR.tensor_leaves(out):
            assert t.device == x.device
