"""The port's native runtime (``deeplearning4j_tpu_torch.native``): the twin
of ``tests/test_native.py``, plus the C ABI under a stand-in driver.

- The library builds here with ``g++`` and exports the JAX library's
  entry points.
- The stand-in driver is a small C file built in the test's temporary
  directory: it implements the CUDA driver calls the library makes over
  host memory, and its "graph" is a host function that copies each static
  input to the matching static output. Through it the client, the dtype
  marshalling of every PJRT code, the content cache, ``dl4j_free_outputs``,
  zero-element outputs, the error strings, the transfer counts and the
  execution lock run without a card.
- The JAX package's graphs (an MLP with a softmax node; conv -> relu ->
  maxpool -> mean) cross by ``save``/``load``: the port's eager answer on
  the CPU is held against the JAX ``output()`` (fp32, 1e-5), and the
  loaded graph's native program is the same bytes as the port-built
  graph's. On the card (marked ``cuda``) the native answer is held
  against the same graph's eager ``output()`` (1e-5, TF32 off) and, for
  the MLP, against numpy; where JAX is installed beside the card, the
  JAX graph crossed by ``save``/``load`` runs through the native
  executable and is held against the JAX ``output()`` (1e-5).
"""

import ctypes
import json
import os
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.autodiff import samediff as tsd
from deeplearning4j_tpu_torch.native import runtime as rt_mod
from deeplearning4j_tpu_torch.native import (NativeRuntime, NativeRuntimeError,
                                             build_native_lib)

JAX_ABI = ("dl4j_client_create", "dl4j_compile", "dl4j_execute",
           "dl4j_free_outputs", "dl4j_client_cache_stats")
PORT_ABI = ("dl4j_client_destroy", "dl4j_client_device_count",
            "dl4j_client_platform_name", "dl4j_client_api_version",
            "dl4j_executable_release", "dl4j_executable_num_outputs")

STANDIN_C = r"""
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

typedef struct { int n; void* src[32]; void* dst[32]; long long nbytes[32];
                 int fail; } Graph;

static long long stats[10];   /* h2d d2d d2h launches destroys retains
                                 releases set_current max_active active */
static void* dev_lo[64]; static void* dev_hi[64]; static int n_dev;

int cuInit(unsigned f) { (void)f; return 0; }
int cuDriverGetVersion(int* v) { *v = 12040; return 0; }
int cuDeviceGetCount(int* n) {
  const char* e = getenv("DL4J_STANDIN_DEVICES");
  *n = e ? atoi(e) : 1; return 0; }
int cuDeviceGet(int* d, int i) { *d = i; return 0; }
int cuDevicePrimaryCtxRetain(void** c, int d) {
  *c = (void*)(long)(d + 1); stats[5]++; return 0; }
int cuDevicePrimaryCtxRelease_v2(int d) { (void)d; stats[6]++; return 0; }
int cuCtxSetCurrent(void* c) { (void)c; stats[7]++; return 0; }
int cuStreamSynchronize(void* s) { (void)s; return 0; }
int cuPointerGetAttribute(void* out, int attr, unsigned long long p) {
  for (int i = 0; i < n_dev; ++i)
    if (attr == 2 && (char*)p >= (char*)dev_lo[i] && (char*)p < (char*)dev_hi[i]) {
      *(unsigned*)out = 2; return 0; }
  return 1; }
int cuMemcpyHtoDAsync_v2(unsigned long long d, const void* s, size_t n, void* st) {
  (void)st; memcpy((void*)d, s, n); stats[0]++; return 0; }
int cuMemcpyDtoDAsync_v2(unsigned long long d, unsigned long long s, size_t n,
                         void* st) {
  (void)st; memcpy((void*)d, (void*)s, n); stats[1]++; return 0; }
int cuMemcpyDtoHAsync_v2(void* d, unsigned long long s, size_t n, void* st) {
  (void)st; memcpy(d, (void*)s, n); stats[2]++; return 0; }
int cuGraphInstantiateWithFlags(void** e, void* g, unsigned long long f) {
  (void)f; if (((Graph*)g)->fail) return 1; *e = g; return 0; }
int cuGraphLaunch(void* e, void* st) {
  (void)st; Graph* g = (Graph*)e;
  long long a = __sync_add_and_fetch(&stats[9], 1);
  if (a > stats[8]) stats[8] = a;
  usleep(200);
  for (int i = 0; i < g->n; ++i) memcpy(g->dst[i], g->src[i], g->nbytes[i]);
  __sync_sub_and_fetch(&stats[9], 1);
  stats[3]++; return 0; }
int cuGraphExecDestroy(void* e) { (void)e; stats[4]++; return 0; }
int cuGetErrorName(int rc, const char** s) {
  *s = rc == 1 ? "CUDA_ERROR_INVALID_VALUE" : "CUDA_ERROR_UNKNOWN"; return 0; }
int cuGetErrorString(int rc, const char** s) {
  *s = rc == 1 ? "invalid argument" : "unknown error"; return 0; }

void* standin_graph(int n, void** src, void** dst, long long* nbytes,
                    int fail) {
  Graph* g = (Graph*)calloc(1, sizeof(Graph));
  g->n = n; g->fail = fail;
  for (int i = 0; i < n; ++i) {
    g->src[i] = src[i]; g->dst[i] = dst[i]; g->nbytes[i] = nbytes[i]; }
  return g; }
void standin_mark_device(void* p, size_t n) {
  if (n_dev < 64) { dev_lo[n_dev] = p; dev_hi[n_dev] = (char*)p + n; n_dev++; } }
void standin_stats(long long* out) { memcpy(out, stats, sizeof(stats)); }
"""

STAT_NAMES = ("h2d", "d2d", "d2h", "launches", "destroys", "retains",
              "releases", "set_current", "max_active")


def _compiler():
    cc = shutil.which("gcc") or shutil.which("g++")
    if cc is None:
        pytest.skip("no C toolchain")
    return cc


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """(path, ctypes handle) of the stand-in driver."""
    d = tmp_path_factory.mktemp("standin")
    src, so = d / "standin.c", d / "libstandin.so"
    src.write_text(STANDIN_C)
    subprocess.run([_compiler(), "-shared", "-fPIC", "-O1", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.standin_graph.restype = ctypes.c_void_p
    lib.standin_graph.argtypes = [ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.POINTER(ctypes.c_longlong),
                                  ctypes.c_int]
    lib.standin_mark_device.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    return str(so), lib


def _stats(lib):
    out = (ctypes.c_longlong * 10)()
    lib.standin_stats(out)
    return dict(zip(STAT_NAMES, out))


def _alloc(shape, dtype_name):
    """A zeroed host buffer of a program signature (numpy has no bf16:
    a CPU tensor then)."""
    if dtype_name == "bfloat16":
        return torch.zeros(shape, dtype=torch.bfloat16)
    return np.zeros(shape, np.dtype(dtype_name))


def _ptr(a):
    return a.data_ptr() if isinstance(a, torch.Tensor) else a.ctypes.data


def _nbytes(a):
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) \
        else a.nbytes


class Copying:
    """A stand-in lowering: the program is a JSON list of (shape, dtype
    name) pairs; the static inputs and outputs are host buffers of those
    signatures, and the graph copies input i to output i. ``fail`` makes
    the stand-in refuse to instantiate it."""

    def __init__(self, lib, fail=False):
        self.lib, self.fail, self.lowered = lib, fail, 0

    def __call__(self, runtime, program, inputs):
        import json
        sig = json.loads(program)
        ins = [_alloc(tuple(s), d) for s, d in sig]
        outs = [_alloc(tuple(s), d) for s, d in sig]
        n = max(1, len(sig))
        g = self.lib.standin_graph(
            len(sig), (ctypes.c_void_p * n)(*[_ptr(a) for a in ins]),
            (ctypes.c_void_p * n)(*[_ptr(a) for a in outs]),
            (ctypes.c_longlong * n)(*[_nbytes(a) for a in ins]),
            int(self.fail))
        self.lowered += 1
        return rt_mod.Lowered(g, 0, ins, outs, launches={"softmax": 1})


def _program(*sig):
    import json
    return json.dumps([[list(s), d if isinstance(d, str)
                        else np.dtype(d).name] for s, d in sig])


@pytest.fixture
def standin_rt(standin):
    path, lib = standin
    lowering = Copying(lib)
    rt = NativeRuntime.create(path, lowerings={"samediff": lowering})
    yield rt, lib, lowering
    rt.close()
    # the stand-in programs are native.compile signatures: keep them out
    # of a later test's churn diagnostics
    from deeplearning4j_tpu_torch.analysis import churn
    churn.get_churn_detector().reset()


# ------------------------------------------------------------ the library
def test_native_lib_builds():
    if shutil.which("g++") is None or shutil.which("nm") is None:
        pytest.skip("no C++ toolchain")
    path = build_native_lib()
    assert os.path.exists(path)
    assert os.path.dirname(path) == str(rt_mod.BUILD_DIR)
    out = subprocess.run(["nm", "-D", "--defined-only", path],
                         capture_output=True, text=True)
    for sym in JAX_ABI + PORT_ABI:
        assert f" T {sym}\n" in out.stdout, sym
    # no serialization entry: a CUDA graph cannot be serialized
    assert "dl4j_executable_serialize" not in out.stdout


def test_a_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "cuda_runtime.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(rt_mod, "_SRC", bad)
    monkeypatch.setattr(rt_mod, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(NativeRuntimeError, match="build failed"):
        build_native_lib()
    assert not list((tmp_path / "_build").glob("*.so"))


# --------------------------------------------------- the stand-in driver
def test_client_through_the_standin(standin_rt, standin):
    rt, lib, _ = standin_rt
    assert rt.device_count == 1
    assert rt.platform_name == "cuda"
    assert rt.api_version == (12, 4)
    assert rt.cache_stats() == {"size": 0, "hits": 0, "misses": 0}
    assert _stats(lib)["retains"] == 0        # contexts retained lazily


def test_every_pjrt_dtype_marshals(standin_rt, standin):
    rt, lib, _ = standin_rt
    rng = np.random.RandomState(0)
    arrays = [rng.rand(3, 2) > 0.5]
    for dt in (np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
               np.uint32, np.uint64):
        arrays.append(rng.randint(0, 100, (2, 3)).astype(dt))
    for dt in (np.float16, np.float32, np.float64):
        arrays.append(rng.randn(4).astype(dt))
    arrays += [(rng.randn(2) + 1j * rng.randn(2)).astype(np.complex64),
               (rng.randn(2) + 1j * rng.randn(2)).astype(np.complex128)]
    bf16 = torch.from_numpy(rng.randn(5).astype(np.float32)).bfloat16()
    sig = [(a.shape, a.dtype) for a in arrays] + [((5,), "bfloat16")]
    codes = [rt_mod._NUMPY_TO_PJRT[np.dtype(d)] for _, d in sig[:-1]]
    assert sorted(codes + [13]) == list(range(1, 16))
    exe = rt.compile(_program(*sig))
    assert exe.num_outputs == len(arrays) + 1
    outs = exe(*arrays, bf16)
    for got, want in zip(outs, arrays):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert outs[-1].dtype == torch.bfloat16 and torch.equal(outs[-1], bf16)
    exe.release()


def test_content_cache_hits_misses_and_size(standin_rt):
    rt, lib, lowering = standin_rt
    p1 = _program(((3,), np.float32))
    p2 = _program(((4,), np.float32))
    e1, e2, e3 = rt.compile(p1), rt.compile(p1), rt.compile(p2)
    assert (e1.cache_hit, e2.cache_hit, e3.cache_hit) == (False, True, False)
    assert lowering.lowered == 2               # a hit lowers nothing
    assert rt.cache_stats() == {"size": 2, "hits": 1, "misses": 2}
    assert e1.token == e2.token != e3.token
    x = np.arange(3, dtype=np.float32)
    np.testing.assert_array_equal(e2(x)[0], x)
    before = _stats(lib)["destroys"]
    e1.release()                               # e2 still holds the entry
    assert rt.cache_stats()["size"] == 2 and e1.token in rt._lowered
    np.testing.assert_array_equal(e2(x + 1)[0], x + 1)
    e2.release()                               # the last handle: destroyed
    assert rt.cache_stats()["size"] == 1
    assert _stats(lib)["destroys"] == before + 1
    assert e1.token not in rt._lowered
    with pytest.raises(NativeRuntimeError, match="released"):
        e2(x)
    e4 = rt.compile(p1)                        # lowered again
    assert not e4.cache_hit and lowering.lowered == 3
    rt.close()                                 # destroys the rest
    assert rt._lowered == {} and e3.released and e4.released


def test_free_outputs_frees_and_nulls():
    lib = rt_mod._lib()
    libc = ctypes.CDLL(None)
    libc.malloc.restype = ctypes.c_void_p
    libc.malloc.argtypes = [ctypes.c_size_t]
    outs = (rt_mod._HostBuffer * 2)()
    outs[0].data = libc.malloc(64)
    outs[1].data = None
    lib.dl4j_free_outputs(outs, 2)
    assert not outs[0].data and not outs[1].data


def test_zero_element_output(standin_rt):
    rt, _, _ = standin_rt
    exe = rt.compile(_program(((0, 3), np.float32), ((2,), np.int32)))
    out = exe(np.zeros((0, 3), np.float32), np.asarray([7, 8], np.int32))
    assert out[0].shape == (0, 3) and out[0].dtype == np.float32
    np.testing.assert_array_equal(out[1], [7, 8])


def test_host_and_device_inputs_and_their_bytes(standin_rt, standin):
    rt, lib, _ = standin_rt
    exe = rt.compile(_program(((4,), np.float32), ((2,), np.int64)))
    dev_in = np.arange(2, dtype=np.int64)
    lib.standin_mark_device(dev_in.ctypes.data, dev_in.nbytes)
    before = _stats(lib)
    h2d0 = rt_mod._M_H2D_BYTES.value
    d2h0 = rt_mod._M_D2H_BYTES.value
    out = exe(np.ones(4, np.float32), dev_in)
    after = _stats(lib)
    assert (after["h2d"] - before["h2d"], after["d2d"] - before["d2d"],
            after["d2h"] - before["d2h"]) == (1, 1, 2)
    np.testing.assert_array_equal(out[1], dev_in)
    # the library asked the driver where each input lies (one copy each
    # way); the frontend counts by type: numpy arrays are host inputs
    assert rt_mod._M_H2D_BYTES.value - h2d0 == 16 + 16
    assert rt_mod._M_D2H_BYTES.value - d2h0 == 16 + 16
    assert exe.calls == 1 and exe.bytes["d2h"] == 32
    # the context is the primary one, retained once by the live client
    # (the closed ones released theirs) and made current for the call
    assert after["retains"] - after["releases"] == 1
    assert after["set_current"] > before["set_current"]


def test_replays_count_the_capture_launches(standin_rt):
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    rt, _, _ = standin_rt
    exe = rt.compile(_program(((2,), np.float32)))
    ck.reset_counts()
    exe(np.ones(2, np.float32))
    exe(np.ones(2, np.float32))
    assert ck.REPLAYS["softmax"] == 2 and exe.launches == {"softmax": 1}


def test_error_strings(standin_rt, standin, monkeypatch):
    rt, lib, _ = standin_rt
    path, _ = standin
    with pytest.raises(NativeRuntimeError, match="format 'mlir' is not"):
        rt.compile("this is not mlir", fmt="mlir")
    with pytest.raises(NativeRuntimeError, match="format 'hlo'"):
        rt.compile(b"\x08\x01", fmt="hlo")
    exe = rt.compile(_program(((2, 3), np.float32)))
    with pytest.raises(NativeRuntimeError,
                       match=r"input 0: the program takes dtype 11 \[2, 3\], "
                             r"got dtype 12 \[2, 3\]"):
        exe(np.zeros((2, 3), np.float64))
    with pytest.raises(NativeRuntimeError, match=r"input 0: .* got dtype 11 "
                                                 r"\[3, 2\]"):
        exe(np.zeros((3, 2), np.float32))
    with pytest.raises(NativeRuntimeError, match="takes 1 inputs, got 2"):
        exe(np.zeros((2, 3), np.float32), np.zeros(1, np.float32))
    with pytest.raises(NativeRuntimeError, match="captured on device 0"):
        exe(np.zeros((2, 3), np.float32), device=1)
    # a lowering that raises: the message crosses C, the exception chains
    def broken(runtime, program, inputs):
        raise ValueError("no such op")
    rt._lowerings["samediff"] = broken
    with pytest.raises(NativeRuntimeError,
                       match="compile failed: ValueError: no such op") as ei:
        rt.compile(_program(((5,), np.float32)))
    assert isinstance(ei.value.__cause__, ValueError)
    # a graph the driver refuses to instantiate: named, and its memory freed
    rt._lowerings["samediff"] = Copying(lib, fail=True)
    held = dict(rt._lowered)
    with pytest.raises(NativeRuntimeError,
                       match="cuGraphInstantiateWithFlags: "
                             r"CUDA_ERROR_INVALID_VALUE \(invalid argument\)"):
        rt.compile(_program(((6,), np.float32)))
    assert rt._lowered == held
    assert rt.cache_stats()["misses"] == 1
    with pytest.raises(NativeRuntimeError, match="unknown create option"):
        NativeRuntime.create(path, create_options={"topology": "v5e:1x1x1"})
    with pytest.raises(NativeRuntimeError, match="dlopen failed"):
        NativeRuntime.create("/nonexistent/libcuda.so.1")
    monkeypatch.setenv("DL4J_STANDIN_DEVICES", "0")
    with pytest.raises(NativeRuntimeError, match="sees no device"):
        NativeRuntime.create(path)
    rt.close()
    with pytest.raises(NativeRuntimeError, match="closed"):
        rt.compile(_program(((2, 3), np.float32)))


def test_executions_never_overlap(standin_rt, standin):
    """Executables of one client share one memory pool: the library runs
    one at a time. Eight threads execute two executables under a short
    switch interval; the stand-in records the most launches it saw at
    once."""
    import sys
    rt, lib, _ = standin_rt
    exes = [rt.compile(_program(((64,), np.float32))),
            rt.compile(_program(((32,), np.int32)))]
    bad = []

    def work(i):
        x = (np.arange(64, dtype=np.float32) + i if i % 2 == 0
             else np.arange(32, dtype=np.int32) * i)
        for _ in range(25):
            out = exes[i % 2](x)[0]
            if not np.array_equal(out, x):
                bad.append(i)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad and _stats(lib)["max_active"] == 1


# ------------------------------------------------------ the SameDiff seam
def _mlp(pkg, device=None):
    rng = np.random.RandomState(0)
    sd = pkg.create(device=device) if device else pkg.create()
    x = sd.placeHolder("x", shape=(None, 6), dtype=np.float32)
    w1 = sd.var("w1", rng.randn(6, 8).astype(np.float32))
    b1 = sd.var("b1", np.zeros(8, np.float32))
    w2 = sd.var("w2", rng.randn(8, 3).astype(np.float32))
    h = sd.nn.relu(x.mmul(w1).add(b1))
    sd.nn.softmax(h.mmul(w2), name="probs")
    return sd, {"x": rng.randn(4, 6).astype(np.float32)}, "probs"


def _convnet(pkg, device=None):
    rng = np.random.RandomState(1)
    sd = pkg.create(device=device) if device else pkg.create()
    x = sd.placeHolder("x", shape=(2, 1, 12, 12), dtype=np.float32)
    w = sd.var("w", (rng.randn(4, 1, 3, 3) * 0.3).astype(np.float32))
    c = sd.cnn.conv2d(x, w, stride=(1, 1), pad=(0, 0))
    r = sd.nn.relu(c)
    p = sd.cnn.maxPooling2d(r, kernel=(2, 2), stride=(2, 2))
    sd.math.reduce_mean(p, name="m")
    return sd, {"x": rng.randn(2, 1, 12, 12).astype(np.float32)}, "m"


def _mlp_numpy(sd, feeds):
    v = {k: t.cpu().numpy().astype(np.float64)
         for k, t in sd._variables.items()}
    h = np.maximum(feeds["x"] @ v["w1"] + v["b1"], 0.0)
    z = h @ v["w2"]
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("build", [_mlp, _convnet],
                         ids=["mlp_softmax", "conv_relu_pool_mean"])
def test_the_jax_graph_crosses_and_keeps_its_program(build, tmp_path):
    """Held against JAX on the CPU: the JAX graph saved, loaded by the
    port, answers as the JAX ``output()`` does (1e-5), and its native
    program is the bytes the port-built graph gives: the card runs the
    JAX graph's program."""
    pytest.importorskip("jax")
    from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
    jsd, feeds, out = build(JSameDiff)
    want = np.asarray(jsd.output(feeds, [out])[out])
    path = str(tmp_path / "g.zip")
    jsd.save(path)
    sd = SameDiff.load(path, device="cpu")
    got = sd.output(feeds, [out])[out].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    mine, _, _ = build(SameDiff, device="cpu")
    phs = {k: mine._native_feed(v) for k, v in feeds.items()}
    assert sd._native_program([out], phs, False) \
        == mine._native_program([out], phs, False)


def test_the_program_is_structure_and_signature_not_weights():
    a, feeds, out = _mlp(SameDiff, device="cpu")
    b, _, _ = _mlp(SameDiff, device="cpu")
    with torch.no_grad():
        for v in b._variables.values():
            v.add_(1.0)
    phs = {k: a._native_feed(v) for k, v in feeds.items()}
    prog = a._native_program([out], phs, False)
    assert prog == b._native_program([out], phs, False)
    assert len(prog) < 4096                    # no weights inside
    wider = {"x": np.zeros((8, 6), np.float32)}
    assert prog != a._native_program([out], wider, False)
    assert prog != a._native_program([out], phs, True)


def test_set_exec_backend():
    sd, feeds, out = _mlp(SameDiff, device="cpu")
    with pytest.raises(ValueError, match="unknown backend 'bogus'"):
        sd.setExecBackend("bogus")
    assert sd.setExecBackend("native").setExecBackend("torch") is sd
    assert sd.output(feeds, [out])[out].shape == (4, 3)


def test_native_backend_on_the_cpu_raises(monkeypatch):
    """No eager path answers for the native backend."""
    sd, feeds, out = _mlp(SameDiff, device="cpu")
    sd.setExecBackend("native")

    def eager(*a, **k):
        raise AssertionError("the eager path ran")
    monkeypatch.setattr(sd, "_exec", eager)
    with pytest.raises(NativeRuntimeError, match="runs on the card"):
        sd.output(feeds, [out])
    with pytest.raises(NativeRuntimeError, match="runs on the card"):
        sd.batchOutput().input("x", feeds["x"]).output(out).execSingle()


def test_the_lowering_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sd, feeds, out = _mlp(SameDiff, device="cpu")
    phs = {k: sd._native_feed(v) for k, v in feeds.items()}
    with pytest.raises(NativeRuntimeError, match="the program names cpu"):
        rt_mod.lower_samediff(None, sd._native_program([out], phs, False))
    monkeypatch.setattr(sd, "device", torch.device("cuda", 0))
    with pytest.raises(NativeRuntimeError, match="no CUDA device"):
        rt_mod.lower_samediff(None, sd._native_program([out], phs, False))


def test_the_program_names_its_device(monkeypatch):
    """The program carries the graph's device, so the content cache
    keeps a graph on one card apart from its twin on another."""
    sd, feeds, out = _mlp(SameDiff, device="cpu")
    phs = {k: sd._native_feed(v) for k, v in feeds.items()}
    progs = {}
    for dev in ("cuda:0", "cuda:1"):
        monkeypatch.setattr(sd, "device", torch.device(dev))
        progs[dev] = sd._native_program([out], phs, False)
        assert json.loads(progs[dev])["device"] == dev
    assert progs["cuda:0"] != progs["cuda:1"]
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(sd, "device", torch.device("cuda"))
    assert sd._native_program([out], phs, False) == progs["cuda:1"]


def test_host_control_flow_is_refused_by_name():
    sd = SameDiff.create(device="cpu")
    cond, body = SameDiff.create(device="cpu"), SameDiff.create(device="cpu")
    ci = cond.placeHolder("i", shape=(), dtype=np.int32)
    cond.placeHolder("a", shape=(2,), dtype=np.float32)
    ci.lt(5.0)
    bi = body.placeHolder("i", shape=(), dtype=np.int32)
    ba = body.placeHolder("a", shape=(2,), dtype=np.float32)
    body.setOutputs(bi.add(1), ba.mul(1.5))
    x = sd.placeHolder("x", shape=(2,), dtype=np.float32)
    out = sd.while_loop(cond, body, [sd.constant(np.int32(0), name="i0"), x],
                        name="loop")[1]
    y = x.mul(3.0)
    with pytest.raises(NativeRuntimeError,
                       match=r"node 'loop:0' \(while_loop\) reads a value on "
                             "the host"):
        rt_mod.refuse_host_control(sd, [out.name])
    rt_mod.refuse_host_control(sd, [y.name])   # a path without the loop


def test_metric_names_equal_the_jax_registry():
    pytest.importorskip("jax")
    import deeplearning4j_tpu.native.runtime  # noqa: F401  (registers them)
    from deeplearning4j_tpu import profiler as jprof
    from deeplearning4j_tpu_torch import profiler as tprof
    jax_names = {n for n in jprof.get_registry().names()
                 if n.startswith("dl4j_native_")}
    port_names = {n for n in tprof.get_registry().names()
                  if n.startswith("dl4j_native_")}
    assert len(jax_names) == 6 and port_names == jax_names


def test_a_subgraph_defaults_to_the_card(monkeypatch):
    """``subgraph_from_spec`` and ``subgraph_fn`` resolve their device:
    the card unless the caller names one or passes a tensor."""
    g = SameDiff.create(device="cpu")
    g.setOutputs(g.placeHolder("a", shape=(3,), dtype=np.float32).mul(2.0))
    spec = tsd.subgraph_spec(g, g._default_outputs(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsd.subgraph_from_spec(spec)
    assert tsd.subgraph_from_spec(spec, device="cpu").device.type == "cpu"
    call = tsd.subgraph_fn(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(np.ones(3, np.float32))
    (out,) = call(torch.ones(3))
    assert out.device.type == "cpu" and torch.equal(out, torch.full((3,), 2.))


# ---------------------------------------------------------------- on the card
@pytest.fixture(scope="module")
def native_rt():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeplearning4j_tpu_torch.native import get_runtime
    return get_runtime()


def _program_of(sd, feeds, out, train=False):
    return sd._native_program(
        [out], {k: sd._native_feed(v) for k, v in feeds.items()}, train)


def _inputs_of(sd, feeds):
    step = torch.zeros((), dtype=torch.int32, device=sd.device)
    return [*sd._variables.values(), *sd._constants.values(),
            *(sd._native_feed(feeds[k]) for k in sorted(feeds)), step]


@pytest.mark.cuda
class TestNativeRuntime:
    def test_client_metadata(self, native_rt):
        assert native_rt.device_count >= 1
        assert native_rt.platform_name == "cuda"
        assert native_rt.api_version >= (12, 0)

    def test_compile_and_execute_matmul(self, native_rt):
        rng = np.random.RandomState(0)
        sd = SameDiff.create()
        a = sd.placeHolder("a", shape=(4, 5), dtype=np.float32)
        b = sd.placeHolder("b", shape=(5, 3), dtype=np.float32)
        s = sd.math.add(a.mmul(b), sd.constant(np.float32(1.0), name="one"),
                        name="s")
        t = sd.math.reduce_sum(a.tanh(), name="t")
        feeds = {"a": rng.randn(4, 5).astype(np.float32),
                 "b": rng.randn(5, 3).astype(np.float32)}
        prog = sd._native_program(
            [s.name, t.name], {k: feeds[k] for k in sorted(feeds)}, False)
        exe = native_rt.compile(prog, inputs=_inputs_of(sd, feeds))
        assert exe.num_outputs == 2
        outs = exe(*_inputs_of(sd, feeds))
        np.testing.assert_allclose(outs[0], feeds["a"] @ feeds["b"] + 1.0,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(outs[1], np.tanh(feeds["a"]).sum(),
                                   rtol=1e-5)
        exe.release()

    def test_compile_cache_hits(self, native_rt):
        sd = SameDiff.create()
        x = sd.placeHolder("x", shape=(3,), dtype=np.float32)
        y = x.mul(2.0)
        feeds = {"x": np.asarray([1.0, 2.0, 3.0], np.float32)}
        prog = _program_of(sd, feeds, y.name)
        e1 = native_rt.compile(prog)
        e2 = native_rt.compile(prog)
        assert not e1.cache_hit and e2.cache_hit
        stats = native_rt.cache_stats()
        assert stats["hits"] >= 1 and stats["size"] >= 1
        out = e2(*_inputs_of(sd, feeds))
        np.testing.assert_allclose(out[0], [2.0, 4.0, 6.0], rtol=1e-6)
        e1.release()
        e2.release()

    def test_int_dtypes_roundtrip(self, native_rt):
        sd = SameDiff.create()
        x = sd.placeHolder("x", shape=(4,), dtype=np.int32)
        y = sd.math.add(x, sd.constant(np.int32(1), name="one"), name="y")
        feeds = {"x": np.asarray([1, 2, 3, 4], np.int32)}
        exe = native_rt.compile(_program_of(sd, feeds, y.name))
        out = exe(*_inputs_of(sd, feeds))
        np.testing.assert_array_equal(out[0], [2, 3, 4, 5])
        assert out[0].dtype == np.int32
        exe.release()

    def test_compile_error_reported(self, native_rt):
        with pytest.raises(NativeRuntimeError, match="compile failed"):
            native_rt.compile("this is not mlir", fmt="mlir")


@pytest.mark.cuda
class TestNativeExecBackend:
    """``setExecBackend("native")``: a SameDiff graph's ``output()`` runs
    through the C++ runtime's executable and matches the eager path."""

    def test_samediff_mlp_through_native_client(self, native_rt):
        sd, feeds, out = _mlp(SameDiff)
        want = sd.output(feeds, [out])[out].cpu().numpy()
        sd.setExecBackend("native")
        got = sd.output(feeds, [out])[out]
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, _mlp_numpy(sd, feeds), rtol=1e-5,
                                   atol=1e-6)
        hits = native_rt.cache_stats()["hits"]
        got2 = sd.output(feeds, [out])[out]          # the same executable
        np.testing.assert_array_equal(got2, got)
        assert native_rt.cache_stats()["hits"] == hits
        assert len(sd.native_executables()) == 1
        sd.setExecBackend("torch")

    def test_imported_zoo_model_native_parity(self, native_rt):
        sd, feeds, out = _convnet(SameDiff)
        want = sd.output(feeds, [out])[out].cpu().numpy()
        sd.setExecBackend("native")
        got = sd.output(feeds, [out])[out]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        for exe in sd.native_executables():
            exe.release()

    @pytest.mark.parametrize("build", [_mlp, _convnet],
                             ids=["mlp_softmax", "conv_relu_pool_mean"])
    def test_the_jax_graph_runs_native(self, native_rt, build, tmp_path):
        """The JAX graph saved, loaded by the port on the card and run
        through the native executable answers as the JAX ``output()``
        does (fp32, 1e-5, TF32 off). The JAX side runs on the CPU."""
        jax = pytest.importorskip("jax")
        from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
        with jax.default_device(jax.devices("cpu")[0]):
            jsd, feeds, out = build(JSameDiff)
            want = np.asarray(jsd.output(feeds, [out])[out])
        path = str(tmp_path / "g.zip")
        jsd.save(path)
        sd = SameDiff.load(path, device="cuda").setExecBackend("native")
        got = sd.output(feeds, [out])[out]
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        for exe in sd.native_executables():
            exe.release()

    def test_a_graph_on_a_named_card_compiles_there(self, native_rt):
        """A graph on ``cuda:<i>`` captures, and its executable runs, on
        card ``i``, for each card of the machine."""
        for i in range(torch.cuda.device_count()):
            sd, feeds, out = _mlp(SameDiff, device=f"cuda:{i}")
            want = sd.output(feeds, [out])[out].cpu().numpy()
            sd.setExecBackend("native")
            got = sd.output(feeds, [out])[out]
            (exe,) = sd.native_executables()
            low = native_rt._lowered[exe.token]
            assert low.device == i
            assert {t.device for t in (*low.inputs, *low.outputs)} \
                == {torch.device("cuda", i)}
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            exe.release()
