"""ctypes binding for the dl4j native runtime over the CUDA driver — the
port of ``deeplearning4j_tpu/native/runtime.py``.

The JAX runtime is a ctypes bridge onto a C++ library that ``dlopen``s a
PJRT plugin, compiles StableHLO into an in-process executable cache keyed
by content, stages inputs and outputs and executes synchronously. The
port's library (``src/cuda_runtime.cc``, plain C++ with no kernel in it)
``dlopen``s the CUDA driver instead and keeps the same flat C ABI and the
PJRT dtype codes. The port has no StableHLO: a program is the JSON spec of
a SameDiff graph (``fmt="samediff"``), its variables, constants,
placeholders and step clock all inputs, so the content key covers the
graph's structure and signature, not its weights. On a cache miss the
library calls back into Python, which builds the graph on the card and
captures it as a CUDA graph (:func:`lower_samediff`, through
``nn.compilecache._record(keep_graph=True)``); the library instantiates its
own executable from the captured ``cudaGraph_t`` and caches it. Hits,
misses and the cache's size are counted in C++.

Typical use::

    rt = NativeRuntime.create()                  # loads libcuda.so.1
    exe = rt.compile(program)                    # a SameDiff graph's spec
    outs = exe(*inputs)                          # numpy in or tensors in,
                                                 # numpy out

``SameDiff.setExecBackend("native")`` runs ``output()`` this way.

Lifetimes: an executable's nodes point into the capture's memory pool and
its static buffers, which Python owns; ``release()`` (its last handle),
``close()`` and a dropped ``SameDiff`` destroy the executable first and
then free that memory. A CUDA graph cannot be serialized, so the library
exports no ``dl4j_executable_serialize``: with the disk tier configured a
compile counts one disk miss a key, as the JAX runtime does with a library
that predates serialization.

Nothing falls back: no card, no driver, a torch whose ``CUDAGraph`` has no
``keep_graph``, a graph with host control flow or a capture that fails
each raise :class:`NativeRuntimeError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.device import resolve_device

# Registered at import so GET /metrics always exposes the compile-cache
# and transfer counters (zero until the native path runs), under the JAX
# package's names.
_REG = _prof.get_registry()
_M_CACHE_HITS = _REG.counter(
    "dl4j_native_compile_cache_hits_total",
    "Native runtime executable-cache hits (dl4j_compile)")
_M_CACHE_MISSES = _REG.counter(
    "dl4j_native_compile_cache_misses_total",
    "Native runtime executable-cache misses (fresh captures instantiated "
    "by the library)")
_M_COMPILE_SECONDS = _REG.histogram(
    "dl4j_native_compile_seconds",
    "Program -> captured CUDA graph -> instantiated executable latency",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0))
_M_H2D_BYTES = _REG.counter(
    "dl4j_native_h2d_bytes_total",
    "Host->device bytes staged through dl4j_execute inputs (host inputs "
    "only)")
_M_D2H_BYTES = _REG.counter(
    "dl4j_native_d2h_bytes_total",
    "Device->host bytes returned from dl4j_execute outputs")
_M_EXECUTE_SECONDS = _REG.histogram(
    "dl4j_native_execute_seconds",
    "Synchronous dl4j_execute round-trip latency (copies in + run + "
    "copies out)")

_THIS_DIR = Path(__file__).resolve().parent
_SRC = _THIS_DIR / "src" / "cuda_runtime.cc"
#: where the library is built at first use (gitignored)
BUILD_DIR = _THIS_DIR.parent / "_build"
CXX_FLAGS = ("-shared", "-fPIC", "-O2", "-std=c++17")
DEFAULT_DRIVER = "libcuda.so.1"


class NativeRuntimeError(RuntimeError):
    pass


# PJRT_Buffer_Type values (the JAX runtime's table) <-> torch dtypes
_TORCH_TO_PJRT = {
    torch.bool: 1, torch.int8: 2, torch.int16: 3, torch.int32: 4,
    torch.int64: 5, torch.uint8: 6, torch.uint16: 7, torch.uint32: 8,
    torch.uint64: 9, torch.float16: 10, torch.float32: 11,
    torch.float64: 12, torch.bfloat16: 13, torch.complex64: 14,
    torch.complex128: 15}
_NUMPY_TO_PJRT = {
    np.dtype(np.bool_): 1,
    np.dtype(np.int8): 2, np.dtype(np.int16): 3, np.dtype(np.int32): 4,
    np.dtype(np.int64): 5,
    np.dtype(np.uint8): 6, np.dtype(np.uint16): 7, np.dtype(np.uint32): 8,
    np.dtype(np.uint64): 9,
    np.dtype(np.float16): 10, np.dtype(np.float32): 11,
    np.dtype(np.float64): 12,
    np.dtype(np.complex64): 14, np.dtype(np.complex128): 15,
}
#: numpy has no bf16: such an output comes back as a CPU bf16 tensor
_PJRT_TO_NUMPY = {v: k for k, v in _NUMPY_TO_PJRT.items()}
_PJRT_BF16 = 13


class _HostBuffer(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p),
                ("dtype", ctypes.c_int32),
                ("ndim", ctypes.c_int32),
                ("dims", ctypes.c_int64 * 16),
                ("nbytes", ctypes.c_int64)]


class _DeviceBuffer(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p),
                ("dtype", ctypes.c_int32),
                ("ndim", ctypes.c_int32),
                ("dims", ctypes.c_int64 * 16),
                ("nbytes", ctypes.c_int64)]


class _Lowered(ctypes.Structure):
    _fields_ = [("graph", ctypes.c_void_p),
                ("device", ctypes.c_int32),
                ("n_inputs", ctypes.c_int32),
                ("n_outputs", ctypes.c_int32),
                ("inputs", ctypes.POINTER(_DeviceBuffer)),
                ("outputs", ctypes.POINTER(_DeviceBuffer)),
                ("token", ctypes.c_int64)]


_LOWER_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int64, ctypes.c_char_p,
                             ctypes.POINTER(_Lowered), ctypes.c_void_p,
                             ctypes.c_size_t)


class _Lowering(ctypes.Structure):
    _fields_ = [("lower", _LOWER_FN), ("user", ctypes.c_void_p)]


# ------------------------------------------------------------------ build
def _lib_path() -> Path:
    key = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdl4j_cuda_runtime-{key[:16]}.so"


def build_native_lib(force: bool = False) -> str:
    """Build the runtime library from ``src/cuda_runtime.cc`` with ``g++``
    into ``_build/`` (keyed by the source and flags) unless it is there;
    returns its path. The build writes a temporary file and renames it,
    so processes building at once do not race. Raises on a missing
    compiler or a failed build, with the compiler's output."""
    out = _lib_path()
    if out.exists() and not force:
        return str(out)
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise NativeRuntimeError(
            "no C++ compiler (g++): the native runtime is built from "
            f"{_SRC} at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC),
                           "-ldl"], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeRuntimeError(
            f"native runtime build failed (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def _load_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_native_lib())
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.dl4j_client_create.restype = P
    lib.dl4j_client_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(I32),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(I64),
        ctypes.c_char_p, ctypes.c_size_t]
    lib.dl4j_client_destroy.argtypes = [P]
    lib.dl4j_client_device_count.argtypes = [P]
    lib.dl4j_client_device_count.restype = ctypes.c_int
    lib.dl4j_client_platform_name.argtypes = [P, ctypes.c_char_p,
                                              ctypes.c_size_t]
    lib.dl4j_client_platform_name.restype = ctypes.c_int
    lib.dl4j_client_api_version.argtypes = [
        P, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.dl4j_client_api_version.restype = ctypes.c_int
    lib.dl4j_compile.restype = P
    lib.dl4j_compile.argtypes = [
        P, ctypes.c_char_p, I64, ctypes.c_char_p, ctypes.c_char_p, I64,
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_size_t]
    lib.dl4j_executable_release.argtypes = [P]
    lib.dl4j_executable_release.restype = I64
    lib.dl4j_executable_token.argtypes = [P]
    lib.dl4j_executable_token.restype = I64
    lib.dl4j_executable_num_outputs.argtypes = [P]
    lib.dl4j_executable_num_outputs.restype = I64
    lib.dl4j_client_cache_stats.argtypes = [P, ctypes.POINTER(I64),
                                            ctypes.POINTER(I64)]
    lib.dl4j_client_cache_stats.restype = I64
    lib.dl4j_execute.restype = ctypes.c_int
    lib.dl4j_execute.argtypes = [
        P, ctypes.c_int, ctypes.POINTER(P), ctypes.POINTER(I32),
        ctypes.POINTER(I32), ctypes.POINTER(I64), ctypes.c_int, P,
        ctypes.POINTER(_HostBuffer), ctypes.c_int, ctypes.c_char_p,
        ctypes.c_size_t]
    lib.dl4j_free_outputs.argtypes = [ctypes.POINTER(_HostBuffer),
                                      ctypes.c_int]
    return lib


_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _load_lib()
        return _LIB


# -------------------------------------------------------------- lowering
class Lowered:
    """What a lowering hands the library for one program: the captured
    graph's handle (``cudaGraph_t`` as an int), the device ordinal, the
    static input and output buffers the graph reads and writes (tensors,
    or numpy arrays for a stand-in driver), whatever else must live as
    long as the executable (``keep``: the ``CUDAGraph`` and its pool), and
    the kernel launches recorded at capture."""

    __slots__ = ("graph", "device", "inputs", "outputs", "keep", "launches")

    def __init__(self, graph: int, device: int, inputs: Sequence,
                 outputs: Sequence, keep=(), launches: Dict[str, int] = None):
        self.graph, self.device = graph, device
        self.inputs, self.outputs = list(inputs), list(outputs)
        self.keep = keep
        self.launches = dict(launches or {})


def _dtype_code(dtype) -> int:
    table = _TORCH_TO_PJRT if isinstance(dtype, torch.dtype) \
        else _NUMPY_TO_PJRT
    code = table.get(dtype if isinstance(dtype, torch.dtype)
                     else np.dtype(dtype))
    if code is None:
        raise NativeRuntimeError(f"no PJRT dtype code for {dtype}")
    return code


def _describe(buf):
    """(pointer, dtype code, shape, nbytes) of a dense tensor or array."""
    if isinstance(buf, torch.Tensor):
        if not buf.is_contiguous():
            raise NativeRuntimeError("a static buffer must be contiguous")
        return (buf.data_ptr(), _dtype_code(buf.dtype), tuple(buf.shape),
                buf.numel() * buf.element_size())
    if not buf.flags.c_contiguous:
        raise NativeRuntimeError("a static buffer must be contiguous")
    return (buf.ctypes.data, _dtype_code(buf.dtype), buf.shape, buf.nbytes)


def _device_buffers(bufs) -> ctypes.Array:
    arr = (_DeviceBuffer * max(1, len(bufs)))()
    for slot, buf in zip(arr, bufs):
        ptr, code, shape, nbytes = _describe(buf)
        if len(shape) > 16:
            raise NativeRuntimeError(f"rank {len(shape)} > 16")
        slot.ptr, slot.dtype, slot.ndim, slot.nbytes = ptr, code, \
            len(shape), nbytes
        for d, n in enumerate(shape):
            slot.dims[d] = n
    return arr


def lower_samediff(runtime: "NativeRuntime", program: bytes,
                   inputs: Optional[Sequence] = None) -> Lowered:
    """Build a ``fmt="samediff"`` program's graph on the card the program
    names (``"device"``; the current one when it names none) and capture
    it there (``keep_graph``: the library instantiates it). ``inputs``,
    when given, seed the static inputs for the warm-up runs; zeros
    otherwise. The program's last input is the step clock its RNG nodes
    draw from (``StepKey(seed, t)``), so the step is an input, not baked
    in. A node that reads the host is refused here, once a program."""
    from deeplearning4j_tpu_torch.autodiff.samediff import subgraph_from_spec
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import registry as op_registry
    from deeplearning4j_tpu_torch.ops.normalization import StepKey
    spec = json.loads(program)
    try:
        dev = resolve_device(spec.get("device"))
    except RuntimeError as e:
        raise NativeRuntimeError(str(e)) from e
    if dev.type != "cuda":
        raise NativeRuntimeError(
            f"the native backend runs on the card: the program names {dev}")
    ordinal = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    if ordinal >= torch.cuda.device_count():
        raise NativeRuntimeError(
            f"the program names cuda:{ordinal}, and the machine has "
            f"{torch.cuda.device_count()} card(s)")
    dev = torch.device("cuda", ordinal)
    sub = subgraph_from_spec(spec, dev)
    outputs = list(spec["outputs"])
    refuse_host_control(sub, outputs)
    names = spec["ph_order"]
    static = []
    for i, name in enumerate(names):
        shape, dt = spec["placeholders"][name]
        t = torch.zeros(tuple(shape or ()), dtype=op_registry.torch_dtype(dt),
                        device=dev)
        if inputs is not None:
            t.copy_(torch.as_tensor(inputs[i]))
        static.append(t)
    train, seed = bool(spec["train"]), int(spec["seed"])

    def run(*args):
        *vals, t = args
        outs = sub._exec({}, dict(zip(names[:-1], vals)), outputs,
                         train=train, key=StepKey(seed, t))
        return tuple(outs[o].contiguous() for o in outputs)

    stream, pool = runtime._capture_options(ordinal)
    try:
        with torch.no_grad(), torch.cuda.device(ordinal):
            with cc._side_stream(static):
                for _ in range(cc.WARMUP_RUNS):
                    run(*static)
            before = dict(ck.LAUNCHES)
            graph, outs = cc._record(run, static, pool=pool, stream=stream,
                                     keep_graph=True)
            handle = graph.raw_cuda_graph()
    except Exception as e:        # no eager parking: the compile fails
        raise NativeRuntimeError(
            f"capture of the SameDiff program failed ({type(e).__name__}: "
            f"{e})") from e
    launches = {k: v - before.get(k, 0) for k, v in ck.LAUNCHES.items()
                if v != before.get(k, 0)}
    return Lowered(handle, ordinal, static, outs, keep=(graph, sub),
                   launches=launches)


def refuse_host_control(sd, outputs: Sequence[str]) -> None:
    """A node the outputs need that reads a value on the host (a
    ``while_loop`` predicate, a ``cond`` branch) cannot be captured:
    refuse the graph, naming the node. (The JAX backend lowers such nodes
    to ``lax`` control flow.)"""
    host = [n for n in sd._needed_nodes(outputs) if n.host]
    if host:
        n = host[0]
        raise NativeRuntimeError(
            f"node '{n.outputs[0]}' ({n.op}) reads a value on the host, so "
            "the native backend cannot capture this graph; run it with "
            "the eager backend")


# ----------------------------------------------------------- executables
class NativeExecutable:
    """A compiled program: a handle on the library's cached executable."""

    def __init__(self, runtime: "NativeRuntime", handle: int,
                 cache_hit: bool):
        self._rt = runtime
        self._h = handle
        self.cache_hit = cache_hit
        self.token = int(_lib().dl4j_executable_token(handle))
        #: bytes moved by this handle's executes, by direction
        self.bytes = {"h2d": 0, "d2d": 0, "d2h": 0}
        self.calls = 0

    @property
    def released(self) -> bool:
        return not self._h or not self._rt._h

    @property
    def num_outputs(self) -> int:
        return int(_lib().dl4j_executable_num_outputs(self._h))

    @property
    def launches(self) -> Dict[str, int]:
        """The kernel launches recorded into the executable's capture."""
        return dict(self._rt._lowered[self.token].launches)

    def execute(self, *inputs, device: Optional[int] = None) -> List:
        """Run once on the caller's current stream and wait for it.
        ``inputs`` are numpy arrays or tensors (on the host: copied
        host->device; on the card: device->device), in the program's
        order and at its signature; the outputs come back as numpy arrays
        (bf16 ones as CPU bf16 tensors)."""
        if self.released:
            raise NativeRuntimeError("this executable was released")
        lowered = self._rt._lowered[self.token]
        ordinal = lowered.device if device is None else int(device)
        keep, h2d, d2d = [], 0, 0
        for a in inputs:
            if isinstance(a, torch.Tensor):
                a = a.detach().contiguous()
                if a.is_cuda:
                    d2d += a.numel() * a.element_size()
                else:
                    h2d += a.numel() * a.element_size()
            else:
                a = np.ascontiguousarray(np.asarray(a))
                h2d += a.nbytes
            keep.append(a)
        n = len(keep)
        _t0 = time.perf_counter()
        _M_H2D_BYTES.inc(h2d)
        described = [_describe(a) for a in keep]
        data = (ctypes.c_void_p * max(1, n))(*[d[0] for d in described])
        dts = (ctypes.c_int32 * max(1, n))(*[d[1] for d in described])
        nds = (ctypes.c_int32 * max(1, n))(*[len(d[2]) for d in described])
        flat = [int(s) for d in described for s in d[2]]
        dims = (ctypes.c_int64 * max(1, len(flat)))(*flat)
        # the caller's stream on a card torch knows (the library checks
        # the ordinal against the executable's)
        stream = torch.cuda.current_stream(ordinal).cuda_stream \
            if 0 <= ordinal < torch.cuda.device_count() else None
        max_out = max(self.num_outputs, 1)
        outs = (_HostBuffer * max_out)()
        err = ctypes.create_string_buffer(2048)
        rc = _lib().dl4j_execute(self._h, n, data, dts, nds, dims, ordinal,
                                 stream, outs, max_out, err, len(err))
        if rc < 0:
            raise NativeRuntimeError(err.value.decode() or "execute failed")
        try:
            results = [_to_host(outs[i]) for i in range(rc)]
        finally:
            _lib().dl4j_free_outputs(outs, rc)
        d2h = sum(int(outs[i].nbytes) for i in range(rc))
        _M_D2H_BYTES.inc(d2h)
        self.bytes["h2d"] += h2d
        self.bytes["d2d"] += d2d
        self.bytes["d2h"] += d2h
        self.calls += 1
        from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
        ck.count_replay(lowered.launches)
        dt = time.perf_counter() - _t0
        _M_EXECUTE_SECONDS.observe(dt)
        if _prof.tracing_enabled():
            _prof.get_tracer().add_event(
                "native:execute", _prof.now_us() - dt * 1e6, dt * 1e6,
                {"n_inputs": n, "n_outputs": rc})
        return results

    __call__ = execute

    def release(self) -> None:
        """Drop this handle; when it was the executable's last, the
        library destroys the executable and the capture's memory is
        freed."""
        if self._h:
            h, self._h = self._h, None
            if self._rt._h:
                self._rt._drop(int(_lib().dl4j_executable_release(h)))


def _to_host(hb: _HostBuffer):
    """One host output, copied once out of the library's buffer."""
    shape = tuple(hb.dims[d] for d in range(hb.ndim))
    if hb.dtype == _PJRT_BF16:
        dt = np.dtype(np.uint16)
    else:
        dt = _PJRT_TO_NUMPY.get(hb.dtype)
        if dt is None:
            raise NativeRuntimeError(f"unmapped output dtype {hb.dtype}")
    n_elems = int(np.prod(shape)) if shape else 1
    if n_elems == 0:
        out = np.zeros(shape, dt)
    else:
        if hb.nbytes == 0 or not hb.data:
            raise NativeRuntimeError(
                f"an output has an empty buffer for non-empty shape {shape}")
        src = np.ctypeslib.as_array(
            ctypes.cast(hb.data, ctypes.POINTER(ctypes.c_uint8)),
            shape=(int(hb.nbytes),))
        out = src[:n_elems * dt.itemsize].view(dt).reshape(shape).copy()
    if hb.dtype == _PJRT_BF16:
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


# --------------------------------------------------------------- runtime
_SHARED_RUNTIME: Optional["NativeRuntime"] = None
_SHARED_LOCK = threading.Lock()


def get_runtime() -> "NativeRuntime":
    """Process-wide shared client for framework execution paths (the
    ``setExecBackend("native")`` seam in ``autodiff.samediff``). Raises
    :class:`NativeRuntimeError` when the driver or the toolchain is not
    there."""
    global _SHARED_RUNTIME
    with _SHARED_LOCK:
        if _SHARED_RUNTIME is None or not _SHARED_RUNTIME._h:
            _SHARED_RUNTIME = NativeRuntime.create()
        return _SHARED_RUNTIME


class NativeRuntime:
    """A client of the CUDA driver owned by the native layer (ref: Nd4j
    backend init over NativeOps)."""

    #: program format -> lowering(runtime, program bytes, inputs) -> Lowered
    LOWERINGS: Dict[str, Callable] = {"samediff": lower_samediff}

    def __init__(self, handle: int, driver_path: str,
                 lowerings: Dict[str, Callable] = None):
        self._h = handle
        self.driver_path = driver_path
        self._lowerings = {**self.LOWERINGS, **(lowerings or {})}
        #: token -> what an executable's memory is, held until the
        #: library's last handle on it goes
        self._lowered: Dict[int, Lowered] = {}
        self._next_token = 1
        #: guards the runtime's Python state; compile() holds it across
        #: the library's call back into the lowering hook, which takes it
        #: again on the same thread
        self._lock = threading.RLock()
        self._compile_inputs = None
        self._compile_token = 0
        self._lower_error: Optional[BaseException] = None
        self._hook = _LOWER_FN(self._lower)
        self._lowering = _Lowering(self._hook, None)
        #: device ordinal -> the capture stream (kept: cuBLAS keeps a
        #: workspace for each stream it meets) and the memory pool every
        #: lowering on it shares (the library serializes executions
        #: accordingly; the pool goes with the last executable on it)
        self._streams: Dict[int, "torch.cuda.Stream"] = {}
        self._pools: Dict[int, tuple] = {}
        #: disk-tier keys already resolved this process
        self._disk_seen: set = set()

    @classmethod
    def create(cls, driver_path: str = None,
               create_options: dict = None,
               lowerings: Dict[str, Callable] = None) -> "NativeRuntime":
        """A client over the driver at ``driver_path`` (``libcuda.so.1``
        by default; a test passes a stand-in). The CUDA driver takes no
        create options. ``lowerings`` adds or replaces program formats."""
        driver_path = driver_path or DEFAULT_DRIVER
        keys, types, strs, ints = [], [], [], []
        for k, v in (create_options or {}).items():
            keys.append(k.encode())
            if isinstance(v, str):
                types.append(0); strs.append(v.encode()); ints.append(0)
            else:
                types.append(1); strs.append(b""); ints.append(int(v))
        n = len(keys)
        err = ctypes.create_string_buffer(2048)
        h = _lib().dl4j_client_create(
            driver_path.encode(), n,
            (ctypes.c_char_p * max(1, n))(*keys),
            (ctypes.c_int32 * max(1, n))(*types),
            (ctypes.c_char_p * max(1, n))(*strs),
            (ctypes.c_int64 * max(1, n))(*ints),
            err, len(err))
        if not h:
            raise NativeRuntimeError(
                f"client create failed for {driver_path}: "
                f"{err.value.decode()}")
        return cls(h, driver_path, lowerings)

    def _check_open(self) -> None:
        if not self._h:
            raise NativeRuntimeError("this runtime was closed")

    @property
    def device_count(self) -> int:
        self._check_open()
        return int(_lib().dl4j_client_device_count(self._h))

    @property
    def platform_name(self) -> str:
        self._check_open()
        buf = ctypes.create_string_buffer(256)
        if _lib().dl4j_client_platform_name(self._h, buf, len(buf)) < 0:
            raise NativeRuntimeError("platform name query failed")
        return buf.value.decode()

    @property
    def api_version(self):
        """The driver's (major, minor) version."""
        self._check_open()
        mj, mn = ctypes.c_int(), ctypes.c_int()
        _lib().dl4j_client_api_version(self._h, ctypes.byref(mj),
                                       ctypes.byref(mn))
        return (mj.value, mn.value)

    def cache_stats(self):
        self._check_open()
        hits, misses = ctypes.c_int64(), ctypes.c_int64()
        size = _lib().dl4j_client_cache_stats(self._h, ctypes.byref(hits),
                                              ctypes.byref(misses))
        return {"size": int(size), "hits": int(hits.value),
                "misses": int(misses.value)}

    def _capture_options(self, ordinal: int):
        """The stream and memory pool every capture on device ``ordinal``
        shares."""
        with self._lock:
            if ordinal not in self._streams:
                self._streams[ordinal] = torch.cuda.Stream(ordinal)
            if ordinal not in self._pools:
                self._pools[ordinal] = torch.cuda.graph_pool_handle()
            return self._streams[ordinal], self._pools[ordinal]

    def _lower(self, _user, program, size, fmt, out, err, errlen) -> int:
        """The library's lowering hook (a ctypes callback, on the thread
        of :meth:`compile`, which holds the lock): an exception cannot
        cross C, so it is kept and :meth:`compile` raises it."""
        with self._lock:
            try:
                name = fmt.decode()
                lowering = self._lowerings.get(name)
                if lowering is None:
                    raise NativeRuntimeError(
                        f"no lowering for format '{name}'")
                low = lowering(self, ctypes.string_at(program, size),
                               self._compile_inputs)
                ins, outs = _device_buffers(low.inputs), \
                    _device_buffers(low.outputs)
                token = self._next_token
                self._next_token += 1
                # the descriptors must live until the library copied them
                low.keep = (low.keep, ins, outs)
                self._lowered[token] = low
                self._compile_token = token
                o = out.contents
                o.graph, o.device, o.token = low.graph, low.device, token
                o.n_inputs, o.n_outputs = len(low.inputs), len(low.outputs)
                o.inputs = ctypes.cast(ins, ctypes.POINTER(_DeviceBuffer))
                o.outputs = ctypes.cast(outs, ctypes.POINTER(_DeviceBuffer))
                return 0
            except BaseException as e:      # re-raised by compile()
                self._lower_error = e
                msg = f"{type(e).__name__}: {e}".encode()[
                    :max(0, errlen - 1)]
                ctypes.memmove(err, msg + b"\0", len(msg) + 1)
                return 1

    def _drop(self, token: int) -> None:
        """Free what the executable behind ``token`` pointed into (the
        library has destroyed it). The last graph of a pool frees the
        pool, which PyTorch then forgets: the next capture on that device
        takes a new one."""
        with self._lock:
            low = self._lowered.pop(token, None) if token else None
            if low is not None and not any(
                    o.device == low.device for o in self._lowered.values()):
                self._pools.pop(low.device, None)

    def compile(self, program, fmt: str = "samediff", *,
                inputs: Optional[Sequence] = None) -> NativeExecutable:
        """Compile a program, cached by content (program and format) in
        the library's executable cache. ``fmt="samediff"``: the JSON spec
        of a SameDiff graph (``SameDiff._native_program``); on a miss the
        library calls the lowering, which captures the graph on the card
        (``inputs`` seed its warm-up runs). ``"mlir"`` and ``"hlo"`` raise:
        the port has no StableHLO."""
        from deeplearning4j_tpu_torch.nn import compilecache as _cc
        self._check_open()
        if isinstance(program, str):
            program = program.encode()
        disk = _cc.disk_cache()
        key = None
        if disk is not None:
            key = _cc.content_key("native:compile", program,
                                  key_parts=(fmt, "cuda"))
            if key in self._disk_seen:
                key = None
        hit = ctypes.c_int(0)
        err = ctypes.create_string_buffer(4096)
        opts = ctypes.string_at(ctypes.addressof(self._lowering),
                                ctypes.sizeof(self._lowering))
        with self._lock:
            self._compile_inputs, self._lower_error = inputs, None
            self._compile_token = 0
            try:
                with _prof.trace_span("native:compile", fmt=fmt,
                                      program_bytes=len(program)):
                    t0 = time.perf_counter()
                    h = _lib().dl4j_compile(self._h, program, len(program),
                                            fmt.encode(), opts, len(opts),
                                            ctypes.byref(hit), err, len(err))
                    dt = time.perf_counter() - t0
            finally:
                self._compile_inputs = None
            if not h:
                # a capture the library could not instantiate is freed here
                self._drop(self._compile_token)
                raise NativeRuntimeError(
                    err.value.decode() or "compile failed") \
                    from self._lower_error
        if key is not None:
            self._disk_seen.add(key)
        if hit.value:
            _M_CACHE_HITS.inc()
        else:
            _M_CACHE_MISSES.inc()
            _M_COMPILE_SECONDS.observe(dt)
            _cc.note_cold_compile(dt)
            if key is not None:
                # no dl4j_executable_serialize: the disk tier never holds
                # a CUDA executable, so every new key is a disk miss
                _cc.note_disk_miss()
            # recompile-churn seam: each fresh program this client
            # compiles is a distinct signature (owner None: an unscoped
            # site every model.validate() surfaces)
            from deeplearning4j_tpu_torch.analysis import churn as _churn
            _churn.get_churn_detector().record(
                "native.compile", (hash(program), fmt))
        return NativeExecutable(self, h, bool(hit.value))

    def close(self) -> None:
        """Destroy the client: every executable, then the memory they
        pointed into."""
        with self._lock:
            h, self._h = self._h, None
            if h:
                _lib().dl4j_client_destroy(h)
                self._lowered.clear()
                self._pools.clear()
