"""Native (C++) runtime layer over the CUDA driver — the port of
``deeplearning4j_tpu/native``.

Reference parity: libnd4j + the nd4j-native JNI bridge (the L0 runtime).
The library is built from ``src/cuda_runtime.cc`` with ``g++`` at first
use (``build_native_lib()``) into the gitignored ``_build/``.
"""

from deeplearning4j_tpu_torch.native.runtime import (NativeExecutable,
                                                     NativeRuntime,
                                                     NativeRuntimeError,
                                                     build_native_lib,
                                                     get_runtime)

__all__ = ["NativeRuntime", "NativeExecutable", "NativeRuntimeError",
           "build_native_lib", "get_runtime"]
