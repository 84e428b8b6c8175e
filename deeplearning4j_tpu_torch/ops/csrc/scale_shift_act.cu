// Fused conv epilogue act(x * scale + shift) for Hopper (sm_90a).
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py
// `_scale_shift_act_kernel` (:184), launched by `_scale_shift_act_pallas`
// (pallas_call at :203) and installed by `make_scale_shift_act_override`
// (:238). The backward stays composed (torch here, jnp there).
//
// Computes, on the channels-minor view x [rows, C] (fp32 or bf16) with
// per-channel scale and shift [C] in x's type: y = x * scale + shift as
// one fp32 FMA, then relu (alpha == 0: y < 0 ? 0 : y, so a NaN passes
// through as jnp.maximum passes it; fmaxf would turn it into 0) or leaky
// (y < 0 ? alpha * y : y, i.e. the JAX override's y >= 0 ? y : alpha*y),
// rounded once to x's type on store.
//
// What bounds it on an H100: device-memory bytes. Each element is read
// once and written once for two flops. At ResNet-50's stem epilogue,
// B=64, x [64*112*112, 64] bf16, it moves 205.5 MB: 0.0613 ms at
// 3.35 TB/s.
//
// Design: one streaming pass with 16-byte loads and stores (8 bf16 or 4
// fp32 per thread per step) over the flat [rows * C] array, grid-stride.
// The grid's step (blocks * threads, in vectors) is made a multiple of
// C / vec, so every thread always lands on the same vec channels: it
// reads its scale and shift once into registers and never again, with no
// shared memory and no per-element index arithmetic. When C is not a
// multiple of the vector width, or x / y are not 16-byte aligned, the
// same kernel runs with one element per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <bool kRelu>
__device__ __forceinline__ float act(float v, float alpha) {
  // comparisons with NaN are false: a NaN takes the `v` branch
  if (kRelu) return v < 0.f ? 0.f : v;
  return v < 0.f ? alpha * v : v;
}

// kVec elements per step: 16 bytes when kVec * sizeof(T) == 16, one
// element when kVec == 1. `cvecs` = C / kVec; the caller makes
// gridDim.x * blockDim.x a multiple of it.
template <typename T, int kVec, bool kRelu>
__global__ void __launch_bounds__(256)
scale_shift_act_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                       const T* __restrict__ shift, T* __restrict__ y,
                       long long nvec, int cvecs, float alpha) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const int c0 = static_cast<int>(tid % cvecs) * kVec;
  float s[kVec], h[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    s[k] = to_f32(scale[c0 + k]);
    h[k] = to_f32(shift[c0 + k]);
  }
  if constexpr (kVec == 1) {
    for (long long i = tid; i < nvec; i += step) {
      y[i] = from_f32<T>(act<kRelu>(__fmaf_rn(to_f32(x[i]), s[0], h[0]),
                                    alpha));
    }
  } else {
    static_assert(kVec * sizeof(T) == sizeof(uint4), "16-byte vectors");
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (long long v = tid; v < nvec; v += step) {
      const uint4 raw = xv[v];
      T in[kVec], out[kVec];
      memcpy(in, &raw, sizeof(raw));
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        out[k] = from_f32<T>(
            act<kRelu>(__fmaf_rn(to_f32(in[k]), s[k], h[k]), alpha));
      }
      uint4 o;
      memcpy(&o, out, sizeof(o));
      yv[v] = o;
    }
  }
}

constexpr int kThreads = 256;

int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T, int kVec>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   void* y, long long rows, int c, float alpha, int sms,
                   cudaStream_t stream) {
  const long long nvec = rows * c / kVec;
  const int cvecs = c / kVec;
  // blocks must be a multiple of `unit` so that the grid's step in
  // vectors is a multiple of cvecs; aim for 8 resident blocks per SM
  const int unit = cvecs / gcd_int(cvecs, kThreads);
  long long want = (nvec + kThreads - 1) / kThreads;
  const long long cap = 8LL * (sms > 0 ? sms : 132);
  if (want > cap) want = cap;
  const long long blocks = (want + unit - 1) / unit * unit;
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  const T* ht = static_cast<const T*>(shift);
  T* yt = static_cast<T*>(y);
  if (alpha == 0.f) {
    scale_shift_act_kernel<T, kVec, true>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            xt, st, ht, yt, nvec, cvecs, alpha);
  } else {
    scale_shift_act_kernel<T, kVec, false>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            xt, st, ht, yt, nvec, cvecs, alpha);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: [rows, c] contiguous; scale, shift: [c] of x's type; dtype 0 =
// fp32, 1 = bf16; alpha 0 = relu, else the leaky slope (as x's type
// holds it); sms = the card's multiprocessor count. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int dl4j_scale_shift_act_fwd(const void* x, const void* scale,
                                        const void* shift, void* y,
                                        long long rows, int c, float alpha,
                                        int dtype, int sms, void* stream) {
  if (rows <= 0 || c <= 0 || c > 4096) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15u) == 0;
  cudaError_t err;
  if (dtype == 0) {
    err = (aligned && c % 4 == 0)
              ? launch<float, 4>(x, scale, shift, y, rows, c, alpha, sms, s)
              : launch<float, 1>(x, scale, shift, y, rows, c, alpha, sms, s);
  } else if (dtype == 1) {
    err = (aligned && c % 8 == 0)
              ? launch<__nv_bfloat16, 8>(x, scale, shift, y, rows, c, alpha,
                                         sms, s)
              : launch<__nv_bfloat16, 1>(x, scale, shift, y, rows, c, alpha,
                                         sms, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
