// Row softmax forward for Hopper (sm_90a).
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py `_softmax_kernel`
// (:131), launched by `_softmax_fwd_pallas` (pallas_call at :144) and
// installed by `make_softmax_override` (:156). The backward stays composed
// (torch here, jnp there: y * (g - sum(g * y))).
//
// Computes, per row of x [N, D] (fp32 or bf16): the row read as fp32, its
// max m, e = exp(x - m) with expf (not __expf), y = e / sum(e), rounded
// once to x's type on store. The max is a compare that keeps NaN
// (fmaxf(NaN, a) would return a), so a NaN anywhere in a row makes the
// whole row NaN, and a row of -inf gives NaN (-inf - -inf), as jnp does.
//
// What bounds it on an H100: device-memory bytes. Each element is read
// once and written once for a handful of flops and one exp. At the
// attention rows of a SameDiff BERT-base forward, B=32, T=128, x
// [49152, 128] fp32, it moves 50.3 MB: 0.0150 ms at 3.35 TB/s.
//
// Design: for D <= 1024, one warp per row, 8 rows to a 256-thread block.
// Each lane loads its slice of the row into registers (16-byte loads of 4
// fp32 or 8 bf16 when D is a multiple of that and x, y are 16-byte
// aligned, one element at a time otherwise), and the max and the sum are
// warp shuffles: the row is read from device memory once and never
// staged. Above 1024, one block per row stages the row as fp32 in shared
// memory (48 KB: D <= 12288) and reduces over the block, as the layer-norm
// kernel does. Reductions are fixed trees, so the result does not depend
// on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kWarpMaxD = 1024;
constexpr int kMaxD = 12288;  // the staged row in 48 KB of shared memory

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

// max that keeps NaN from either side
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kVec elements from p: one 16-byte load when kVec > 1, else one element
template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (kVec == 1) {
    out[0] = to_f32(*p);
  } else {
    static_assert(kVec * sizeof(T) == sizeof(uint4), "16-byte vectors");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    T in[kVec];
    memcpy(in, &raw, sizeof(raw));
#pragma unroll
    for (int k = 0; k < kVec; ++k) out[k] = to_f32(in[k]);
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  if constexpr (kVec == 1) {
    *p = from_f32<T>(in[0]);
  } else {
    T out[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) out[k] = from_f32<T>(in[k]);
    uint4 raw;
    memcpy(&raw, out, sizeof(raw));
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// One warp per row; lane l holds columns (it * 32 + l) * kVec + [0, kVec)
// for it < kIters, which cover D (kIters * 32 * kVec >= D). With kVec > 1,
// D is a multiple of kVec, so a vector is either wholly in the row or out.
template <typename T, int kVec, int kIters>
__global__ void __launch_bounds__(kThreads)
softmax_warp_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                    int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp shares the row
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float v[kIters * kVec];
  float m = -INFINITY;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = (it * 32 + lane) * kVec;
    if (c < d) {
      load_vec<T, kVec>(xr + c, v + it * kVec);
#pragma unroll
      for (int k = 0; k < kVec; ++k) m = nan_max(v[it * kVec + k], m);
    }
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = (it * 32 + lane) * kVec;
    if (c < d) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float e = expf(v[it * kVec + k] - m);
        v[it * kVec + k] = e;
        s += e;
      }
    }
  }
  s = warp_sum(s);
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = (it * 32 + lane) * kVec;
    if (c < d) {
      float o[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) o[k] = v[it * kVec + k] / s;
      store_vec<T, kVec>(yr + c, o);
    }
  }
}

// Block-wide reductions returned to every thread. `red` holds one partial
// per warp; the trailing barrier lets the caller reuse it.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (blockDim.x >> 5) ? red[lane] : -INFINITY;
  t = warp_max(t);
  __syncthreads();
  return t;
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (blockDim.x >> 5) ? red[lane] : 0.f;
  t = warp_sum(t);
  __syncthreads();
  return t;
}

// One block per row, the row staged as fp32 in shared memory; each thread
// revisits only the entries it wrote itself.
template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_block_kernel(const T* __restrict__ x, T* __restrict__ y, int d) {
  extern __shared__ float row[];  // d floats
  __shared__ float red[32];
  const long long base = static_cast<long long>(blockIdx.x) * d;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(x[base + i]);
    row[i] = v;
    m = nan_max(v, m);
  }
  m = block_max(m, red);
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float e = expf(row[i] - m);
    row[i] = e;
    s += e;
  }
  s = block_sum(s, red);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    y[base + i] = from_f32<T>(row[i] / s);
  }
}

template <typename T, int kVec>
cudaError_t launch_warp(const void* x, void* y, long long n, int d,
                        cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int iters = (d + 32 * kVec - 1) / (32 * kVec);
  const long long nblocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(nblocks);
  if (iters <= 1) {
    softmax_warp_kernel<T, kVec, 1><<<blocks, kThreads, 0, s>>>(xt, yt, n, d);
  } else if (iters <= 2) {
    softmax_warp_kernel<T, kVec, 2><<<blocks, kThreads, 0, s>>>(xt, yt, n, d);
  } else if (iters <= 4) {
    softmax_warp_kernel<T, kVec, 4><<<blocks, kThreads, 0, s>>>(xt, yt, n, d);
  } else if (iters <= 8) {
    softmax_warp_kernel<T, kVec, 8><<<blocks, kThreads, 0, s>>>(xt, yt, n, d);
  } else if constexpr (kVec == 1) {
    if (iters <= 16) {
      softmax_warp_kernel<T, 1, 16><<<blocks, kThreads, 0, s>>>(xt, yt, n, d);
    } else {
      softmax_warp_kernel<T, 1, 32><<<blocks, kThreads, 0, s>>>(xt, yt, n, d);
    }
  } else {
    return cudaErrorInvalidValue;  // kVec > 1 covers D <= 1024 in 8 steps
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_block(const void* x, void* y, long long n, int d,
                         cudaStream_t s) {
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  softmax_block_kernel<T><<<static_cast<unsigned>(n), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), d);
  return cudaGetLastError();
}

}  // namespace

// x, y: [n, d] contiguous, dtype 0 = fp32, 1 = bf16, 1 <= d <= 12288.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int dl4j_softmax_fwd(const void* x, void* y, long long n, int d,
                                int dtype, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15u) == 0;
  cudaError_t err;
  if (dtype == 0) {
    if (d > kWarpMaxD) {
      err = launch_block<float>(x, y, n, d, s);
    } else if (aligned && d % 4 == 0) {
      err = launch_warp<float, 4>(x, y, n, d, s);
    } else {
      err = launch_warp<float, 1>(x, y, n, d, s);
    }
  } else if (dtype == 1) {
    if (d > kWarpMaxD) {
      err = launch_block<__nv_bfloat16>(x, y, n, d, s);
    } else if (aligned && d % 8 == 0) {
      err = launch_warp<__nv_bfloat16, 8>(x, y, n, d, s);
    } else {
      err = launch_warp<__nv_bfloat16, 1>(x, y, n, d, s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
