// Row LayerNorm forward for Hopper (sm_90a).
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py `_layer_norm_kernel`
// (:57), launched by `_layer_norm_fwd_pallas` (pallas_call at :72) and
// installed by `make_layer_norm_override` (:88).
//
// Computes, per row of x [N, D] (fp32 or bf16): fp32 mean, then the biased
// (population) variance of the centred row, then
// y = (x - m) * rsqrt(v + eps) * g + b cast back to x's type. g and b are
// fp32 [D].
//
// What bounds it on an H100: device-memory bytes. Each element is read
// once and written once and takes a handful of flops, far below the
// ~20 flop/byte (fp32) at which the card stops being memory-bound. At the
// serving path's [4096, 768] fp32 it moves 25.2 MB: 7.5 us at 3.35 TB/s;
// at [16384, 768] (T=512) 100.7 MB, 30 us. So the design keeps as many
// bytes in flight per SM as it can and reads each element once.
//
// Design: for D <= 1024, one warp per row and 8 rows (warps) to a block of
// 256 threads, a grid of ceil(N / 8) blocks. Lane l holds columns
// (it * 32 + l) * kVec + [0, kVec) for it < kIters in registers, read as
// 16-byte vectors (4 fp32 or 8 bf16; at D=768 fp32, 6 float4 a lane) when
// D is a multiple of kVec and x, y, g and b are 16-byte aligned, one
// element at a time otherwise. The mean and then the sum of squared
// deviations come from those registers through warp shuffles (never
// E[x^2] - m^2, which cancels for rows with |mean| >> std); g and b are
// read with the same vectors. Nothing is staged in shared memory and
// there is no block barrier. Above 1024 (up to the gate's 8192), one block
// of 256 threads per row stages the row as fp32 in shared memory and takes
// both statistics from there with block reductions, as softmax.cu splits
// its warp and block kernels at 1024. Reductions are fixed trees
// (xor-shuffles, then one warp over the per-warp partials), so the result
// does not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kWarpMaxD = 1024;
constexpr int kMaxD = 8192;  // the staged row in 32 KB of shared memory

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kVec elements from p as fp32: one 16-byte load of T when kVec > 1
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

// kVec fp32 values from p: 16-byte loads when kVec > 1
template <int kVec>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (kVec == 1) {
    out[0] = *p;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; k += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + k);
      out[k] = f.x;
      out[k + 1] = f.y;
      out[k + 2] = f.z;
      out[k + 3] = f.w;
    }
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

// One warp per row (see the note above); kIters * 32 * kVec >= d. With
// kVec > 1, d is a multiple of kVec, so a vector is wholly in the row or
// wholly out.
template <typename T, int kVec, int kIters>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel_warp(const T* __restrict__ x,
                           const float* __restrict__ gain,
                           const float* __restrict__ bias,
                           T* __restrict__ y, long long n, int d, float eps) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp shares the row
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float v[kIters * kVec];
  float s = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = (it * 32 + lane) * kVec;
    if (c < d) {
      load_vec<T, kVec>(xr + c, v + it * kVec);
#pragma unroll
      for (int k = 0; k < kVec; ++k) s += v[it * kVec + k];
    }
  }
  const float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = (it * 32 + lane) * kVec;
    if (c < d) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float cv = v[it * kVec + k] - mean;
        q += cv * cv;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(q) / d + eps);
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = (it * 32 + lane) * kVec;
    if (c < d) {
      float g[kVec], b[kVec], out[kVec];
      load_f32<kVec>(gain + c, g);
      load_f32<kVec>(bias + c, b);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float yn = (v[it * kVec + k] - mean) * inv;
        out[k] = yn * g[k] + b[k];
      }
      store_vec<T, kVec>(yr + c, out);
    }
  }
}

// Sum of v over the block, returned to every thread. `red` holds one
// partial per warp; the trailing barrier lets the caller reuse it.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
  t = warp_sum(t);
  __syncthreads();
  return t;
}

// One block per row, the row staged as fp32 in shared memory; each thread
// revisits only the entries it wrote itself.
template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel_block(const T* __restrict__ x,
                            const float* __restrict__ gain,
                            const float* __restrict__ bias,
                            T* __restrict__ y, int d, float eps) {
  extern __shared__ float row[];  // d floats
  __shared__ float red[32];
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const T* xr = x + base;
  T* yr = y + base;

  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    row[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / d;

  float q = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = row[i] - mean;
    q += c * c;
  }
  const float inv = rsqrtf(block_sum(q, red) / d + eps);

  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float yn = (row[i] - mean) * inv;
    yr[i] = from_f32<T>(yn * gain[i] + bias[i]);
  }
}

template <typename T, int kVec>
cudaError_t launch_warp(const void* x, const float* g, const float* b,
                        void* y, long long n, int d, float eps,
                        cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int iters = (d + 32 * kVec - 1) / (32 * kVec);
  const long long nblocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(nblocks);
#define DL4J_LN_WARP(IT)                                                  \
  layer_norm_fwd_kernel_warp<T, kVec, IT><<<blocks, kThreads, 0, s>>>(    \
      xt, g, b, yt, n, d, eps)
  if (iters <= 1) {
    DL4J_LN_WARP(1);
  } else if (iters <= 2) {
    DL4J_LN_WARP(2);
  } else if (iters <= 3) {
    DL4J_LN_WARP(3);
  } else if (iters <= 4) {
    DL4J_LN_WARP(4);
  } else if (iters <= 6) {
    DL4J_LN_WARP(6);
  } else if (iters <= 8) {
    DL4J_LN_WARP(8);
  } else if constexpr (kVec == 1) {
    if (iters <= 16) {
      DL4J_LN_WARP(16);
    } else {
      DL4J_LN_WARP(32);
    }
  } else {
    return cudaErrorInvalidValue;  // kVec > 1 covers D <= 1024 in 8 steps
  }
#undef DL4J_LN_WARP
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_block(const void* x, const float* g, const float* b,
                         void* y, long long n, int d, float eps,
                         cudaStream_t s) {
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  layer_norm_fwd_kernel_block<T>
      <<<static_cast<unsigned>(n), kThreads, smem, s>>>(
          static_cast<const T*>(x), g, b, static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

template <typename T, int kVec>
cudaError_t launch(const void* x, const float* g, const float* b, void* y,
                   long long n, int d, float eps, bool aligned,
                   cudaStream_t s) {
  if (d > kWarpMaxD) return launch_block<T>(x, g, b, y, n, d, eps, s);
  if (aligned && d % kVec == 0)
    return launch_warp<T, kVec>(x, g, b, y, n, d, eps, s);
  return launch_warp<T, 1>(x, g, b, y, n, d, eps, s);
}

}  // namespace

// x, y: [n, d] contiguous, dtype 0 = fp32, 1 = bf16, 1 <= d <= 8192;
// gain, bias: fp32 [d]. Returns the cudaError_t of the launch (0 = launched).
extern "C" int dl4j_layer_norm_fwd(const void* x, const void* gain,
                                   const void* bias, void* y, long long n,
                                   int d, float eps, int dtype, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gain);
  const float* b = static_cast<const float*>(bias);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(b)) &
       15u) == 0;
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, 4>(x, g, b, y, n, d, eps, aligned, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16, 8>(x, g, b, y, n, d, eps, aligned, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
