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
// serving path's [4096, 768] fp32 it moves 25.2 MB: ~7.5 us at 3.35 TB/s.
//
// Design: one block per row. The row is read from device memory once,
// converted to fp32 into shared memory, and both statistics are taken
// from there in two passes (mean, then the sum of squared deviations —
// never E[x^2] - m^2, which cancels for rows with |mean| >> std). Block
// reductions are a fixed tree (warp shuffles, then one warp over the
// per-warp partials), so the result does not depend on scheduling. Reads
// and writes are coalesced; vectorised 16-byte accesses and several rows
// per block are left to a later tuning pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

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

// Sum of v over the block, returned to every thread. `red` holds one
// partial per warp; the trailing barrier lets the caller reuse it.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  __syncthreads();
  return t;
}

template <typename T>
__global__ void layer_norm_fwd_kernel(const T* __restrict__ x,
                                      const float* __restrict__ gain,
                                      const float* __restrict__ bias,
                                      T* __restrict__ y, int d, float eps) {
  extern __shared__ float row[];  // d floats
  __shared__ float red[32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  const T* xr = x + base;
  T* yr = y + base;

  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    row[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / d;

  // each thread revisits only the entries it wrote itself
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

}  // namespace

// x, y: [n, d] contiguous, dtype 0 = fp32, 1 = bf16; gain, bias: fp32 [d].
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int dl4j_layer_norm_fwd(const void* x, const void* gain,
                                   const void* bias, void* y, int n, int d,
                                   float eps, int dtype, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = d >= 256 ? 256 : ((d + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gain);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) {
    layer_norm_fwd_kernel<float><<<n, threads, smem, s>>>(
        static_cast<const float*>(x), g, b, static_cast<float*>(y), d, eps);
  } else if (dtype == 1) {
    layer_norm_fwd_kernel<__nv_bfloat16><<<n, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, b,
        static_cast<__nv_bfloat16*>(y), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
