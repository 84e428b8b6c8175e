// Training-mode BatchNorm + leaky relu as two streaming passes, for Hopper
// (sm_90a): the kernels of the BN+leaky probe.
//
// Replaces: benchmarks/probe_bn_leaky.py `pallas_bn_leaky`, whose two
// pallas_calls are the statistics pass (:89, kernel `stats_kernel` :71)
// and the apply pass (:114, kernel `apply_kernel` :107).
//
// Both take the channel-major view x [C, M] (M = N*H*W), contiguous, fp32
// or bf16, any C >= 1 and M >= 1 (the TPU kernels need M to be a multiple
// of 416*1664 for their VMEM blocks).
//
// - bn_stats: per channel, sum(x) and sum(x*x) in fp32 -> [C] each. A NaN
//   or inf in a channel gives NaN or inf in that channel's sums.
// - bn_apply_leaky: y = x * scale[c] + shift[c] as one fp32 FMA, then
//   y > 0 ? y : alpha * y (a NaN takes the alpha branch and stays NaN),
//   rounded once to x's type. scale and shift are fp32.
//
// What bounds them on an H100: device-memory bytes. At the probe's shape,
// x [16, 32*416*416] bf16, the statistics read 177.2 MB (0.0529 ms at
// 3.35 TB/s) and the apply moves 354.4 MB (0.1058 ms); each does 2-3
// flops an element.
//
// Design. The TPU carried each channel's running sums in VMEM scratch
// across a sequential grid; here blocks run in parallel and in no order,
// so each row is cut into chunks of kChunkVecs 16-byte vectors (8 bf16 or
// 4 fp32), one block a chunk, one 1-D grid over C x chunks. A thread
// loads its kVecsPerThread vectors first (all in flight at once), then
// accumulates them; elements before a row's first 16-byte boundary (the
// head, in the first block of the row) and after its last whole vector
// (the tail, in the last block) go one at a time. The statistics pass
// reduces each block by warp shuffles and shared memory into a partials
// buffer [C, chunks, 2] and a second launch sums each channel's partials
// in fp64, a warp a channel in a fixed order: no atomics, so the sums are
// the same bits on every run. The apply pass keeps its channel's scale and shift in
// registers; its 16-byte path needs x and y at the same offset modulo 16
// bytes, else it runs one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 8;
constexpr long long kChunkVecs = kThreads * kVecsPerThread;

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

// elements in one 16-byte vector
template <typename T> struct Vec {
  static constexpr int n = static_cast<int>(sizeof(uint4) / sizeof(T));
};

// elements of `row` before its first 16-byte boundary, at most m
template <typename T>
__device__ __forceinline__ long long head_of(const T* row, long long m) {
  const unsigned mis = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(row) & 15u);
  const long long head = mis ? (16 - mis) / sizeof(T) : 0;
  return head < m ? head : m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial_kernel(const T* __restrict__ x, long long m, int chunks,
                        float* __restrict__ partials) {
  constexpr int kVec = Vec<T>::n;
  const long long c = blockIdx.x / chunks;
  const int b = static_cast<int>(blockIdx.x % chunks);
  const T* row = x + c * m;
  const long long head = head_of(row, m);
  const long long nvec = (m - head) / kVec;
  const uint4* rv = reinterpret_cast<const uint4*>(row + head);
  const long long v0 = b * kChunkVecs + threadIdx.x;
  uint4 raw[kVecsPerThread];
#pragma unroll
  for (int k = 0; k < kVecsPerThread; ++k) {
    const long long v = v0 + k * kThreads;
    raw[k] = v < nvec ? __ldg(rv + v) : make_uint4(0u, 0u, 0u, 0u);
  }
  float s = 0.f, q = 0.f;              // zero bits are 0.0 in both types
#pragma unroll
  for (int k = 0; k < kVecsPerThread; ++k) {
    T in[kVec];
    memcpy(in, &raw[k], sizeof(uint4));
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = to_f32(in[j]);
      s += f;
      q = __fmaf_rn(f, f, q);
    }
  }
  if (b == 0) {
    for (long long i = threadIdx.x; i < head; i += kThreads) {
      const float f = to_f32(row[i]);
      s += f;
      q = __fmaf_rn(f, f, q);
    }
  }
  if (b == chunks - 1) {
    for (long long i = head + nvec * kVec + threadIdx.x; i < m;
         i += kThreads) {
      const float f = to_f32(row[i]);
      s += f;
      q = __fmaf_rn(f, f, q);
    }
  }
  __shared__ float red[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum(s);
  q = warp_sum(q);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? red[0][lane] : 0.f;
    q = lane < kThreads / 32 ? red[1][lane] : 0.f;
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) {
      float* out = partials + 2 * static_cast<long long>(blockIdx.x);
      out[0] = s;
      out[1] = q;
    }
  }
}

// one warp a channel: lane l sums the channel's partials l, l + 32, ...
// in fp64, then a fixed xor tree; the warp's lanes share one channel, so
// they leave together
__global__ void __launch_bounds__(kThreads)
bn_stats_final_kernel(const float* __restrict__ partials, long long c_total,
                      int chunks, float* __restrict__ sums,
                      float* __restrict__ sumsq) {
  const long long c =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (c >= c_total) return;
  const float* p = partials + 2 * c * chunks;
  double s = 0.0, q = 0.0;
  for (int b = lane; b < chunks; b += 32) {
    s += p[2 * b];
    q += p[2 * b + 1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  if (lane == 0) {
    sums[c] = static_cast<float>(s);
    sumsq[c] = static_cast<float>(q);
  }
}

__device__ __forceinline__ float leaky(float v, float alpha) {
  return v > 0.f ? v : alpha * v;   // NaN > 0 is false: alpha * NaN
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
bn_apply_leaky_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ y,
                      long long m, int chunks, float alpha) {
  constexpr int kVec = Vec<T>::n;
  const long long c = blockIdx.x / chunks;
  const int b = static_cast<int>(blockIdx.x % chunks);
  const T* xr = x + c * m;
  T* yr = y + c * m;
  const float sc = scale[c], sh = shift[c];
  if constexpr (!kVector) {
    const long long e1 = (b + 1) * kChunkVecs * kVec;
    const long long end = e1 < m ? e1 : m;
    for (long long i = b * kChunkVecs * kVec + threadIdx.x; i < end;
         i += kThreads) {
      yr[i] = from_f32<T>(leaky(__fmaf_rn(to_f32(xr[i]), sc, sh), alpha));
    }
  } else {
    const long long head = head_of(xr, m);
    const long long nvec = (m - head) / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
    uint4* yv = reinterpret_cast<uint4*>(yr + head);
    const long long v0 = b * kChunkVecs + threadIdx.x;
    uint4 raw[kVecsPerThread];
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      const long long v = v0 + k * kThreads;
      if (v < nvec) raw[k] = __ldg(xv + v);
    }
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      const long long v = v0 + k * kThreads;
      if (v < nvec) {
        T in[kVec], out[kVec];
        memcpy(in, &raw[k], sizeof(uint4));
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          out[j] = from_f32<T>(leaky(__fmaf_rn(to_f32(in[j]), sc, sh),
                                     alpha));
        }
        uint4 o;
        memcpy(&o, out, sizeof(uint4));
        yv[v] = o;
      }
    }
    if (b == 0) {
      for (long long i = threadIdx.x; i < head; i += kThreads) {
        yr[i] = from_f32<T>(leaky(__fmaf_rn(to_f32(xr[i]), sc, sh), alpha));
      }
    }
    if (b == chunks - 1) {
      for (long long i = head + nvec * kVec + threadIdx.x; i < m;
           i += kThreads) {
        yr[i] = from_f32<T>(leaky(__fmaf_rn(to_f32(xr[i]), sc, sh), alpha));
      }
    }
  }
}

long long chunks_of(long long m, int dtype) {
  const long long per_block = kChunkVecs * (dtype == 0 ? 4 : 8);
  const long long n = (m + per_block - 1) / per_block;
  return n < 1 ? 1 : n;
}

bool grid_fits(long long c, long long chunks) {
  return c >= 1 && c * chunks <= 0x7fffffffLL;
}

template <typename T>
cudaError_t launch_stats(const void* x, long long c, long long m, int chunks,
                         void* partials, void* sums, void* sumsq,
                         cudaStream_t s) {
  bn_stats_partial_kernel<T>
      <<<static_cast<unsigned>(c * chunks), kThreads, 0, s>>>(
          static_cast<const T*>(x), m, chunks, static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long warps_per_block = kThreads / 32;
  bn_stats_final_kernel<<<static_cast<unsigned>(
                              (c + warps_per_block - 1) / warps_per_block),
                          kThreads, 0, s>>>(
      static_cast<const float*>(partials), c, chunks,
      static_cast<float*>(sums), static_cast<float*>(sumsq));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply(const void* x, const void* scale, const void* shift,
                         void* y, long long c, long long m, int chunks,
                         float alpha, cudaStream_t s) {
  const bool same_offset =
      ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(y)) &
       15u) == 0;
  const unsigned blocks = static_cast<unsigned>(c * chunks);
  const T* xt = static_cast<const T*>(x);
  const float* st = static_cast<const float*>(scale);
  const float* ht = static_cast<const float*>(shift);
  T* yt = static_cast<T*>(y);
  if (same_offset) {
    bn_apply_leaky_kernel<T, true><<<blocks, kThreads, 0, s>>>(
        xt, st, ht, yt, m, chunks, alpha);
  } else {
    bn_apply_leaky_kernel<T, false><<<blocks, kThreads, 0, s>>>(
        xt, st, ht, yt, m, chunks, alpha);
  }
  return cudaGetLastError();
}

}  // namespace

// Blocks a row takes in both passes, for m elements of dtype (0 = fp32,
// 1 = bf16): the partials buffer of dl4j_bn_stats holds 2 * c * this.
extern "C" long long dl4j_bn_chunks(long long m, int dtype) {
  return chunks_of(m, dtype);
}

// x: [c, m] contiguous; partials: 2 * c * dl4j_bn_chunks(m, dtype) fp32
// of scratch; sums, sumsq: [c] fp32. Two launches on `stream`. Returns
// the cudaError_t of the launches (0 = launched).
extern "C" int dl4j_bn_stats(const void* x, long long c, long long m,
                             int dtype, void* partials, void* sums,
                             void* sumsq, void* stream) {
  const long long chunks = chunks_of(m, dtype);
  if (m < 1 || !grid_fits(c, chunks) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ch = static_cast<int>(chunks);
  const cudaError_t err =
      dtype == 0
          ? launch_stats<float>(x, c, m, ch, partials, sums, sumsq, s)
          : launch_stats<__nv_bfloat16>(x, c, m, ch, partials, sums, sumsq, s);
  return static_cast<int>(err);
}

// x, y: [c, m] contiguous, of dtype (0 = fp32, 1 = bf16); scale, shift:
// [c] fp32; alpha the negative slope. One launch on `stream`.
extern "C" int dl4j_bn_apply_leaky(const void* x, const void* scale,
                                   const void* shift, void* y, long long c,
                                   long long m, float alpha, int dtype,
                                   void* stream) {
  const long long chunks = chunks_of(m, dtype);
  if (m < 1 || !grid_fits(c, chunks) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ch = static_cast<int>(chunks);
  const cudaError_t err =
      dtype == 0 ? launch_apply<float>(x, scale, shift, y, c, m, ch, alpha, s)
                 : launch_apply<__nv_bfloat16>(x, scale, shift, y, c, m, ch,
                                               alpha, s);
  return static_cast<int>(err);
}
