// FlashAttention forward for Hopper (sm_90a).
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py `_flash_fwd_kernel`
// (:284), launched by `_flash_fwd_pallas` (pallas_call at :341) and
// installed by `make_flash_attention_override` (:425).
//
// Computes, for q [B, Tq, H, D] and k, v [B, Tk, H, D] (fp32 or bf16, read
// in that layout through strides — no transpose copies):
//   s = (q . k) * 1/sqrt(D)            fp32 accumulation, scale after the dot
//   causal: s[i, j] = -inf for j > i    (top-left aligned, as the reference)
//   online softmax over k tiles: running max m, running sum l, fp32 acc;
//   P is rounded to v's type before the P.V product, as the reference does
//   o = acc / max(l, 1e-30)  -> [B, Tq, H, D] in q's type
//   lse = m + log(max(l, 1e-30)) -> fp32 [B, H, Tq]
//
// What bounds it on an H100: at the serving path's B=32, T=128, H=12, D=64
// bf16 it must move ~25 MB (q, k, v, o once each; ~7.5 us at 3.35 TB/s)
// for 1.6 GFLOP (~1.6 us at the 989 TFLOP/s bf16 tensor-core peak), so the
// bound is memory. At T=512 the operations grow with T^2 and the bound
// moves toward the tensor cores.
//
// Design: one block of 256 threads per (b*h, 64-row q tile); the k
// dimension, a sequential grid axis on the TPU, is a loop inside the block.
// The q tile and each k/v tile are staged in shared memory as fp32, rows
// padded by one float so that the strided reads below hit distinct banks.
// Each thread owns a 4 x (BK/16) piece of the score tile and a 4 x (D/16)
// piece of the output accumulator over the SAME four rows, so the running
// max, sum and the rescale factor of those rows stay in registers; the row
// reductions are shuffles within the 16 lanes that share the rows. P goes
// through shared memory to feed the P.V product. Causal calls stop at the
// last k tile that meets the diagonal and mask inside it. The products
// run as fp32 FMAs on the CUDA cores — exact to the reference's fp32
// arithmetic, and well short of the bound; wgmma/TMA tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // q rows per block: 16 row groups x 4 rows

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

// P rounded to v's type (identity for fp32), returned as fp32
template <typename T> __device__ __forceinline__ float round_to(float p) {
  return to_f32(from_f32<T>(p));
}

template <int D>
__host__ __device__ constexpr int k_tile() { return D <= 128 ? 64 : 32; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (D + 1) +
          2 * static_cast<size_t>(k_tile<D>()) * (D + 1) +
          static_cast<size_t>(kBQ) * (k_tile<D>() + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk,
                 int64_t qsb, int64_t qst, int64_t qsh,
                 int64_t ksb, int64_t kst, int64_t ksh,
                 int64_t vsb, int64_t vst, int64_t vsh,
                 int64_t osb, int64_t ost, int64_t osh,
                 float scale, int causal) {
  constexpr int BK = k_tile<D>();
  constexpr int RI = kBQ / 16;  // rows per thread
  constexpr int CJ = BK / 16;   // score columns per thread
  constexpr int DJ = D / 16;    // output columns per thread
  constexpr int LD = D + 1;     // padded smem row of q/k/v
  constexpr int LP = BK + 1;    // padded smem row of P

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column lane within a row group
  const int ty = tid >> 4;  // row group: rows ty + 16 * i
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBQ;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int t = q0 + r;
    Qs[r * LD + c] = t < Tq ? to_f32(qb[t * qst + c]) : 0.f;
  }

  float acc[RI][DJ];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kend = causal ? min(Tk, q0 + kBQ) : Tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      const int t = k0 + r;
      const bool in = t < Tk;
      Ks[r * LD + c] = in ? to_f32(kb[t * kst + c]) : 0.f;
      Vs[r * LD + c] = in ? to_f32(vb[t * vst + c]) : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Tk && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing valid yet keeps p = 0 instead of exp(nan)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_use);
        ps += p;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Tq) {
      const float lc = fmaxf(l[i], 1e-30f);
      T* orow = o + b * osb + row * ost + h * osh;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        orow[tx + 16 * j] = from_f32<T>(acc[i][j] / lc);
      if (tx == 0) lse[static_cast<int64_t>(bh) * Tq + row] = m[i] + logf(lc);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Tq, int Tk, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int H, int Tq, int Tk, int D, const long long* st,
             float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                            stream);
    case 192:
      return launch<T, 192>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Tq, H, D], k/v [B, Tk, H, D], o [B, Tq, H, D]: element strides over
// (b, t, h) in `strides` as q, k, v, o triples; the last dim is contiguous.
// lse: fp32 [B, H, Tq] contiguous. dtype 0 = fp32, 1 = bf16.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int dl4j_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int Tq, int Tk, int D,
                                        const long long* strides, float scale,
                                        int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((Tq + kBQ - 1) / kBQ > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, lse, B, H, Tq, Tk, D, strides, scale,
                           causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, lse, B, H, Tq, Tk, D, strides,
                                   scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
