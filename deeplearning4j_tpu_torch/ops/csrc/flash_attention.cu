// FlashAttention forward for Hopper (sm_90a): a tensor-core route for bf16,
// a 3xTF32 tensor-core route for fp32, and a CUDA-core route for the calls
// whose 16-byte copies would not align.
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
//   a row with nothing valid yet keeps p = 0 (m_use = 0 while m = -inf);
//   P is rounded to v's type before the P.V product, as the reference does
//   o = acc / max(l, 1e-30)  -> [B, Tq, H, D] in q's type
//   lse = m + log(max(l, 1e-30)) -> fp32 [B, H, Tq]
// Every route uses the same k tile per D (k_tile<D>: 64 for D <= 128, 32
// above), so P rounds at the same running max in all and in the plain
// version (`flash_k_tile`). The CUDA-core route takes p = expf(s - m); the
// tensor-core routes fold log2e into the scale, p = 2^(dot * scale * log2e
// - m * log2e) (one FMA and one MUFU.EX2), which moves lse by about
// |m| * 1e-7, inside the 1e-5 that chip_smoke.py holds it to on every case.
//
// What bounds it on an H100: at the serving path's B=32, T=128, H=12, D=64
// bf16 it must move 25.3 MB (q, k, v, o once each, lse) for 1.6 GFLOP, so
// the bound is memory (7.6 us at 3.35 TB/s). At T=512 it moves 101.5 MB
// (30 us) for 25.8 GFLOP (26 us at the 989 TFLOP/s bf16 tensor-core peak):
// the two bounds meet, and the kernel must run its products on the tensor
// cores and keep a copy in flight to approach either.
//
// Tensor-core route (`flash_fwd_kernel_tc<D>`, bf16, FlashAttention-2
// shape):
// - One block of 8 warps per (128-row q tile, b*h), a 1-D grid with the q
//   tile fastest, so the blocks that share one head's k/v run together and
//   find it in L2. Warp w owns q rows 16w..16w+15 of the tile. At D=64 the
//   block asks for two blocks an SM (`tc_min_blocks`), which caps registers
//   at 128 with no spill. Other shapes timed slower on an H100 at the
//   serving shapes (B=32, H=12, D=64, T=128 and 512): 64 rows on 4 warps
//   (twice the k/v copies from L2), 256 rows on 16 warps, and 32 rows a
//   warp (two m-tiles sharing each K/V fragment, which halves the ldmatrix
//   traffic a product, but hit the register limit and spilled). So one
//   shape serves every D.
// - Copies: `cp.async.cg` 16-byte chunks into shared memory (src-size 0
//   zero-fills rows past T), rows of D/8 chunks with chunk c of row r
//   stored at c ^ (r & 7), so the 8 row addresses of every `ldmatrix`
//   phase land in 8 distinct bank groups. K and V are double-buffered with
//   one barrier a tile: after it, tile j is visible to every warp and every
//   warp is done with tile j - 1, so tile j + 1's copy goes into that
//   buffer and is in flight while tile j's math runs. Q is copied once.
// - S = Q K^T with `mma.sync.m16n8k16` bf16 -> fp32: Q's A fragments come
//   from `ldmatrix.x4` (for D <= 128 once, kept in registers for the whole
//   k loop; for D = 192 and 256 re-read from shared memory each tile, as
//   the A fragments (48 or 64 registers) on top of the accumulator (96 or
//   128) would not fit), K's B fragments from `ldmatrix.x4`, all of a
//   d step's fragments loaded before its products.
// - The softmax runs on the accumulator fragments: each thread holds two
//   rows (g and g + 8 of its warp's 16) of every m16n8 tile, so the row
//   max is a max over the thread's values and then over the four lanes of
//   its quad (`__shfl_xor_sync` 1, 2). The running sum stays per thread
//   and is summed over the quad once, after the loop (alpha is the same
//   across a quad). Masks (-inf) are applied only on a tile that crosses
//   Tk or the causal diagonal; a causal warp skips tiles wholly above its
//   rows, and a causal block stops after the tile that holds its last
//   row's diagonal.
// - P.V: P is packed to bf16 pairs in registers and is the A operand as it
//   stands (the C layout of n-tiles 2i and 2i+1 of m16n8 is the A layout of
//   m16n8k16 for key step i); V's B fragments come from `ldmatrix.x4.trans`.
//   Nothing of P goes through shared memory.
// - Epilogue: o = acc / max(l, 1e-30) as bf16 pairs into the warp's own
//   (now dead) Q rows of shared memory, then 16-byte coalesced stores; lse
//   from lane 0 of each quad.
// - k tile, shared memory and registers (`ptxas -v`, printed by
//   chip_smoke.py) per D: D=64 64 keys, 48 KB, 128 registers; D=128 64,
//   96 KB, 216; D=192 32, 96 KB, 216; D=256 32, 128 KB, 250. No D spills.
// - Why mma.sync and not wgmma/TMA: at the serving shapes (D=64, T=128-512)
//   a block does a few 64x64x64 products per tile, between the memory bound
//   and the compute ridge, and warp MMA fed by cp.async was the simpler
//   first step. wgmma needs 64-row warpgroup tiles with descriptor-laid-out
//   shared memory, and TMA a descriptor per call for the strided thirds of
//   the QKV product; what they would still add is in ROADMAP.md.
// - Takes: bf16, every base pointer 16-byte aligned, and the b, t, h
//   strides multiples of 8 elements (each 16-byte chunk aligned); the
//   wrapper's gate checks that and never copies.
//
// 3xTF32 route (`flash_fwd_kernel_x3<D>`, fp32): replaces the CUDA-core
// kernel below for every aligned fp32 call (the served fp32 BERT-base's
// QKV thirds, the Keras encoder, the fp32 ring).
// - What bounds it: at [32, 128, 12, 64] fp32 it must move 50.5 MB (15 us
//   at 3.35 TB/s) for 1.61 GFLOP; fp32 FMAs on the CUDA cores take 24 us
//   at 67 TFLOP/s, so the CUDA-core kernel was compute bound and 1.3-1.5x
//   slower than fp32 SDPA, which runs CUTLASS's 3xTF32 on the tensor
//   cores. Three TF32 products (3 x 1.61 GFLOP at 495 TFLOP/s: 10 us) put
//   the bound back on memory at T=128; at T=1024 the products bound it.
// - Why three products: one TF32 product keeps 11 significant bits of each
//   operand (a score off by ~5e-4, far outside the fp32 route's 2e-5 on o
//   and 1e-5 on lse). Each operand x is split into big = tf32(x) (round to
//   nearest, ties away, as `cvt.rna.tf32.f32`) and small = x - big, whose
//   low 13 bits the tensor core drops, so x = big + small to 2^-21 |x|,
//   and a.b = a_small.b_big + a_big.b_small + a_big.b_big (the small.small
//   term, ~2^-22, dropped), each an `mma.sync.m16n8k8` TF32 product
//   accumulated in fp32, the small terms first (CUTLASS's
//   OpMultiplyAddFastF32). The split runs in registers after each load
//   (Q, K, P and V, per warp) and costs more instructions than the
//   products: it, not the tensor cores, sets the pace.
// - The tensor core's fp32 accumulation truncates, so a score chained
//   over all D/8 d steps drifts with D: for D > 128 the scores are chained
//   4 d steps at a time and the chains summed in fp32 (x3_score_chain).
// - Shape: at D=64 4 warps of 32 q rows (two m-tiles, so each K and V
//   fragment's split serves two products), two blocks an SM; 8 warps of
//   16 rows at D=128, 4 warps of 16 above, one block an SM. Each block
//   holds 128 (64 above D=128) q rows, and fp32 Q and double-buffered K
//   and V fit in shared memory (96, 192, 144, 192 KB for D = 64, 128, 192,
//   256). The k tile is k_tile<D>. The grid and the causal skips are the
//   bf16 route's.
// - Copies: `cp.async.cg` 16-byte chunks (4 floats), rows of D/4 chunks,
//   chunk c of row r stored at c ^ (r & 7); K and V double-buffered with
//   one barrier a tile, Q copied once.
// - S = Q K^T: Q's and K's fragments from `ldmatrix.x4` (a tf32 word read
//   as a pair of 16-bit halves: lane l gets row l/4, word l%4, the m16n8k8
//   A and B layout), split in registers after each load. Q is re-read
//   from shared memory each tile: its split fragments would not fit
//   beside the score and output accumulators.
// - P.V with no shuffle: the m16n8 accumulator gives a lane keys 2c and
//   2c+1 of each 8-key step, and P's A operand wants k slots c and c+4, so
//   key 2c takes slot c and key 2c+1 slot c+4; V's B fragments follow:
//   b0 = V[2c][n], b1 = V[2c+1][n]. The accumulator registers are then the
//   A operand as they stand. The output columns are permuted too: n-tile
//   j's column n is d = 4 (n + 8 (j / 4)) + j % 4, so a lane reads V a
//   row at a time with 16-byte shared loads (4 n-tiles each) and holds 8
//   contiguous d of each of its two rows at the end, stored as two 16-byte
//   writes.
// - Registers: every shared load is a lane's offset plus an immediate, and
//   the epilogue recomputes its indices from blockIdx, so little stays
//   live across the k loop; no D spills (`ptxas -v`, printed by
//   chip_smoke.py, which fails on a spill at D=64).
// - Softmax and epilogue as on the bf16 route, with P kept in fp32.
// - Takes: fp32, every base pointer 16-byte aligned, the b, t, h strides
//   multiples of 4 elements; the wrapper's gate checks that and never
//   copies.
//
// CUDA-core route (`flash_fwd_kernel`, fp32 and bf16 that the tensor-core
// routes do not take): one block of 256 threads per (b*h, 64-row q tile).
// The q tile and each k/v tile are staged in shared memory as fp32, rows padded
// by one float so that the strided reads below hit distinct banks. Each
// thread owns a 4 x (BK/16) piece of the score tile and a 4 x (D/16) piece
// of the output accumulator over the SAME four rows, so the running max,
// sum and the rescale factor of those rows stay in registers; the row
// reductions are shuffles within the 16 lanes that share the rows. P goes
// through shared memory to feed the P.V product. Causal calls stop at the
// last k tile that meets the diagonal and mask inside it. The products run
// as fp32 FMAs on the CUDA cores: exact to the reference's fp32 arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;  // CUDA-core route
constexpr int kBQ = 64;        // q rows per block of the CUDA-core route

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

// ---------------------------------------------------------------------------
// Tensor-core route (bf16)

constexpr float kLog2e = 1.4426950408889634f;

// shared memory of a block with a q tile of BQ rows
template <int D, int BQ>
constexpr size_t tc_smem_bytes() {
  // Q, then two K buffers, then two V buffers, all bf16
  return 2 * (static_cast<size_t>(BQ) * D +
              4 * static_cast<size_t>(k_tile<D>()) * D);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a tile of D/8 chunks a row,
// chunk index XOR-swizzled with the row's low three bits
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((r * (D / 8) + (c ^ (r & 7))) * 16);
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (MUFU.EX2; subnormal results flush to zero, exp2(-inf) = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// cp.async ROWS rows of D bf16 (row t at base + t * st) into a swizzled
// tile; rows at or past tmax are zero-filled and read nothing
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* base,
                                          int64_t st, int t0, int tmax) {
  constexpr int kChunks = D / 8;
  static_assert((ROWS * kChunks) % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const int t = t0 + r;
    const bool ok = t < tmax;
    cp_async_16(tile + swz<D>(r, c), ok ? base + t * st + c * 8 : base, ok);
  }
}

// warps of a tensor-core block, 16 q rows each
constexpr int kTcWarps = 8;

// at D=64 a block asks for two blocks (16 warps) an SM: 128 registers a
// thread, with no spill (unbounded, ptxas takes 137-156)
template <int D>
constexpr int tc_min_blocks() { return D == 64 ? 2 : 1; }

template <int D>
__global__ void __launch_bounds__(32 * kTcWarps, tc_min_blocks<D>())
flash_fwd_kernel_tc(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int H, int Tq, int Tk, int nq,
                    int64_t qsb, int64_t qst, int64_t qsh,
                    int64_t ksb, int64_t kst, int64_t ksh,
                    int64_t vsb, int64_t vst, int64_t vsh,
                    int64_t osb, int64_t ost, int64_t osh,
                    float scale, int causal) {
  constexpr int BQ = 16 * kTcWarps;
  constexpr int NT = 32 * kTcWarps;
  constexpr int BK = k_tile<D>();
  constexpr int KT = BK / 8;   // n-tiles of the score tile
  constexpr int DT = D / 8;    // n-tiles of the output
  constexpr bool kQInRegs = D <= 128;
  constexpr uint32_t kTileBytes = BK * D * 2;

  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t sQ = smem_addr(tc_smem);
  const uint32_t sK = sQ + BQ * D * 2;
  const uint32_t sV = sK + 2 * kTileBytes;

  const int qt = static_cast<int>(blockIdx.x % nq);
  const int bh = static_cast<int>(blockIdx.x / nq);
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // rows g and g + 8 of the warp's 16
  const int t4 = lane & 3;   // columns 2 * t4, 2 * t4 + 1 of each n-tile
  const int wrow0 = q0 + 16 * warp;

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  const int kend = causal ? min(Tk, q0 + BQ) : Tk;
  const int ntiles = (kend + BK - 1) / BK;

  load_tile<D, BQ, NT>(sQ, qb, qst, q0, Tq);
  load_tile<D, BK, NT>(sK, kb, kst, 0, Tk);
  load_tile<D, BK, NT>(sV, vb, vst, 0, Tk);
  cp_async_commit();

  // the A fragment of d step kk from the warp's 16 Q rows
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
    ldsm_x4(sQ + swz<D>(16 * warp + (lane & 15), 2 * kk + (lane >> 4)), a);
  };
  uint32_t qf[kQInRegs ? D / 16 : 1][4];
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    const uint32_t kt = sK + (j & 1) * kTileBytes;
    const uint32_t vt = sV + (j & 1) * kTileBytes;
    cp_async_wait<0>();  // tile j, this thread's copies
    // tile j visible to every warp; every warp is done with tile j - 1,
    // whose buffer the next copy refills
    __syncthreads();
    if (j + 1 < ntiles) {
      const uint32_t nb = ((j + 1) & 1) * kTileBytes;
      load_tile<D, BK, NT>(sK + nb, kb, kst, k0 + BK, Tk);
      load_tile<D, BK, NT>(sV + nb, vb, vst, k0 + BK, Tk);
      cp_async_commit();
    }

    if constexpr (kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) q_frag(kk, qf[kk]);
      }
    }

    if (causal && k0 > wrow0 + 15) continue;  // wholly above the diagonal

    float s[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        q_frag(kk, a);
      }
      // every fragment of the step first, so the loads are in flight
      // together (the asm statements keep their order)
      uint32_t bf[KT / 2][4];  // keys 16np..+7, +8..+15 x d 16kk..+7, +8..
#pragma unroll
      for (int np = 0; np < KT / 2; ++np)
        ldsm_x4(kt + swz<D>(16 * np + (lane & 7) + ((lane >> 4) << 3),
                            2 * kk + ((lane >> 3) & 1)),
                bf[np]);
#pragma unroll
      for (int np = 0; np < KT / 2; ++np) {
        mma_bf16(s[2 * np], a, bf[np][0], bf[np][1]);
        mma_bf16(s[2 * np + 1], a, bf[np][2], bf[np][3]);
      }
    }

    if (k0 + BK > Tk || (causal && k0 + BK - 1 > wrow0)) {
#pragma unroll
      for (int n = 0; n < KT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * n + 2 * t4 + (e & 1);
          const int row = wrow0 + g + 8 * (e >> 1);
          if (col >= Tk || (causal && col > row)) s[n][e] = -INFINITY;
        }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float mb[2], alpha[2];  // mb: the max in log2 units
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // max(dot) * scale = max(dot * scale): rounding is monotonic
      const float m_new = fmaxf(m[i], mx[i] * scale);
      // a row with nothing valid yet keeps p = 0 instead of exp(nan)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = expf(m[i] - m_use);
      mb[i] = m_use * kLog2e;
      m[i] = m_new;
    }
    const float scale_log2 = scale * kLog2e;
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // exp(dot * scale - m) = 2^(dot * scale * log2e - m * log2e): one
        // FMA and one MUFU.EX2
        const float p = ex2(fmaf(s[n][e], scale_log2, -mb[e >> 1]));
        s[n][e] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ps[i];
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // fragments four d steps at a time, loaded ahead of their products
      constexpr int G = D / 16 < 4 ? D / 16 : 4;
#pragma unroll
      for (int d0 = 0; d0 < D / 16; d0 += G) {
        uint32_t bf[G][4];  // keys 16kk..+7, +8..+15 x d 16dp..+7, +8..+15
#pragma unroll
        for (int dp = 0; dp < G; ++dp)
          ldsm_x4_t(vt + swz<D>(16 * kk + (lane & 7) +
                                    (((lane >> 3) & 1) << 3),
                                2 * (d0 + dp) + (lane >> 4)),
                    bf[dp]);
#pragma unroll
        for (int dp = 0; dp < G; ++dp) {
          mma_bf16(acc[2 * (d0 + dp)], a, bf[dp][0], bf[dp][1]);
          mma_bf16(acc[2 * (d0 + dp) + 1], a, bf[dp][2], bf[dp][3]);
        }
      }
    }
  }

  // stage o in the warp's own Q rows (no other warp reads them), then
  // 16-byte stores of whole rows
  float lc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lc[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;
      const uint32_t val =
          pack_bf16(acc[n][2 * i] / lc[i], acc[n][2 * i + 1] / lc[i]);
      *reinterpret_cast<uint32_t*>(tc_smem + swz<D>(r, n) + 4 * t4) = val;
    }
  if (t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow0 + g + 8 * i;
      if (row < Tq)
        lse[static_cast<int64_t>(bh) * Tq + row] = m[i] + logf(lc[i]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * DT / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / DT;
    const int c = idx - r * DT;
    const int row = wrow0 + r;
    if (row < Tq)
      *reinterpret_cast<uint4*>(o + b * osb + row * ost + h * osh + c * 8) =
          *reinterpret_cast<const uint4*>(tc_smem + swz<D>(16 * warp + r, c));
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int Tq, int Tk, const long long* st, float scale,
              int causal, cudaStream_t stream) {
  constexpr int BQ = 16 * kTcWarps;
  constexpr size_t smem = tc_smem_bytes<D, BQ>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_tc<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (Tq + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(nq) * B * H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel_tc<D><<<static_cast<unsigned>(blocks), 32 * kTcWarps,
                           smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Tq, Tk, nq, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// what the tensor-core routes take: 16-byte-aligned bases, and b, t, h
// strides (of the dims longer than 1) multiples of `per_chunk` elements
// (8 bf16 or 4 fp32: one 16-byte chunk)
bool chunks_aligned(const void* const* ptrs, int B, int H, int Tq, int Tk,
                    const long long* st, int per_chunk) {
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15u) return false;
  for (int i = 0; i < 4; ++i) {
    const int T = i == 0 || i == 3 ? Tq : Tk;
    if ((B > 1 && st[3 * i] % per_chunk) ||
        (T > 1 && st[3 * i + 1] % per_chunk) ||
        (H > 1 && st[3 * i + 2] % per_chunk))
      return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// 3xTF32 route (fp32)

// warps of a block and m-tiles (16 q rows each) a warp: at D=64 4 warps
// of 32 rows, two blocks an SM; 8 warps of 16 rows at D=128, 4 above
template <int D>
__host__ __device__ constexpr int x3_warps() { return D == 128 ? 8 : 4; }
template <int D>
__host__ __device__ constexpr int x3_mtiles() { return D == 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int x3_rows() {
  return 16 * x3_mtiles<D>() * x3_warps<D>();
}
template <int D>
__host__ __device__ constexpr int x3_min_blocks() { return D == 64 ? 2 : 1; }

// d steps of Q.K^T accumulated in one tensor-core chain
template <int D>
__host__ __device__ constexpr int x3_score_chain() {
  return D <= 128 ? D / 8 : 4;
}

template <int D>
constexpr size_t x3_smem_bytes() {
  // Q, then two K buffers, then two V buffers, all fp32
  return 4 * (static_cast<size_t>(x3_rows<D>()) * D +
              4 * static_cast<size_t>(k_tile<D>()) * D);
}

// byte offset of 16-byte chunk c of row r in an fp32 tile of D/4 chunks a
// row, chunk index XOR-swizzled with the row's low three bits
template <int D>
__device__ __forceinline__ uint32_t swz_f32(int r, int c) {
  return static_cast<uint32_t>((r * (D / 4) + (c ^ (r & 7))) * 16);
}

// cp.async ROWS rows of D floats (row t at base + t * st) into a swizzled
// tile; rows at or past tmax are zero-filled and read nothing
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_f32(uint32_t tile, const float* base,
                                              int64_t st, int t0, int tmax) {
  constexpr int kChunks = D / 4;
  static_assert((ROWS * kChunks) % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const int t = t0 + r;
    const bool ok = t < tmax;
    cp_async_16(tile + swz_f32<D>(r, c), ok ? base + t * st + c * 4 : base,
                ok);
  }
}

// blockIdx.x read afresh: the epilogue's indices are recomputed from it,
// so none is carried (and, at D=64, spilled) across the k loop
__device__ __forceinline__ int block_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(r));
  return static_cast<int>(r);
}

// four floats from shared memory (16-byte aligned)
__device__ __forceinline__ void lds_x4(uint32_t addr, float (&r)[4]) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(r[0]), "=f"(r[1]), "=f"(r[2]), "=f"(r[3])
               : "r"(addr));
}

// x split as big + small: big = x rounded to TF32 (10 mantissa bits) to
// nearest, ties away from zero (what `cvt.rna.tf32.f32` gives, in two
// integer operations where the cvt compiles to four); small = x - big,
// exact in fp32, whose low 13 bits the tensor core drops (round toward
// zero), so x = big + small to 2^-21 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b to fp32 accuracy from the split operands: the two small
// terms first, then big * big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}

template <int D>
__global__ void __launch_bounds__(32 * x3_warps<D>(), x3_min_blocks<D>())
flash_fwd_kernel_x3(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int H, int Tq, int Tk, int nq,
                    int64_t qsb, int64_t qst, int64_t qsh,
                    int64_t ksb, int64_t kst, int64_t ksh,
                    int64_t vsb, int64_t vst, int64_t vsh,
                    int64_t osb, int64_t ost, int64_t osh,
                    float scale, int causal) {
  constexpr int MT = x3_mtiles<D>();
  constexpr int BQ = x3_rows<D>();
  constexpr int NT = 32 * x3_warps<D>();
  constexpr int BK = k_tile<D>();
  constexpr int KT = BK / 8;   // n-tiles of the score tile, k steps of P.V
  constexpr int DT = D / 8;    // k steps of Q.K^T, n-tiles of the output
  constexpr int SG = x3_score_chain<D>();
  constexpr uint32_t kRow = D / 4 * 16;   // bytes of a row
  constexpr uint32_t kTileBytes = BK * kRow;

  extern __shared__ __align__(128) unsigned char x3_smem[];
  const uint32_t sQ = smem_addr(x3_smem);
  const uint32_t sK = sQ + BQ * kRow;
  const uint32_t sV = sK + 2 * kTileBytes;

  const int qt = static_cast<int>(blockIdx.x % nq);
  const int bh = static_cast<int>(blockIdx.x / nq);
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // rows g and g + 8 of each m-tile
  const int t4 = lane & 3;   // k slots t4 and t4 + 4; keys 2 t4, 2 t4 + 1
  const int wrow0 = q0 + 16 * MT * warp;   // m-tile mt: rows + 16 mt

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  const int kend = causal ? min(Tk, q0 + BQ) : Tk;
  const int ntiles = (kend + BK - 1) / BK;

  // Shared-memory offsets, so that every load below is a lane's register
  // plus an immediate (and, for Q and K, one XOR): few registers live
  // across the k loop. Each row a lane hands ldmatrix has r & 7 == lane & 7,
  // so its swizzled chunk for d step kk, (2 kk + hi) ^ (lane & 7), is
  // 8 (kk / 4) + 2 ((kk % 4) ^ sw) + (hi ^ (lane & 1)) with sw = (lane >> 1)
  // & 3. V's rows for key step kp are 8 kp + 2 t4 (+1), chunk (g + 8 i) ^
  // (2 t4 (+1)) = (g ^ (2 t4 (+1))) + 8 i.
  const uint32_t sw = (lane >> 1) & 3;
  const uint32_t q_base = sQ + (16 * MT * warp + (lane & 15)) * kRow +
                          (((lane >> 4) ^ lane) & 1) * 16;
  const uint32_t k_row = ((lane & 7) + ((lane >> 4) << 3)) * kRow +
                         (((lane >> 3) ^ lane) & 1) * 16;
  const uint32_t v_off0 = 2 * t4 * kRow + (g ^ (2 * t4)) * 16;

  load_tile_f32<D, BQ, NT>(sQ, qb, qst, q0, Tq);
  load_tile_f32<D, BK, NT>(sK, kb, kst, 0, Tk);
  load_tile_f32<D, BK, NT>(sV, vb, vst, 0, Tk);
  cp_async_commit();

  float acc[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  float m[MT][2], l[MT][2];  // l: this thread's share of the row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = -INFINITY;
      l[mt][i] = 0.f;
    }

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    const uint32_t kt = sK + (j & 1) * kTileBytes;
    const uint32_t vt = sV + (j & 1) * kTileBytes;
    cp_async_wait<0>();  // tile j, this thread's copies
    // tile j visible to every warp; every warp is done with tile j - 1,
    // whose buffer the next copy refills
    __syncthreads();
    if (j + 1 < ntiles) {
      const uint32_t nb = ((j + 1) & 1) * kTileBytes;
      load_tile_f32<D, BK, NT>(sK + nb, kb, kst, k0 + BK, Tk);
      load_tile_f32<D, BK, NT>(sV + nb, vb, vst, k0 + BK, Tk);
      cp_async_commit();
    }

    // wholly above the diagonal
    if (causal && k0 > wrow0 + 16 * MT - 1) continue;

    // the scores, chained in the tensor cores SG d steps at a time and
    // summed in fp32 between chains (the accumulator's rounding drifts
    // along a chain); each K fragment's split serves the warp's MT m-tiles
    float s[MT][KT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < KT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kg = 0; kg < DT / SG; ++kg) {
      float c[MT][KT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < KT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[mt][n][e] = 0.f;
#pragma unroll
      for (int kk = kg * SG; kk < (kg + 1) * SG; ++kk) {
        // Q rows of each m-tile x d 8kk..8kk+7, then keys 16np..16np+15 x
        // the same d (n-tiles 2np and 2np+1), loaded as they are used
        const uint32_t dq = (((kk & 3) ^ sw) << 5) + (kk >> 2) * 128;
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4(q_base + mt * 16 * kRow + dq, a);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(a[e]), ab[mt][e], as[mt][e]);
        }
#pragma unroll
        for (int np = 0; np < KT / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4(kt + k_row + dq + np * 16 * kRow, bf);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t bb[2], bs[2];
            split_tf32(__uint_as_float(bf[2 * half]), bb[0], bs[0]);
            split_tf32(__uint_as_float(bf[2 * half + 1]), bb[1], bs[1]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_3xtf32(c[mt][2 * np + half], ab[mt], as[mt], bb, bs);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < KT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] += c[mt][n][e];
    }

    if (k0 + BK > Tk || (causal && k0 + BK - 1 > wrow0)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < KT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * n + 2 * t4 + (e & 1);
            const int row = wrow0 + 16 * mt + g + 8 * (e >> 1);
            if (col >= Tk || (causal && col > row)) s[mt][n][e] = -INFINITY;
          }
    }

    const float scale_log2 = scale * kLog2e;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < KT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
      }
      float mb[2], alpha[2];  // mb: the max in log2 units
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[mt][i], mx[i] * scale);
        // a row with nothing valid yet keeps p = 0 instead of exp(nan)
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = expf(m[mt][i] - m_use);
        mb[i] = m_use * kLog2e;
        m[mt][i] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < KT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[mt][n][e], scale_log2, -mb[e >> 1]));
          s[mt][n][e] = p;
          ps[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[mt][i] = l[mt][i] * alpha[i] + ps[i];
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        acc[mt][n][0] *= alpha[0];
        acc[mt][n][1] *= alpha[0];
        acc[mt][n][2] *= alpha[1];
        acc[mt][n][3] *= alpha[1];
      }
    }

#pragma unroll
    for (int kp = 0; kp < KT; ++kp) {
      // P's A operand from the accumulator as it stands: key 2 t4 in slot
      // t4 (registers 0 and 2: rows g, g + 8), key 2 t4 + 1 in slot t4 + 4
      uint32_t pb[MT][4], pq[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(s[mt][kp][0], pb[mt][0], pq[mt][0]);
        split_tf32(s[mt][kp][2], pb[mt][1], pq[mt][1]);
        split_tf32(s[mt][kp][1], pb[mt][2], pq[mt][2]);
        split_tf32(s[mt][kp][3], pb[mt][3], pq[mt][3]);
      }
#pragma unroll
      for (int i = 0; i < DT / 4; ++i) {
        // keys 8 kp + 2 t4 and + 1 at d 4 (g + 8i) .. +3: column g of
        // n-tiles 4i .. 4i+3
        const uint32_t vrow = vt + kp * 8 * kRow + i * 128;
        float x0[4], x1[4];
        lds_x4(vrow + v_off0, x0);
        // key 2 t4 + 1: the next row at chunk (g ^ 2 t4) ^ 1, one chunk
        // up or down as bit 4 of v_off0 (that chunk's parity) says
        lds_x4(vrow + v_off0 + kRow + 16 - ((v_off0 >> 3) & 2) * 16, x1);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bb[2], bs[2];
          split_tf32(x0[jj], bb[0], bs[0]);
          split_tf32(x1[jj], bb[1], bs[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3xtf32(acc[mt][4 * i + jj], pb[mt], pq[mt], bb, bs);
        }
      }
    }
  }

  const int bh_e = block_index() / nq;
  const int b_e = bh_e / H;
  float* ob = o + b_e * osb + (bh_e - b_e * H) * osh;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float lc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mt][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      lc[i] = fmaxf(li, 1e-30f);
    }
    if (t4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wrow0 + 16 * mt + g + 8 * i;
        if (row < Tq)
          lse[static_cast<int64_t>(bh_e) * Tq + row] = m[mt][i] + logf(lc[i]);
      }
    }
    // a lane holds, of rows g and g + 8, d 8 t4 + 32 i .. +7 for each i:
    // n-tiles 4i .. 4i+3, columns 2 t4 (d +0..3) and 2 t4 + 1 (d +4..7)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int row = wrow0 + 16 * mt + g + 8 * i2;
      if (row >= Tq) continue;
      float* orow = ob + row * ost;
#pragma unroll
      for (int i = 0; i < DT / 4; ++i) {
        const float4 lo = {acc[mt][4 * i][2 * i2] / lc[i2],
                           acc[mt][4 * i + 1][2 * i2] / lc[i2],
                           acc[mt][4 * i + 2][2 * i2] / lc[i2],
                           acc[mt][4 * i + 3][2 * i2] / lc[i2]};
        const float4 hi = {acc[mt][4 * i][2 * i2 + 1] / lc[i2],
                           acc[mt][4 * i + 1][2 * i2 + 1] / lc[i2],
                           acc[mt][4 * i + 2][2 * i2 + 1] / lc[i2],
                           acc[mt][4 * i + 3][2 * i2 + 1] / lc[i2]};
        float4* dst = reinterpret_cast<float4*>(orow + 8 * t4 + 32 * i);
        dst[0] = lo;
        dst[1] = hi;
      }
    }
  }
}

template <int D>
int launch_x3(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int Tq, int Tk, const long long* st, float scale,
              int causal, cudaStream_t stream) {
  constexpr int BQ = x3_rows<D>();
  constexpr size_t smem = x3_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_x3<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (Tq + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(nq) * B * H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel_x3<D><<<static_cast<unsigned>(blocks), 32 * x3_warps<D>(),
                           smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Tq, Tk, nq, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// CUDA-core route (fp32 and bf16 that the tensor-core routes do not take)

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

int launch_tc_d(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int H, int Tq, int Tk, int D,
                const long long* st, float scale, int causal,
                cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_tc<64>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                           stream);
    case 128:
      return launch_tc<128>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                            stream);
    case 192:
      return launch_tc<192>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                            stream);
    case 256:
      return launch_tc<256>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_x3_d(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int H, int Tq, int Tk, int D,
                const long long* st, float scale, int causal,
                cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_x3<64>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                           stream);
    case 128:
      return launch_x3<128>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                            stream);
    case 192:
      return launch_x3<192>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                            stream);
    case 256:
      return launch_x3<256>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Tq, H, D], k/v [B, Tk, H, D], o [B, Tq, H, D]: element strides over
// (b, t, h) in `strides` as q, k, v, o triples; the last dim is contiguous.
// lse: fp32 [B, H, Tq] contiguous. dtype 0 = fp32, 1 = bf16. route 1 = the
// bf16 tensor-core kernel, 2 = the 3xTF32 kernel (fp32), each taking only
// its dtype, aligned as chunks_aligned says (anything else is refused,
// never rerouted); 0 = the CUDA-core kernel. Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int dl4j_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int Tq, int Tk, int D,
                                        const long long* strides, float scale,
                                        int causal, int dtype, int route,
                                        void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[4] = {q, k, v, o};
  if (route == 1) {
    if (dtype != 1 || !chunks_aligned(ptrs, B, H, Tq, Tk, strides, 8))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_tc_d(q, k, v, o, lse, B, H, Tq, Tk, D, strides, scale,
                       causal, s);
  }
  if (route == 2) {
    if (dtype != 0 || !chunks_aligned(ptrs, B, H, Tq, Tk, strides, 4))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_x3_d(q, k, v, o, lse, B, H, Tq, Tk, D, strides, scale,
                       causal, s);
  }
  if (route != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((Tq + kBQ - 1) / kBQ > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, lse, B, H, Tq, Tk, D, strides, scale,
                           causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, lse, B, H, Tq, Tk, D, strides,
                                   scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
