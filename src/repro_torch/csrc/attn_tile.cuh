// Tensor-core attention tile for Hopper (sm_90a): one warpgroup (128
// threads) owns 64 query rows and runs the flash loop over 64-key tiles
// with wgmma.  The dense flash kernel uses it; the sparse prefill's flash
// loop over selected key tiles is the same tile.
//
// Shared-memory layout of every bf16 tile [ROWS, D] (Q, K and V alike):
// 64-column panels of ROWS rows x 128 bytes, the 16-byte chunks of row r
// XOR-swizzled by r % 8 (the 128-byte swizzle of wgmma and TMA).  Panel p
// starts at p * ROWS * 128 bytes; tiles start on 1024-byte boundaries.
//  - Q and K are the K-major operands of S = Q K^T (the head dimension is
//    contiguous): stride between 8-row groups (SBO) 1024 bytes, the next
//    16 channels 32 bytes further, the next panel ROWS * 128 bytes.
//  - V [keys, D] is the MN-major B operand of O = P V (transpose bit set):
//    SBO 1024 bytes between groups of 8 keys, LBO = one panel (64 * 128
//    bytes for a 64-key tile) between 64-channel halves of D.
//
// Register fragments (per warpgroup, warp w holds rows 16w..16w+15, lane l
// rows l/4 and l/4 + 8): an m64nN f32 accumulator has d[4j + {0,1}] at
// (row l/4, columns 8j + 2(l%4) + {0,1}) and d[4j + {2,3}] at row l/4 + 8.
// That is the A-fragment layout of a register-sourced wgmma, so the
// probabilities of S feed P V with no shuffle: k-step kk (keys 16kk ..
// 16kk + 15) takes d[8kk .. 8kk + 7] as four bf16 pairs.
//
// P in two bf16 halves: P = exp(s - m) is formed and summed (l) in f32,
// then split into hi = bf16(P) and lo = bf16(P - hi), and O accumulates
// hi V + lo V.  One bf16 rounding of P (what FlashAttention does) leaves
// outputs up to 20x the one-bf16-step limit of repro_torch.kernels.parity
// against the f32 plain version (S 4096, logit std 1.5); hi + lo carries
// P to about 16 bits and stays inside it, for half again the tensor-core
// work (6 D instead of 4 D flops per query-key pair).
#pragma once

#include "common.cuh"

namespace absparse {
namespace tile {

constexpr int ROWS_WG = 64;             // query rows of one warpgroup
constexpr int KEYS = 64;                // keys per tile
constexpr float NEG = -1e30f;           // row maximum before any live key

// Byte offset of 16-byte chunk c (channels 8c .. 8c + 7) of row r.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// Rows [0, ROWS) of a row-major [*, D] bf16 array -> swizzled tile at dst,
// by NTHR threads; rows >= rows_valid are zero-filled and not read.
template <int ROWS, int D, int NTHR>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int rows_valid, int tid) {
  constexpr int CPR = D / 8;
  static_assert((ROWS * CPR) % NTHR == 0, "tile chunks must divide evenly");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / NTHR; ++it) {
    const int i = tid + it * NTHR, r = i / CPR, c = i % CPR;
    const bool ok = r < rows_valid;
    cp_async16(dst + swz<ROWS>(r, c), src + (size_t)(ok ? r : 0) * D + c * 8, ok);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving accesses of r across a wgmma issue / wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define ABS_F8(d, i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ABS_F32(d) ABS_F8(d, 0), ABS_F8(d, 8), ABS_F8(d, 16), ABS_F8(d, 24)
#define ABS_F64(d) ABS_F32(d), ABS_F8(d, 32), ABS_F8(d, 40), ABS_F8(d, 48), ABS_F8(d, 56)
#define ABS_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[32] (+)= A[64 x 16] B[16 x 64], A and B from shared memory (K-major).
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ABS_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ABS_F32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] += A[64 x 16] B[16 x 128], A from registers, B MN-major in shared.
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ABS_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A[64 x 16] B[16 x 64], A from registers, B MN-major in shared.
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ABS_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ABS_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ABS_F8
#undef ABS_F32
#undef ABS_F64
#undef ABS_R32

// s = Q K^T for one warpgroup: q_tile / k_tile are the shared addresses of
// the warpgroup's 64 query rows (inside a tile of QROWS rows) and of a
// 64-key tile.  Issues D / 16 wgmma (no commit).
template <int D, int QROWS>
__device__ __forceinline__ void qk(float (&s)[32], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t a = q_rows + (kk >> 2) * (QROWS * 128) + (kk & 3) * 32;
    const uint32_t b = k_tile + (kk >> 2) * (KEYS * 128) + (kk & 3) * 32;
    mma_ss_n64(s, desc(a, 16, 1024), desc(b, 16, 1024), kk > 0);
  }
}

// o += P V over one 64-key tile, P as A fragments p[k-step][4].  Issues 4
// wgmma (no commit).
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&p)[4][4],
                                   uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    const uint64_t b = desc(v_tile + kk * 16 * 128, KEYS * 128, 1024);
    if constexpr (D == 128) mma_rs_n128(o, p[kk], b);
    else mma_rs_n64(o, p[kk], b);
  }
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Online-softmax step of this thread's two rows (h = 0: row l/4, h = 1:
// row l/4 + 8) over one key tile.  s holds raw logits q . k (-inf where
// masked), scale_log2 = D^-1/2 log2(e); m is kept in that base-2 domain.
// On return s holds p = 2^(s scale_log2 - m_new), m the new row maxima, l
// the thread's partial row sums (l * alpha + its p's), alpha the factor
// the output rows must be rescaled by.  A row with no live key so far keeps
// m = NEG and p = 0.
__device__ __forceinline__ void softmax_step(float (&s)[32], float scale_log2,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]) * scale_log2);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], scale_log2, -m[h]));
    sum[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// p (f32, the S accumulator after softmax_step) -> A fragments of
// hi = bf16(p) and lo = bf16(p - hi), one [4] per 16-key k-step.
__device__ __forceinline__ void split_p(const float (&p)[32], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = p[8 * kk + 2 * r], x1 = p[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      hi[kk][r] = bf16x2_bits(h);
      lo[kk][r] = bf16x2_bits(
          __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
    }
}

}  // namespace tile
}  // namespace absparse
