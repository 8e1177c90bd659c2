// Shared device helpers of the AB-Sparse Hopper kernels: the sortable-u32
// encoding of f32 scores, the INT4/INT8 store dequant, the one-warp row
// scoring shared by the fused and the staged decode, block reductions, the
// exact top-k threshold search (lax.top_k's lowest-index tie order) and
// 16-byte cp.async copies into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ABS_NEG_INF (-1e30f)
#define ABS_POS_INF (1e30f)

namespace absparse {

constexpr int NT = 256;               // threads per block of every kernel
constexpr int NWARPS = NT / 32;
constexpr int GMAX = 8;               // largest GQA group handled

// f32 -> u32 whose unsigned order is the float order (sign bit flipped for
// non-negatives, all bits flipped for negatives).
__device__ __forceinline__ uint32_t to_sortable(float x) {
  int32_t i = __float_as_int(x);
  int32_t mask = (i >> 31) | (int32_t)0x80000000;
  return (uint32_t)(i ^ mask);
}

// Inverse of to_sortable.
__device__ __forceinline__ float from_sortable(uint32_t u) {
  return __uint_as_float(u ^ ((u & 0x80000000u) ? 0x80000000u : 0xffffffffu));
}

// Channel c of one packed store row, dequantized: INT4 split-half (byte j
// holds channels j and j + Dp/2 as low/high nibbles), INT8, or raw f32.
// Multiply and add are rounded separately, as the plain version computes
// them (no fused multiply-add).
__device__ __forceinline__ float dequant(const uint8_t* row, int c, int Dp,
                                         int bits, bool sym, float scale,
                                         float zero) {
  if (bits == 0) return reinterpret_cast<const float*>(row)[c];
  float q;
  if (bits == 4) {
    const int half = Dp >> 1;
    q = (c < half) ? (float)(row[c] & 0xF) : (float)(row[c - half] >> 4);
  } else {
    q = (float)row[c];
  }
  if (sym) {
    const float qhi = (float)((1 << (bits - 1)) - 1);
    return __fmul_rn(__fsub_rn(q, qhi), scale);
  }
  return __fadd_rn(__fmul_rn(q, scale), zero);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block score of one packed store row against its head's GQA group of rank
// queries, computed by one warp: lane l takes channels l, l + 32, ...
// (dequant, then one fused multiply-add per group row), a butterfly
// warp_sum per group row, then the max over the group.  Every lane returns
// the score.  The summation order does not depend on the row's position,
// so identical rows score identically.  The staged scoring kernel and the
// fused decode kernel both score through this one function, so their
// scores are bitwise equal.  rq: [g, Dp] (row stride Dp); scale / zero:
// the head's [Dp] affine parameters (not read for an f32 store, bits 0).
__device__ __forceinline__ float score_row(const uint8_t* row, const float* rq,
                                           int g, int Dp, int bits, bool sym,
                                           const float* scale,
                                           const float* zero) {
  const int lane = threadIdx.x & 31;
  float acc[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) acc[gi] = 0.f;
  for (int c = lane; c < Dp; c += 32) {
    const float x = bits == 0
        ? reinterpret_cast<const float*>(row)[c]
        : dequant(row, c, Dp, bits, sym, scale[c], zero[c]);
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi)
      if (gi < g) acc[gi] = fmaf(x, rq[gi * Dp + c], acc[gi]);
  }
  float best = ABS_NEG_INF;
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi < g) {
      const float v = warp_sum(acc[gi]);
      best = gi == 0 ? v : fmaxf(best, v);
    }
  }
  return best;
}

// Sum of one int per thread over the block; every thread gets the total.
// red: shared scratch of NWARPS ints.  Must be reached by all threads.
__device__ __forceinline__ int block_sum_int(int v, int* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum_int(v);
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  int tot = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) tot += red[w];
  return tot;
}

// Exclusive rank of this thread's flag among the block's set flags (thread
// order == index order); *total gets the number of set flags.
__device__ __forceinline__ int block_excl_scan(bool f, int* red, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, f);
  const int in_warp = __popc(m & ((1u << lane) - 1u));
  __syncthreads();
  if (lane == 0) red[wid] = __popc(m);
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    const int c = red[w];
    if (w < wid) off += c;
    tot += c;
  }
  *total = tot;
  return off + in_warp;
}

// Exact k-th largest of s[0..n) as a sortable u32 (32-step binary search on
// the count of entries >= candidate), plus the count strictly above it.
// Selecting every entry above the threshold and the first (k - n_gt) ties
// in index order reproduces lax.top_k's selected set.
__device__ __forceinline__ uint32_t topk_threshold(const float* s, int n, int k,
                                                   int* red, int* n_gt) {
  uint32_t t = 0;
  for (int i = 0; i < 32; ++i) {
    const uint32_t cand = t | (1u << (31 - i));
    int cnt = 0;
    for (int j = threadIdx.x; j < n; j += NT) cnt += to_sortable(s[j]) >= cand;
    cnt = block_sum_int(cnt, red);
    if (cnt >= k) t = cand;
  }
  int gt = 0;
  for (int j = threadIdx.x; j < n; j += NT) gt += to_sortable(s[j]) > t;
  *n_gt = block_sum_int(gt, red);
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared; zero-filled (nothing read)
// when !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// Make this thread's generic-proxy shared-memory writes (cp.async
// included) visible to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

}  // namespace absparse
