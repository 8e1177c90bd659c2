// Shared device helpers of the AB-Sparse Hopper kernels: the sortable-u32
// encoding of f32 scores, the INT4/INT8 store dequant, the row scoring
// (eight lanes per row) shared by the fused and the staged decode, block
// reductions, the exact top-k threshold (a radix select; lax.top_k's
// lowest-index tie order) and 16-byte cp.async copies into shared memory.
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

// Block scores of packed store rows against their head's GQA group of rank
// queries, max over the group, four rows per warp: lanes 8i .. 8i + 7 (a
// row group, ROW_LANES lanes) score the row `row` each of them passes.
//
// The row is read as 16-byte chunks (4 f32 channels, 16 INT8 channels, or
// 16 INT4 bytes = channels j .. j + 15 in the low nibbles and j + Dp/2 ..
// in the high ones); lane s of the group takes chunks s, s + 8, s + 16, ...
// and issues up to ROW_CPL of its loads before any arithmetic.  It walks
// each chunk in runs of 4 channels ("quads"): an f32 chunk is one quad; an
// INT8 chunk is quads m = 0..3 at channel 16 k + 4 r, an INT4 chunk the
// same with the high-nibble quad at Dp/2 + 16 k + 4 r after each low one,
// where r = (m + s / 2) % 4 rotates the quads so that the group's eight
// float4 reads of the rank queries fall in distinct shared-memory banks.
// Each channel is dequantized (multiply and add rounded separately, as the
// plain version computes them), then one fused multiply-add per group row
// into that lane's sum; the group then adds its lanes with a 3-step
// butterfly (xor 4, 2, 1) and takes the max over the group rows.  Every
// lane of the group returns the row's score.  The order depends only on a
// lane's place in its group and the channel, never on the row's position,
// so identical rows score identically.  The staged scoring kernel and the
// fused decode kernel both score through this one function, so their
// scores are bitwise equal.  All 32 lanes of the warp must call it (a
// group without a row of its own passes any valid row and ignores the
// result).  rq: [g, Dp] in shared memory (16-byte aligned, row stride Dp);
// row, scale and zero 16-byte aligned (scale / zero: the head's [Dp]
// affine parameters, not read for an f32 store, bits 0); Dp % 32 == 0.
constexpr int ROW_LANES = 8;                    // lanes per row
constexpr int ROWS_PER_WARP = 32 / ROW_LANES;   // rows a warp scores at once
constexpr int ROW_CPL = 8;                      // chunks a lane loads at once

// One quad of channels c .. c + 3 (values x) into the group rows' sums.
__device__ __forceinline__ void fma_quad(const float (&x)[4], const float* rq,
                                         int c, int g, int Dp,
                                         float (&acc)[GMAX]) {
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi < g) {
      const float4 r = *reinterpret_cast<const float4*>(rq + gi * Dp + c);
      acc[gi] = fmaf(x[0], r.x, acc[gi]);
      acc[gi] = fmaf(x[1], r.y, acc[gi]);
      acc[gi] = fmaf(x[2], r.z, acc[gi]);
      acc[gi] = fmaf(x[3], r.w, acc[gi]);
    }
  }
}

// Codes q[0..3] of channels c .. c + 3, dequantized as dequant() does.
__device__ __forceinline__ void dequant_quad(float (&x)[4], const float* scale,
                                             const float* zero, int c, int bits,
                                             bool sym) {
  const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + c));
  const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
  if (sym) {
    const float qhi = (float)((1 << (bits - 1)) - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __fmul_rn(__fsub_rn(x[j], qhi), sc[j]);
  } else {
    const float4 z4 = __ldg(reinterpret_cast<const float4*>(zero + c));
    const float ze[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __fadd_rn(__fmul_rn(x[j], sc[j]), ze[j]);
  }
}

// Chunk k of a row (its 16 bytes in v) into the sums of lane s.
__device__ __forceinline__ void fma_chunk(const uint4& v, int k, int s,
                                          const float* rq, int g, int Dp,
                                          int bits, bool sym, const float* scale,
                                          const float* zero, float (&acc)[GMAX]) {
  if (bits == 0) {
    const float x[4] = {__uint_as_float(v.x), __uint_as_float(v.y),
                        __uint_as_float(v.z), __uint_as_float(v.w)};
    fma_quad(x, rq, 4 * k, g, Dp, acc);
    return;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = (m + (s >> 1)) & 3;
    const uint32_t w = r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
    const int c = 16 * k + 4 * r;
    float x[4];
    if (bits == 8) {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = (float)((w >> (8 * j)) & 0xFFu);
      dequant_quad(x, scale, zero, c, bits, sym);
      fma_quad(x, rq, c, g, Dp, acc);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = (float)((w >> (8 * j)) & 0xFu);
      dequant_quad(x, scale, zero, c, bits, sym);
      fma_quad(x, rq, c, g, Dp, acc);
      const int ch = (Dp >> 1) + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = (float)((w >> (8 * j + 4)) & 0xFu);
      dequant_quad(x, scale, zero, ch, bits, sym);
      fma_quad(x, rq, ch, g, Dp, acc);
    }
  }
}

__device__ __forceinline__ float score_row(const uint8_t* row, const float* rq,
                                           int g, int Dp, int bits, bool sym,
                                           const float* scale,
                                           const float* zero) {
  const int s = threadIdx.x & (ROW_LANES - 1);
  const int n_chunks = (bits == 0 ? Dp * 4 : bits == 4 ? Dp / 2 : Dp) >> 4;
  const uint4* src = reinterpret_cast<const uint4*>(row);
  float acc[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) acc[gi] = 0.f;
  for (int k0 = s; k0 < n_chunks; k0 += ROW_LANES * ROW_CPL) {
    uint4 v[ROW_CPL];
#pragma unroll
    for (int i = 0; i < ROW_CPL; ++i) {
      const int k = k0 + i * ROW_LANES;
      if (k < n_chunks) v[i] = __ldg(src + k);
    }
#pragma unroll
    for (int i = 0; i < ROW_CPL; ++i) {
      const int k = k0 + i * ROW_LANES;
      if (k < n_chunks) fma_chunk(v[i], k, s, rq, g, Dp, bits, sym, scale, zero, acc);
    }
  }
  float best = ABS_NEG_INF;
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi < g) {
      float t = acc[gi];
      t += __shfl_xor_sync(0xffffffffu, t, 4);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      best = gi == 0 ? t : fmaxf(best, t);
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

// Exact k-th largest of s[0..n) as a sortable u32, plus the count strictly
// above it: the largest t with at least k entries >= t (0 when k > n).
// Selecting every entry above the threshold and the first (k - n_gt) ties
// in index order reproduces lax.top_k's selected set.  A radix select over
// the 32 bits, 8 at a time: each of 4 passes counts, among the entries
// whose higher bits equal the prefix found so far, how many fall in each of
// 256 bins, and warp 0 finds the bin that holds the k-th (bin sums of eight
// per lane, a suffix scan by shuffles, a ballot).  Must be reached by all
// threads of the block; red: shared scratch of NWARPS ints.
__device__ __forceinline__ uint32_t topk_threshold(const float* s, int n, int k,
                                                   int* red, int* n_gt) {
  __shared__ int hist[256];
  __shared__ uint32_t prefix_s;
  __shared__ int k_s;
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t prefix = 0, mask = 0;
  int kk = k;
  for (int shift = 24; shift >= 0 && k <= n; shift -= 8) {
    for (int i = tid; i < 256; i += NT) hist[i] = 0;
    __syncthreads();
    for (int j = tid; j < n; j += NT) {
      const uint32_t u = to_sortable(s[j]);
      if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 255u], 1);
    }
    __syncthreads();
    if (tid < 32) {
      int c = 0;                          // bins 8 lane .. 8 lane + 7
#pragma unroll
      for (int i = 0; i < 8; ++i) c += hist[8 * lane + i];
      int suf = c;                        // bins >= 8 lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += v;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, suf >= kk);
      const int top = 31 - __clz(hit);    // the lane whose bins hold the k-th
      if (lane == top) {
        int cum = suf - c;                // entries in higher bins
        for (int i = 7; i >= 0; --i) {
          const int h = hist[8 * lane + i];
          if (cum + h >= kk) {
            prefix_s = prefix | ((uint32_t)(8 * lane + i) << shift);
            k_s = kk - cum;
            break;
          }
          cum += h;
        }
      }
    }
    __syncthreads();
    prefix = prefix_s;
    kk = k_s;
    mask |= 255u << shift;
  }
  int gt = 0;
  for (int j = tid; j < n; j += NT) gt += to_sortable(s[j]) > prefix;
  *n_gt = block_sum_int(gt, red);
  return prefix;
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
