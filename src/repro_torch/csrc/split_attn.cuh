// Split-KV decode attention over one run of page-table slots, shared by the
// staged paged_attention.cu and the fused fused_decode.cu.
//
// One (sequence, kv head) cell's slot list is cut into runs; a run is
// attended by the first PT threads of one thread block (PW warps) and
// leaves either the output (the cell's only run) or its softmax state
// (m, l, f32 acc) for the combine kernel below.  A token counts only if
// its slot is valid, its page lies in [0, n_pages) and its position
// page * page_size + i < seq_len; a slot that does not count is never
// read, whatever page it holds.
//
//  - each of the PW warps takes whole 16-token units (a page of 16 tokens
//    x 128 channels is 4 KB, contiguous) and keeps its own (m, l, acc) for
//    the g rows in registers; a lane holds 8 channels of one token row, so
//    every K and V load is 16 bytes and V is read once per token for all
//    g rows;
//  - each lane looks up one of its warp's next 32 units in the run's slots,
//    and the warp walks the live ones from registers (a ballot), so no
//    table read sits on the loop's path and a slot that does not count
//    costs nothing;
//  - units arrive by cp.async into a per-warp ring of three stages, two
//    units ahead of the arithmetic; a lane reads back only what it copied,
//    so the unit loop has no barrier at all;
//  - the warps' states merge once at the end through shared memory.
//
// A cell with no live token at all (every slot invalid, or every selected
// token at or past seq_len) gets the mean of the V rows of its whole table,
// as JAX's kernel computes it (its masked logits all equal the -1e30 start
// of the running max, so each row weighs exp(0) = 1); pages are clamped
// into [0, n_pages) for that read.  Only such a cell takes that path.
#pragma once

#include "common.cuh"

namespace absparse {
namespace split {

constexpr int PW = 4;                   // warps that attend a run
constexpr int PT = 32 * PW;
constexpr int UNIT = 16;                // tokens per unit of a warp's work
constexpr int NS = 3;                   // cp.async stages per warp

template <int D>
__host__ __device__ constexpr int unit_bytes() { return 2 * UNIT * D * 2; }  // K and V

// Shared memory attend_run needs.
template <int D>
__host__ __device__ constexpr size_t ring_bytes() { return (size_t)PW * NS * unit_bytes<D>(); }

// Barrier of the first PT threads only (named barrier 1), so that a block
// with more threads can leave the rest out of the attention.
__device__ __forceinline__ void attn_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(PT) : "memory");
}

// Channel d of the mean V row over the P slots of tbl (page_size rows each).
__device__ __forceinline__ float table_mean(const __nv_bfloat16* vh, const int* tbl,
                                            int P, int n_pages, int page_size, int D,
                                            int d) {
  float acc = 0.f;
  for (int p = 0; p < P; ++p) {
    const int pg = min(max(tbl[p], 0), n_pages - 1);
    const __nv_bfloat16* r = vh + (size_t)pg * page_size * D + d;
    for (int t = 0; t < page_size; ++t) acc += bf2f(r[(size_t)t * D]);
  }
  return P * page_size > 0 ? acc / (float)(P * page_size) : 0.f;
}

// Attend one run of n_slots slots (tbl / vld: the run's entries, global or
// shared memory) for the G query rows qc [G, D] of one cell.  With out
// non-null the run is the cell's only one: write out [G, D] bf16 (the mean
// of tbl_all's p_all slots' V rows if no token counts).  Otherwise write
// the run's state: ml [G, 2] = (m, l) and acc [G, D] (m = -1e30, l = 0,
// acc = 0 for a run without a live token).  Called by threads 0 .. PT - 1
// of the block; smem: ring_bytes<D>() bytes, 16-byte aligned.
template <int D, int G>
__device__ __forceinline__ void attend_run(
    const __nv_bfloat16* __restrict__ qc, const __nv_bfloat16* __restrict__ kh,
    const __nv_bfloat16* __restrict__ vh, const int* tbl, const uint8_t* vld,
    int n_slots, int sl, int n_pages, int page_size, float scale_qk,
    unsigned char* smem, __nv_bfloat16* out, const int* tbl_all, int p_all,
    float* ml, float* acc_out) {
  constexpr int LPR = D / 8;            // lanes per token row, 8 channels each
  constexpr int RPI = 32 / LPR;         // token rows per warp-wide load
  constexpr int IT = UNIT / RPI;        // loads per unit per lane (K or V)
  constexpr int UB = unit_bytes<D>();

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int c = lane % LPR, r0 = lane / LPR;
  const int gpp = (page_size + UNIT - 1) / UNIT;    // units per page
  const int n_units = max(0, n_slots) * gpp;

  float qf[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const uint4 raw = *reinterpret_cast<const uint4*>(qc + (size_t)gi * D + c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) qf[gi][j] = bf2f(e[j]);
  }

  // position of unit u's first token, -1 if nothing of it counts
  auto unit_pos = [&](int u) -> int {
    const int slot = u / gpp, w0 = (u % gpp) * UNIT;
    const int pg = tbl[slot];
    if (!vld[slot] || pg < 0 || pg >= n_pages || pg * page_size + w0 >= sl) return -1;
    return pg * page_size + w0;
  };

  unsigned char* wbuf = smem + (size_t)wid * NS * UB;
  // copy the unit whose first token is at pos (w0 tokens into its page)
  // into stage st; rows past the page are zero-filled, not read
  auto issue = [&](int pos, int w0, int st) {
    const uint32_t ks = smem_u32(wbuf + st * UB), vs = ks + UB / 2;
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int t = r0 + RPI * i;
      const bool ok = w0 + t < page_size;
      const size_t src = (size_t)(pos + (ok ? t : 0)) * D + c * 8;
      const uint32_t dst = (uint32_t)(t * D + c * 8) * 2;
      cp_async16(ks + dst, kh + src, ok);
      cp_async16(vs + dst, vh + src, ok);
    }
  };

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = ABS_NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[gi][j] = 0.f;
  }

  // The warp's units are u = wid + PW i, taken in rounds of 32: lane i
  // looks unit i of the round up once, and the warp walks the round's live
  // units in order with the answers in registers.
  for (int base = wid; base < n_units; base += 32 * PW) {
    const int u_l = base + lane * PW;
    const int pos_l = u_l < n_units ? unit_pos(u_l) : -1;
    unsigned live = __ballot_sync(0xffffffffu, pos_l >= 0);
    unsigned to_load = live;
    auto issue_next = [&](int st) {
      if (to_load) {
        const int i = __ffs(to_load) - 1;
        to_load &= to_load - 1;
        issue(__shfl_sync(0xffffffffu, pos_l, i), ((base + i * PW) % gpp) * UNIT, st);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) issue_next(st);
    for (int k = 0; live; ++k) {
      const int i = __ffs(live) - 1;
      live &= live - 1;
      issue_next((k + NS - 1) % NS);
      cp_async_wait<NS - 1>();          // this lane's copies of unit k landed

      const __nv_bfloat16* ks =
          reinterpret_cast<const __nv_bfloat16*>(wbuf + (k % NS) * UB);
      const __nv_bfloat16* vs = ks + UNIT * D;
      const int pos = __shfl_sync(0xffffffffu, pos_l, i);
      const int w0 = ((base + i * PW) % gpp) * UNIT;
      float lg[G][IT];
#pragma unroll
      for (int ii = 0; ii < IT; ++ii) {
        const int t = r0 + RPI * ii;
        const uint4 raw = *reinterpret_cast<const uint4*>(ks + t * D + c * 8);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
        float kf[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = bf2f(e[j]);
        const bool tok = w0 + t < page_size && pos + t < sl;
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) d = fmaf(qf[gi][j], kf[j], d);
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
          lg[gi][ii] = tok ? d * scale_qk : ABS_NEG_INF;
        }
      }
      // token 0 of a live unit counts, so the unit's max is finite
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float mx = ABS_NEG_INF;
#pragma unroll
        for (int ii = 0; ii < IT; ++ii) mx = fmaxf(mx, lg[gi][ii]);
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[gi], mx);
        const float alpha = expf(m[gi] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int ii = 0; ii < IT; ++ii) {
          lg[gi][ii] = expf(lg[gi][ii] - m_new);
          sum += lg[gi][ii];
        }
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        m[gi] = m_new;
        l[gi] = l[gi] * alpha + sum;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[gi][j] *= alpha;
      }
#pragma unroll
      for (int ii = 0; ii < IT; ++ii) {
        const int t = r0 + RPI * ii;
        const uint4 raw = *reinterpret_cast<const uint4*>(vs + t * D + c * 8);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float vv = bf2f(e[j]);
#pragma unroll
          for (int gi = 0; gi < G; ++gi) acc[gi][j] = fmaf(lg[gi][ii], vv, acc[gi][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the warp's rows of tokens hold partial sums of acc: add them up
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        acc[gi][j] += __shfl_xor_sync(0xffffffffu, acc[gi][j], o);

  // merge the warps: each writes [G] m, [G] l, [G][D] acc into its own ring
  float* mine = reinterpret_cast<float*>(wbuf);
  if (lane == 0)
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      mine[gi] = m[gi];
      mine[G + gi] = l[gi];
    }
  if (r0 == 0)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int j = 0; j < 8; ++j) mine[2 * G + gi * D + c * 8 + j] = acc[gi][j];
  attn_sync();
  for (int pi = tid; pi < G * D; pi += PT) {
    const int gi = pi / D, d = pi - gi * D;
    float mm = ABS_NEG_INF;
#pragma unroll
    for (int w = 0; w < PW; ++w)
      mm = fmaxf(mm, reinterpret_cast<const float*>(smem + (size_t)w * NS * UB)[gi]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < PW; ++w) {
      const float* f = reinterpret_cast<const float*>(smem + (size_t)w * NS * UB);
      const float wt = expf(f[gi] - mm);
      ll += f[G + gi] * wt;
      aa += f[2 * G + gi * D + d] * wt;
    }
    if (out != nullptr) {
      const float o = ll > 0.f ? aa / ll
                               : table_mean(vh, tbl_all, p_all, n_pages, page_size, D, d);
      out[(size_t)gi * D + d] = __float2bfloat16(o);
    } else {
      acc_out[(size_t)gi * D + d] = aa;
      if (d == 0) {
        ml[gi * 2] = mm;
        ml[gi * 2 + 1] = ll;
      }
    }
  }
}

// grid (n_split, n_kv, B), PT threads: run `split` of the (sequence b, kv
// head h) cell's table [P_sel] (per_split slots a run).
template <int D, int G>
__global__ void __launch_bounds__(PT) split_attention_kernel(
    const __nv_bfloat16* __restrict__ q,      // [B, n_q, D]
    const __nv_bfloat16* __restrict__ kp,     // [B, n_kv, nP, ps, D]
    const __nv_bfloat16* __restrict__ vp,
    const int* __restrict__ table,            // [B, n_kv, P_sel]
    const uint8_t* __restrict__ valid,        // [B, n_kv, P_sel]
    const int* __restrict__ seq_len,          // [B]
    __nv_bfloat16* __restrict__ out,          // [B, n_q, D], one split only
    float* __restrict__ part_ml,              // [B, n_kv, n_split, G, 2]
    float* __restrict__ part_acc,             // [B, n_kv, n_split, G, D]
    int n_kv, int n_pages, int page_size, int p_sel, int per_split,
    float scale_qk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const size_t cell = (size_t)b * n_kv + h;
  const int* tbl = table + cell * p_sel;
  const size_t kv_off = cell * (size_t)n_pages * page_size * D;
  const int s0 = min(p_sel, split * per_split);
  const int n_slots = min(p_sel, s0 + per_split) - s0;
  const size_t row = (cell * n_split + split) * G;
  attend_run<D, G>(q + cell * G * D, kp + kv_off, vp + kv_off, tbl + s0,
                   valid + cell * p_sel + s0, n_slots, seq_len[b], n_pages,
                   page_size, scale_qk, smem,
                   n_split == 1 ? out + cell * G * D : nullptr, tbl, p_sel,
                   part_ml + row * 2, part_acc + row * D);
}

// One block per (sequence, kv head), one warp per query row of the group:
// combine the runs' (m, l, acc).  Lane i reads run s0 + i's (m, l), its
// weight reaches every lane by shuffle, and each lane sums D / 32 channels
// with independent loads per run.  A cell whose runs hold no live token
// (l = 0 in every run) gets the mean V row of its table [p_sel] instead.
template <int D>
__global__ void __launch_bounds__(32 * GMAX) combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ table,
    __nv_bfloat16* __restrict__ out, int n_split, int g, int p_sel, int n_pages,
    int page_size) {
  constexpr int CPL = D / 32;
  const int gi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (gi >= g) return;
  const size_t row0 = (size_t)blockIdx.x * n_split * g + gi;   // run 0's row
  float mm = ABS_NEG_INF;
  for (int s = lane; s < n_split; s += 32) mm = fmaxf(mm, part_ml[(row0 + (size_t)s * g) * 2]);
  mm = warp_max(mm);
  float ll = 0.f, acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += 32) {
    float w = 0.f;
    if (s0 + lane < n_split) {
      const size_t r = row0 + (size_t)(s0 + lane) * g;
      w = expf(part_ml[r * 2] - mm);
      ll += part_ml[r * 2 + 1] * w;
    }
    const int n = min(32, n_split - s0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const float* a = part_acc + (row0 + (size_t)(s0 + j) * g) * D + lane;
#pragma unroll
      for (int k = 0; k < CPL; ++k) acc[k] = fmaf(a[32 * k], wj, acc[k]);
    }
  }
  ll = warp_sum(ll);
  __nv_bfloat16* o = out + ((size_t)blockIdx.x * g + gi) * D + lane;
  if (ll > 0.f) {
    const float inv = 1.f / ll;
#pragma unroll
    for (int k = 0; k < CPL; ++k) o[32 * k] = __float2bfloat16(acc[k] * inv);
  } else {
    const __nv_bfloat16* vh = vp + (size_t)blockIdx.x * n_pages * page_size * D;
    const int* tbl = table + (size_t)blockIdx.x * p_sel;
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      o[32 * k] = __float2bfloat16(
          table_mean(vh, tbl, p_sel, n_pages, page_size, D, lane + 32 * k));
  }
}

// Launch the split attention over a page table and, with more than one
// split, the combine; returns the cudaError_t (0 on success).
template <int D, int G>
int launch_split(const void* q, const void* kp, const void* vp, const int* table,
                 const uint8_t* valid, const int* seq_len, void* out, float* part_ml,
                 float* part_acc, int B, int n_kv, int n_pages, int page_size,
                 int p_sel, int n_split, float scale_qk, cudaStream_t stream) {
  const size_t smem = ring_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(split_attention_kernel<D, G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int per_split = (p_sel + n_split - 1) / n_split;
  split_attention_kernel<D, G><<<dim3(n_split, n_kv, B), PT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, table, valid, seq_len, (__nv_bfloat16*)out,
      part_ml, part_acc, n_kv, n_pages, page_size, p_sel, per_split, scale_qk);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  combine_kernel<D><<<B * n_kv, 32 * G, 0, stream>>>(
      part_ml, part_acc, (const __nv_bfloat16*)vp, table, (__nv_bfloat16*)out,
      n_split, G, p_sel, n_pages, page_size);
  return (int)cudaGetLastError();
}

// launch_split with the group size g (1 .. GMAX) and head_dim 64 / 128 as
// runtime arguments.
inline int launch_split_any(int D, int g, const void* q, const void* kp, const void* vp,
                            const int* table, const uint8_t* valid, const int* seq_len,
                            void* out, float* part_ml, float* part_acc, int B, int n_kv,
                            int n_pages, int page_size, int p_sel, int n_split,
                            float scale_qk, cudaStream_t st) {
#define ABS_G(DD, G)                                                             \
  case G:                                                                        \
    return launch_split<DD, G>(q, kp, vp, table, valid, seq_len, out, part_ml,   \
                               part_acc, B, n_kv, n_pages, page_size, p_sel,     \
                               n_split, scale_qk, st);
#define ABS_D(DD)                                                                \
  if (D == DD) {                                                                 \
    switch (g) { ABS_G(DD, 1) ABS_G(DD, 2) ABS_G(DD, 3) ABS_G(DD, 4)             \
                 ABS_G(DD, 5) ABS_G(DD, 6) ABS_G(DD, 7) ABS_G(DD, 8) }           \
  }
  ABS_D(64)
  ABS_D(128)
#undef ABS_D
#undef ABS_G
  return (int)cudaErrorInvalidValue;
}

}  // namespace split
}  // namespace absparse
