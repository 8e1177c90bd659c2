// Paged decode attention for Hopper (sm_90a): one query token per sequence
// attends only the pages a dense [B, n_kv, P_sel] page table selects.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py
// (_paged_attn_kernel, pallas_call at line 143): a running (max, sum, acc)
// softmax in f32 over the table's slots for the head's GQA group of
// g <= 8 query rows.  A token counts only if its slot is valid, its page
// lies in [0, n_pages) and its position page * page_size + i < seq_len[b];
// a slot that does not count is never read, whatever page it holds.  The
// output is acc / max(l, 1e-30) in bf16 (0 where a head has no live
// token).  Slots may come in any order (the staged path lists them in rank
// order); only rounding depends on it.
//
// Bound on the card: bytes (the selected tokens' K and V rows, about 2 g
// flops per byte).  One block per (sequence, head) kept only B * n_kv SMs
// busy, each walking thousands of tokens serially.  Split-KV design:
//  - each (sequence, head) cell's slot list is cut into n_split contiguous
//    runs (the wrapper's split_plan: about two resident blocks per SM);
//    grid (n_split, n_kv, B);
//  - inside a block each of the 4 warps takes whole 16-token units (a page
//    of 16 tokens x 128 channels is 4 KB, contiguous) and keeps its own
//    (m, l, acc) for the g rows in registers; a lane holds 8 channels of
//    one token row, so every K and V load is 16 bytes and V is read once
//    per token for all g rows;
//  - each lane looks up one of its warp's next 32 units in the page table,
//    and the warp walks the live ones from registers (a ballot), so no
//    table read sits on the loop's path and a slot that does not count
//    costs nothing;
//  - units arrive by cp.async into a per-warp ring of three stages, two
//    units ahead of the arithmetic; a lane reads back only what it copied,
//    so the page loop has no barrier at all;
//  - the warps' states merge once at the end through shared memory; with
//    one split the block writes the output, otherwise each split writes
//    its (m, l) and f32 acc to scratch and a second small kernel combines
//    them (a split with no live token has l = 0 and weight 0).
#include "common.cuh"

using namespace absparse;

namespace {

constexpr int PW = 4;                   // warps per block
constexpr int PT = 32 * PW;
constexpr int UNIT = 16;                // tokens per unit of a warp's work
constexpr int NS = 3;                   // cp.async stages per warp

template <int D>
__host__ __device__ constexpr int unit_bytes() { return 2 * UNIT * D * 2; }  // K and V

template <int D>
constexpr size_t smem_bytes() { return (size_t)PW * NS * unit_bytes<D>(); }

template <int D, int G>
__global__ void __launch_bounds__(PT) paged_attention_kernel(
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
  constexpr int LPR = D / 8;            // lanes per token row, 8 channels each
  constexpr int RPI = 32 / LPR;         // token rows per warp-wide load
  constexpr int IT = UNIT / RPI;        // loads per unit per lane (K or V)
  constexpr int UB = unit_bytes<D>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int c = lane % LPR, r0 = lane / LPR;
  const size_t cell = (size_t)b * n_kv + h;
  const int sl = seq_len[b];
  const int* tbl = table + cell * p_sel;
  const uint8_t* vld = valid + cell * p_sel;
  const __nv_bfloat16* kh = kp + cell * (size_t)n_pages * page_size * D;
  const __nv_bfloat16* vh = vp + cell * (size_t)n_pages * page_size * D;
  const int gpp = (page_size + UNIT - 1) / UNIT;    // units per page
  const int s0 = split * per_split;
  const int n_units = max(0, min(p_sel, s0 + per_split) - s0) * gpp;

  float qf[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + ((size_t)b * n_kv * G + h * G + gi) * D + c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) qf[gi][j] = bf2f(e[j]);
  }

  // position of unit u's first token, -1 if nothing of it counts
  auto unit_pos = [&](int u) -> int {
    const int slot = s0 + u / gpp, w0 = (u % gpp) * UNIT;
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
  // units in order with the answers in registers (no table read on the
  // path of the loop).
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
  __syncthreads();
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
    if (n_split == 1) {
      out[(cell * G + gi) * D + d] = __float2bfloat16(aa / fmaxf(ll, 1e-30f));
    } else {
      const size_t row = (cell * n_split + split) * G + gi;
      part_acc[row * D + d] = aa;
      if (d == 0) {
        part_ml[row * 2] = mm;
        part_ml[row * 2 + 1] = ll;
      }
    }
  }
}

// One block per (sequence, kv head), one warp per query row of the group:
// combine the splits' (m, l, acc).  Lane i reads split s0 + i's (m, l),
// its weight reaches every lane by shuffle, and each lane sums D / 32
// channels with independent loads per split.
template <int D>
__global__ void __launch_bounds__(32 * GMAX) paged_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    __nv_bfloat16* __restrict__ out, int n_split, int g) {
  constexpr int CPL = D / 32;
  const int gi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (gi >= g) return;
  const size_t row0 = (size_t)blockIdx.x * n_split * g + gi;   // split 0's row
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
  const float inv = 1.f / fmaxf(warp_sum(ll), 1e-30f);
  __nv_bfloat16* o = out + ((size_t)blockIdx.x * g + gi) * D + lane;
#pragma unroll
  for (int k = 0; k < CPL; ++k) o[32 * k] = __float2bfloat16(acc[k] * inv);
}

template <int D, int G>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const uint8_t* valid, const int* seq_len, void* out, float* part_ml,
           float* part_acc, int B, int n_kv, int n_pages, int page_size,
           int p_sel, int n_split, float scale_qk, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(paged_attention_kernel<D, G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int per_split = (p_sel + n_split - 1) / n_split;
  paged_attention_kernel<D, G><<<dim3(n_split, n_kv, B), PT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, table, valid, seq_len, (__nv_bfloat16*)out,
      part_ml, part_acc, n_kv, n_pages, page_size, p_sel, per_split, scale_qk);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  paged_combine_kernel<D><<<B * n_kv, 32 * G, 0, stream>>>(
      part_ml, part_acc, (__nv_bfloat16*)out, n_split, G);
  return (int)cudaGetLastError();
}

template <int D>
int launch_g(int g, const void* q, const void* kp, const void* vp,
             const int* table, const uint8_t* valid, const int* seq_len,
             void* out, float* part_ml, float* part_acc, int B, int n_kv,
             int n_pages, int page_size, int p_sel, int n_split, float scale_qk,
             cudaStream_t st) {
#define ABS_G(G)                                                                \
  case G:                                                                       \
    return launch<D, G>(q, kp, vp, table, valid, seq_len, out, part_ml, part_acc, \
                        B, n_kv, n_pages, page_size, p_sel, n_split, scale_qk, st);
  switch (g) {
    ABS_G(1) ABS_G(2) ABS_G(3) ABS_G(4) ABS_G(5) ABS_G(6) ABS_G(7) ABS_G(8)
  }
#undef ABS_G
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  part_ml /
// part_acc: scratch of [B, n_kv, n_split, g, 2] and [.., g, D] floats (not
// read when n_split is 1).
extern "C" int paged_attention_launch(
    const void* q, const void* kp, const void* vp, const int* table,
    const uint8_t* valid, const int* seq_len, void* out, float* part_ml,
    float* part_acc, int B, int n_kv, int g, int D, int n_pages, int page_size,
    int p_sel, int n_split, float scale_qk, void* stream) {
  if (g > GMAX || g < 1 || n_split < 1 || B < 1 || B > 65535 || n_kv < 1 ||
      n_kv > 65535 || page_size < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return launch_g<64>(g, q, kp, vp, table, valid, seq_len, out, part_ml, part_acc,
                        B, n_kv, n_pages, page_size, p_sel, n_split, scale_qk, st);
  if (D == 128)
    return launch_g<128>(g, q, kp, vp, table, valid, seq_len, out, part_ml, part_acc,
                         B, n_kv, n_pages, page_size, p_sel, n_split, scale_qk, st);
  return (int)cudaErrorInvalidValue;
}
