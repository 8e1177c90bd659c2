// Fused AB-Sparse decode for Hopper (sm_90a): score -> exact top-K_h ->
// flash attention over the selected blocks, one launch per layer.
//
// Replaces the TPU kernel repro/kernels/fused_decode.py (_fused_decode_kernel,
// pallas_call at line 333).  One thread block per (kv head, sequence):
//
//  1. scores the head's packed centroid segment (rows [row_off, row_off +
//     n_blocks) of the flattened store), eight lanes per row (four rows per
//     warp at once) through score_row (common.cuh), the device function
//     the staged scoring kernel centroid_score.cu uses too: 16-byte loads,
//     INT4/INT8 dequant in registers, dot with each GQA rank query, max
//     over the group; the lane-partial + butterfly sum order is the same
//     for every row, so identical rows score identically;
//  2. masks blocks past seq_len to -1e30 and pins sink / local blocks to
//     +1e30, then selects exactly K_h blocks by a 32-step binary search over
//     the sortable-u32 encoding with the lowest index winning ties, and
//     compacts the selected block ids in ascending order;
//  3. writes the page table / valid mask and streams each live block's keys
//     and values through an online softmax in f32, writing bf16 out.
//
// Bound on the card: bytes.  A step reads the selected K_h*B_h = T tokens of
// K and V per (sequence, head) plus the codes; the work per byte is a few
// flops.  This first version reads K/V straight from device memory with
// coalesced row loads and keeps the softmax state in shared memory; splitting
// a head's blocks over several SMs (one block per (b, h) uses only B*n_kv SMs)
// is later work.
#include "common.cuh"

using namespace absparse;

namespace {

template <int DPL>  // head_dim = 32 * DPL channels, DPL per lane
__global__ void __launch_bounds__(NT) fused_decode_kernel(
    const __nv_bfloat16* __restrict__ q,      // [B, n_q, D]
    const float* __restrict__ rq,             // [B, n_q, Dp]
    const __nv_bfloat16* __restrict__ kp,     // [B, n_kv, nP, ps, D]
    const __nv_bfloat16* __restrict__ vp,
    const uint8_t* __restrict__ codes,        // [B, R, row_bytes]
    const float* __restrict__ scale,          // [B, n_kv, Dp]
    const float* __restrict__ zero,
    const int* __restrict__ row_off, const int* __restrict__ n_blocks,
    const int* __restrict__ top_k, const int* __restrict__ bsz,
    const int* __restrict__ ppb, const int* __restrict__ seq_len,
    __nv_bfloat16* __restrict__ out,          // [B, n_q, D]
    int* __restrict__ table,                  // [B, n_kv, P_sel]
    uint8_t* __restrict__ valid,              // [B, n_kv, P_sel]
    int n_kv, int g, int Dp, int n_pages, int page_size, int total_rows,
    int row_bytes, int bits, int sym, int sink_pages, int local_pages,
    int max_blocks, int k_max, int p_sel, int wmax, float scale_qk) {
  constexpr int D = 32 * DPL;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int n_q = n_kv * g;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rq_s = reinterpret_cast<float*>(smem_raw);       // [g, Dp], 16-B aligned
  float* s = rq_s + g * Dp;                               // [max_blocks]
  int* slot_blk = reinterpret_cast<int*>(s + max_blocks); // [k_max]
  float* lg = reinterpret_cast<float*>(slot_blk + k_max); // [g, wmax]
  float* m_s = lg + g * wmax;                             // [g]
  float* l_s = m_s + GMAX;                                // [g]
  float* al_s = l_s + GMAX;                               // [g]
  int* red = reinterpret_cast<int*>(al_s + GMAX);         // [NWARPS]

  const int roff = row_off[h], nblk = n_blocks[h], ksel = top_k[h];
  const int bs = bsz[h], pb = ppb[h], sl = seq_len[b];

  for (int i = tid; i < g * Dp; i += NT)
    rq_s[i] = rq[((size_t)b * n_q + (size_t)h * g) * Dp + i];
  if (tid < GMAX) {
    m_s[tid] = ABS_NEG_INF;
    l_s[tid] = 0.f;
    al_s[tid] = 1.f;
  }
  __syncthreads();

  // ---- phase 1: score the head's segment, mask and pin -------------------
  const float* sc_h = scale + ((size_t)b * n_kv + h) * Dp;
  const float* ze_h = zero + ((size_t)b * n_kv + h) * Dp;
  const bool symm = sym != 0;
  for (int j0 = wid * ROWS_PER_WARP; j0 < nblk; j0 += NWARPS * ROWS_PER_WARP) {
    const int j = j0 + lane / ROW_LANES;  // this lane group's row
    const uint8_t* row = codes + ((size_t)b * total_rows + roff + min(j, nblk - 1)) *
                                     (size_t)row_bytes;
    const float best = score_row(row, rq_s, g, Dp, bits, symm, sc_h, ze_h);
    if (lane % ROW_LANES == 0 && j < nblk) {
      const int st = j * bs;
      const bool ok = st < sl;
      float sc = ok ? best : ABS_NEG_INF;
      if (sink_pages > 0 && st < min(sink_pages * page_size, sl))
        sc = ABS_POS_INF;
      if (local_pages > 0) {
        const int lo = max(sl - local_pages * page_size, 0);
        if (ok && st + bs > lo) sc = ABS_POS_INF;
      }
      s[j] = sc;
    }
  }
  __syncthreads();

  // ---- phase 2: exact top-K_h, compacted in ascending block order --------
  int n_gt;
  const uint32_t thr = topk_threshold(s, nblk, ksel, red, &n_gt);
  const int quota = ksel - n_gt;
  int tie_off = 0, n_sel = 0;
  for (int base = 0; base < nblk; base += NT) {
    const int j = base + tid;
    const bool in = j < nblk;
    const uint32_t u = in ? to_sortable(s[j]) : 0u;
    const bool tie = in && u == thr;
    int tot;
    const int tr = block_excl_scan(tie, red, &tot) + tie_off;
    tie_off += tot;
    const bool sel = in && (u > thr || (tie && tr < quota));
    const int sr = block_excl_scan(sel, red, &tot) + n_sel;
    if (sel && sr < k_max) slot_blk[sr] = j;
    n_sel += tot;
  }
  __syncthreads();
  const int n_slots = min(min(ksel, n_sel), k_max);

  // ---- page table: slot p / ppb holds page p % ppb of its block ----------
  for (int p = tid; p < p_sel; p += NT) {
    const int slot = p / pb, within = p - slot * pb;
    const int blk = slot < n_slots ? slot_blk[slot] : 0;
    const bool live = slot < n_slots && s[blk] > ABS_NEG_INF / 2;
    const int pg = min(max(blk * pb + within, 0), n_pages - 1);
    const size_t o = ((size_t)b * n_kv + h) * p_sel + p;
    table[o] = pg;
    valid[o] = live ? 1 : 0;
  }

  // ---- phase 3: online-softmax attention over the live blocks ------------
  float qreg[GMAX][DPL];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi)
#pragma unroll
    for (int k = 0; k < DPL; ++k)
      qreg[gi][k] = gi < g
          ? bf2f(q[((size_t)b * n_q + h * g + gi) * D + lane * DPL + k])
          : 0.f;

  constexpr int PAIRS = (GMAX * D + NT - 1) / NT;
  float acc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = 0.f;

  const size_t head_base = ((size_t)b * n_kv + h) * (size_t)n_pages * page_size;
  for (int i = 0; i < n_slots; ++i) {
    const int blk = slot_blk[i];
    if (!(s[blk] > ABS_NEG_INF / 2)) continue;       // uniform over the block
    const int t0 = blk * bs;
    const int nt = min(bs, sl - t0);
    for (int t = wid; t < nt; t += NWARPS) {
      const __nv_bfloat16* krow = kp + (head_base + t0 + t) * D + lane * DPL;
      float kf[DPL];
#pragma unroll
      for (int k = 0; k < DPL; ++k) kf[k] = bf2f(krow[k]);
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        if (gi < g) {
          float d = 0.f;
#pragma unroll
          for (int k = 0; k < DPL; ++k) d = fmaf(qreg[gi][k], kf[k], d);
          d = warp_sum(d);
          if (lane == 0) lg[gi * wmax + t] = d * scale_qk;
        }
      }
    }
    __syncthreads();
    if (wid < g) {
      float mx = ABS_NEG_INF;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, lg[wid * wmax + t]);
      mx = warp_max(mx);
      const float m_old = m_s[wid];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float p = expf(lg[wid * wmax + t] - m_new);
        lg[wid * wmax + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        m_s[wid] = m_new;
        l_s[wid] = l_s[wid] * alpha + sum;
        al_s[wid] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i2 = 0; i2 < PAIRS; ++i2) {
      const int pi = tid + i2 * NT;
      if (pi < g * D) {
        const int gi = pi / D, d = pi - gi * D;
        float a = acc[i2] * al_s[gi];
        const __nv_bfloat16* vcol = vp + (head_base + t0) * D + d;
        for (int t = 0; t < nt; ++t)
          a = fmaf(lg[gi * wmax + t], bf2f(vcol[(size_t)t * D]), a);
        acc[i2] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i2 = 0; i2 < PAIRS; ++i2) {
    const int pi = tid + i2 * NT;
    if (pi < g * D) {
      const int gi = pi / D, d = pi - gi * D;
      out[((size_t)b * n_q + h * g + gi) * D + d] =
          __float2bfloat16(acc[i2] / fmaxf(l_s[gi], 1e-30f));
    }
  }
}

template <int DPL>
int launch(const void* q, const float* rq, const void* kp, const void* vp,
           const uint8_t* codes, const float* scale, const float* zero,
           const int* row_off, const int* n_blocks, const int* top_k,
           const int* bsz, const int* ppb, const int* seq_len, void* out,
           int* table, uint8_t* valid, int B, int n_kv, int g, int Dp,
           int n_pages, int page_size, int total_rows, int row_bytes,
           int bits, int sym, int sink_pages, int local_pages, int max_blocks,
           int k_max, int p_sel, int wmax, float scale_qk, size_t smem,
           cudaStream_t stream) {
  auto kern = fused_decode_kernel<DPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_kv, B);
  kern<<<grid, NT, smem, stream>>>(
      (const __nv_bfloat16*)q, rq, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, codes, scale, zero, row_off, n_blocks, top_k,
      bsz, ppb, seq_len, (__nv_bfloat16*)out, table, valid, n_kv, g, Dp,
      n_pages, page_size, total_rows, row_bytes, bits, sym, sink_pages,
      local_pages, max_blocks, k_max, p_sel, wmax, scale_qk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t fused_decode_smem_bytes(int g, int Dp, int max_blocks,
                                          int k_max, int wmax) {
  return sizeof(float) * ((size_t)max_blocks + g * Dp + g * wmax + 3 * GMAX) +
         sizeof(int) * ((size_t)k_max + NWARPS);
}

// Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_decode_launch(
    const void* q, const float* rq, const void* kp, const void* vp,
    const uint8_t* codes, const float* scale, const float* zero,
    const int* row_off, const int* n_blocks, const int* top_k, const int* bsz,
    const int* ppb, const int* seq_len, void* out, int* table, uint8_t* valid,
    int B, int n_kv, int g, int D, int Dp, int n_pages, int page_size,
    int total_rows, int row_bytes, int bits, int sym, int sink_pages,
    int local_pages, int max_blocks, int k_max, int p_sel, int wmax,
    float scale_qk, void* stream) {
  if (g > GMAX || g < 1 || Dp % 32) return (int)cudaErrorInvalidValue;
  const size_t smem = fused_decode_smem_bytes(g, Dp, max_blocks, k_max, wmax);
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS                                                                  \
  q, rq, kp, vp, codes, scale, zero, row_off, n_blocks, top_k, bsz, ppb,      \
      seq_len, out, table, valid, B, n_kv, g, Dp, n_pages, page_size,         \
      total_rows, row_bytes, bits, sym, sink_pages, local_pages, max_blocks,  \
      k_max, p_sel, wmax, scale_qk, smem, st
  if (D == 64) return launch<2>(ARGS);
  if (D == 128) return launch<4>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
