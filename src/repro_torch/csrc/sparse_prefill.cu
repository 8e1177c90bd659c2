// Query-block sparse flash prefill for Hopper (sm_90a), one launch per layer.
//
// Replaces the TPU kernel repro/kernels/sparse_prefill.py
// (_sparse_prefill_kernel, pallas_call at line 355).  One thread block per
// (query block, kv head, sequence):
//
//  1. scores the candidate blocks of the head's running score segment (blocks
//     fully behind the query block's local window, past the sink): per-row
//     affine INT4/INT8 dequant into shared memory, dot with every live rank
//     query of the block (g * BQ rows, in chunks of 64), max over them.  Each
//     dot is a sequential sum over the channels, the same order for every
//     block row;
//  2. selects forced blocks (sink, and every causal block overlapping the
//     local window / diagonal) plus the top ceil(K_h * scale) candidates by
//     the exact sortable-u32 threshold with lowest-index ties, compacted in
//     ascending order; a dead query block (q_start >= n_valid) selects none.
//     With a non-null `sel_out` the selection is also written out as a
//     [max_blocks] 0/1 byte map per cell, for checking against the plain
//     version;
//  3. runs a causal flash loop over the selected blocks for all g * BQ query
//     rows: Q, K and V tiles in shared memory (bf16), S = Q K^T and P V as
//     register-tiled FMA in f32, online softmax with masked lanes zeroed.
//
// Bound on the card: operations.  A query block does 2 * (g*BQ) * D flops
// per attended key for QK^T and as many for PV against 4 * D bytes of K/V
// per key; with g*BQ = 192 rows that is far above the card's ~295 flop/byte
// ridge.  This first version uses CUDA-core FMA (no tensor cores); moving the
// two products to wgmma is later work.
#include "common.cuh"

using namespace absparse;

namespace {

constexpr int WMAX = 64;  // largest block size (tokens) the tile holds
constexpr int RC = 64;    // rank-query rows per scoring chunk
constexpr int JT = 4;     // block rows a warp scores together

// RPT query rows x (DPT * 16) channels: thread (rg, cg) = (tid / 16, tid % 16)
// owns rows rg*RPT + i and channels cg + 16*k of the output tile.
template <int RPT, int DPT>
__global__ void __launch_bounds__(NT) sparse_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,      // [B, n_kv, nQB, g, BQ, D]
    const float* __restrict__ rq,             // [B, n_kv, nQB, g, BQ, Dp]
    const __nv_bfloat16* __restrict__ kp,     // [B, n_kv, nP, ps, D]
    const __nv_bfloat16* __restrict__ vp,
    const uint8_t* __restrict__ codes,        // [B, R, row_bytes]
    const float* __restrict__ pscale,         // [B, R] per-row
    const float* __restrict__ pzero,
    const int* __restrict__ row_off, const int* __restrict__ n_blocks,
    const int* __restrict__ k_sel, const int* __restrict__ bsz,
    const int* __restrict__ n_valid,
    __nv_bfloat16* __restrict__ out,          // like q
    int* __restrict__ n_att,                  // [B, n_kv, nQB]
    uint8_t* __restrict__ sel_out,            // [B, n_kv, nQB, max_blocks] or null
    int n_kv, int nQB, int g, int BQ, int Dp, int n_pages, int page_size,
    int total_rows, int row_bytes, int bits, int sym, int sink_pages,
    int local_pages, int max_blocks, int qb0, float scale_qk) {
  constexpr int D = 16 * DPT;
  constexpr int QST = D + 2;        // bf16 row strides of the Q / K tiles
  constexpr int PST = WMAX + 1;     // f32 row stride of the P tile
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int rg = tid >> 4, cg = tid & 15;
  const int R = g * BQ;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s = reinterpret_cast<float*>(smem_raw);            // [max_blocks]
  int* slot_blk = reinterpret_cast<int*>(s + max_blocks);   // [max_blocks]
  int* red = slot_blk + max_blocks;                         // [NWARPS]
  unsigned char* u_base = reinterpret_cast<unsigned char*>(red + NWARPS);
  // scoring view of the union region
  float* rq_s = reinterpret_cast<float*>(u_base);           // [RC, Dp + 1]
  float* rk_s = rq_s + RC * (Dp + 1);                       // [NWARPS, JT, Dp]
  // attention view of the union region
  __nv_bfloat16* Q_s = reinterpret_cast<__nv_bfloat16*>(u_base);  // [R, QST]
  __nv_bfloat16* K_s = Q_s + (size_t)R * QST;                      // [WMAX, QST]
  __nv_bfloat16* V_s = K_s + WMAX * QST;                           // [WMAX, D]
  float* P_s = reinterpret_cast<float*>(V_s + WMAX * D);           // [R, PST]

  const int roff = row_off[h], nblk = n_blocks[h], ks = k_sel[h];
  const int bs = bsz[h], nv = n_valid[b];
  const int q_start = (qb0 + qb) * BQ;
  const int q_end = min(q_start + BQ, nv) - 1;
  const bool q_live = q_start < nv;
  const int sink_tok = sink_pages * page_size;
  const int lo = q_start - local_pages * page_size;
  const size_t cell = ((size_t)b * n_kv + h) * nQB + qb;

  // block j: causal / forced / candidate, as in the plain version
  auto causal = [&](int j) {
    const int st = j * bs;
    return j < nblk && st <= q_end && st < nv;
  };
  auto forced = [&](int j) {
    const int st = j * bs;
    return causal(j) && (st < sink_tok || st + bs > lo);
  };
  auto cand = [&](int j) { return causal(j) && !forced(j); };

  for (int j = tid; j < nblk; j += NT) s[j] = ABS_NEG_INF;
  __syncthreads();

  // ---- phase 1: score candidate blocks, max over live query rows ---------
  // candidates end before the local window: st + bs <= lo
  const int j_end = (q_live && lo > 0) ? min(nblk, lo / bs) : 0;
  const bool symm = sym != 0;
  const float* rq_cell = rq + cell * (size_t)R * Dp;
  for (int r0 = 0; r0 < R && j_end > 0; r0 += RC) {
    __syncthreads();
    for (int i = tid; i < RC * Dp; i += NT) {
      const int rr = i / Dp, c = i - rr * Dp;
      rq_s[rr * (Dp + 1) + c] = (r0 + rr < R) ? rq_cell[(size_t)(r0 + rr) * Dp + c] : 0.f;
    }
    __syncthreads();
    // lane's query rows r0 + lane, r0 + lane + 32: live iff their position < nv
    bool rlive[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + lane + 32 * e;
      rlive[e] = r < R && q_start + (r % BQ) < nv;
    }
    float* rk_w = rk_s + wid * JT * Dp;
    for (int j4 = wid * JT; j4 < j_end; j4 += NWARPS * JT) {
      for (int jt = 0; jt < JT; ++jt) {
        const int j = j4 + jt;
        const size_t row = (size_t)b * total_rows + roff + min(j, nblk - 1);
        const uint8_t* crow = codes + row * (size_t)row_bytes;
        const float sc = pscale[row], ze = pzero[row];
        for (int c = lane; c < Dp; c += 32)
          rk_w[jt * Dp + c] = dequant(crow, c, Dp, bits, symm, sc, ze);
      }
      __syncwarp();
      float dot[JT][2];
#pragma unroll
      for (int jt = 0; jt < JT; ++jt) dot[jt][0] = dot[jt][1] = 0.f;
      for (int c = 0; c < Dp; ++c) {
        const float a0 = rq_s[lane * (Dp + 1) + c];
        const float a1 = rq_s[(lane + 32) * (Dp + 1) + c];
#pragma unroll
        for (int jt = 0; jt < JT; ++jt) {
          const float x = rk_w[jt * Dp + c];
          dot[jt][0] = fmaf(x, a0, dot[jt][0]);
          dot[jt][1] = fmaf(x, a1, dot[jt][1]);
        }
      }
#pragma unroll
      for (int jt = 0; jt < JT; ++jt) {
        float best = ABS_NEG_INF;
        if (rlive[0]) best = fmaxf(best, dot[jt][0]);
        if (rlive[1]) best = fmaxf(best, dot[jt][1]);
        best = warp_max(best);
        const int j = j4 + jt;
        if (lane == 0 && j < j_end && cand(j)) s[j] = fmaxf(s[j], best);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- phase 2: forced union exact top-K over candidates ------------------
  int n_gt;
  const uint32_t thr = topk_threshold(s, nblk, ks, red, &n_gt);
  const int quota = ks - n_gt;
  int tie_off = 0, n_live = 0;
  for (int base = 0; base < nblk; base += NT) {
    const int j = base + tid;
    const bool in = j < nblk;
    const uint32_t u = in ? to_sortable(s[j]) : 0u;
    const bool tie = in && u == thr;
    int tot;
    const int tr = block_excl_scan(tie, red, &tot) + tie_off;
    tie_off += tot;
    const bool scored = in && (u > thr || (tie && tr < quota)) && cand(j) &&
                        s[j] > ABS_NEG_INF / 2;
    const bool sel = q_live && in && (forced(j) || scored);
    const int sr = block_excl_scan(sel, red, &tot) + n_live;
    if (sel) slot_blk[sr] = j;
    if (sel_out != nullptr && in) sel_out[cell * max_blocks + j] = sel;
    n_live += tot;
  }
  if (sel_out != nullptr)
    for (int j = nblk + tid; j < max_blocks; j += NT) sel_out[cell * max_blocks + j] = 0;
  if (tid == 0) n_att[cell] = n_live;
  __syncthreads();

  // ---- phase 3: causal flash attention over the selected blocks ----------
  const __nv_bfloat16* q_cell = q + cell * (size_t)R * D;
  for (int i = tid; i < R * (D / 2); i += NT) {
    const int r = i / (D / 2), c2 = i - r * (D / 2);
    reinterpret_cast<__nv_bfloat162*>(Q_s + (size_t)r * QST)[c2] =
        reinterpret_cast<const __nv_bfloat162*>(q_cell + (size_t)r * D)[c2];
  }
  float acc[RPT][DPT], m_r[RPT], l_r[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_r[i] = ABS_NEG_INF;
    l_r[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DPT; ++k) acc[i][k] = 0.f;
  }
  const size_t head_base = ((size_t)b * n_kv + h) * (size_t)n_pages * page_size;

  for (int sidx = 0; sidx < n_live; ++sidx) {
    const int t0 = slot_blk[sidx] * bs;
    const int nt = min(bs, nv - t0);
    __syncthreads();
    for (int i = tid; i < nt * (D / 2); i += NT) {
      const int t = i / (D / 2), c2 = i - t * (D / 2);
      const size_t src = (head_base + t0 + t) * D;
      reinterpret_cast<__nv_bfloat162*>(K_s + t * QST)[c2] =
          reinterpret_cast<const __nv_bfloat162*>(kp + src)[c2];
      reinterpret_cast<__nv_bfloat162*>(V_s + t * D)[c2] =
          reinterpret_cast<const __nv_bfloat162*>(vp + src)[c2];
    }
    __syncthreads();

    float sv[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sv[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = bf2f(K_s[(cg + 16 * c) * QST + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg * RPT + i;
        const float qv = r < R ? bf2f(Q_s[(size_t)r * QST + d]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[i][c] = fmaf(qv, kv[c], sv[i][c]);
      }
    }

    float alpha[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      const int qpos = q_start + (r % BQ);
      float lg[4];
      bool ok[4];
      float mx = ABS_NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = cg + 16 * c, pos = t0 + col;
        ok[c] = col < nt && pos <= qpos;
        lg[c] = ok[c] ? sv[i][c] * scale_qk : ABS_NEG_INF;
        mx = fmaxf(mx, lg[c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o, 16));
      const float m_new = fmaxf(m_r[i], mx);
      alpha[i] = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(lg[c] - m_new) : 0.f;
        if (r < R) P_s[(size_t)r * PST + cg + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o, 16);
      l_r[i] = l_r[i] * alpha[i] + sum;
      m_r[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int k = 0; k < DPT; ++k) acc[i][k] *= alpha[i];
    for (int t = 0; t < nt; ++t) {
      float vv[DPT];
#pragma unroll
      for (int k = 0; k < DPT; ++k) vv[k] = bf2f(V_s[t * D + cg + 16 * k]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg * RPT + i;
        const float p = r < R ? P_s[(size_t)r * PST + t] : 0.f;
#pragma unroll
        for (int k = 0; k < DPT; ++k) acc[i][k] = fmaf(p, vv[k], acc[i][k]);
      }
    }
  }

  __nv_bfloat16* o_cell = out + cell * (size_t)R * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i;
    if (r < R) {
      const float inv_l = 1.f / fmaxf(l_r[i], 1e-30f);
#pragma unroll
      for (int k = 0; k < DPT; ++k)
        o_cell[(size_t)r * D + cg + 16 * k] = __float2bfloat16(acc[i][k] * inv_l);
    }
  }
}

size_t smem_bytes(int R, int D, int Dp, int max_blocks) {
  const size_t fixed = sizeof(float) * (size_t)max_blocks +
                       sizeof(int) * ((size_t)max_blocks + NWARPS);
  const size_t score = sizeof(float) * ((size_t)RC * (Dp + 1) + NWARPS * JT * Dp);
  const size_t attn = sizeof(__nv_bfloat16) *
                          ((size_t)R * (D + 2) + WMAX * (D + 2) + WMAX * D) +
                      sizeof(float) * (size_t)R * (WMAX + 1);
  return fixed + (score > attn ? score : attn);
}

template <int RPT, int DPT>
int launch(const void* q, const float* rq, const void* kp, const void* vp,
           const uint8_t* codes, const float* pscale, const float* pzero,
           const int* row_off, const int* n_blocks, const int* k_sel,
           const int* bsz, const int* n_valid, void* out, int* n_att,
           uint8_t* sel_out, int B, int n_kv, int nQB, int g, int BQ, int Dp,
           int n_pages, int page_size, int total_rows, int row_bytes, int bits, int sym,
           int sink_pages, int local_pages, int max_blocks, int qb0,
           float scale_qk, size_t smem, cudaStream_t stream) {
  auto kern = sparse_prefill_kernel<RPT, DPT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nQB, n_kv, B);
  kern<<<grid, NT, smem, stream>>>(
      (const __nv_bfloat16*)q, rq, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, codes, pscale, pzero, row_off, n_blocks, k_sel,
      bsz, n_valid, (__nv_bfloat16*)out, n_att, sel_out, n_kv, nQB, g, BQ, Dp,
      n_pages, page_size, total_rows, row_bytes, bits, sym, sink_pages, local_pages,
      max_blocks, qb0, scale_qk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t sparse_prefill_smem_bytes(int g, int BQ, int D, int Dp,
                                            int max_blocks) {
  return smem_bytes(g * BQ, D, Dp, max_blocks);
}

// Returns the cudaError_t of the launch (0 on success).
extern "C" int sparse_prefill_launch(
    const void* q, const float* rq, const void* kp, const void* vp,
    const uint8_t* codes, const float* pscale, const float* pzero,
    const int* row_off, const int* n_blocks, const int* k_sel, const int* bsz,
    const int* n_valid, void* out, int* n_att, uint8_t* sel_out, int B,
    int n_kv, int nQB, int g, int BQ, int D, int Dp, int n_pages,
    int page_size, int total_rows, int row_bytes, int bits, int sym,
    int sink_pages, int local_pages, int max_blocks, int qb0, float scale_qk, void* stream) {
  const int R = g * BQ;
  const size_t smem = smem_bytes(R, D, Dp, max_blocks);
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS                                                                  \
  q, rq, kp, vp, codes, pscale, pzero, row_off, n_blocks, k_sel, bsz,         \
      n_valid, out, n_att, sel_out, B, n_kv, nQB, g, BQ, Dp, n_pages,         \
      page_size, total_rows, row_bytes, bits, sym, sink_pages, local_pages,   \
      max_blocks, qb0, scale_qk, smem, st
#define DISPATCH(RPT)                                                         \
  if (R <= 16 * RPT) {                                                        \
    if (D == 64) return launch<RPT, 4>(ARGS);                                 \
    if (D == 128) return launch<RPT, 8>(ARGS);                                \
    return (int)cudaErrorInvalidValue;                                        \
  }
  DISPATCH(4)
  DISPATCH(8)
  DISPATCH(12)
  DISPATCH(16)
#undef DISPATCH
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
