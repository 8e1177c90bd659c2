// Paged decode attention for Hopper (sm_90a): one query token per sequence
// attends only the pages a dense [B, n_kv, P_sel] page table selects.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py
// (_paged_attn_kernel, pallas_call at line 143).  One thread block per
// (kv head, sequence) holds the head's GQA group of g <= 8 query rows in
// registers and walks the table's P_sel * page_size token positions in
// steps of CH tokens with a running (max, sum, acc) softmax state in f32:
//
//  1. each warp takes CH / NWARPS tokens of the step, loads their K rows
//     (all loads issued before the dot products) and writes the g logits;
//     a token counts only if its slot is valid, its page lies in
//     [0, n_pages) and its position page * page_size + i < seq_len[b]
//     (a slot that does not count is never read, whatever page it holds);
//  2. warps 0..g-1 fold the step into their row's running max and sum;
//  3. every thread rescales its (row, channel) accumulators and adds the
//     step's p * V.
//
// A step with no live token is skipped.  The output is acc / max(l, 1e-30)
// in bf16 (0 where a head has no live token).  Slots may come in any order
// (the staged path lists them in rank order); only rounding depends on it.
//
// Bound on the card: bytes (the selected tokens' K and V rows, a few flops
// per byte).  One block per (sequence, head) keeps B * n_kv SMs busy;
// splitting the page loop over several blocks with a combine pass, TMA and
// wgmma are later work.
#include "common.cuh"

using namespace absparse;

namespace {

constexpr int CH = 64;                  // tokens per step of the page loop
constexpr int TPW = CH / NWARPS;        // tokens per warp per step

template <int DPL>  // head_dim = 32 * DPL channels, DPL per lane
__global__ void __launch_bounds__(NT) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,      // [B, n_q, D]
    const __nv_bfloat16* __restrict__ kp,     // [B, n_kv, nP, ps, D]
    const __nv_bfloat16* __restrict__ vp,
    const int* __restrict__ table,            // [B, n_kv, P_sel]
    const uint8_t* __restrict__ valid,        // [B, n_kv, P_sel]
    const int* __restrict__ seq_len,          // [B]
    __nv_bfloat16* __restrict__ out,          // [B, n_q, D]
    int n_kv, int g, int n_pages, int page_size, int p_sel, float scale_qk) {
  constexpr int D = 32 * DPL;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int n_q = n_kv * g;

  __shared__ float lg[GMAX][CH];        // logits, then probabilities
  __shared__ int tok_row[CH];           // token row in the head's pool, -1 off
  __shared__ float m_s[GMAX], l_s[GMAX], al_s[GMAX];

  if (tid < GMAX) {
    m_s[tid] = ABS_NEG_INF;
    l_s[tid] = 0.f;
    al_s[tid] = 1.f;
  }
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

  const int sl = seq_len[b];
  const size_t cell = (size_t)b * n_kv + h;
  const int* tbl = table + cell * p_sel;
  const uint8_t* vld = valid + cell * p_sel;
  const __nv_bfloat16* kh = kp + cell * (size_t)n_pages * page_size * D;
  const __nv_bfloat16* vh = vp + cell * (size_t)n_pages * page_size * D;
  const int n_tok = p_sel * page_size;

  for (int base = 0; base < n_tok; base += CH) {
    // ---- 1. logits of the step's tokens ---------------------------------
    int rows[TPW];
    float kf[TPW][DPL];
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int j = base + wid + i * NWARPS;
      int row = -1;
      if (j < n_tok) {
        const int slot = j / page_size, w = j - slot * page_size;
        const int pg = tbl[slot];
        if (vld[slot] && pg >= 0 && pg < n_pages && pg * page_size + w < sl)
          row = pg * page_size + w;
      }
      rows[i] = row;
      const __nv_bfloat16* krow = kh + (size_t)max(row, 0) * D + lane * DPL;
#pragma unroll
      for (int k = 0; k < DPL; ++k) kf[i][k] = row >= 0 ? bf2f(krow[k]) : 0.f;
    }
    bool live = false;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int t = wid + i * NWARPS;
      live |= rows[i] >= 0;
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        if (gi < g) {
          float d = 0.f;
#pragma unroll
          for (int k = 0; k < DPL; ++k) d = fmaf(qreg[gi][k], kf[i][k], d);
          d = warp_sum(d);
          if (lane == 0) lg[gi][t] = rows[i] >= 0 ? d * scale_qk : ABS_NEG_INF;
        }
      }
      if (lane == 0) tok_row[t] = rows[i];
    }
    if (!__syncthreads_or(live)) continue;      // no live token in the step

    // ---- 2. running max and sum per query row ---------------------------
    if (wid < g) {
      float mx = ABS_NEG_INF;
      for (int t = lane; t < CH; t += 32) mx = fmaxf(mx, lg[wid][t]);
      mx = warp_max(mx);
      const float m_old = m_s[wid];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int t = lane; t < CH; t += 32) {
        const float p = tok_row[t] >= 0 ? expf(lg[wid][t] - m_new) : 0.f;
        lg[wid][t] = p;
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

    // ---- 3. acc = acc * alpha + p V ---------------------------------------
#pragma unroll
    for (int i2 = 0; i2 < PAIRS; ++i2) {
      const int pi = tid + i2 * NT;
      if (pi < g * D) {
        const int gi = pi / D, d = pi - gi * D;
        float a = acc[i2] * al_s[gi];
#pragma unroll 8
        for (int t = 0; t < CH; ++t) {
          // a token that does not count has p == 0 and reads row 0 of the
          // head's pool (in bounds) instead of its own
          const int r = max(tok_row[t], 0);
          a = fmaf(lg[gi][t], bf2f(vh[(size_t)r * D + d]), a);
        }
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
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const uint8_t* valid, const int* seq_len, void* out, int B,
           int n_kv, int g, int n_pages, int page_size, int p_sel,
           float scale_qk, cudaStream_t stream) {
  dim3 grid(n_kv, B);
  paged_attention_kernel<DPL><<<grid, NT, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, table, valid, seq_len, (__nv_bfloat16*)out,
      n_kv, g, n_pages, page_size, p_sel, scale_qk);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_attention_launch(
    const void* q, const void* kp, const void* vp, const int* table,
    const uint8_t* valid, const int* seq_len, void* out, int B, int n_kv,
    int g, int D, int n_pages, int page_size, int p_sel, float scale_qk,
    void* stream) {
  if (g > GMAX || g < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return launch<2>(q, kp, vp, table, valid, seq_len, out, B, n_kv, g,
                     n_pages, page_size, p_sel, scale_qk, st);
  if (D == 128)
    return launch<4>(q, kp, vp, table, valid, seq_len, out, B, n_kv, g,
                     n_pages, page_size, p_sel, scale_qk, st);
  return (int)cudaErrorInvalidValue;
}
