// Query-block sparse flash prefill for Hopper (sm_90a), one call per layer.
//
// Replaces the TPU kernel repro/kernels/sparse_prefill.py
// (_sparse_prefill_kernel, pallas_call at line 355).  Per (sequence, kv head,
// query block) "cell": score the head's running score segment against the
// block's rank queries, select the forced (sink, local / diagonal) blocks
// plus the top ceil(K_h * scale) scored candidates, and run causal flash
// attention for the block's g * BQ query rows over the selected blocks.
//
// Bound on the card: operations.  A cell does 2 * (g*BQ) * D flops per
// attended key for QK^T and as many for PV against 4 * D bytes of K/V per
// key, far above the card's ~295 flop/byte ridge; the scoring is f32 on the
// CUDA cores.  The call is four kernels (five with more than one split)
// and a memset:
//
//  1. dequant: each candidate row of the score segment is dequantized once
//     per (sequence, head) into an f32 scratch [B, total_rows, Dp] (per-row
//     affine INT4/INT8, multiply and add rounded separately); the chunk's
//     cells share their candidate rows, only their last candidate differs;
//  2. score: grid (64-row tiles of candidates, slice of 32 RPT query rows
//     x cell): a register-tiled f32 product of the tile's rows by the
//     slice's rank queries (8 rows x RPT queries per thread, both operands
//     staged in shared memory 32 channels at a time, the next 32 fetched
//     into registers while this chunk's products run), each dot one
//     sequential sum over the channels, then the max over the slice's live
//     query rows, merged into the cell's score by an atomic max on the
//     sortable-u32 encoding (exact in any order).  Slicing the rows keeps
//     the grid at several blocks per SM (RPT 3 at g * BQ = 192: 2 slices);
//  3. select: grid (query block, kv head, sequence): forced blocks plus the
//     exact top candidates by the sortable-u32 threshold with lowest-index
//     ties (common.cuh), compacted in ascending order into a slot list per
//     cell, with n_attended and the optional 0/1 selection map; a dead query
//     block (q_start >= n_valid) selects none;
//  4. attend: grid (run x row group, query block, kv head x sequence) on
//     attn_tile.cuh's wgmma tile, one warpgroup per 64 query rows and one
//     thread block per (cell, run) holding all of the cell's row tiles up
//     to three (g * BQ = 192: 384 threads, 168 registers), so that each
//     gathered K / V tile is read from L2 once for all of them (one block
//     per row tile read it three times and took 0.147 against 0.123 ms at
//     offset 8192 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).  More
//     row tiles (g * BQ up to 512) go in blocks of two, and at head_dim
//     256 every row tile is a block of its own (attend_wgs), each block
//     gathering the run's K / V tiles again.  The
//     cell's selected tokens, in slot order, form 64-key tiles (64 / bs
//     blocks each at bs 16 / 32 / 64); a run is a contiguous range of those
//     tiles (the wrapper's split plan: about two blocks per SM, the run
//     count of least modeled time over whole waves).  The run's slot ids
//     are staged in shared memory; K and V are gathered by 16-byte cp.async
//     into swizzled tiles, K in a ring of two stages and V of three, so
//     that the next tile's K/V loads while this tile's products run.  Keys
//     are masked only on tiles that reach the cell's first query position
//     or n_valid, or that run past the last selected token.  P is kept as
//     bf16 hi + lo with l from the f32 P (attn_tile.cuh says why);
//  5. combine (more than one run): per query row, the runs' (m, l, acc)
//     weighted by 2^(m_s - max m), as paged_attention.cu's combine.
#include "common.cuh"
#include "attn_tile.cuh"

using namespace absparse;

namespace {

constexpr int JT = 64;          // candidate rows per scoring tile
constexpr int KC = 32;          // channels per staged scoring chunk
constexpr int JTP = JT + 4;     // padded row stride of the staged rows
constexpr int QT = tile::ROWS_WG;   // query rows per warpgroup
constexpr int NTA = 128;        // threads of a warpgroup
constexpr int KST = 2, VST = 3; // K / V ring stages

// Candidates of a cell end before its local window: block j is a candidate
// only if j < j_end (and causal, not forced).  0 for a dead query block.
__device__ __forceinline__ int cell_j_end(int qb_abs, int BQ, int nv, int local_pages,
                                          int page_size, int nblk, int bs) {
  const int q_start = qb_abs * BQ;
  if (q_start >= nv) return 0;
  const int lo = q_start - local_pages * page_size;
  return lo > 0 ? min(nblk, lo / bs) : 0;
}

// The largest j_end over the chunk's cells of sequence b (the last live one).
__device__ __forceinline__ int last_j_end(int qb0, int nQB, int BQ, int nv,
                                          int local_pages, int page_size, int nblk,
                                          int bs) {
  if (nv <= qb0 * BQ) return 0;
  const int qb_last = min(qb0 + nQB - 1, (nv - 1) / BQ);
  return cell_j_end(qb_last, BQ, nv, local_pages, page_size, nblk, bs);
}

// ---- 1. dequant ------------------------------------------------------------
// grid (ceil(jb / NWARPS), n_kv, B): warp w dequantizes candidate row
// blockIdx.x * NWARPS + w of head h.
__global__ void __launch_bounds__(NT) prefill_dequant_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ pscale,
    const float* __restrict__ pzero, const int* __restrict__ row_off,
    const int* __restrict__ n_blocks, const int* __restrict__ bsz,
    const int* __restrict__ n_valid, float* __restrict__ rk, int nQB, int BQ,
    int Dp, int total_rows, int row_bytes, int bits, int sym, int local_pages,
    int page_size, int qb0) {
  const int h = blockIdx.y, b = blockIdx.z, lane = threadIdx.x & 31;
  const int j = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  const int jend = last_j_end(qb0, nQB, BQ, n_valid[b], local_pages, page_size,
                              n_blocks[h], bsz[h]);
  if (j >= jend) return;
  const size_t row = (size_t)b * total_rows + row_off[h] + j;
  const uint8_t* crow = codes + row * (size_t)row_bytes;
  const float sc = pscale[row], ze = pzero[row];
  for (int c = lane; c < Dp; c += 32)
    rk[row * Dp + c] = dequant(crow, c, Dp, bits, sym != 0, sc, ze);
}

// ---- 2. score --------------------------------------------------------------
// grid (ceil(jb / JT), n_slices * nQB, n_kv * B), NT threads: warp w owns
// candidate rows j0 + 8w .. j0 + 8w + 7, lane the slice's query rows
// r0 + lane + 32 i (i < RPT), r0 = 32 RPT * slice.  score: the sortable-u32
// encoding of the max, zeroed before the launch.
template <int RPT>
__global__ void __launch_bounds__(NT) prefill_score_kernel(
    const float* __restrict__ rk,             // [B, total_rows, Dp] f32
    const float* __restrict__ rq,             // [B, n_kv, nQB, R, Dp]
    const int* __restrict__ row_off, const int* __restrict__ n_blocks,
    const int* __restrict__ bsz, const int* __restrict__ n_valid,
    uint32_t* __restrict__ score,             // [B, n_kv, nQB, max_blocks]
    int n_kv, int nQB, int g, int BQ, int Dp, int total_rows, int local_pages,
    int page_size, int max_blocks, int qb0) {
  constexpr int RP = 32 * RPT + 1;      // padded query stride: conflict-free stores
  const int qb = blockIdx.y % nQB, r0 = 32 * RPT * (blockIdx.y / nQB);
  const int h = blockIdx.z % n_kv, b = blockIdx.z / n_kv;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int R = g * BQ, nv = n_valid[b];
  const int rows = min(32 * RPT, R - r0);       // this slice's query rows
  const int q_start = (qb0 + qb) * BQ;
  const int jend = cell_j_end(qb0 + qb, BQ, nv, local_pages, page_size, n_blocks[h], bsz[h]);
  const int j0 = blockIdx.x * JT;
  if (j0 >= jend) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rqT = reinterpret_cast<float*>(smem_raw);       // [KC][RP]
  float* rkT = rqT + KC * RP;                            // [KC][JTP]
  const size_t cell = ((size_t)b * n_kv + h) * nQB + qb;
  const float* rq_cell = rq + cell * (size_t)R * Dp;
  const float* rk_head = rk + ((size_t)b * total_rows + row_off[h]) * Dp;

  float acc[8][RPT];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[jj][i] = 0.f;

  // chunk c0's operands: this thread's float4s of the slice's rank queries
  // and of the tile's rows, fetched into registers one chunk ahead
  constexpr int QLD = 32 * RPT * (KC / 4) / NT, KLD = JT * (KC / 4) / NT;
  float4 vq[QLD], vk[KLD];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int u = 0; u < QLD; ++u) {
      const int i = tid + u * NT, r = i / (KC / 4), k = i % (KC / 4);
      vq[u] = r < rows ? *reinterpret_cast<const float4*>(
                             rq_cell + (size_t)(r0 + r) * Dp + c0 + 4 * k)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < KLD; ++u) {
      const int i = tid + u * NT, jj = i / (KC / 4), k = i % (KC / 4);
      const int j = min(j0 + jj, jend - 1);
      vk[u] = *reinterpret_cast<const float4*>(rk_head + (size_t)j * Dp + c0 + 4 * k);
    }
  };
  fetch(0);
  for (int c0 = 0; c0 < Dp; c0 += KC) {
    __syncthreads();                    // the last chunk's products are done
#pragma unroll
    for (int u = 0; u < QLD; ++u) {
      const int i = tid + u * NT, r = i / (KC / 4), k = i % (KC / 4);
      rqT[(4 * k + 0) * RP + r] = vq[u].x;
      rqT[(4 * k + 1) * RP + r] = vq[u].y;
      rqT[(4 * k + 2) * RP + r] = vq[u].z;
      rqT[(4 * k + 3) * RP + r] = vq[u].w;
    }
#pragma unroll
    for (int u = 0; u < KLD; ++u) {
      const int i = tid + u * NT, jj = i / (KC / 4), k = i % (KC / 4);
      rkT[(4 * k + 0) * JTP + jj] = vk[u].x;
      rkT[(4 * k + 1) * JTP + jj] = vk[u].y;
      rkT[(4 * k + 2) * JTP + jj] = vk[u].z;
      rkT[(4 * k + 3) * JTP + jj] = vk[u].w;
    }
    __syncthreads();
    if (c0 + KC < Dp) fetch(c0 + KC);   // in flight during this chunk's products
#pragma unroll 4
    for (int c = 0; c < KC; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(rkT + c * JTP + 8 * wid);
      const float4 a1 = *reinterpret_cast<const float4*>(rkT + c * JTP + 8 * wid + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float x[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) x[i] = rqT[c * RP + lane + 32 * i];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[jj][i] = fmaf(a[jj], x[i], acc[jj][i]);
    }
  }

  bool live[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = lane + 32 * i;
    live[i] = r < rows && q_start + ((r0 + r) % BQ) < nv;
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    float best = ABS_NEG_INF;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (live[i]) best = fmaxf(best, acc[jj][i]);
    best = warp_max(best);
    const int j = j0 + 8 * wid + jj;
    if (lane == 0 && j < jend) atomicMax(score + cell * max_blocks + j, to_sortable(best));
  }
}

// ---- 3. select -------------------------------------------------------------
// grid (nQB, n_kv, B), NT threads.
__global__ void __launch_bounds__(NT) prefill_select_kernel(
    const uint32_t* __restrict__ score, const int* __restrict__ n_blocks,
    const int* __restrict__ k_sel, const int* __restrict__ bsz,
    const int* __restrict__ n_valid, int* __restrict__ slots,  // [cells, max_blocks]
    int* __restrict__ n_att, uint8_t* __restrict__ sel_out, int n_kv, int nQB,
    int BQ, int page_size, int sink_pages, int local_pages, int max_blocks, int qb0) {
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s = reinterpret_cast<float*>(smem_raw);          // [max_blocks]
  int* red = reinterpret_cast<int*>(s + max_blocks);      // [NWARPS]

  const int nblk = n_blocks[h], ks = k_sel[h], bs = bsz[h], nv = n_valid[b];
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
  auto cand = [&](int j) { return q_live && causal(j) && !forced(j); };

  for (int j = tid; j < nblk; j += NT)
    s[j] = cand(j) ? from_sortable(score[cell * max_blocks + j]) : ABS_NEG_INF;
  __syncthreads();

  int n_gt;
  const uint32_t thr = topk_threshold(s, nblk, ks, red, &n_gt);
  const int quota = ks - n_gt;
  int tie_off = 0, n_live = 0;
  int* sl = slots + cell * max_blocks;
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
    if (sel) sl[sr] = j;
    if (sel_out != nullptr && in) sel_out[cell * max_blocks + j] = sel;
    n_live += tot;
  }
  if (sel_out != nullptr)
    for (int j = nblk + tid; j < max_blocks; j += NT) sel_out[cell * max_blocks + j] = 0;
  if (tid == 0) n_att[cell] = n_live;
}

// ---- 4. attend -------------------------------------------------------------
// grid (n_split * n_groups, nQB, n_kv * B), NWG * 128 threads: warpgroup w
// of group gr = x % n_groups owns row tile NWG gr + w (64 query rows) of the
// cell's R = g * BQ rows, run x / n_groups of its key tiles; the group's
// warpgroups share each gathered K / V tile.  A warpgroup past the cell's
// last row only loads and waits at the barriers.
template <int D, int NWG>
__global__ void __launch_bounds__(NTA * NWG, 1) prefill_attend_kernel(
    const __nv_bfloat16* __restrict__ q,      // [B, n_kv, nQB, R, D]
    const __nv_bfloat16* __restrict__ kp,     // [B, n_kv, nP, ps, D]
    const __nv_bfloat16* __restrict__ vp,
    const int* __restrict__ slots, const int* __restrict__ n_att,
    const int* __restrict__ bsz, const int* __restrict__ n_valid,
    __nv_bfloat16* __restrict__ out,          // like q, one run only
    float* __restrict__ part_ml,              // [cells, n_split, R, 2]
    float* __restrict__ part_acc,             // [cells, n_split, R, D]
    int n_kv, int nQB, int g, int BQ, int n_pages, int page_size,
    int max_blocks, int qb0, int n_split, float scale_log2) {
  using namespace absparse::tile;
  constexpr int NTHR = NTA * NWG;
  constexpr int QROWS = QT * NWG;       // query rows of the group's Q tile
  constexpr int TILE = KEYS * D * 2;    // bytes of one K or V tile
  constexpr int CPR = D / 8;            // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + QROWS * D * 2;  // K stage st at sk + st * TILE
  const uint32_t sv = sk + KST * TILE;     // V stage st at sv + st * TILE

  const int R = g * BQ, n_groups = (R + QROWS - 1) / QROWS;
  const int gr = blockIdx.x % n_groups, split = blockIdx.x / n_groups, qb = blockIdx.y;
  const int h = blockIdx.z % n_kv, b = blockIdx.z / n_kv;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const size_t cell = ((size_t)b * n_kv + h) * nQB + qb;
  const int nv = n_valid[b], bs = bsz[h];
  const int q_start = (qb0 + qb) * BQ;
  const int n_tok = (q_start < nv ? n_att[cell] : 0) * bs;
  const int n_t = (n_tok + KEYS - 1) / KEYS;
  const int per = (n_t + n_split - 1) / n_split;
  const int t_begin = min(n_t, split * per), n = min(n_t, t_begin + per) - t_begin;
  const int g_base = gr * QROWS;           // the group's first row
  const bool active = g_base + wg * QT < R;
  // this thread's rows (in the cell): row0 and row0 + 8
  const int row0 = g_base + wg * QT + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const size_t prow = (cell * n_split + split) * (size_t)R;   // run's partial rows

  if (n == 0) {                         // nothing to attend: 0, or an empty run
    for (int i = tid; i < QROWS * D; i += NTHR) {
      const int r = g_base + i / D, d = i % D;
      if (r >= R) continue;
      if (n_split == 1) {
        out[(cell * R + r) * D + d] = __float2bfloat16(0.f);
      } else {
        part_acc[(prow + r) * D + d] = 0.f;
        if (d == 0) {
          part_ml[(prow + r) * 2] = NEG;
          part_ml[(prow + r) * 2 + 1] = 0.f;
        }
      }
    }
    return;
  }

  // the run's selected blocks, staged in shared memory after the tiles:
  // slots s_lo .. s_lo + n_sl - 1 of the cell's list
  int* sl_s = reinterpret_cast<int*>(smem_raw + (sq - smem_u32(smem_raw)) +
                                     QROWS * D * 2 + (KST + VST) * TILE);
  const int s_lo = t_begin * KEYS / bs;
  const int n_sl = min(n_tok / bs, ((t_begin + n) * KEYS + bs - 1) / bs) - s_lo;
  for (int i = tid; i < n_sl; i += NTHR) sl_s[i] = slots[cell * max_blocks + s_lo + i];
  const size_t head_tok = ((size_t)b * n_kv + h) * (size_t)n_pages * page_size;
  const __nv_bfloat16* kh = kp + head_tok * D;
  const __nv_bfloat16* vh = vp + head_tok * D;
  // position of the cell's selected key i (i < n_tok)
  auto key_pos = [&](int i) { return sl_s[i / bs - s_lo] * bs + i % bs; };
  __syncthreads();

  // gather key tile t (keys 64 t .. 64 t + 63 of the slot order) into K
  // stage t % KST and V stage t % VST; keys past the last selected token or
  // at or past n_valid are zero-filled, not read
  auto load_kv = [&](int t) {
    const uint32_t kd = sk + (t % KST) * TILE, vd = sv + (t % VST) * TILE;
#pragma unroll
    for (int it = 0; it < (KEYS * CPR + NTHR - 1) / NTHR; ++it) {
      const int i = tid + it * NTHR, r = i / CPR, c = i % CPR;
      if (i >= KEYS * CPR) break;
      const int key = t * KEYS + r;
      int pos = key < n_tok ? key_pos(key) : 0;
      const bool ok = key < n_tok && pos < nv;
      pos = ok ? pos : 0;
      cp_async16(kd + swz<KEYS>(r, c), kh + (size_t)pos * D + c * 8, ok);
      cp_async16(vd + swz<KEYS>(r, c), vh + (size_t)pos * D + c * 8, ok);
    }
  };
  // a tile needs per-key masks if it runs past the last selected token or
  // its last key reaches the cell's first query position or n_valid
  auto needs_mask = [&](int t) {
    const int last = (t + 1) * KEYS - 1;
    if (last >= n_tok) return true;
    const int p = key_pos(last);
    return p >= q_start || p >= nv;
  };

  load_tile<QROWS, D, NTHR>(sq, q + (cell * R + g_base) * D, R - g_base, tid);
  load_kv(t_begin);
  cp_async_commit();
  if (n > 1) load_kv(t_begin + 1);
  cp_async_commit();
  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();

  const uint32_t q_rows = sq + wg * QT * 128;
  float s[32], o[D / 2];
  uint32_t p_hi[4][4], p_lo[4][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qpos[hh] = q_start + (row0 + 8 * hh) % BQ;

  if (active) {
    wg_fence();
    qk<D, QROWS>(s, q_rows, sk + (t_begin % KST) * TILE);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
  }

  for (int j = 0; j < n; ++j) {
    const int t = t_begin + j;
    if (active) {
      if (needs_mask(t)) {
#pragma unroll
        for (int cc = 0; cc < 16; ++cc) {  // the thread's 16 key columns
          const int col = 8 * (cc >> 1) + 2 * (lane & 3) + (cc & 1);
          const int key = t * KEYS + col;
          const int pos = key < n_tok ? key_pos(key) : nv;
          const bool kok = pos < nv;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * (cc >> 1) + 2 * hh + (cc & 1);
            if (!kok || pos > qpos[hh]) s[i] = -INFINITY;
          }
        }
      }
      softmax_step(s, scale_log2, m, l, alpha);
      wg_wait<0>();                     // P V of tile j - 1 is done
      fence_regs(o);
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) rescale(o, alpha);
      split_p(s, p_hi, p_lo);
    }
    cp_async_wait<0>();                 // tile j + 1 has landed
    fence_async_smem();
    __syncthreads();                    // ... for all threads; K of j, V of j - 1 free
    if (j + 2 < n) load_kv(t + 2);
    cp_async_commit();
    if (active) {
      // the logits of tile j + 1 (after the last tile: of tile j again,
      // unused), so that every iteration commits the same two groups
      wg_fence();
      qk<D, QROWS>(s, q_rows, sk + ((t_begin + min(j + 1, n - 1)) % KST) * TILE);
      wg_commit();
      const uint32_t v_tile = sv + (t % VST) * TILE;
      pv<D>(o, p_hi, v_tile);
      pv<D>(o, p_lo, v_tile);
      wg_commit();
      wg_wait<1>();                     // logits of tile j + 1
      fence_regs(s);
    }
  }
  if (!active) return;
  wg_wait<0>();
  fence_regs(o);

  float lsum[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) lsum[hh] = quad_sum(l[hh]);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int hh = (i >> 1) & 1, r = row0 + 8 * hh;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (r >= R) continue;
    if (n_split == 1) {
      const float inv = 1.f / fmaxf(lsum[hh], 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(out + (cell * R + r) * D + col) =
          __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    } else {
      *reinterpret_cast<float2*>(part_acc + (prow + r) * D + col) = make_float2(o[i], o[i + 1]);
      if (i < 4 && (lane & 3) == 0) {
        part_ml[(prow + r) * 2] = m[hh];
        part_ml[(prow + r) * 2 + 1] = lsum[hh];
      }
    }
  }
}

// ---- 5. combine ------------------------------------------------------------
// grid (cells, ceil(R / NWARPS)): warp w combines query row NWARPS y + w of
// one cell, each lane D / 32 channels.
template <int D>
__global__ void __launch_bounds__(NT) prefill_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    __nv_bfloat16* __restrict__ out, int n_split, int R) {
  constexpr int CPL = D / 32;
  const size_t cell = blockIdx.x;
  const int r = blockIdx.y * NWARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= R) return;
  float mm = tile::NEG;
  for (int s = 0; s < n_split; ++s)
    mm = fmaxf(mm, part_ml[((cell * n_split + s) * R + r) * 2]);
  float ll = 0.f, acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t pr = (cell * n_split + s) * R + r;
    const float w = tile::ex2(part_ml[pr * 2] - mm);
    ll += part_ml[pr * 2 + 1] * w;
    const float* a = part_acc + pr * D + lane * CPL;
#pragma unroll
    for (int k = 0; k < CPL; ++k) acc[k] = fmaf(a[k], w, acc[k]);
  }
  const float inv = 1.f / fmaxf(ll, 1e-30f);
  __nv_bfloat16* o = out + (cell * R + r) * D + lane * CPL;
#pragma unroll
  for (int k = 0; k < CPL; k += 2)
    *reinterpret_cast<__nv_bfloat162*>(o + k) =
        __floats2bfloat162_rn(acc[k] * inv, acc[k + 1] * inv);
}

// Shared memory of an attention block: 1024 bytes of slack to align the
// tiles to the swizzle period, the Q / K / V tiles, and the run's slots
// (at most ceil(max_blocks / n_split) + 1).
template <int D, int NWG>
constexpr size_t attend_smem(int run_slots) {
  return 1024 + (size_t)QT * NWG * D * 2 + (size_t)(KST + VST) * tile::KEYS * D * 2 +
         sizeof(int) * (size_t)run_slots;
}

// Slots a run of key tiles can span: at most ceil(max_blocks / n_split)
// blocks plus those cut at its two ends (64 / bs + 2 with bs >= 1).
int run_slots(int max_blocks, int n_split) {
  return (max_blocks + n_split - 1) / n_split + 66;
}

// Warpgroups of an attention block: every row tile of the cell up to 3
// (192 rows, a 384-thread block), else 2 (R 256: two blocks of 128 rows,
// R 512: four); one at head_dim 256, where a second 32 KB Q tile beside
// the five 32 KB K / V stages would pass the 227 KB a block may use.
int attend_wgs(int R, int D) {
  const int nrt = (R + QT - 1) / QT;
  return D == 256 ? 1 : nrt <= 3 ? nrt : 2;
}

// Query rows per lane of a scoring slice: the one of 4, 3, 2 that leaves
// the fewest idle lanes over the cell's R rows (the larger on a tie).
int score_rpt(int R) {
  int best = 4, waste = 1 << 30;
  for (int rpt = 4; rpt >= 2; --rpt) {
    const int w = (R + 32 * rpt - 1) / (32 * rpt) * 32 * rpt - R;
    if (w < waste) best = rpt, waste = w;
  }
  return best;
}

size_t score_smem(int RPT) {
  return sizeof(float) * ((size_t)KC * (32 * RPT + 1) + (size_t)KC * JTP);
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// Shared memory of the largest of the call's kernels (for the wrapper's check).
extern "C" size_t sparse_prefill_smem_bytes(int g, int BQ, int D, int Dp,
                                            int max_blocks, int n_split) {
  (void)Dp;
  size_t m = score_smem(score_rpt(g * BQ));
  const size_t sel = sizeof(float) * (size_t)max_blocks + sizeof(int) * NWARPS;
  const int nwg = attend_wgs(g * BQ, D), rs = run_slots(max_blocks, n_split);
  const size_t att = D == 256 ? attend_smem<256, 1>(rs)
                     : D == 64 ? (nwg == 1 ? attend_smem<64, 1>(rs)
                                           : nwg == 2 ? attend_smem<64, 2>(rs)
                                                      : attend_smem<64, 3>(rs))
                               : (nwg == 1 ? attend_smem<128, 1>(rs)
                                           : nwg == 2 ? attend_smem<128, 2>(rs)
                                                      : attend_smem<128, 3>(rs));
  if (sel > m) m = sel;
  return att > m ? att : m;
}

// Returns the cudaError_t of the first failed launch (0 on success).
// Scratch: rk [B, total_rows, Dp] f32; score [B, n_kv, nQB, max_blocks] u32;
// slots [B, n_kv, nQB, max_blocks] int32; part_ml / part_acc [B, n_kv, nQB,
// n_split, g * BQ, 2 | D] f32 (not read when n_split is 1).  jb: a bound on
// the candidate rows of any head (the grid of the dequant / score kernels).
extern "C" int sparse_prefill_launch(
    const void* q, const float* rq, const void* kp, const void* vp,
    const uint8_t* codes, const float* pscale, const float* pzero,
    const int* row_off, const int* n_blocks, const int* k_sel, const int* bsz,
    const int* n_valid, void* out, int* n_att, uint8_t* sel_out, float* rk,
    uint32_t* score, int* slots, float* part_ml, float* part_acc, int B, int n_kv,
    int nQB, int g, int BQ, int D, int Dp, int n_pages, int page_size,
    int total_rows, int row_bytes, int bits, int sym, int sink_pages,
    int local_pages, int max_blocks, int qb0, int jb, int n_split,
    float scale_qk, void* stream) {
  const int R = g * BQ;
  if (R < 1 || R > 8 * QT || Dp % KC || (D != 64 && D != 128 && D != 256) ||
      n_split < 1 || B < 1 || n_kv < 1 || n_kv * B > 65535 || nQB < 1 || nQB > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e;
  if (jb > 0) {
    prefill_dequant_kernel<<<dim3((jb + NWARPS - 1) / NWARPS, n_kv, B), NT, 0, st>>>(
        codes, pscale, pzero, row_off, n_blocks, bsz, n_valid, rk, nQB, BQ, Dp,
        total_rows, row_bytes, bits, sym, local_pages, page_size, qb0);
    if ((e = (int)cudaGetLastError())) return e;
    const int rpt = score_rpt(R), n_slices = (R + 32 * rpt - 1) / (32 * rpt);
    const dim3 sgrid((jb + JT - 1) / JT, n_slices * nQB, n_kv * B);
    if ((e = (int)cudaMemsetAsync(score, 0, sizeof(uint32_t) * (size_t)B * n_kv * nQB *
                                                max_blocks, st)))
      return e;
#define ABS_SCORE(RPT)                                                           \
  if (rpt == RPT) {                                                              \
    const size_t sm = score_smem(RPT);                                           \
    if ((e = set_smem((const void*)prefill_score_kernel<RPT>, sm))) return e;    \
    prefill_score_kernel<RPT><<<sgrid, NT, sm, st>>>(                            \
        rk, rq, row_off, n_blocks, bsz, n_valid, score, n_kv, nQB, g, BQ, Dp,    \
        total_rows, local_pages, page_size, max_blocks, qb0);                    \
  }
    ABS_SCORE(2) ABS_SCORE(3) ABS_SCORE(4)
#undef ABS_SCORE
    if ((e = (int)cudaGetLastError())) return e;
  }
  const size_t sel_sm = sizeof(float) * (size_t)max_blocks + sizeof(int) * NWARPS;
  if ((e = set_smem((const void*)prefill_select_kernel, sel_sm))) return e;
  prefill_select_kernel<<<dim3(nQB, n_kv, B), NT, sel_sm, st>>>(
      score, n_blocks, k_sel, bsz, n_valid, slots, n_att, sel_out, n_kv, nQB, BQ,
      page_size, sink_pages, local_pages, max_blocks, qb0);
  if ((e = (int)cudaGetLastError())) return e;

  const int nwg = attend_wgs(R, D), n_groups = (R + QT * nwg - 1) / (QT * nwg);
  const dim3 agrid(n_split * n_groups, nQB, n_kv * B);
  const float scale_log2 = scale_qk * 1.4426950408889634f;
#define ABS_ATTEND(DD, NWG)                                                      \
  if (D == DD && nwg == NWG) {                                                   \
    const size_t sm = attend_smem<DD, NWG>(run_slots(max_blocks, n_split));     \
    if ((e = set_smem((const void*)prefill_attend_kernel<DD, NWG>, sm))) return e; \
    prefill_attend_kernel<DD, NWG><<<agrid, NTA * NWG, sm, st>>>(                \
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,                       \
        (const __nv_bfloat16*)vp, slots, n_att, bsz, n_valid,                    \
        (__nv_bfloat16*)out, part_ml, part_acc, n_kv, nQB, g, BQ, n_pages,       \
        page_size, max_blocks, qb0, n_split, scale_log2);                        \
  }
  ABS_ATTEND(64, 1) ABS_ATTEND(64, 2) ABS_ATTEND(64, 3)
  ABS_ATTEND(128, 1) ABS_ATTEND(128, 2) ABS_ATTEND(128, 3)
  ABS_ATTEND(256, 1)
#undef ABS_ATTEND
  if ((e = (int)cudaGetLastError()) || n_split == 1) return e;
  const dim3 cgrid(B * n_kv * nQB, (R + NWARPS - 1) / NWARPS);
  if (D == 64)
    prefill_combine_kernel<64><<<cgrid, NT, 0, st>>>(part_ml, part_acc,
                                                     (__nv_bfloat16*)out, n_split, R);
  else if (D == 128)
    prefill_combine_kernel<128><<<cgrid, NT, 0, st>>>(part_ml, part_acc,
                                                      (__nv_bfloat16*)out, n_split, R);
  else
    prefill_combine_kernel<256><<<cgrid, NT, 0, st>>>(part_ml, part_acc,
                                                      (__nv_bfloat16*)out, n_split, R);
  return (int)cudaGetLastError();
}
