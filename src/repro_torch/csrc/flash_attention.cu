// Dense GQA flash attention for Hopper (sm_90a), causal or not:
// q [B, Hq, Sq, D] at positions q_offset + i, k / v [B, Hkv, Sk, D] bf16
// -> out [B, Hq, Sq, D] bf16, query head h reading kv head h / (Hq / Hkv),
// f32 logits, softmax state and accumulators.  Key j is attended by query
// i when j < k_len[b] and, if causal, j <= q_offset + i.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (_flash_kernel,
// pallas_call at line 117), whose contract is the case q_offset = 0,
// Sq = Sk = k_len.  Same arithmetic: logits = (q . k) * D^-1/2, future keys
// masked when causal, a running (max, sum, acc) rescaled per key tile, and
// out = acc / max(l, 1e-30).  The TPU kernel walks the key tiles as the
// last, sequential grid axis with the state in VMEM scratch; here one
// thread block per (head, query tile of 128 rows, 64 at head_dim 256,
// sequence) loops over the 64-key tiles itself, and a causal block stops
// at the tile of its last query's position (masking from the first tile a
// row of it must not see whole).  Blocks are issued heaviest first: the
// grid's slowest axis after the heads is the query tile, last tile first.
//
// The offset and the key length serve chunked dense prefill: a chunk's
// queries at offset over the keys [0, offset + n) of the slot's cache row
// (the paged cache [n_kv, n_pages, 16, D] is [n_kv, S, D] in memory).
// Both may be any integer, so the tile bounds come from positions, not
// indices: a warpgroup masks per key from the first tile whose last key
// lies past its first row's position, or that holds k_len; the key tile
// holding k_len loads zeros past it; no tile past k_len is read.
//
// Bound on the card: operations (4 D flops per live query-key pair at the
// bf16 tensor-core rate; 6 D as run here, see below).  Design
// (attn_tile.cuh holds the tile):
//  - both products on the tensor cores with wgmma: two warpgroups, each 64
//    query rows (one at head_dim 256, for shared memory: Shape below); S = Q K^T from shared memory (m64n64k16), O += P V with P
//    from registers and V from shared memory (m64nDk16, transposed B);
//  - P is split into bf16 hi + lo and O accumulates both products: one
//    bf16 rounding of P fails the one-bf16-step comparison with the f32
//    plain version (attn_tile.cuh says by how much);
//  - K and V arrive by 16-byte cp.async into a ring of three swizzled
//    stages, tile j + 2 loading while tile j is computed; Q is loaded once;
//  - the products of tile j + 1's logits and tile j's P V are issued
//    together, and the softmax of tile j + 1 runs while P V is still on
//    the tensor cores (one block-wide barrier per key tile);
//  - a query tile that runs past Sq zero-fills its missing rows and does
//    not store them.
#include "common.cuh"
#include "attn_tile.cuh"

using namespace absparse;
using namespace absparse::tile;

namespace {

constexpr int BK = KEYS;                // keys per tile
constexpr int NSTAGE = 3;               // K / V ring depth
constexpr float LOG2E = 1.4426950408889634f;

// Warpgroups of a thread block: two (128 query rows) at head_dim 64 and
// 128; one at 256, where a 128-row Q tile (64 KB) beside the three-stage
// K / V ring (192 KB) would pass the 227 KB a block may use (64 rows:
// 225 KB).  Each K / V tile is then read once per 64 query rows.
template <int D>
struct Shape {
  static constexpr int NWG = D == 256 ? 1 : 2;
  static constexpr int BQ = NWG * ROWS_WG;   // query rows per thread block
  static constexpr int NTHR = NWG * 128;
};

template <int D>
constexpr size_t smem_bytes() {
  // 1024 bytes of slack to align the tiles to the swizzle period
  return 1024 + (size_t)Shape<D>::BQ * D * 2 + (size_t)NSTAGE * 2 * BK * D * 2;
}

// The TPU kernel's contract (q_offset 0, Sq = Sk = k_len, a multiple of
// the key tile), kept as the kernel was before the offset and the key
// length were added: the general kernel after it, even instantiated with
// the offset and the length fixed at compile time, ran this contract
// about 1.4% slower with the same outputs (tools/flash_parent_check.py on
// an H100).
template <int D>
__global__ void __launch_bounds__(Shape<D>::NTHR, 1) flash_square_kernel(
    const __nv_bfloat16* __restrict__ q,    // [B, Hq, S, D]
    const __nv_bfloat16* __restrict__ k,    // [B, Hkv, S, D]
    const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ out,        // [B, Hq, S, D]
    int Hq, int Hkv, int S, int causal, float scale_log2) {
  constexpr int BQ = Shape<D>::BQ, NTHR = Shape<D>::NTHR;
  constexpr int TILE = BK * D * 2;      // bytes of one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + BQ * D * 2;  // stage st: K at skv + 2 st TILE, V after

  const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int q0 = qt * BQ;
  // this thread's rows: row0 and row0 + 8
  const int row0 = q0 + wg * ROWS_WG + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const __nv_bfloat16* qh = q + (((size_t)b * Hq + h) * S + q0) * D;
  const __nv_bfloat16* kh = k + ((size_t)b * Hkv + hk) * S * D;
  const __nv_bfloat16* vh = v + ((size_t)b * Hkv + hk) * S * D;
  const int n_kt = causal ? min(S / BK, (q0 + BQ - 1) / BK + 1) : S / BK;

  auto load_kv = [&](int t) {
    const uint32_t st = skv + (t % NSTAGE) * 2 * TILE;
    load_tile<BK, D, NTHR>(st, kh + (size_t)t * BK * D, BK, tid);
    load_tile<BK, D, NTHR>(st + TILE, vh + (size_t)t * BK * D, BK, tid);
  };
  load_tile<BQ, D, NTHR>(sq, qh, S - q0, tid);
  load_kv(0);
  cp_async_commit();
  if (n_kt > 1) load_kv(1);
  cp_async_commit();
  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();

  const uint32_t q_rows = sq + wg * ROWS_WG * 128;
  float s[32], o[D / 2];
  uint32_t p_hi[4][4], p_lo[4][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  wg_fence();
  qk<D, BQ>(s, q_rows, skv);
  wg_commit();
  wg_wait<0>();
  fence_regs(s);

  // key tiles past the warpgroup's first row need the causal mask
  const int diag0 = (q0 + wg * ROWS_WG) / BK;
  for (int j = 0; j < n_kt; ++j) {
    if (causal && j >= diag0) {
      const int k0 = j * BK + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + 8 * (i >> 2) + (i & 1);
        if (col > row0 + 8 * ((i >> 1) & 1)) s[i] = -INFINITY;
      }
    }
    softmax_step(s, scale_log2, m, l, alpha);
    wg_wait<0>();                       // P V of tile j - 1 is done
    fence_regs(o);
    // rows whose maximum did not move have alpha = 1
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) rescale(o, alpha);
    split_p(s, p_hi, p_lo);
    cp_async_wait<0>();                 // tile j + 1 has landed
    fence_async_smem();
    __syncthreads();                    // ... for all threads; stage of j - 1 free
    if (j + 2 < n_kt) load_kv(j + 2);
    cp_async_commit();
    // the logits of tile j + 1 (after the last tile: of tile j again,
    // unused), so that every iteration commits the same two groups and
    // the compiler can keep the products in flight
    wg_fence();
    qk<D, BQ>(s, q_rows, skv + (min(j + 1, n_kt - 1) % NSTAGE) * 2 * TILE);
    wg_commit();
    const uint32_t v_tile = skv + (j % NSTAGE) * 2 * TILE + TILE;
    pv<D>(o, p_hi, v_tile);
    pv<D>(o, p_lo, v_tile);
    wg_commit();
    wg_wait<1>();                       // logits of tile j + 1
    fence_regs(s);
  }
  wg_wait<0>();
  fence_regs(o);

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / fmaxf(quad_sum(l[hh]), 1e-30f);
  __nv_bfloat16* oh = out + ((size_t)b * Hq + h) * S * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int hh = (i >> 1) & 1, row = row0 + 8 * hh;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (row < S)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)row * D + col) =
          __floats2bfloat162_rn(o[i] * inv[hh], o[i + 1] * inv[hh]);
  }
}

// Any q_offset and key length.  TAIL: some sequence's key length is no
// multiple of the key tile (or the lengths come per sequence), so the tile
// holding it loads zeros past it and masks per key; without it no load
// carries a row predicate and no key a length mask.
template <int D, bool TAIL>
__global__ void __launch_bounds__(Shape<D>::NTHR, 1) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q,    // [B, Hq, Sq, D]
    const __nv_bfloat16* __restrict__ k,    // [B, Hkv, Sk, D]
    const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ out,        // [B, Hq, Sq, D]
    const int* __restrict__ k_len,          // [B], or null: k_len_all
    int k_len_all, int Hq, int Hkv, int Sq, int Sk, int q_offset, int causal,
    float scale_log2) {
  constexpr int BQ = Shape<D>::BQ, NTHR = Shape<D>::NTHR;
  constexpr int TILE = BK * D * 2;      // bytes of one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + BQ * D * 2;  // stage st: K at skv + 2 st TILE, V after

  const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int q0 = qt * BQ;
  const int klen = TAIL && k_len ? k_len[b] : k_len_all;
  // this thread's rows: row0 and row0 + 8, at positions pos0 and pos0 + 8
  const int row0 = q0 + wg * ROWS_WG + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int pos0 = q_offset + row0;
  const __nv_bfloat16* qh = q + (((size_t)b * Hq + h) * Sq + q0) * D;
  const __nv_bfloat16* kh = k + ((size_t)b * Hkv + hk) * Sk * D;
  const __nv_bfloat16* vh = v + ((size_t)b * Hkv + hk) * Sk * D;
  // key tiles holding live keys; when causal, up to the last query's position
  const int q_last = q_offset + min(q0 + BQ, Sq) - 1;
  const int n_kt = causal ? min((klen + BK - 1) / BK, q_last / BK + 1)
                          : (klen + BK - 1) / BK;

  auto load_kv = [&](int t) {
    const uint32_t st = skv + (t % NSTAGE) * 2 * TILE;
    const __nv_bfloat16* kt = kh + (size_t)t * BK * D;
    const __nv_bfloat16* vt = vh + (size_t)t * BK * D;
    if (!TAIL || (t + 1) * BK <= klen) {  // a whole tile: no row predicate
      load_tile<BK, D, NTHR>(st, kt, BK, tid);
      load_tile<BK, D, NTHR>(st + TILE, vt, BK, tid);
    } else {                            // the tile holding k_len: zeros past it
      load_tile<BK, D, NTHR>(st, kt, klen - t * BK, tid);
      load_tile<BK, D, NTHR>(st + TILE, vt, klen - t * BK, tid);
    }
  };
  load_tile<BQ, D, NTHR>(sq, qh, Sq - q0, tid);
  load_kv(0);
  cp_async_commit();
  if (n_kt > 1) load_kv(1);
  cp_async_commit();
  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();

  const uint32_t q_rows = sq + wg * ROWS_WG * 128;
  float s[32], o[D / 2];
  uint32_t p_hi[4][4], p_lo[4][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  wg_fence();
  qk<D, BQ>(s, q_rows, skv);
  wg_commit();
  wg_wait<0>();
  fence_regs(s);

  // key tiles from the warpgroup's diagonal on need the causal mask: the
  // first is the one whose last key lies past its first row's position;
  // with TAIL the tile holding k_len needs per-key masks too
  const int diag0 = (q_offset + q0 + wg * ROWS_WG + 1) / BK;
  const int mask_from = TAIL ? min(causal ? diag0 : n_kt, klen / BK) : diag0;
  for (int j = 0; j < n_kt; ++j) {
    if ((TAIL || causal) && j >= mask_from) {
      const int k0 = j * BK + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + 8 * (i >> 2) + (i & 1);
        const int pos = pos0 + 8 * ((i >> 1) & 1);
        if (TAIL ? (causal && col > pos) || col >= klen : col > pos) s[i] = -INFINITY;
      }
    }
    softmax_step(s, scale_log2, m, l, alpha);
    wg_wait<0>();                       // P V of tile j - 1 is done
    fence_regs(o);
    // rows whose maximum did not move have alpha = 1
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) rescale(o, alpha);
    split_p(s, p_hi, p_lo);
    cp_async_wait<0>();                 // tile j + 1 has landed
    fence_async_smem();
    __syncthreads();                    // ... for all threads; stage of j - 1 free
    if (j + 2 < n_kt) load_kv(j + 2);
    cp_async_commit();
    // the logits of tile j + 1 (after the last tile: of tile j again,
    // unused), so that every iteration commits the same two groups and
    // the compiler can keep the products in flight
    wg_fence();
    qk<D, BQ>(s, q_rows, skv + (min(j + 1, n_kt - 1) % NSTAGE) * 2 * TILE);
    wg_commit();
    const uint32_t v_tile = skv + (j % NSTAGE) * 2 * TILE + TILE;
    pv<D>(o, p_hi, v_tile);
    pv<D>(o, p_lo, v_tile);
    wg_commit();
    wg_wait<1>();                       // logits of tile j + 1
    fence_regs(s);
  }
  wg_wait<0>();
  fence_regs(o);

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / fmaxf(quad_sum(l[hh]), 1e-30f);
  __nv_bfloat16* oh = out + ((size_t)b * Hq + h) * Sq * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int hh = (i >> 1) & 1, row = row0 + 8 * hh;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (row < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)row * D + col) =
          __floats2bfloat162_rn(o[i] * inv[hh], o[i + 1] * inv[hh]);
  }
}

template <int D, bool TAIL>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* out, const int* k_len,
           int k_len_all, int B, int Hq, int Hkv, int Sq, int Sk, int q_offset,
           int causal, float scale, cudaStream_t stream) {
  constexpr int BQ = Shape<D>::BQ, NTHR = Shape<D>::NTHR;
  const size_t smem = smem_bytes<D>();
  const bool square = !TAIL && q_offset == 0 && Sq == Sk && k_len_all == Sk;
  cudaError_t e = cudaFuncSetAttribute(
      square ? (const void*)flash_square_kernel<D>
             : (const void*)flash_attention_kernel<D, TAIL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (Sq + BQ - 1) / BQ;
  if (square)
    flash_square_kernel<D><<<dim3(Hq, n_qt, B), NTHR, smem, stream>>>(
        q, k, v, out, Hq, Hkv, Sq, causal, scale * LOG2E);
  else
    flash_attention_kernel<D, TAIL><<<dim3(Hq, n_qt, B), NTHR, smem, stream>>>(
        q, k, v, out, k_len, k_len_all, Hq, Hkv, Sq, Sk, q_offset, causal,
        scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
             const __nv_bfloat16* v, __nv_bfloat16* out, const int* k_len,
             int k_len_all, int B, int Hq, int Hkv, int Sq, int Sk, int q_offset,
             int causal, float scale, cudaStream_t stream) {
  if (k_len || k_len_all % BK)
    return launch<D, true>(q, k, v, out, k_len, k_len_all, B, Hq, Hkv, Sq, Sk,
                           q_offset, causal, scale, stream);
  return launch<D, false>(q, k, v, out, k_len, k_len_all, B, Hq, Hkv, Sq, Sk,
                          q_offset, causal, scale, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  k_len: [B] int32
// live keys per sequence (each in [1, Sk]), or null for k_len_all keys in
// every sequence.
extern "C" int flash_attention_launch(const __nv_bfloat16* q,
                                      const __nv_bfloat16* k,
                                      const __nv_bfloat16* v,
                                      __nv_bfloat16* out, const int* k_len,
                                      int k_len_all, int B, int Hq, int Hkv,
                                      int Sq, int Sk, int D, int q_offset,
                                      int causal, float scale, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || Hq % Hkv || Hq > 65535 || Sq < 1 ||
      Sk < 1 || q_offset < 0 || (!k_len && (k_len_all < 1 || k_len_all > Sk)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch_d<128>(q, k, v, out, k_len, k_len_all, B, Hq, Hkv, Sq, Sk,
                         q_offset, causal, scale, st);
  if (D == 64)
    return launch_d<64>(q, k, v, out, k_len, k_len_all, B, Hq, Hkv, Sq, Sk,
                        q_offset, causal, scale, st);
  if (D == 256)
    return launch_d<256>(q, k, v, out, k_len, k_len_all, B, Hq, Hkv, Sq, Sk,
                         q_offset, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
