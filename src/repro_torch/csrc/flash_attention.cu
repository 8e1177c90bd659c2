// Dense GQA flash attention for Hopper (sm_90a), causal or not:
// q [B, Hq, S, D], k / v [B, Hkv, S, D] bf16 -> out [B, Hq, S, D] bf16,
// query head h reading kv head h / (Hq / Hkv), f32 logits, softmax state
// and accumulators.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (_flash_kernel,
// pallas_call at line 117).  Same arithmetic: logits = (q . k) * D^-1/2,
// future keys masked when causal, a running (max, sum, acc) rescaled per
// key tile, and out = acc / max(l, 1e-30).  The TPU kernel walks the key
// tiles as the last, sequential grid axis with the state in VMEM scratch;
// here one thread block per (head, query tile of 128 rows, sequence) loops
// over the 64-key tiles itself, and a causal block stops at its diagonal
// tile (masking inside it).  Blocks are issued heaviest first: the grid's
// slowest axis after the heads is the query tile, last tile first.
//
// Bound on the card: operations (4 D flops per live query-key pair at the
// bf16 tensor-core rate; 6 D as run here, see below).  Design
// (attn_tile.cuh holds the tile):
//  - both products on the tensor cores with wgmma: two warpgroups, each 64
//    query rows; S = Q K^T from shared memory (m64n64k16), O += P V with P
//    from registers and V from shared memory (m64nDk16, transposed B);
//  - P is split into bf16 hi + lo and O accumulates both products: one
//    bf16 rounding of P fails the one-bf16-step comparison with the f32
//    plain version (attn_tile.cuh says by how much);
//  - K and V arrive by 16-byte cp.async into a ring of three swizzled
//    stages, tile j + 2 loading while tile j is computed; Q is loaded once;
//  - the products of tile j + 1's logits and tile j's P V are issued
//    together, and the softmax of tile j + 1 runs while P V is still on
//    the tensor cores (one block-wide barrier per key tile);
//  - a query tile that runs past S (S a multiple of 64, not of 128) zero-
//    fills its missing rows and does not store them.
#include "common.cuh"
#include "attn_tile.cuh"

using namespace absparse;
using namespace absparse::tile;

namespace {

constexpr int BQ = 2 * ROWS_WG;         // query rows per thread block
constexpr int BK = KEYS;                // keys per tile
constexpr int NSTAGE = 3;               // K / V ring depth
constexpr int NTHR = 256;               // two warpgroups
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes() {
  // 1024 bytes of slack to align the tiles to the swizzle period
  return 1024 + (size_t)BQ * D * 2 + (size_t)NSTAGE * 2 * BK * D * 2;
}

template <int D>
__global__ void __launch_bounds__(NTHR, 1) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q,    // [B, Hq, S, D]
    const __nv_bfloat16* __restrict__ k,    // [B, Hkv, S, D]
    const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ out,        // [B, Hq, S, D]
    int Hq, int Hkv, int S, int causal, float scale_log2) {
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

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* out, int B, int Hq, int Hkv,
           int S, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (S + BQ - 1) / BQ;
  flash_attention_kernel<D><<<dim3(Hq, n_qt, B), NTHR, smem, stream>>>(
      q, k, v, out, Hq, Hkv, S, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const __nv_bfloat16* q,
                                      const __nv_bfloat16* k,
                                      const __nv_bfloat16* v,
                                      __nv_bfloat16* out, int B, int Hq,
                                      int Hkv, int S, int D, int causal,
                                      float scale, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || Hq % Hkv || Hq > 65535 || S < BK ||
      S % BK)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return launch<128>(q, k, v, out, B, Hq, Hkv, S, causal, scale, st);
  if (D == 64) return launch<64>(q, k, v, out, B, Hq, Hkv, S, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
