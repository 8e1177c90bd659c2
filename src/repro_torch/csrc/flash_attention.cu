// Dense GQA flash attention for Hopper (sm_90a), causal or not:
// q [B, Hq, S, D], k / v [B, Hkv, S, D] bf16 -> out [B, Hq, S, D] bf16,
// query head h reading kv head h / (Hq / Hkv), f32 logits, softmax state
// and accumulators.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (_flash_kernel,
// pallas_call at line 117).  Same arithmetic: logits = (q . k) * D^-1/2,
// future keys at -1e30 when causal, a running (max, sum, acc) rescaled by
// exp(m_old - m_new) per key tile, and out = acc / max(l, 1e-30).  The TPU
// kernel walks the key tiles as the last, sequential grid axis with the
// state in VMEM scratch; here one thread block per (query tile of BQ rows,
// head, sequence) loops over the key tiles itself with the state in
// registers, and a causal block stops at its diagonal tile (the TPU grid
// still visits the dead tiles).  Blocks are issued heaviest first.
//
// Per key tile: the K tile is converted to f32 in shared memory; each of
// the 256 threads (a 16 x 16 grid) computes a 4 x 4 patch of the logits
// with CUDA-core FMAs; a butterfly over the 16 threads of a row gives its
// max and sum; the probabilities go to shared memory, the V tile replaces
// the K tile, and each thread adds p V to its 4 rows x D/16 channels.
//
// Bound on the card: operations (4 S^2 D flops per query head when not
// causal, about half that when causal).  This first version runs on the
// CUDA cores at the f32 FMA rate, far below the bf16 tensor cores; wgmma
// and TMA are later work.
#include "common.cuh"

using namespace absparse;

namespace {

constexpr int BQ = 64;                  // query rows per thread block
constexpr int BK = 64;                  // keys per tile
constexpr int TR = 4;                   // logit rows per thread (16 x 4 = BQ)
constexpr int TC = 4;                   // logit columns per thread (16 x 4 = BK)
constexpr int PST = BK + 1;             // row stride of the probability tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + (size_t)BQ * PST);
}

// rows [64, D] bf16 (row stride D) -> f32 in shared memory, row stride D + 1
template <int D>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          float* dst) {
  constexpr int V = D / 8;              // 16-byte vectors per row
  for (int i = threadIdx.x; i < 64 * V; i += NT) {
    const int r = i / V, c8 = (i - r * V) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int u = 0; u < 8; ++u) dst[r * (D + 1) + c8 + u] = bf2f(e[u]);
  }
}

// max / sum over the 16 threads of one logit row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q,    // [B, Hq, S, D]
    const __nv_bfloat16* __restrict__ k,    // [B, Hkv, S, D]
    const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ out,        // [B, Hq, S, D]
    int Hq, int Hkv, int S, int causal, float scale) {
  constexpr int DS = D + 1;
  constexpr int DC = D / 16;            // output channels per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [BQ][DS]
  float* kv = qs + BQ * DS;                         // [BK][DS], K then V
  float* ps = kv + BK * DS;                         // [BQ][PST]

  const int qt = S / BQ - 1 - blockIdx.x;           // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t q_off = (((size_t)b * Hq + h) * S + (size_t)qt * BQ) * D;
  const __nv_bfloat16* kh = k + ((size_t)b * Hkv + hk) * S * D;
  const __nv_bfloat16* vh = v + ((size_t)b * Hkv + hk) * S * D;

  load_tile<D>(q + q_off, qs);
  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = ABS_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = causal ? qt + 1 : S / BK;        // BQ == BK
  for (int kt = 0; kt < n_kt; ++kt) {
    load_tile<D>(kh + (size_t)kt * BK * D, kv);
    __syncthreads();
    float sc[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[TR], kk[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = qs[(ty + 16 * i) * DS + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) kk[j] = kv[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) sc[i][j] = fmaf(qv[i], kk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = ty + 16 * i, row = qt * BQ + r;
      float mx = ABS_NEG_INF;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        float x = sc[i][j] * scale;
        if (causal && kt * BK + tx + 16 * j > row) x = ABS_NEG_INF;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[r * PST + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                    // K reads done, probabilities written
    load_tile<D>(vh + (size_t)kt * BK * D, kv);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[TR], vv[DC];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = ps[(ty + 16 * i) * PST + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = kv[j * DS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncthreads();                    // before the next tile overwrites kv
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* o = out + q_off + (size_t)(ty + 16 * i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[tx + 16 * c] = __float2bfloat16(acc[i][c] / denom);
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
  flash_attention_kernel<D><<<dim3(S / BQ, Hq, B), NT, smem, stream>>>(
      q, k, v, out, Hq, Hkv, S, causal, scale);
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
  if (B < 1 || B > 65535 || Hkv < 1 || Hq % Hkv || Hq > 65535 || S < BQ ||
      S % BQ)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return launch<128>(q, k, v, out, B, Hq, Hkv, S, causal, scale, st);
  if (D == 64) return launch<64>(q, k, v, out, B, Hq, Hkv, S, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
