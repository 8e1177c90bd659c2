// Block rank-key pooling for Hopper (sm_90a): raw keys [BH, S, D] (f32 or
// bf16) -> per-block rank keys [BH, S / bs, Dp] f32 for one block size bs.
//   mean    -> mean over the block's tokens              (width D)
//   quest   -> [channel max, channel min]                (width 2 D)
//   arkvale -> [center = (max + min) / 2, radius]        (width D + 1)
// with radius = sqrt(max over the block's tokens of |k - center|^2); the
// lanes from the width up to Dp are written as zeros.
//
// Replaces the TPU kernel repro/kernels/block_centroid.py (pool_rank_keys,
// _pool_kernel, pallas_call at line 80).  The TPU kernel pools a chunk of
// tokens per sequential grid step in VMEM.  Here the BH * S / bs rank keys
// form one flat list (key f pools tokens [f bs, (f + 1) bs) of the flat
// [BH * S, D] keys and writes row f of the flat output); a thread owns 8
// consecutive channels of one rank key, D / 8 neighbouring threads one
// key, and a thread block NT * 8 / D consecutive keys
// (kernels/block_centroid.py::pool_plan is the same arithmetic).
//
// Bound on the card: bytes.  Every key is read once (twice for arkvale,
// the second time mostly from L2) and a rank key is written per block;
// the work is a few operations per byte.  On an H100 (3.35 TB/s): 168 MB,
// 0.050 ms, for llama3.2-3b's bf16 serving cache [4, 8, 16384, 128] at
// quest / block 16; 75 MB, 0.023 ms, for one f32 calibration launch
// [8, 1, 16384, 128].  What the design does about it:
//  - one 16-byte load per token row and thread for bf16, two for f32, so
//    a warp instruction moves 512 bytes, not 64 or 128 as with a thread
//    per channel;
//  - the block size is a template parameter (16, 32, 64; a runtime loop
//    for any other), and each thread issues the loads of CH tokens (256
//    bytes) before it reduces any of them;
//  - max, min and the f32 sum (in token order, as the plain version's
//    reduction of one channel: sum = x0, then += x1, ...) stay in
//    registers, and the rank key leaves as float4 stores, pad lanes too;
//  - arkvale's second pass reads the block again with the same 16-byte
//    loads and sums |k - center|^2 over a key's D / 8 threads with
//    log2(D / 8) shuffles per token.
#include "common.cuh"

using namespace absparse;

namespace {

constexpr int VEC = 8;                  // channels per thread
constexpr int MAXD = 256;               // largest head_dim taken (D / 8 <= 32)
enum { MEAN = 0, QUEST = 1, ARKVALE = 2 };

// 8 consecutive channels of one token row, kept as loaded until needed.
template <typename T> struct Row8;

template <> struct Row8<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float (&x)[VEC]) const {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is exact: the high half
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <> struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float (&x)[VEC]) const {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

__device__ __forceinline__ void store8(float* o, const float (&x)[VEC]) {
  reinterpret_cast<float4*>(o)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// BS > 0: the block size, known at compile time; BS == 0: bs at run time.
template <typename T, int BS>
__global__ void __launch_bounds__(NT) pool_rank_keys_kernel(
    const T* __restrict__ keys,         // [n_keys * bs, D]
    float* __restrict__ out,            // [n_keys, Dp]
    int n_keys, int keys_per_cta, int D, int bs_rt, int Dp, int method) {
  constexpr int CH = 16 * 16 / (VEC * (int)sizeof(T));  // tokens per load batch
  const int bs = BS > 0 ? BS : bs_rt;
  const int L = D / VEC;                // threads per rank key, a power of 2
  const int slot = threadIdx.x / L, sub = threadIdx.x & (L - 1);
  const int key = blockIdx.x * keys_per_cta + slot;
  if (slot >= keys_per_cta || key >= n_keys) return;  // whole keys leave
  const int c0 = sub * VEC;
  const T* p = keys + (size_t)key * bs * D + c0;
  float* o = out + (size_t)key * Dp;

  // One batch of CH tokens at a time: not unrolled, so that the compiler
  // does not hoist every batch's loads (a thread's registers hold one).
  float mx[VEC], mn[VEC], sm[VEC];
#pragma unroll 1
  for (int t0 = 0; t0 < bs; t0 += CH) {
    Row8<T> r[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if ((BS > 0 && BS % CH == 0) || t0 + i < bs)
        r[i].load(p + (size_t)(t0 + i) * D);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (!((BS > 0 && BS % CH == 0) || t0 + i < bs)) continue;
      float x[VEC];
      r[i].get(x);
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        if (t0 + i == 0) {
          mx[c] = mn[c] = sm[c] = x[c];
        } else {
          mx[c] = fmaxf(mx[c], x[c]);
          mn[c] = fminf(mn[c], x[c]);
          sm[c] += x[c];
        }
      }
    }
  }

  float ctr[VEC];
  int width4;                           // float4s of the rank key before its pad
  if (method == MEAN) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) sm[c] = sm[c] / (float)bs;
    store8(o + c0, sm);
    width4 = D / 4;
  } else if (method == QUEST) {
    store8(o + c0, mx);
    store8(o + D + c0, mn);
    width4 = D / 2;
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c) ctr[c] = 0.5f * (mx[c] + mn[c]);
    store8(o + c0, ctr);
    width4 = D / 4 + 1;                 // [radius, 0, 0, 0] below
  }
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = width4 + sub; i < Dp / 4; i += L) reinterpret_cast<float4*>(o)[i] = z4;
  if (method != ARKVALE) return;        // uniform over the thread block

  // radius: the key's L threads are L aligned lanes of one warp
  const int lane = threadIdx.x & 31;
  const unsigned mask = L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (lane & ~(L - 1));
  float best = 0.f;
#pragma unroll 1
  for (int t0 = 0; t0 < bs; t0 += CH) {
    Row8<T> r[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if ((BS > 0 && BS % CH == 0) || t0 + i < bs)
        r[i].load(p + (size_t)(t0 + i) * D);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (!((BS > 0 && BS % CH == 0) || t0 + i < bs)) continue;
      float x[VEC];
      r[i].get(x);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const float d = x[c] - ctr[c];
        acc = fmaf(d, d, acc);
      }
      for (int off = L >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(mask, acc, off);
      best = fmaxf(best, acc);
    }
  }
  if (sub == 0) reinterpret_cast<float4*>(o)[D / 4] = make_float4(sqrtf(best), 0.f, 0.f, 0.f);
}

template <typename T>
cudaError_t launch(const T* keys, float* out, int n_keys, int keys_per_cta,
                   int D, int bs, int Dp, int method, cudaStream_t stream) {
  const dim3 grid((n_keys + keys_per_cta - 1) / keys_per_cta);
  switch (bs) {
    case 16:
      pool_rank_keys_kernel<T, 16><<<grid, NT, 0, stream>>>(
          keys, out, n_keys, keys_per_cta, D, bs, Dp, method);
      break;
    case 32:
      pool_rank_keys_kernel<T, 32><<<grid, NT, 0, stream>>>(
          keys, out, n_keys, keys_per_cta, D, bs, Dp, method);
      break;
    case 64:
      pool_rank_keys_kernel<T, 64><<<grid, NT, 0, stream>>>(
          keys, out, n_keys, keys_per_cta, D, bs, Dp, method);
      break;
    default:
      pool_rank_keys_kernel<T, 0><<<grid, NT, 0, stream>>>(
          keys, out, n_keys, keys_per_cta, D, bs, Dp, method);
  }
  return cudaGetLastError();
}

}  // namespace

// keys_per_cta: rank keys per thread block (kernels/block_centroid.py::
// pool_plan).  Returns the cudaError_t of the launch (0 on success).
extern "C" int pool_rank_keys_launch(const void* keys, float* out, int BH,
                                     int S, int D, int bs, int Dp, int method,
                                     int keys_per_cta, int is_bf16,
                                     void* stream) {
  const int width = method == MEAN ? D : (method == QUEST ? 2 * D : D + 4);
  const int L = D / VEC;
  if (method < MEAN || method > ARKVALE || D < VEC || D > MAXD || D % VEC ||
      (L & (L - 1)) || bs < 1 || S % bs || Dp % 4 || Dp < width || BH < 1 ||
      keys_per_cta < 1 || keys_per_cta * L > NT)
    return (int)cudaErrorInvalidValue;
  const int n_keys = BH * (S / bs);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch(static_cast<const __nv_bfloat16*>(keys), out, n_keys,
                       keys_per_cta, D, bs, Dp, method, st);
  return (int)launch(static_cast<const float*>(keys), out, n_keys,
                     keys_per_cta, D, bs, Dp, method, st);
}
