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
// tokens per sequential grid step in VMEM; here one thread block takes a
// run of RUN consecutive rank-key blocks of one (sequence, head) row, with
// a thread per (block, channel) walking the block's tokens once and keeping
// max, min and the f32 sum in registers (neighbouring threads read
// neighbouring channels, so every token row is one coalesced read).
// arkvale needs the center before the radius: the centers go to shared
// memory and one warp per rank-key block reads the block again (from L2)
// and reduces |k - center|^2 over channels with a butterfly sum.
//
// Bound on the card: bytes.  Every key is read once (twice for arkvale,
// the second time from L2) and a rank key is written per block; the work
// is a few operations per byte.
#include "common.cuh"

using namespace absparse;

namespace {

constexpr int RUN = 8;                  // rank-key blocks per thread block
constexpr int MAXD = 256;               // largest head_dim taken
enum { MEAN = 0, QUEST = 1, ARKVALE = 2 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return bf2f(*p); }

template <typename T>
__global__ void __launch_bounds__(NT) pool_rank_keys_kernel(
    const T* __restrict__ keys,         // [BH, S, D]
    float* __restrict__ out,            // [BH, S / bs, Dp]
    int S, int D, int bs, int Dp, int method) {
  const int nb = S / bs;
  const int j0 = blockIdx.x * RUN;
  const int nrun = min(RUN, nb - j0);
  const size_t bh = blockIdx.y;
  const T* kb = keys + bh * S * D;
  float* ob = out + (bh * nb + j0) * Dp;
  __shared__ float ctr_s[RUN][MAXD];

  for (int i = threadIdx.x; i < nrun * D; i += NT) {
    const int j = i / D, c = i - j * D;
    const T* p = kb + ((size_t)(j0 + j) * bs) * D + c;
    float mx = ld(p), mn = mx, sum = mx;
#pragma unroll 8
    for (int t = 1; t < bs; ++t) {
      const float x = ld(p + (size_t)t * D);
      mx = fmaxf(mx, x);
      mn = fminf(mn, x);
      sum += x;
    }
    float* o = ob + (size_t)j * Dp;
    if (method == MEAN) {
      o[c] = sum / (float)bs;
    } else if (method == QUEST) {
      o[c] = mx;
      o[D + c] = mn;
    } else {
      const float ctr = 0.5f * (mx + mn);
      o[c] = ctr;
      ctr_s[j][c] = ctr;
    }
  }
  const int width = method == MEAN ? D : (method == QUEST ? 2 * D : D + 1);
  const int npad = Dp - width;
  for (int i = threadIdx.x; i < nrun * npad; i += NT) {
    const int j = i / npad;
    ob[(size_t)j * Dp + width + (i - j * npad)] = 0.f;
  }
  if (method != ARKVALE) return;        // uniform over the block
  __syncthreads();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int j = wid; j < nrun; j += NWARPS) {
    const T* p = kb + ((size_t)(j0 + j) * bs) * D;
    float best = 0.f;
    for (int t = 0; t < bs; ++t) {
      float acc = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float d = ld(p + (size_t)t * D + c) - ctr_s[j][c];
        acc = fmaf(d, d, acc);
      }
      best = fmaxf(best, warp_sum(acc));
    }
    if (lane == 0) ob[(size_t)j * Dp + D] = sqrtf(best);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int pool_rank_keys_launch(const void* keys, float* out, int BH,
                                     int S, int D, int bs, int Dp, int method,
                                     int is_bf16, void* stream) {
  const int width = method == MEAN ? D : (method == QUEST ? 2 * D : D + 1);
  if (method < MEAN || method > ARKVALE || D < 1 || D > MAXD || bs < 1 ||
      S % bs || Dp < width || BH < 1 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((S / bs + RUN - 1) / RUN, BH);
  if (is_bf16)
    pool_rank_keys_kernel<__nv_bfloat16><<<grid, NT, 0, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(keys), out, S, D, bs, Dp, method);
  else
    pool_rank_keys_kernel<float><<<grid, NT, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(keys), out, S, D, bs, Dp, method);
  return (int)cudaGetLastError();
}
