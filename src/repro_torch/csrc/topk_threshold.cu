// Exact K_h-th largest score per (sequence, head) for Hopper (sm_90a):
// scores [B, H, M] f32 -> (threshold [B, H] f32, count of scores strictly
// above it [B, H] int32).  Selecting every score above the threshold and
// the first (K_h - count) ties in index order gives lax.top_k's set.
//
// Replaces the TPU kernel repro/kernels/topk_threshold.py (_kth_kernel,
// pallas_call at line 88).  One thread block per (head, sequence) copies
// its score row into shared memory and runs topk_threshold (common.cuh): a
// radix select on the sortable-u32 encoding of f32, four passes of a
// 256-bin count.  The fused decode and sparse prefill selections go
// through the same device function, so the standalone threshold and
// theirs are one computation.
//
// Bound on the card: bytes (each score read once from device memory, then
// from shared memory), well under a microsecond at the decode shapes
// ([4, 8, 1024]).  The dependent block-wide passes (three barriers each)
// make the kernel latency-bound instead; the earlier 32-step binary search
// took 0.012 ms there (device time on an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md).
#include "common.cuh"

using namespace absparse;

namespace {

__global__ void __launch_bounds__(NT) topk_threshold_kernel(
    const float* __restrict__ scores,   // [B, H, M]
    const int* __restrict__ k_per_head, // [H]
    float* __restrict__ thr,            // [B, H]
    int* __restrict__ count_gt,         // [B, H]
    int H, int M) {
  extern __shared__ float s_row[];      // [M]
  __shared__ int red[NWARPS];
  const size_t cell = (size_t)blockIdx.y * H + blockIdx.x;
  const float* row = scores + cell * M;
  for (int j = threadIdx.x; j < M; j += NT) s_row[j] = row[j];
  __syncthreads();
  int n_gt;
  const uint32_t t = topk_threshold(s_row, M, k_per_head[blockIdx.x], red, &n_gt);
  if (threadIdx.x == 0) {
    thr[cell] = from_sortable(t);
    count_gt[cell] = n_gt;
  }
}

}  // namespace

extern "C" size_t topk_threshold_smem_bytes(int M) {
  return sizeof(float) * (size_t)M;
}

// Returns the cudaError_t of the launch (0 on success).
extern "C" int topk_threshold_launch(const float* scores, const int* k_per_head,
                                     float* thr, int* count_gt, int B, int H,
                                     int M, void* stream) {
  if (B < 1 || H < 1 || M < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = topk_threshold_smem_bytes(M);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        topk_threshold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  topk_threshold_kernel<<<dim3(H, B), NT, smem, (cudaStream_t)stream>>>(
      scores, k_per_head, thr, count_gt, H, M);
  return (int)cudaGetLastError();
}
