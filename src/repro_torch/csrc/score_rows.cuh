// The staged scoring kernel (centroid_score.cu says what it replaces and
// how it is laid out), shared by centroid_score.cu and the fused decode's
// scoring launch (fused_decode.cu), so both rank the same scores from one
// kernel: every row of the flattened ragged centroid store against its
// head's GQA group of rank queries through score_row, max over the group
// -> flat scores [B, total_rows] f32.
#pragma once

#include "common.cuh"

namespace absparse {
namespace score {

constexpr int SPAN = ROWS_PER_WARP * NWARPS;   // rows per thread block

// grid (n_tiles * ceil(tile_rows / SPAN), B): run `part` of SPAN rows of
// tile `tile`, whose head is tile_head[tile].
__global__ void __launch_bounds__(NT) score_rows_kernel(
    const float* __restrict__ rq,          // [B, n_q, Dp]
    const uint8_t* __restrict__ codes,     // [B, total_rows, row_bytes]
    const float* __restrict__ scale,       // [B, n_kv, Dp] (bits != 0)
    const float* __restrict__ zero,
    const int* __restrict__ tile_head,     // [n_tiles]
    float* __restrict__ out,               // [B, total_rows]
    int n_kv, int g, int Dp, int total_rows, int tile_rows, int row_bytes,
    int bits, int sym) {
  const int parts = (tile_rows + SPAN - 1) / SPAN;
  const int tile = blockIdx.x / parts, part = blockIdx.x - tile * parts;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int h = tile_head[tile];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rq_s = reinterpret_cast<float*>(smem_raw);      // [g, Dp]
  const float* rq_h = rq + ((size_t)b * n_kv * g + (size_t)h * g) * Dp;
  for (int i = tid; i < g * Dp; i += NT) rq_s[i] = rq_h[i];
  __syncthreads();

  const float* sc_h = bits ? scale + ((size_t)b * n_kv + h) * Dp : nullptr;
  const float* ze_h = bits ? zero + ((size_t)b * n_kv + h) * Dp : nullptr;
  const int j = part * SPAN + wid * ROWS_PER_WARP + lane / ROW_LANES;
  const size_t r = (size_t)b * total_rows + (size_t)tile * tile_rows +
                   min(j, tile_rows - 1);
  const float s = score_row(codes + r * (size_t)row_bytes, rq_s, g, Dp, bits,
                            sym != 0, sc_h, ze_h);
  if (lane % ROW_LANES == 0 && j < tile_rows) out[r] = s;
}

inline size_t smem_bytes(int g, int Dp) { return sizeof(float) * (size_t)g * Dp; }

// Launch the scoring kernel; returns the cudaError_t (0 on success).
inline int launch(const float* rq, const uint8_t* codes, const float* scale,
                  const float* zero, const int* tile_head, float* out, int B, int n_kv,
                  int g, int Dp, int total_rows, int tile_rows, int row_bytes, int bits,
                  int sym, cudaStream_t stream) {
  if (g > GMAX || g < 1 || tile_rows < 1 || total_rows % tile_rows || Dp % 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(g, Dp);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        score_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int parts = (tile_rows + SPAN - 1) / SPAN;
  dim3 grid(total_rows / tile_rows * parts, B);
  score_rows_kernel<<<grid, NT, smem, stream>>>(rq, codes, scale, zero, tile_head, out,
                                               n_kv, g, Dp, total_rows, tile_rows,
                                               row_bytes, bits, sym);
  return (int)cudaGetLastError();
}

}  // namespace score
}  // namespace absparse
