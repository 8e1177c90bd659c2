// Staged AB-Sparse block scoring for Hopper (sm_90a): every row of the
// flattened ragged centroid store against its head's GQA group of rank
// queries, max over the group -> flat scores [B, total_rows] f32.
//
// Replaces the TPU kernels repro/kernels/centroid_score.py
// (centroid_scores_quantized, pallas_call at line 147, INT4 split-half /
// INT8 affine dequant; centroid_scores_f32, pallas_call at line 181, an
// unquantized f32 store).  One thread block per (run of SPAN = 32 rows of
// one tile of tile_rows rows, 128 by default; sequence); the tile's head
// comes from tile_head[tile], as the TPU kernel's scalar prefetch routes
// it.  The block loads that head's rank queries [g, Dp] into shared memory
// once, then each group of eight lanes scores one row through score_row
// (common.cuh), the same device function the fused decode kernel scores
// with, so the staged and the fused path rank bitwise-equal scores.  Every row is scored, rows
// past a sequence's end and tile padding included, as on the TPU: masking
// is the selection's job (mask_and_pin_scores).
//
// Bound on the card: bytes.  A call reads every store row once (Dp/2 bytes
// per INT4 row, 4 Dp per f32 row) and does 2 g Dp flops per row, far below
// the f32 rate's break-even.  On an H100 (3.35 TB/s), for llama3.2-3b's
// store at B 4 (5120 rows x Dp 256 per sequence): 21 MB, 0.0063 ms, for
// an f32 store; 2.9 MB, 0.0009 ms, for INT4, where launch and memory
// latency, not bytes, set the time.  What the design does about it: each
// lane issues all of its row's 16-byte loads (eight per lane for an f32
// row of Dp 256, one for INT4) before any arithmetic, four rows per warp
// are in flight at once, a row's lanes reduce in 3 shuffle steps, and the
// 40 tiles x 4 sequences become 640 thread blocks.
#include "common.cuh"

using namespace absparse;

namespace {

constexpr int SPAN = ROWS_PER_WARP * NWARPS;   // rows per thread block

__global__ void __launch_bounds__(NT) centroid_score_kernel(
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

}  // namespace

extern "C" size_t centroid_score_smem_bytes(int g, int Dp) {
  return sizeof(float) * (size_t)g * Dp;
}

// Returns the cudaError_t of the launch (0 on success).
extern "C" int centroid_score_launch(
    const float* rq, const uint8_t* codes, const float* scale,
    const float* zero, const int* tile_head, float* out, int B, int n_kv,
    int g, int Dp, int total_rows, int tile_rows, int row_bytes, int bits,
    int sym, void* stream) {
  if (g > GMAX || g < 1 || tile_rows < 1 || total_rows % tile_rows || Dp % 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = centroid_score_smem_bytes(g, Dp);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        centroid_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int parts = (tile_rows + SPAN - 1) / SPAN;
  dim3 grid(total_rows / tile_rows * parts, B);
  centroid_score_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      rq, codes, scale, zero, tile_head, out, n_kv, g, Dp, total_rows,
      tile_rows, row_bytes, bits, sym);
  return (int)cudaGetLastError();
}
