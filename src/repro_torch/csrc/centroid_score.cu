// Staged AB-Sparse block scoring for Hopper (sm_90a): every row of the
// flattened ragged centroid store against its head's GQA group of rank
// queries, max over the group -> flat scores [B, total_rows] f32.
//
// Replaces the TPU kernels repro/kernels/centroid_score.py
// (centroid_scores_quantized, pallas_call at line 147, INT4 split-half /
// INT8 affine dequant; centroid_scores_f32, pallas_call at line 181, an
// unquantized f32 store).  The kernel lives in score_rows.cuh, which the
// fused decode's scoring launch shares.  One thread block per (run of SPAN = 32 rows of
// one tile of tile_rows rows, 128 by default; sequence); the tile's head
// comes from tile_head[tile], as the TPU kernel's scalar prefetch routes
// it.  The block loads that head's rank queries [g, Dp] into shared memory
// once, then each group of eight lanes scores one row through score_row
// (common.cuh); the fused decode scores with this same kernel, so the
// staged and the fused path rank bitwise-equal scores.  Every row is scored, rows
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
#include "score_rows.cuh"

using namespace absparse;

extern "C" size_t centroid_score_smem_bytes(int g, int Dp) {
  return score::smem_bytes(g, Dp);
}

extern "C" int centroid_score_launch(
    const float* rq, const uint8_t* codes, const float* scale,
    const float* zero, const int* tile_head, float* out, int B, int n_kv,
    int g, int Dp, int total_rows, int tile_rows, int row_bytes, int bits,
    int sym, void* stream) {
  return score::launch(rq, codes, scale, zero, tile_head, out, B, n_kv, g, Dp,
                       total_rows, tile_rows, row_bytes, bits, sym,
                       (cudaStream_t)stream);
}
