// Fused AB-Sparse decode for Hopper (sm_90a): score -> exact top-K_h ->
// split-KV flash attention over the selected blocks, one call per layer.
//
// Replaces the TPU kernel repro/kernels/fused_decode.py (_fused_decode_kernel,
// pallas_call at line 333).  The call launches
//
//  1. score: the staged path's scoring kernel (score_rows.cuh): every row
//     of the flattened centroid store, eight lanes per row through
//     score_row (16-byte loads, INT4/INT8 dequant in registers, dot with
//     each GQA rank query, max over the group), 32 rows per thread block,
//     so the page sets equal the staged path's;
//  2. select: grid (n_kv, B): the head's rows [row_off, row_off + n_blocks)
//     of the flat scores, blocks past seq_len at -1e30 and sink / local
//     blocks at +1e30, then exactly K_h blocks by the radix select of
//     common.cuh over the sortable-u32 encoding, the lowest index winning
//     ties, compacted in ascending block order into the page table / valid
//     mask (slot p / ppb holds page p % ppb of its block);
//  3. attend: split_attn.cuh's split attention over that table, n_split runs
//     of slots per (sequence, head) (the wrapper's split_plan): four warps,
//     16-byte cp.async two 16-token units ahead, V read once for the group,
//     no barrier in the loop; with more than one run, the combine.
//
// Bound on the card: bytes.  A step reads the selected K_h*B_h = T tokens of
// K and V per (sequence, head) plus the codes; the work per byte is a few
// flops.  One thread block per (sequence, head) doing all three phases kept
// 100 of 132 SMs idle at B 4 and walked 4096 tokens serially.  With the
// attention split but the scoring and selection repeated in each of a
// cell's blocks (one launch), the serial scoring of up to 1024 rows by one
// block's eight warps took most of the launch (0.111 ms at B 4 on an
// NVIDIA H100 80GB HBM3 at 700 W, PERF.md); as separate launches the
// scoring spreads over the card and only the selection runs one block per
// (sequence, head).
#include "common.cuh"
#include "score_rows.cuh"
#include "split_attn.cuh"

using namespace absparse;

namespace {

__global__ void __launch_bounds__(NT) fused_select_kernel(
    const float* __restrict__ flat,           // [B, total_rows] scores
    const int* __restrict__ row_off, const int* __restrict__ n_blocks,
    const int* __restrict__ top_k, const int* __restrict__ bsz,
    const int* __restrict__ ppb, const int* __restrict__ seq_len,
    int* __restrict__ table,                  // [B, n_kv, P_sel]
    uint8_t* __restrict__ valid, int n_kv, int n_pages, int page_size,
    int total_rows, int sink_pages, int local_pages, int k_max, int p_sel) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nblk = n_blocks[h], ksel = top_k[h], pb = ppb[h], bs = bsz[h];
  const int sl = seq_len[b];
  float* s = reinterpret_cast<float*>(smem_raw);          // [n_blocks]
  int* slot_blk = reinterpret_cast<int*>(s + nblk);       // [k_max]
  int* red = slot_blk + k_max;                            // [NWARPS]
  const size_t cell = (size_t)b * n_kv + h;
  const float* row = flat + (size_t)b * total_rows + row_off[h];
  const int lo = max(sl - local_pages * page_size, 0);
  for (int j = tid; j < nblk; j += NT) {
    const int st = j * bs;
    const bool ok = st < sl;
    float sc = ok ? row[j] : ABS_NEG_INF;
    if (sink_pages > 0 && st < min(sink_pages * page_size, sl)) sc = ABS_POS_INF;
    if (local_pages > 0 && ok && st + bs > lo) sc = ABS_POS_INF;
    s[j] = sc;
  }
  __syncthreads();

  int n_gt;
  const uint32_t thr = topk_threshold(s, nblk, ksel, red, &n_gt);
  const int quota = ksel - n_gt;
  int tie_off = 0, n_sel = 0;
  for (int base = 0; base < nblk; base += NT) {
    const int j = base + tid;
    const bool in = j < nblk;
    const uint32_t u = in ? to_sortable(s[j]) : 0u;
    const bool tie = in && u == thr;
    int tot;
    const int tr = block_excl_scan(tie, red, &tot) + tie_off;
    tie_off += tot;
    const bool sel = in && (u > thr || (tie && tr < quota));
    const int sr = block_excl_scan(sel, red, &tot) + n_sel;
    if (sel && sr < k_max) slot_blk[sr] = j;
    n_sel += tot;
  }
  __syncthreads();
  const int n_slots = min(min(ksel, n_sel), k_max);
  for (int p = tid; p < p_sel; p += NT) {
    const int slot = p / pb, within = p - slot * pb;
    const int blk = slot < n_slots ? slot_blk[slot] : 0;
    const bool live = slot < n_slots && s[blk] > ABS_NEG_INF / 2;
    table[cell * p_sel + p] = min(max(blk * pb + within, 0), n_pages - 1);
    valid[cell * p_sel + p] = live ? 1 : 0;
  }
}

size_t select_smem(int max_blocks, int k_max) {
  return sizeof(float) * (size_t)max_blocks + sizeof(int) * ((size_t)k_max + NWARPS);
}

}  // namespace

// Shared memory of the largest of the call's kernels (for the wrapper's check).
extern "C" size_t fused_decode_smem_bytes(int D, int g, int Dp, int max_blocks,
                                          int k_max) {
  size_t m = score::smem_bytes(g, Dp);
  const size_t sel = select_smem(max_blocks, k_max);
  const size_t ring = D == 64 ? split::ring_bytes<64>() : split::ring_bytes<128>();
  if (sel > m) m = sel;
  return ring > m ? ring : m;
}

// Returns the cudaError_t of the first failed launch (0 on success).
// Scratch: flat [B, total_rows] f32 scores; part_ml / part_acc [B, n_kv,
// n_split, g, 2 | D] f32 (not read when n_split is 1).
extern "C" int fused_decode_launch(
    const void* q, const float* rq, const void* kp, const void* vp,
    const uint8_t* codes, const float* scale, const float* zero,
    const int* tile_head, const int* row_off, const int* n_blocks,
    const int* top_k, const int* bsz, const int* ppb, const int* seq_len,
    void* out, int* table, uint8_t* valid, float* flat, float* part_ml,
    float* part_acc, int B, int n_kv, int g, int D, int Dp, int n_pages,
    int page_size, int total_rows, int tile_rows, int row_bytes, int bits,
    int sym, int sink_pages, int local_pages, int max_blocks, int k_max,
    int p_sel, int n_split, float scale_qk, void* stream) {
  if (g > GMAX || g < 1 || Dp % 32 || n_split < 1 || p_sel < 1 ||
      n_split > p_sel || B < 1 || B > 65535 || n_kv < 1 || n_kv > 65535 ||
      max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e = score::launch(rq, codes, scale, zero, tile_head, flat, B, n_kv, g, Dp,
                        total_rows, tile_rows, row_bytes, bits, sym, st);
  if (e) return e;
  const size_t sel_sm = select_smem(max_blocks, k_max);
  if ((e = (int)cudaFuncSetAttribute(fused_select_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)sel_sm)))
    return e;
  fused_select_kernel<<<dim3(n_kv, B), NT, sel_sm, st>>>(
      flat, row_off, n_blocks, top_k, bsz, ppb, seq_len, table, valid, n_kv, n_pages,
      page_size, total_rows, sink_pages, local_pages, k_max, p_sel);
  if ((e = (int)cudaGetLastError())) return e;
  return split::launch_split_any(D, g, q, kp, vp, table, valid, seq_len, out, part_ml,
                                 part_acc, B, n_kv, n_pages, page_size, p_sel,
                                 n_split, scale_qk, st);
}
