// Paged decode attention for Hopper (sm_90a): one query token per sequence
// attends only the pages a dense [B, n_kv, P_sel] page table selects.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py
// (_paged_attn_kernel, pallas_call at line 143): a running (max, sum, acc)
// softmax in f32 over the table's slots for the head's GQA group of
// g <= 8 query rows.  A token counts only if its slot is valid, its page
// lies in [0, n_pages) and its position page * page_size + i < seq_len[b];
// a slot that does not count is never read, whatever page it holds.  The
// output is acc / l in bf16; a head with no live token gets the mean of
// the V rows of its whole table, as JAX's kernel computes it.  Slots may
// come in any order (the staged path lists them in rank order); only
// rounding depends on it.
//
// Bound on the card: bytes (the selected tokens' K and V rows, about 2 g
// flops per byte).  One block per (sequence, head) kept only B * n_kv SMs
// busy, each walking thousands of tokens serially.  Split-KV design:
//  - each (sequence, head) cell's slot list is cut into n_split contiguous
//    runs (the wrapper's split_plan: about two resident blocks per SM);
//    grid (n_split, n_kv, B);
//  - a block attends its run with split_attn.cuh's split_attention_kernel
//    (4 warps, 16-byte cp.async two units ahead, V read once for the group,
//    no barrier in the loop); with one split the block writes the output,
//    otherwise each split writes its (m, l) and f32 acc to scratch and a
//    second small kernel combines them (a split with no live token has
//    l = 0 and weight 0).
#include "common.cuh"
#include "split_attn.cuh"

using namespace absparse;

// Returns the cudaError_t of the launch (0 on success).  part_ml /
// part_acc: scratch of [B, n_kv, n_split, g, 2] and [.., g, D] floats (not
// read when n_split is 1).
extern "C" int paged_attention_launch(
    const void* q, const void* kp, const void* vp, const int* table,
    const uint8_t* valid, const int* seq_len, void* out, float* part_ml,
    float* part_acc, int B, int n_kv, int g, int D, int n_pages, int page_size,
    int p_sel, int n_split, float scale_qk, void* stream) {
  if (g > GMAX || g < 1 || n_split < 1 || B < 1 || B > 65535 || n_kv < 1 ||
      n_kv > 65535 || page_size < 1)
    return (int)cudaErrorInvalidValue;
  return split::launch_split_any(D, g, q, kp, vp, table, valid, seq_len, out, part_ml,
                                 part_acc, B, n_kv, n_pages, page_size, p_sel,
                                 n_split, scale_qk, (cudaStream_t)stream);
}
