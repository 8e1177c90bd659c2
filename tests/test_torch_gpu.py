"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: on a machine without CUDA every test skips.  Run on a
machine with an H100:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's ``conftest.py`` imports JAX, which a machine
with the card need not have.)

Grids: quant {none, int8, int4} x {asym, sym}, non-uniform and uniform
block-size layouts, sink/local settings, ragged live lengths, head_dim 64
and 128, GQA groups 1 to 8; sparse prefill over chunk offsets with dead
trailing query blocks and prefill top-K scales; the staged decode's
scoring and paged-attention kernels on the same axes, and the
paged-attention kernel with its split count forced (1, 7, 8, one slot
per split), with a head whose slots are all invalid (the mean V row of
its table, as the plain version and JAX give), and with pages of 8 and
32 tokens.  The fused decode and the sparse prefill also run with their
split counts forced, and at GQA group 4 with head_dim 128 (qwen3-8b's
group: 256 query rows per prefill cell, four row tiles).  Queries are scaled
so that attention logits have standard deviation 1.5.  Selection (decode
page tables, prefill block sets) is exact up to the near-tie rule of
:mod:`repro_torch.kernels.parity`; staged scores within its
``SCORE_RTOL``, and the staged page sets equal to the fused kernel's
exactly; bf16 outputs agree within one bf16 rounding step per element and
a relative L2 error of 1e-2 per row.  The four attention kernels also run
at head_dim 256 (gemma-7b: the fused and staged decode at groups 1 to 4,
the sparse prefill at groups 1 and 2, flash S x S and with an offset at
16 / 16 heads, the identity table), and the sparse prefill at group 8
(qwen3-32b: 512 query rows a cell).

The scoring kernel also runs at GQA groups 1, 3 and 8 and rank-key
widths 128 and 256 for every store, and on 48-row tiles.  The pooling
kernel runs over the three centroid methods, block sizes 16/32/64 (and 8
and 48, its runtime path), f32 and bf16 keys and head_dim 64/128, also
with a number of rank keys that is not a multiple of a thread block's run
(quest bitwise equal to the plain version, mean / arkvale within
``POOL_RTOL``), and through the
``"cuda"`` backend's ``build_store`` (one launch per distinct block size,
store bytes equal to the ``"reference"`` backend's); the threshold kernel
over row lengths with ties and +-inf (bitwise); the dense flash kernel
causal and not, head_dim 64/128, GQA groups 1 to 8, sequence lengths that
are not a multiple of its 128-row query tile; and with a query offset and
a key length (chunked dense prefill): offsets that are no multiple of its
64-key tile, chunks of 1, 64 and 512 queries, ragged key lengths per
sequence, 32/8 and 24/8 heads, head_dim 64/128.  The paged-attention
kernel also runs over the identity page table of dense decode (the
``"dense"`` backend, an inactive plan) at GQA group 4 over 1024 pages, and
the staged scoring and paged-attention kernels at GQA group 4 with
head_dim 128 (qwen3-8b's shape).  Last, the serving engine's degradation
ladder at smoke width: each rung's whole decode ticks launch its own
kernels, and the degraded run's logits stay within a cosine of 0.9995 of
a fault-free run fed the same tokens.  Then tiered KV memory at smoke
width: a graphed tiered engine against an eager one (tokens, pool and
tiering counters, a forced miss re-run on the graph), ``CachePageIO``'s
pinned, in-place, bitwise round trip, and a poisoned selected page that
stalls its sequence without a non-finite row.  Last, tracing toggled on ->
off -> on a graphed engine: one capture per telemetry variant, replayed
after every toggle, and logits bitwise equal to an untraced graphed
engine's.  musicgen-large's attention shape (32 / 32 heads of 64: the
fused decode and the sparse prefill at group 1 and head_dim 64, flash
with an offset), and the compiled decode step of granite's and
musicgen's smoke variants (the MoE routing, the sinusoidal positions
inside the graph) bitwise the eager one.  Last, the recurrent families'
smoke variants (recurrentgemma-9b at 5 layers, rwkv6-3b): the graphed
decode step bitwise the eager one from random ring buffers and states,
and greedy decode continuing a single-shot prefill (cosine 0.9995).
Then training: three ``Trainer`` steps of llama3.2-3b's smoke variant on
the card against the CPU's, and the embedding's bf16 gradient for
repeated tokens against exact sums.
"""
import pytest
import torch

from repro_torch.backends.base import CentroidStore
from repro_torch.backends.store import build_score_rows, build_store_codes
from repro_torch.config import SparseConfig
from repro_torch.core.centroids import rank_query
from repro_torch.core.quantization import store_bits, store_symmetric
from repro_torch.core.ragged import layout_for
from repro_torch.core.stacked import as_arrays
from repro_torch.core.selection import select_page_table
from repro_torch.backends import get_backend
from repro_torch.kernels import block_centroid, centroid_score, flash_attention
from repro_torch.kernels import fused_decode, ops, paged_attention, parity
from repro_torch.kernels import sparse_prefill, topk_threshold
from repro_torch.models import moe_check

pytestmark = pytest.mark.gpu

S, PS, BUDGET = 2048, 16, 512
LAYOUTS = {"nonuniform": (16, 32, 64, 32), "uniform": (32, 32, 32, 32)}
QUANTS = ["none", "int8_asym", "int4_asym", "int8_sym", "int4_sym"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, blocks, B, D, seed, **sparse_kw):
    sparse = SparseConfig(token_budget=BUDGET, **sparse_kw)
    la = as_arrays(layout_for(blocks, S, PS, BUDGET), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (B, len(blocks), S // PS, PS, D)
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return sparse, la, gen, k, v


def _decode(dev, blocks, quant, seq, sink, local, D=128, g=3, seed=0, n_split=None):
    B = len(seq)
    sparse, la, gen, k, v = _inputs(dev, blocks, B, D, seed, quant=quant,
                                    sink_pages=sink, local_pages=local)
    q = torch.randn((B, len(blocks) * g, D), generator=gen, device=dev)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    store = build_store_codes(k, la, sparse)
    rq = rank_query(q, sparse.centroid_method, D)
    sl = torch.tensor(seq, dtype=torch.int32, device=dev)
    launches = fused_decode.launches
    res = parity.compare_fused_decode(q, rq, k, v, store, la, sparse, sl,
                                      n_split=n_split)
    assert fused_decode.launches == launches + 1
    return res


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("blocks", list(LAYOUTS.values()), ids=list(LAYOUTS))
@pytest.mark.parametrize("sink,local", [(0, 0), (2, 8), (1, 4)])
def test_fused_decode_kernel_matches_plain(cuda, quant, blocks, sink, local):
    _decode(cuda, blocks, quant, (S, 1234), sink, local)


@pytest.mark.parametrize("seq", [(1, 17), (31, 100), (2047, 513)],
                         ids=["edge", "tiny", "ragged"])
@pytest.mark.parametrize("D,g", [(128, 3), (64, 2), (128, 8), (128, 4), (256, 1),
                                 (256, 4), (64, 1)])
def test_fused_decode_kernel_shapes_and_lengths(cuda, seq, D, g):
    _decode(cuda, LAYOUTS["nonuniform"], "int4_asym", seq, 1, 4, D=D, g=g, seed=5)


@pytest.mark.parametrize("seq", [(S, 1234), (31, 100)], ids=["long", "tiny"])
@pytest.mark.parametrize("n_split", [1, 7, 8, BUDGET // PS])
def test_fused_decode_kernel_forced_splits(cuda, n_split, seq):
    """Forced split counts of the fused kernel: one run (the block writes
    the output), 7 runs (the last one short), 8 and one slot per run (runs
    with no live slot at the tiny lengths); page tables and valid masks
    exact, outputs within the bf16 rule."""
    _decode(cuda, LAYOUTS["nonuniform"], "int4_asym", seq, 1, 4, seed=11,
            n_split=n_split)


def _prefill(dev, blocks, quant, off, sq, n_valid, D=128, g=3, scale=1.0,
             seed=0, n_split=None):
    B = len(n_valid)
    sparse, la, gen, k, v = _inputs(dev, blocks, B, D, seed, quant=quant,
                                    prefill_topk_scale=scale)
    q = torch.randn((B, len(blocks) * g, sq, D), generator=gen, device=dev)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    codes, sc, ze = build_score_rows(k, la, sparse)
    ss = CentroidStore(codes, sc, ze, store_bits(quant), store_symmetric(quant))
    rq = rank_query(q, sparse.centroid_method, D)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    launches = sparse_prefill.launches
    res = parity.compare_sparse_prefill(q, rq, k, v, ss, la, sparse, nv, off,
                                        n_split=n_split)
    assert sparse_prefill.launches == launches + 1
    return res


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("blocks", list(LAYOUTS.values()), ids=list(LAYOUTS))
def test_sparse_prefill_kernel_matches_plain(cuda, quant, blocks):
    _prefill(cuda, blocks, quant, 1024, 512, (1536, 1300))


@pytest.mark.parametrize(
    "off,sq,n_valid",
    [(0, 512, (512, 100)), (1536, 512, (2048, 1600)), (768, 384, (1152, 769))],
    ids=["first-chunk", "last-chunk", "dead-tail"],
)
@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_sparse_prefill_kernel_chunks_and_scales(cuda, off, sq, n_valid, scale):
    _prefill(cuda, LAYOUTS["nonuniform"], "int4_asym", off, sq, n_valid,
             scale=scale, seed=3)


@pytest.mark.parametrize("D,g", [(64, 4), (128, 1), (64, 2), (128, 4), (256, 1),
                                 (256, 2), (128, 8), (64, 1)])
def test_sparse_prefill_kernel_shapes(cuda, D, g):
    """Head dims 64, 128 and 256 (one warpgroup a block at 256), groups up
    to 8: g 8 at the default query block of 64 is 512 query rows a cell,
    four blocks of two warpgroups."""
    _prefill(cuda, LAYOUTS["nonuniform"], "int8_asym", 1024, 256, (1280, 1100),
             D=D, g=g, seed=7)


@pytest.mark.parametrize("off,n_valid", [(1536, (2048, 1600)), (0, (512, 100))],
                         ids=["last-chunk", "first-chunk"])
@pytest.mark.parametrize("n_split", [1, 3, 8, 40])
def test_sparse_prefill_kernel_forced_splits(cuda, n_split, off, n_valid):
    """Forced runs of key tiles per cell: one run (the block writes the
    output), 3 (runs of unequal length), 8, and 40 (more runs than most
    cells have tiles, so many runs are empty); in the first chunk every
    cell has only its few causal tiles."""
    _prefill(cuda, LAYOUTS["nonuniform"], "int4_asym", off, 512, n_valid,
             seed=13, n_split=n_split)


def _staged(dev, blocks, quant, seq, sink, local, D=128, g=3, seed=0):
    """Scoring kernel vs plain, its page sets vs the fused kernel's (exact),
    then the paged-attention kernel on the plain scores' table."""
    B = len(seq)
    sparse, la, gen, k, v = _inputs(dev, blocks, B, D, seed, quant=quant,
                                    sink_pages=sink, local_pages=local)
    q = torch.randn((B, len(blocks) * g, D), generator=gen, device=dev)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    store = build_store_codes(k, la, sparse)
    rq = rank_query(q, sparse.centroid_method, D)
    sl = torch.tensor(seq, dtype=torch.int32, device=dev)
    name = "centroid_scores_f32" if quant == "none" else "centroid_scores_quantized"
    launches = centroid_score.launches[name]
    res = parity.compare_centroid_scores(rq, store, la, sparse, sl)
    assert centroid_score.launches[name] == launches + 1
    _, f_tbl, f_vld = ops.fused_decode(q, rq, k, v, store, la, sink, local, sl)
    assert parity.page_sets_equal(res["table"], res["valid"], f_tbl, f_vld)
    tbl, vld = select_page_table(res["plain"], la, sl, sink, local)
    launches = paged_attention.launches
    parity.compare_paged_attention(q, k, v, tbl, vld, PS, sl)
    assert paged_attention.launches == launches + 1


def _paged_case(dev, seq, D=128, g=3, seed=0):
    """A page table selected from random block scores (sink 1, local 4)."""
    blocks = LAYOUTS["nonuniform"]
    sparse, la, gen, k, v = _inputs(dev, blocks, len(seq), D, seed)
    q = torch.randn((len(seq), len(blocks) * g, D), generator=gen, device=dev)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    scores = torch.randn((len(seq), len(blocks), la.max_blocks), generator=gen,
                         device=dev)
    sl = torch.tensor(seq, dtype=torch.int32, device=dev)
    tbl, vld = select_page_table(scores, la, sl, 1, 4)
    return q, k, v, tbl, vld, sl


@pytest.mark.parametrize("dead", [False, True], ids=["live", "dead-head"])
@pytest.mark.parametrize("n_split", [1, 7, 8, BUDGET // PS])
def test_paged_attention_kernel_forced_splits(cuda, n_split, dead):
    """Forced split counts: one run, 7 runs (the last one short), 8 runs,
    one slot per run (more runs than the 7 live slots of the short
    sequence); a head whose slots are all invalid gives the mean V row of
    its table, as the plain version does."""
    q, k, v, tbl, vld, sl = _paged_case(cuda, (S - 3, 100))
    if dead:
        vld[0, 1] = False
    launches = paged_attention.launches
    parity.compare_paged_attention(q, k, v, tbl, vld, PS, sl, n_split=n_split)
    assert paged_attention.launches == launches + 1


@pytest.mark.parametrize("ps", [8, 32])
def test_paged_attention_kernel_page_sizes(cuda, ps):
    """Pages of 8 tokens (half of the kernel's 16-token unit) and of 32
    (two units), random distinct pages in any order, random invalid slots,
    a sequence that ends inside a page; the planned and a forced split."""
    B, n_kv, g, D, n_pages, P = 2, 4, 3, 128, 64, 24
    gen = torch.Generator(device=cuda).manual_seed(ps)
    kp, vp = (torch.randn((B, n_kv, n_pages, ps, D), generator=gen, device=cuda)
              .to(torch.bfloat16) for _ in range(2))
    q = torch.randn((B, n_kv * g, D), generator=gen, device=cuda)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    tbl = torch.stack([torch.randperm(n_pages, generator=gen, device=cuda)[:P]
                       for _ in range(B * n_kv)]).reshape(B, n_kv, P).to(torch.int32)
    vld = torch.rand((B, n_kv, P), generator=gen, device=cuda) > 0.2
    sl = torch.tensor([n_pages * ps - 3, n_pages * ps // 3 + 1], dtype=torch.int32,
                      device=cuda)
    for n_split in (None, 5):
        launches = paged_attention.launches
        parity.compare_paged_attention(q, kp, vp, tbl, vld, ps, sl, n_split=n_split)
        assert paged_attention.launches == launches + 1


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("blocks", list(LAYOUTS.values()), ids=list(LAYOUTS))
@pytest.mark.parametrize("sink,local", [(0, 0), (1, 4)])
def test_staged_kernels_match_plain_and_fused(cuda, quant, blocks, sink, local):
    _staged(cuda, blocks, quant, (S, 1234), sink, local)


@pytest.mark.parametrize("seq", [(1, 17), (31, 100), (2047, 513)],
                         ids=["edge", "tiny", "ragged"])
@pytest.mark.parametrize("D,g", [(128, 3), (64, 1), (128, 8), (64, 5), (128, 4),
                                 (256, 1), (256, 3)])
def test_staged_kernels_shapes_and_lengths(cuda, seq, D, g):
    _staged(cuda, LAYOUTS["nonuniform"], "int4_asym", seq, 1, 4, D=D, g=g, seed=5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [16, 32, 64])
@pytest.mark.parametrize("method", ["mean", "quest", "arkvale"])
def test_pool_rank_keys_kernel_matches_plain(cuda, method, bs, D, dtype):
    gen = torch.Generator(device=cuda).manual_seed(bs + D)
    keys = torch.randn((2, 3, S, D), generator=gen, device=cuda).to(dtype)
    launches = block_centroid.launches
    res = parity.compare_pool_rank_keys(keys, bs, method)
    assert block_centroid.launches == launches + 1
    # one token's key moved shows up in its block's rank key, and only there
    moved = keys.clone()
    moved[1, 2, 5 * bs + 3] += 4.0
    out = block_centroid.pool_rank_keys(moved, bs, method)
    changed = (out != res["kernel"]).any(-1)
    assert changed[1, 2, 5] and int(changed.sum()) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [16, 32, 64, 8, 48])
@pytest.mark.parametrize("method", ["mean", "quest", "arkvale"])
def test_pool_rank_keys_kernel_ragged_grid(cuda, method, bs, D, dtype):
    """5 rows of S = 1344: the flat list of rank keys is not a multiple of
    a thread block's run (``pool_plan``) for any block size; 8 and 48 take
    the kernel's runtime block-size path.  The last key of the last row
    is the one a moved token changes."""
    s = 1344
    gen = torch.Generator(device=cuda).manual_seed(3 * bs + D)
    keys = torch.randn((1, 5, s, D), generator=gen, device=cuda).to(dtype)
    plan = block_centroid.pool_plan(5, s, D, bs)
    assert plan["n_keys"] % plan["keys_per_cta"]
    launches = block_centroid.launches
    res = parity.compare_pool_rank_keys(keys, bs, method)
    assert block_centroid.launches == launches + 1
    moved = keys.clone()
    last = s // bs - 1
    moved[0, 4, last * bs + bs - 1] -= 4.0
    out = block_centroid.pool_rank_keys(moved, bs, method)
    changed = (out != res["kernel"]).any(-1)
    assert changed[0, 4, last] and int(changed.sum()) == 1


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("g", [1, 3, 8, 4])
@pytest.mark.parametrize("D", [64, 128], ids=["Dp128", "Dp256"])
def test_centroid_scores_kernel_groups_and_widths(cuda, quant, g, D):
    """GQA groups 1, 3, 8 and 4 at rank-key widths 128 and 256, every store:
    scores within ``SCORE_RTOL``, the staged page sets equal to the fused
    kernel's (both score through ``common.cuh::score_row``)."""
    _staged(cuda, LAYOUTS["nonuniform"], quant, (S - 5, 700), 1, 4, D=D, g=g,
            seed=g + D)


@pytest.mark.parametrize("quant", ["none", "int4_asym"])
def test_centroid_scores_kernel_short_tiles(cuda, quant):
    """Tiles of 48 rows: a thread block's run of 32 rows ends past its tile
    in every second block of the grid."""
    blocks = LAYOUTS["nonuniform"]
    sparse = SparseConfig(token_budget=BUDGET, quant=quant)
    la = as_arrays(layout_for(blocks, S, PS, BUDGET, tile_rows=48), cuda)
    gen = torch.Generator(device=cuda).manual_seed(48)
    k = torch.randn((2, len(blocks), S // PS, PS, 128), generator=gen,
                    device=cuda).to(torch.bfloat16)
    q = torch.randn((2, len(blocks) * 3, 128), generator=gen, device=cuda)
    rq = rank_query(q, sparse.centroid_method, 128)
    store = build_store_codes(k, la, sparse)
    sl = torch.tensor([S, 999], dtype=torch.int32, device=cuda)
    parity.compare_centroid_scores(rq, store, la, sparse, sl)


@pytest.mark.parametrize("quant", ["none", "int8_asym", "int4_asym"])
@pytest.mark.parametrize("blocks", list(LAYOUTS.values()), ids=list(LAYOUTS))
def test_build_store_cuda_backend_matches_reference(cuda, quant, blocks):
    gen = torch.Generator(device=cuda).manual_seed(9)
    keys = torch.randn((2, len(blocks), S, 128), generator=gen, device=cuda)
    lay = layout_for(blocks, S, PS, BUDGET)
    launches = block_centroid.launches
    got = get_backend("cuda").build_store(keys, lay, "quest", quant=quant)
    assert block_centroid.launches == launches + len(set(blocks))
    want = get_backend("reference").build_store(keys, lay, "quest", quant=quant)
    assert torch.equal(got.codes, want.codes)
    if quant != "none":
        assert torch.equal(got.scale, want.scale) and torch.equal(got.zero, want.zero)


@pytest.mark.parametrize("M", [64, 1024, 5000])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_topk_threshold_kernel_matches_plain(cuda, M, ties):
    gen = torch.Generator(device=cuda).manual_seed(M)
    s = torch.randn((4, 8, M), generator=gen, device=cuda)
    if ties:
        s = torch.round(s * 2)
        s[:, :, ::13] = float("-inf")
        s[:, :, 3::17] = float("inf")
        s[:, 2, M // 2:] = -1e30
    k = torch.randint(1, M + 1, (8,), generator=gen, device=cuda, dtype=torch.int32)
    k[0], k[1] = 1, M
    launches = topk_threshold.launches
    parity.compare_topk_threshold(s, k)
    assert topk_threshold.launches == launches + 1


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv,s,d", [(4, 4, 256, 64), (24, 8, 512, 128),
                                        (8, 1, 384, 128), (6, 3, 640, 64),
                                        (16, 16, 512, 256), (6, 2, 320, 256)])
def test_flash_attention_kernel_matches_plain(cuda, causal, hq, hkv, s, d):
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (torch.randn((2, h, s, d), generator=gen, device=cuda) for h in (hq, hkv, hkv))
    q = (q * parity.QSCALE).to(torch.bfloat16)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    launches = flash_attention.launches
    parity.compare_flash_attention(q, k, v, causal)
    assert flash_attention.launches == launches + 1


@pytest.mark.parametrize("causal,hq,hkv,s,d", [
    (True, 6, 2, 4160, 128), (False, 6, 2, 4160, 128),
    (False, 16, 2, 1024, 128), (False, 8, 1, 2048, 64),
    (True, 2, 1, 64, 128), (False, 3, 3, 192, 64),
], ids=["causal-4160", "full-4160", "full-g8", "full-g8-d64", "causal-64", "full-192"])
def test_flash_attention_kernel_ragged_query_tile_and_wide_groups(cuda, causal, hq,
                                                                  hkv, s, d):
    """S 4160, 64 and 192 are not multiples of the 128-row query tile (the
    last tile masks half its rows; at S 64 there is one key tile); GQA
    groups of 8, not causal."""
    gen = torch.Generator(device=cuda).manual_seed(s + hq)
    q, k, v = (torch.randn((1, h, s, d), generator=gen, device=cuda) for h in (hq, hkv, hkv))
    q = (q * parity.QSCALE).to(torch.bfloat16)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    launches = flash_attention.launches
    parity.compare_flash_attention(q, k, v, causal)
    assert flash_attention.launches == launches + 1


#: (chunk queries, offset, key buffer, key length per sequence or None)
FLASH_CHUNKS = {
    "chunk512-off1536": (512, 1536, 2048, (2048, 1600)),
    "chunk512-off200": (512, 200, 1024, (712, 712)),
    "chunk64-off63": (64, 63, 1024, (127, 100)),
    "chunk64-off4001": (64, 4001, 4096, (4065, 4065)),
    "chunk1-off1000": (1, 1000, 2048, (1001, 17)),
    "chunk1-off0": (1, 0, 64, (1, 1)),
    "chunk512-off0": (512, 0, 640, None),
}


@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (24, 8, 128), (32, 8, 64),
                                      (24, 8, 64), (16, 16, 256), (32, 32, 64)],
                         ids=["32-8-128", "24-8-128", "32-8-64", "24-8-64",
                              "16-16-256", "32-32-64"])
@pytest.mark.parametrize("case", list(FLASH_CHUNKS))
def test_flash_attention_kernel_with_offset(cuda, case, hq, hkv, d):
    """Queries at an offset over a prefix of the keys, as chunked dense
    prefill calls the kernel: the key tile holding the length loads
    zeros past it, a warpgroup's per-key mask starts at a tile found from
    positions; the buffer's rows past the lengths hold large values, which
    must never reach an output."""
    sq, off, sk, k_len = FLASH_CHUNKS[case]
    gen = torch.Generator(device=cuda).manual_seed(sq + off + hq + d)
    q = torch.randn((2, hq, sq, d), generator=gen, device=cuda)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    k, v = (torch.randn((2, hkv, sk, d), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    if k_len is not None:
        for b, n in enumerate(k_len):
            k[b, :, n:] = 3e4
            v[b, :, n:] = 3e4
        k_len = torch.tensor(k_len, dtype=torch.int32, device=cuda)
    launches = flash_attention.launches
    res = parity.compare_flash_attention(q, k, v, True, off, k_len)
    assert flash_attention.launches == launches + 1
    assert bool(torch.isfinite(res["kernel"]).all())
    if k_len is not None and int(k_len[0]) == int(k_len[1]):
        # one key length for every sequence: the int form, same output
        out = flash_attention.flash_attention(q, k, v, True, off, int(k_len[0]))
        assert torch.equal(out, res["kernel"])


def test_flash_attention_kernel_offset_not_causal(cuda):
    gen = torch.Generator(device=cuda).manual_seed(77)
    q = (torch.randn((2, 24, 100, 128), generator=gen, device=cuda)
         * parity.QSCALE).to(torch.bfloat16)
    k, v = (torch.randn((2, 8, 700, 128), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    k_len = torch.tensor([700, 333], dtype=torch.int32, device=cuda)
    parity.compare_flash_attention(q, k, v, False, 300, k_len)


@pytest.mark.parametrize("seq", [(16384, 12000, 7001, 1), (5, 16383, 16, 17)],
                         ids=["ragged", "edges"])
def test_paged_attention_kernel_identity_table(cuda, seq):
    """Dense decode's identity page table over 1024 pages at GQA group 4
    (qwen3-8b's 32 / 8 heads), through the ``"cuda"`` and ``"dense"``
    backends against the plain oracle ``dense_decode_attention``."""
    _identity_case(cuda, seq, n_kv=8, g=4, D=128)


@pytest.mark.parametrize("seq", [(16384, 12000, 7001, 1), (5, 16383, 16, 17)],
                         ids=["ragged", "edges"])
def test_paged_attention_kernel_identity_table_head_dim_256(cuda, seq):
    """The same at gemma-7b's 16 / 16 heads of 256 (a token row spans the
    whole warp)."""
    _identity_case(cuda, seq, n_kv=16, g=1, D=256)


def _identity_case(cuda, seq, n_kv, g, D):
    from repro_torch.backends import DenseBackend

    B, n_pages = 4, 1024
    gen = torch.Generator(device=cuda).manual_seed(sum(seq))
    kp, vp = (torch.randn((B, n_kv, n_pages, PS, D), generator=gen, device=cuda)
              .to(torch.bfloat16) for _ in range(2))
    q = (torch.randn((B, n_kv * g, D), generator=gen, device=cuda)
         * parity.QSCALE).to(torch.bfloat16)
    sl = torch.tensor(seq, dtype=torch.int32, device=cuda)
    tbl, vld = get_backend("cuda").full_page_table(kp, sl)
    launches = paged_attention.launches
    res = parity.compare_paged_attention(q, kp, vp, tbl, vld, PS, sl)
    assert paged_attention.launches == launches + 1
    sparse = SparseConfig()
    out = get_backend("dense").decode(q, kp, vp, None, None, sparse, sl)[0]
    assert torch.equal(out, res["kernel"])
    # the model's decode step passes the table it built once for the step
    stepped = get_backend("dense").decode(q, kp, vp, None, None, sparse, sl,
                                          page_table=(tbl, vld))[0]
    assert torch.equal(stepped, out)
    oracle = DenseBackend(plain=True).decode(q, kp, vp, None, None, sparse, sl)[0]
    keep = torch.ones(oracle.shape[:-1], dtype=torch.bool, device=cuda)
    parity.check_outputs(out, oracle, keep, "dense decode vs its oracle")


# -- the degradation ladder on the card ------------------------------------------


def _smoke_model(dev, arch="llama3.2-3b", **sparse_kw):
    """``arch``'s smoke variant at 2 layers, d_model 256, 4 / 2 heads of
    64, bf16, block sizes ((16, 32), (64, 16)), T 128, ``sparse_kw`` on
    top; random weights (generator seed 0)."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import Transformer

    base = smoke_variant(get_config(arch))
    cfg = dataclasses.replace(
        base, d_model=256, n_heads=4, n_kv_heads=2, dtype="bfloat16",
        sparse=dataclasses.replace(
            base.sparse, token_budget=128, block_sizes=((16, 32), (64, 16)),
            prefill_block_q=64, **sparse_kw))
    return Transformer(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))


def _ladder_serve(dev, model, plan=None, forced=None, eager=False):
    """Two requests (200 and 150 tokens, 16 new) through ``Engine`` on the
    ``"cuda"`` backend with the fused decode and sparse prefill, chunks of
    128, ``repromote_after`` 3, ``plan`` injected, ``forced`` tokens fed in
    place of the samples; with ``eager`` the engine is built under
    ``step_graphs_disabled()``.  -> (engine, requests, the run's
    ``SampleRecorder`` and ``LadderProbe``)."""
    import contextlib

    import numpy as np

    from repro_torch import kernels
    from repro_torch.config import ResilienceConfig, ServeConfig
    from repro_torch.resilience import FaultInjector, FaultSpec
    from repro_torch.serving import Engine, Request, step_graphs_disabled
    from repro_torch.serving.probe import LadderProbe, SampleRecorder

    with step_graphs_disabled() if eager else contextlib.nullcontext():
        eng = Engine(model.cfg, model, ServeConfig(
            max_batch=2, max_context=512, prefill_chunk=128,
            prefill_tokens_per_tick=192, temperature=0.0,
            resilience=ResilienceConfig(repromote_after=3)), device=dev)
    if plan is not None:
        eng.set_fault_injector(FaultInjector([FaultSpec(**d) for d in plan]))
    samples, probe = SampleRecorder(eng, forced), LadderProbe(eng)
    rng = np.random.default_rng(9)
    reqs = [Request(i, rng.integers(0, model.cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=16) for i, n in enumerate((200, 150))]
    for r in reqs:
        eng.submit(r)
    kernels.reset_counts()
    eng.run_until_done(max_ticks=200, tick_callback=probe)
    samples.detach()
    probe.detach()
    return eng, reqs, samples, probe


def _ladder_plan(probe):
    """A prefill fault on the last chunk tick of a fault-free run, a decode
    fault on the next decode tick, a NaN row of request 0 five decode
    ticks later."""
    last_chunk = max(t for t, st in probe.steps.items()
                     if any(k == "chunk" for _, k, _ in st))
    after = sorted(t for t, st in probe.steps.items() if t > last_chunk
                   and any(k == "decode" for _, k, _ in st))
    return [dict(site="prefill", tick=last_chunk, count=1),
            dict(site="decode", tick=after[0], count=1),
            dict(site="decode_nan", tick=after[5], seq_id=0, count=1)]


def test_ladder_rungs_launch_their_kernels(cuda):
    """The three-rung ladder at smoke width (2 layers, 4 / 2 heads of 64,
    bf16): a prefill fault on the last chunk tick (fused -> staged), a
    decode fault (-> reference), a NaN row on the staged rung (->
    reference), re-promotion back to fused.  Each rung runs a whole decode
    tick that launches its kernels once per layer and no other rung's, the
    reference rung sees no chunk (it prefills dense), no request is charged
    a retry, and every committed position's logits are within cosine 0.9995
    of a fault-free run fed the same tokens."""
    model = _smoke_model(cuda, backend="cuda", fused_decode=True, sparse_prefill=True)
    cfg = model.cfg
    _, _, rec_f, probe_f = _ladder_serve(cuda, model)
    plan = _ladder_plan(probe_f)
    eng, reqs, rec, probe = _ladder_serve(cuda, model, plan, rec_f.tokens)
    snap = eng.metrics.snapshot()
    assert snap["degradations_by_rung"] == {"staged": 1, "reference": 2}
    assert snap["repromotions"] == 3 and eng._rung == 0 and snap["retries"] == 0
    assert snap["sampler_anomalies"] == eng._fault.fired["decode_nan"] == 1
    assert all(r.status == "ok" and len(r.output) == 16 for r in reqs)
    assert not any(r == 2 and k == "chunk" for st in probe.steps.values() for r, k, _ in st)
    want = {"fused": {"fused_decode"},
            "staged": {"centroid_scores_quantized", "paged_attention"},
            "reference": set()}
    whole = probe.whole_decode_ticks()
    for rung, (name, _) in enumerate(eng._ladder):
        assert whole.get(rung), name
        for t in whole[rung]:
            for kernel in ("fused_decode", "centroid_scores_quantized",
                           "paged_attention"):
                n = cfg.n_layers if kernel in want[name] else 0
                assert probe.launches[t][kernel] == n, (name, t, kernel)
            if name == "reference":
                assert probe.launches[t]["sparse_prefill"] == 0
    for r in reqs:
        for i in range(len(r.output)):
            key = (r.req_id, i)
            assert bool(torch.isfinite(rec.logits[key]).all())
            cos = torch.nn.functional.cosine_similarity(rec.logits[key], rec_f.logits[key],
                                                        dim=0)
            assert float(cos) >= 0.9995, key


# -- the compiled decode step (repro_torch.serving.graphs) -------------------------

#: capturable decodes -> (sparse overrides, max_context, lengths): an
#: inactive plan at 200 (under twice the budget, a padded last page)
GRAPH_KINDS = {
    "fused": (dict(backend="cuda", fused_decode=True), 512, (500, 301)),
    "staged": (dict(backend="cuda", fused_decode=False), 512, (500, 301)),
    "dense": (dict(backend="dense", fused_decode=False), 512, (500, 301)),
    "inactive": (dict(backend="cuda", fused_decode=True), 200, (190, 77)),
}


def _graph_case(dev, kind, telemetry, arch="llama3.2-3b"):
    """-> (model, cache of random K/V with rebuilt stores, lengths)."""
    overrides, ctx, lens = GRAPH_KINDS[kind]
    model = _smoke_model(dev, arch, **overrides)
    gen = torch.Generator(device=dev).manual_seed(3)
    cache = model.init_cache(2, ctx)
    for e in cache["layers"]:
        for name in ("k", "v"):
            e[name].copy_(torch.randn(e[name].shape, generator=gen, device=dev))
    for slot in range(2):
        model.refresh_slot_store(cache, slot)
    if telemetry:
        cache["_telemetry"] = torch.zeros((model.cfg.n_layers, 2, 4),
                                          dtype=torch.int32, device=dev)
    return model, cache, torch.tensor(lens, dtype=torch.int32, device=dev)


def _written(cache):
    out = {"seq_len": cache["seq_len"].clone()}
    if "_telemetry" in cache:
        out["_telemetry"] = cache["_telemetry"].clone()
    for l, e in enumerate(cache["layers"]):
        out.update({f"{k}[{l}]": v.clone() for k, v in e.items()})
    return out


@pytest.mark.parametrize("telemetry", [False, True], ids=["plain", "telemetry"])
@pytest.mark.parametrize("kind", list(GRAPH_KINDS))
def test_graphed_decode_step_matches_eager(cuda, kind, telemetry):
    """A ``DecodeGraph``'s first call (warm-up, capture, replay) and a later
    replay give the eager step's logits and cache bytes, bitwise, and the
    bookkeeping counts one eager step's launches per replay."""
    _graphed_matches_eager(cuda, kind, telemetry)


@pytest.mark.parametrize("kind", ["fused", "staged", "dense"])
def test_graphed_granite_decode_step_matches_eager(cuda, kind):
    """The same for granite-moe-3b-a800m's smoke variant (4 experts top-2):
    the MoE FFN's routing, dispatch and combine run inside the graph."""
    _graphed_matches_eager(cuda, kind, False, arch="granite-moe-3b-a800m")


@pytest.mark.parametrize("kind", ["fused", "staged", "dense"])
def test_graphed_musicgen_decode_step_matches_eager(cuda, kind):
    """The same for musicgen-large's smoke variant: its sinusoidal
    positions, read from the device lengths, run inside the graph."""
    _graphed_matches_eager(cuda, kind, False, arch="musicgen-large")


def _graphed_matches_eager(cuda, kind, telemetry, arch="llama3.2-3b"):
    from repro_torch import kernels
    from repro_torch.serving import DecodeGraph

    model, cache, lens = _graph_case(cuda, kind, telemetry, arch)
    assert (model.cfg.moe is not None) == (arch == "granite-moe-3b-a800m")
    assert model.cfg.name.startswith("musicgen") == (arch == "musicgen-large")
    tokens = torch.tensor([7, 100], device=cuda)
    cache["seq_len"].copy_(lens)
    kernels.reset_counts()
    want = model.decode_step(cache, tokens)[0].clone()
    one_step = kernels.counts()
    assert any(c["launches"] for c in one_step.values())
    state = _written(cache)
    graph = DecodeGraph(model.decode_step, cache)
    for calls in (1, 2):
        cache["seq_len"].copy_(lens)
        kernels.reset_counts()
        logits, _ = graph(cache, tokens)
        torch.cuda.synchronize()
        assert torch.equal(logits, want)
        got = _written(cache)
        for k, v in state.items():
            assert torch.equal(v, got[k]), k
        assert kernels.counts() == one_step and graph.replays == calls


def test_ladder_graphs_count_as_eager(cuda):
    """The three-rung ladder served on graphs and under
    ``step_graphs_disabled()``, fed the same tokens: the same launches tick
    by tick, logits at cosine 0.9995 or closer at every sampled position,
    and on the graphed engine every decode step of a kernel rung a replay
    (the reference rung stays eager)."""
    model = _smoke_model(cuda, backend="cuda", fused_decode=True, sparse_prefill=True)
    _, _, rec_f, probe_f = _ladder_serve(cuda, model)
    plan = _ladder_plan(probe_f)
    runs = {eager: _ladder_serve(cuda, model, plan, rec_f.tokens, eager=eager)
            for eager in (False, True)}
    (g_eng, _, g_rec, g_probe), (e_eng, _, e_rec, e_probe) = runs[False], runs[True]
    assert g_probe.launches == e_probe.launches
    assert g_probe.steps == e_probe.steps
    assert g_rec.logits.keys() == e_rec.logits.keys()
    for key, lg in g_rec.logits.items():
        cos = torch.nn.functional.cosine_similarity(lg, e_rec.logits[key], dim=0)
        assert float(cos) >= 0.9995, key
    assert not e_eng._step_graphs and set(g_eng._step_graphs) == {0, 1}
    for rung, graph in g_eng._step_graphs.items():
        steps = sum(k == "decode" for st in g_probe.steps.values()
                    for r, k, _ in st if r == rung)
        assert graph.replays == steps > 0


def test_host_sync_fails_the_capture(cuda):
    """A step that reads device memory on the host (``.item()``) cannot be
    captured: the call raises, and a clean capture still works after it."""
    from repro_torch.serving import DecodeGraph

    model, cache, lens = _graph_case(cuda, "fused", False)
    tokens = torch.tensor([7, 100], device=cuda)

    def step(cache, tokens):
        int(cache["seq_len"][0].item())
        return model.decode_step(cache, tokens)

    cache["seq_len"].copy_(lens)
    with pytest.raises(RuntimeError):
        DecodeGraph(step, cache)(cache, tokens)
    torch.cuda.synchronize()
    cache["seq_len"].copy_(lens)
    logits, _ = DecodeGraph(model.decode_step, cache)(cache, tokens)
    assert bool(torch.isfinite(logits).all())


def test_capture_survives_a_collection_of_another_graph(cuda):
    """Another captured graph becomes cyclic garbage during a capture and a
    collection would run at the next allocation (threshold 1): the capture
    still succeeds, since destroying that graph mid-capture is a CUDA call
    that invalidates the capture; the cycle is collected after."""
    import gc
    import weakref

    from repro_torch.serving import DecodeGraph

    model, cache, lens = _graph_case(cuda, "fused", False)
    tokens = torch.tensor([7, 100], device=cuda)
    x = torch.zeros(8, device=cuda)
    other = torch.cuda.CUDAGraph()
    with torch.cuda.graph(other):
        x.add_(1)
    held, dropped = [other], []
    del other

    class Cycle:
        pass

    def step(cache, tokens):
        if held and torch.cuda.is_current_stream_capturing():
            cycle = Cycle()
            cycle.graph, cycle.self = held.pop(), cycle
            dropped.append(weakref.ref(cycle))
            del cycle
        return model.decode_step(cache, tokens)

    threshold = gc.get_threshold()
    cache["seq_len"].copy_(lens)
    gc.set_threshold(1)
    try:
        logits, _ = DecodeGraph(step, cache)(cache, tokens)
    finally:
        gc.set_threshold(*threshold)
    assert bool(torch.isfinite(logits).all())
    gc.collect()
    assert len(dropped) == 1 and dropped[0]() is None


# -- tiered KV memory (repro_torch.memory) -----------------------------------------

def _tiered_serve(dev, model, eager=False, pool=None, force_miss=True):
    """Three requests of 300 tokens (12 new) at max_batch 4, max_context 512,
    on 28 device + 72 host pages (``pool`` overrides the pool settings): the
    requests hold 60 pages, so the pool is overcommitted; with
    ``force_miss``, request 1's sink page is demoted around the shield once
    it decodes with two tokens out.  -> (engine, requests, the forced
    miss: {"tick", "page", "n_out", "stalled_on", "n_out_after"} or {}, the
    number of decode steps)."""
    import contextlib

    import numpy as np

    from repro_torch.config import ServeConfig
    from repro_torch.serving import Engine, Request, step_graphs_disabled
    from repro_torch.serving.probe import LadderProbe, demote_around_shield

    pool = pool or dict(hbm_pages=28, host_pages=72)
    with step_graphs_disabled() if eager else contextlib.nullcontext():
        eng = Engine(model.cfg, model, ServeConfig(
            max_batch=4, max_context=512, prefill_chunk=128,
            prefill_tokens_per_tick=1024, temperature=0.0, **pool), device=dev)
    rng = np.random.default_rng(7)
    reqs = [Request(i, rng.integers(0, model.cfg.vocab_size, 300).astype(np.int32),
                    max_new_tokens=12) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    probe = LadderProbe(eng)
    miss = {}
    for _ in range(300):
        if not eng.scheduler.has_work:
            break
        seq = eng.scheduler.running.get(1)
        if (force_miss and not miss and eng.memory is not None and seq is not None
                and seq.state == "decode" and len(seq.req.output) >= 2
                and 1 not in eng.memory.stalled):
            sink = demote_around_shield(eng, 1)
            if sink is not None:
                miss = {"tick": eng.metrics.ticks, "page": sink,
                        "n_out": len(seq.req.output)}
        eng.step()
        probe(eng, eng.metrics.ticks)
        if miss.get("tick") == eng.metrics.ticks - 1:
            miss["stalled_on"] = sorted(eng.memory.stalled.get(1, ()))
            miss["n_out_after"] = len(seq.req.output)
    probe.detach()
    assert all(r.done for r in reqs)
    assert eng.pool.assert_consistent(known_pins=eng.prefix_cache.pages()) == []
    steps = sum(k == "decode" for st in probe.steps.values() for _, k, _ in st)
    return eng, reqs, miss, steps


def test_tiered_engine_graphed_matches_eager(cuda):
    """A tiered engine whose decode step is a CUDA graph and one built under
    ``step_graphs_disabled()``: the same tokens, pool and tiering counters,
    with migrations, a forced miss and the stalled step re-run on the graph
    (every decode step a replay); the tokens equal a flat pool's."""
    model = _smoke_model(cuda, backend="cuda", fused_decode=True, sparse_prefill=True)
    from repro_torch.serving.probe import TIER_COUNTERS

    g_eng, g_reqs, g_miss, g_steps = _tiered_serve(cuda, model)
    e_eng, e_reqs, e_miss, _ = _tiered_serve(cuda, model, eager=True)
    _, f_reqs, _, _ = _tiered_serve(cuda, model, pool=dict(pool_pages=100))
    assert [r.output for r in g_reqs] == [r.output for r in e_reqs]
    assert [r.output for r in g_reqs] == [r.output for r in f_reqs]
    g, e = g_eng.metrics.snapshot(), e_eng.metrics.snapshot()
    assert {k: g[k] for k in TIER_COUNTERS} == {k: e[k] for k in TIER_COUNTERS}
    assert g_eng.pool.stats() == e_eng.pool.stats()
    assert g_eng.pool.demotions > 0 and g["stalls"] >= 1 and g_miss == e_miss
    assert not e_eng._step_graphs and set(g_eng._step_graphs) == {0}
    assert g_eng._step_graphs[0].replays == g_steps > 0


def test_page_io_restore_is_bitwise(cuda):
    """``CachePageIO`` on a bf16 engine-shaped cache on the card: the host
    copy is pinned, poison writes 9984 (1e4 in bf16) to that slot's page in
    every layer and nothing else, restore brings every byte back, and no
    cache tensor moves."""
    from repro_torch.memory import POISON, CachePageIO

    model = _smoke_model(cuda, backend="cuda", fused_decode=True)
    cache = model.init_cache(3, 512)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for e in cache["layers"]:
        for n in ("k", "v"):
            e[n].copy_(torch.randn(e[n].shape, generator=gen, device=cuda))
    layers = cache["layers"]
    before = [{n: e[n].clone() for n in ("k", "v")} for e in layers]
    ptrs = [(e["k"].data_ptr(), e["v"].data_ptr()) for e in layers]
    io = CachePageIO()
    kb, vb = io.gather(layers, 2, 7)
    assert kb.is_pinned() and vb.is_pinned() and kb.device.type == "cpu"
    io.poison(layers, 2, 7)
    torch.cuda.synchronize()
    assert float(torch.tensor(POISON, dtype=torch.bfloat16)) == 9984.0
    for e, b in zip(layers, before):
        for n in ("k", "v"):
            assert bool((e[n][2, :, 7] == 9984).all())
            mask = torch.ones(e[n].shape[:3], dtype=torch.bool, device=cuda)
            mask[2, :, 7] = False
            assert torch.equal(e[n][mask], b[n][mask])
    io.restore(layers, 2, 7, kb, vb)
    torch.cuda.synchronize()
    for e, b in zip(layers, before):
        for n in ("k", "v"):
            assert torch.equal(e[n], b[n])
    assert [(e["k"].data_ptr(), e["v"].data_ptr()) for e in layers] == ptrs
    assert io.page_nbytes(layers) == 2 * model.cfg.n_layers * 2 * 16 * 64 * 2


def test_poisoned_selected_page_stalls_with_finite_rows(cuda):
    """A page the next selection needs, demoted around the shield: the
    owning sequence stalls on it (its token not committed), no row of the
    step is non-finite (no sampler anomaly, no retry, no degradation), and
    its stream equals a flat pool's."""
    model = _smoke_model(cuda, backend="cuda", fused_decode=True, sparse_prefill=True)
    eng, reqs, miss, _ = _tiered_serve(cuda, model)
    _, flat, _, _ = _tiered_serve(cuda, model, pool=dict(pool_pages=100))
    assert miss["page"] in miss["stalled_on"]
    assert miss["n_out_after"] == miss["n_out"]
    snap = eng.metrics.snapshot()
    assert snap["sampler_anomalies"] == 0 and snap["retries"] == 0
    assert snap["degradations"] == 0 and snap["prefetch_misses"] >= 1
    assert [r.output for r in reqs] == [r.output for r in flat]


# -- tracing on a graphed engine ---------------------------------------------------


def test_graphed_engine_toggles_tracing(cuda):
    """``set_tracing`` on -> off -> on a graphed engine (fused decode,
    sparse prefill), one closed batch between toggles: the decode step is
    captured once per telemetry variant and replayed after every toggle,
    the trace validates, and every sampled row's logits equal, bitwise,
    those of a graphed engine that never traced (the counters change no
    logit)."""
    import numpy as np

    from repro_torch.config import ServeConfig
    from repro_torch.obs import TraceRecorder, validate_chrome_trace
    from repro_torch.serving import Engine, Request
    from repro_torch.serving.probe import SampleRecorder

    model = _smoke_model(cuda, backend="cuda", fused_decode=True, sparse_prefill=True)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (150, 220, 90, 180, 130, 200)]

    def serve(toggle):
        eng = Engine(model.cfg, model, ServeConfig(
            max_batch=2, max_context=512, prefill_chunk=128, temperature=0.0),
            device=cuda)
        rec, samples = TraceRecorder(), SampleRecorder(eng)
        for i, attach in enumerate((rec, None, rec)):
            if toggle:
                eng.set_tracing(attach)
            assert ("_telemetry" in eng.cache) == (toggle and attach is not None)
            for j in (2 * i, 2 * i + 1):
                eng.submit(Request(j, prompts[j], max_new_tokens=8))
            eng.run_until_done(max_ticks=300)
        samples.detach()
        return eng, rec, samples

    eng, rec, traced = serve(True)
    plain_eng, _, plain = serve(False)
    variants = eng._graph_variants
    assert set(variants) == {(0, True), (0, False)}
    assert all(g.replays > 0 for g in variants.values())
    assert set(plain_eng._graph_variants) == {(0, False)}
    assert traced.logits.keys() == plain.logits.keys() and len(traced.logits) == 48
    for key, lg in traced.logits.items():
        assert torch.equal(lg, plain.logits[key]), key
    assert traced.tokens == plain.tokens
    assert validate_chrome_trace(
        rec.to_chrome(), ["engine.tick", "engine.decode", "prefill.chunk", "seq.decode"],
        ["pool", "queue", "sparsity"], ["sched.admit"]) == []
    assert eng.metrics.snapshot()["sparsity_steps"] > 0


# -- the MoE FFN (repro_torch.models.moe) on the card ------------------------------


@pytest.mark.parametrize("case", ["chunk", "padded-chunk", "decode"])
def test_moe_ffn_on_cuda_matches_cpu(cuda, case):
    """granite-moe-3b-a800m's published routing (40 experts top-8, capacity
    factor 1.25) at d_model 256, d_ff 128, bf16: the card's ``moe_ffn``
    against the same function in f32 (and bf16) on the CPU
    (``moe_check.compare_moe_ffn``): a 512-token chunk, 300 live rows of a
    512-row buffer, a decode step of 4 slots (``group_size`` 4)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.layers import DecoderLayer

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), d_model=256, d_ff=128)
    layer = DecoderLayer(cfg, torch.bfloat16, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for p in layer.parameters():
        if p.dim() > 1:
            p.copy_(torch.randn(p.shape, generator=gen, device=cuda) * p.shape[-2] ** -0.5)
    shape, kw, live = {"chunk": ((1, 512), {}, 512),
                       "padded-chunk": ((1, 512), {"n_tokens": 512}, 300),
                       "decode": ((4, 1), {"group_size": 4}, 4)}[case]
    x = torch.randn(shape + (256,), generator=gen, device=cuda)
    x = (x + 1.5 * torch.randn(256, generator=gen, device=cuda)).to(torch.bfloat16)
    res = moe_check.compare_moe_ffn(layer, x[:, :live] if case == "padded-chunk" else x,
                                    cfg, **kw)
    assert res["tie_tokens"] <= 2 and res["max_rel_l2"] <= parity.REL_L2
    assert (res["dropped"] > 0) == (case != "decode")


# -- the recurrent families (recurrentgemma-9b, rwkv6-3b) ------------------------


def _recurrent_model(dev, arch):
    """``arch``'s smoke variant (recurrentgemma at 5 layers: a cycle and two
    remainder rglru layers) at d_model 256, bf16, the ``"cuda"`` backend
    with the fused decode (which launches nothing here: the plan is
    inactive); random weights (generator seed 0)."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import Transformer

    base = smoke_variant(get_config(arch))
    cfg = dataclasses.replace(
        base, d_model=256, dtype="bfloat16",
        n_layers=5 if arch == "recurrentgemma-9b" else base.n_layers,
        sparse=dataclasses.replace(base.sparse, backend="cuda", fused_decode=True))
    return Transformer(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b"])
def test_recurrent_graphed_step_and_continuation(cuda, arch):
    """On the card: the decode step of a cache of random ring buffers and
    states, graphed (``DecodeGraph``: warm-up and capture restore the
    recurrent states) and eager from the same state, bitwise in logits and
    every cache tensor, no kernel launched; and chip_smoke's continuation
    oracle (b): 150 prompt tokens (past the 64-token window) prefilled,
    then 12 greedy decode steps, each step's logits within cosine 0.9995
    of a single-shot prefill of the prompt and the tokens before it."""
    from repro_torch import kernels
    from repro_torch.serving import DecodeGraph

    model = _recurrent_model(cuda, arch)
    gen = torch.Generator(device=cuda).manual_seed(3)
    cache = model.init_cache(2, 512)
    for e in cache["layers"]:
        for t in e.values():
            t.copy_(torch.randn(t.shape, generator=gen, device=cuda) * 0.5)
    start = _written(cache)
    lens = torch.tensor([500, 77], dtype=torch.int32, device=cuda)
    tokens = torch.tensor([7, 100], device=cuda)
    cache["seq_len"].copy_(lens)
    kernels.reset_counts()
    want = model.decode_step(cache, tokens)[0].clone()
    assert not any(c["launches"] or c["plain_calls"] for c in kernels.counts().values())
    state = _written(cache)
    assert any(not torch.equal(state[k], start[k]) for k in state if k != "seq_len")

    def restore():
        for l, e in enumerate(cache["layers"]):
            for name, t in e.items():
                t.copy_(start[f"{name}[{l}]"])
        cache["seq_len"].copy_(lens)

    restore()
    graph = DecodeGraph(model.decode_step, cache)
    for calls in (1, 2):
        restore()
        logits, _ = graph(cache, tokens)
        torch.cuda.synchronize()
        assert torch.equal(logits, want)
        got = _written(cache)
        for k, v in state.items():
            assert torch.equal(v, got[k]), k
        assert graph.replays == calls

    prompt = torch.randint(0, model.cfg.vocab_size, (1, 150), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    logits, cache = model.prefill(prompt, max_context=256)
    seq = prompt
    for _ in range(12):
        nxt = logits.argmax(-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        logits, cache = model.decode_step(cache, nxt)
        ref = model.prefill(seq, max_context=256)[0]
        cos = torch.nn.functional.cosine_similarity(logits.float(), ref.float(), dim=-1)
        assert float(cos.min()) >= 0.9995


# -- training (repro_torch.training) ----------------------------------------------


def test_train_steps_on_cuda_match_cpu(cuda):
    """llama3.2-3b's smoke variant (f32): three ``Trainer`` steps (remat
    "dots", global batch 4 of 128 tokens) on the card from the CPU's
    initial weights, against the same steps on the CPU: every loss within
    1e-4 relative, every parameter within 1e-3 relative L2 after them;
    no kernel launched."""
    from repro_torch import kernels
    from repro_torch.config import MeshPlan, TrainConfig
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import Trainer

    cfg = smoke_variant(get_config("llama3.2-3b"))
    tc = TrainConfig(checkpoint_dir=None, warmup_steps=1, total_steps=3,
                     learning_rate=1e-3)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=4)
    host = Trainer(cfg, tc, dc, MeshPlan(remat="dots"), device="cpu")
    card = Trainer(cfg, tc, dc, MeshPlan(remat="dots"), device=cuda)
    start = host.init_state(0)
    kernels.reset_counts()
    got = card.run(3, state={"params": start["params"], "opt": card.init_state(0)["opt"]},
                   resume=False)
    assert not any(c["launches"] or c["plain_calls"] for c in kernels.counts().values())
    want = host.run(3, state=start, resume=False)
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= 1e-4 * abs(b)
    for name, p in want["state"]["params"].items():
        q = got["state"]["params"][name].detach().cpu()
        assert float((q - p.detach()).norm() / p.detach().norm()) <= 1e-3, name


def test_embedding_gradient_sums_repeats_in_f32(cuda):
    """``Transformer.embed_inputs``' backward on the card: a bf16 table's
    gradient for Zipf tokens (one id 762 times) within 5e-2 relative L2 of
    the exact sums (f64; the CPU's backward reaches 0.0163), where an
    indexing lookup's backward, which sums a repeated token's rows in bf16
    on the card, put the tied embedding's leaf 0.07 off its f32 copy's in
    ``chip_smoke.py`` phase 13 a)."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import Transformer
    from repro_torch.training.data import DataConfig, batch_for_step
    from repro_torch.training.train_loop import trainable

    cfg = dataclasses.replace(smoke_variant(get_config("llama3.2-3b")), dtype="bfloat16")
    model = Transformer(cfg, device=cuda).init(torch.Generator(device=cuda).manual_seed(0))
    embed = trainable(model)["embed"]
    toks = batch_for_step(DataConfig(cfg.vocab_size, 2048, 2), 0, device=cuda).long()
    w = torch.randn((2, 2048, cfg.d_model), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    x = model.embed_inputs(toks)
    (g,) = torch.autograd.grad((x.float() * w).sum(), [embed])
    want = torch.zeros(embed.shape, dtype=torch.float64, device=cuda).index_add_(
        0, toks.flatten(), w.to(torch.bfloat16).double().reshape(-1, cfg.d_model))
    assert float((g.double() - want).norm() / want.norm()) <= 5e-2


@pytest.mark.parametrize("data", [1, 2])
def test_sharded_kernels_stitch_to_the_whole_call(cuda, data):
    """Mesh serving's per-shard launches (``distributed.kernel_partition``'s
    slices and splits, as the backends launch them)
    at this file's shape (4 kv heads of group 3, B 4): at ``model`` 2 (and
    ``data`` 1 or 2) every shard's ``fused_decode`` and ``sparse_prefill``
    on its rows, its heads, its rows of the store and its layout, at the
    whole call's split, stitch to the whole call's outputs bit for bit
    (out, page table, valid; out, n_attended, selected blocks)."""
    from repro_torch.distributed import kernel_partition as kp

    blocks, g = LAYOUTS["nonuniform"], 3
    sparse, la, gen, k, v = _inputs(cuda, blocks, 4, 128, 21, quant="int4_asym")
    q = (torch.randn((4, 4 * g, 128), generator=gen, device=cuda)
         * parity.QSCALE).to(torch.bfloat16)
    pq = (torch.randn((4, 4 * g, 512, 128), generator=gen, device=cuda)
          * parity.QSCALE).to(torch.bfloat16)
    store = build_store_codes(k, la, sparse)
    codes, sc, ze = build_score_rows(k, la, sparse)
    ss = CentroidStore(codes, sc, ze, 4, False)
    rq, prq = rank_query(q, "quest", 128), rank_query(pq, "quest", 128)
    sl = torch.tensor((2048, 1500, 777, 40), dtype=torch.int32, device=cuda)
    nv = torch.tensor((2048, 1900, 1600, 1537), dtype=torch.int32, device=cuda)
    kw = dict(sink_pages=1, local_pages=4, block_q=64, topk_scale=1.0)
    want_d = ops.fused_decode(q, rq, k, v, store, la, 1, 4, sl)
    want_p = ops.sparse_prefill(pq, prq, k, v, ss, la, n_valid=nv, chunk_offset=1536,
                                return_selected=True, **kw)
    got_d = [torch.full_like(t, 7) for t in want_d]
    got_p = [torch.full_like(t, 7) for t in want_p]
    for _, s in kp.every_shard((data, 2), 4, 4):
        t = lambda x, grp=1: s.take(x, 1, grp).contiguous()
        sla, spq = kp.shard_layout(la, s.heads), t(pq, g)
        dec = ops.fused_decode(t(q, g), t(rq, g), t(k), t(v),
                               kp.shard_store(store, la, s, True), sla, 1, 4,
                               s.take_rows(sl).contiguous(),
                               n_split=kp.decode_split(s, la.selected_pages, cuda))
        pre = ops.sparse_prefill(spq, t(prq, g), t(k), t(v),
                                 kp.shard_store(ss, la, s, False), sla,
                                 n_valid=s.take_rows(nv).contiguous(),
                                 chunk_offset=1536, return_selected=True, **kw,
                                 n_split=kp.prefill_split(s, spq, 64))
        for dst, part, grp in zip(got_d + got_p, dec + pre, (g, 1, 1, g, 1, 1)):
            s.take(dst, 1, grp).copy_(part)
    for want, got in zip(want_d + want_p, got_d + got_p):
        assert torch.equal(want, got)
