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
scoring and paged-attention kernels on the same axes.  Queries are scaled
so that attention logits have standard deviation 1.5.  Selection (decode
page tables, prefill block sets) is exact up to the near-tie rule of
:mod:`repro_torch.kernels.parity`; staged scores within its
``SCORE_RTOL``, and the staged page sets equal to the fused kernel's
exactly; bf16 outputs agree within one bf16 rounding step per element and
a relative L2 error of 1e-2 per row.
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
from repro_torch.kernels import centroid_score, fused_decode, ops, paged_attention
from repro_torch.kernels import parity, sparse_prefill

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


def _decode(dev, blocks, quant, seq, sink, local, D=128, g=3, seed=0):
    B = len(seq)
    sparse, la, gen, k, v = _inputs(dev, blocks, B, D, seed, quant=quant,
                                    sink_pages=sink, local_pages=local)
    q = torch.randn((B, len(blocks) * g, D), generator=gen, device=dev)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    store = build_store_codes(k, la, sparse)
    rq = rank_query(q, sparse.centroid_method, D)
    sl = torch.tensor(seq, dtype=torch.int32, device=dev)
    launches = fused_decode.launches
    res = parity.compare_fused_decode(q, rq, k, v, store, la, sparse, sl)
    assert fused_decode.launches == launches + 1
    return res


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("blocks", list(LAYOUTS.values()), ids=list(LAYOUTS))
@pytest.mark.parametrize("sink,local", [(0, 0), (2, 8), (1, 4)])
def test_fused_decode_kernel_matches_plain(cuda, quant, blocks, sink, local):
    _decode(cuda, blocks, quant, (S, 1234), sink, local)


@pytest.mark.parametrize("seq", [(1, 17), (31, 100), (2047, 513)],
                         ids=["edge", "tiny", "ragged"])
@pytest.mark.parametrize("D,g", [(128, 3), (64, 2), (128, 8)])
def test_fused_decode_kernel_shapes_and_lengths(cuda, seq, D, g):
    _decode(cuda, LAYOUTS["nonuniform"], "int4_asym", seq, 1, 4, D=D, g=g, seed=5)


def _prefill(dev, blocks, quant, off, sq, n_valid, D=128, g=3, scale=1.0,
             seed=0):
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
    res = parity.compare_sparse_prefill(q, rq, k, v, ss, la, sparse, nv, off)
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


@pytest.mark.parametrize("D,g", [(64, 4), (128, 1), (64, 2)])
def test_sparse_prefill_kernel_shapes(cuda, D, g):
    _prefill(cuda, LAYOUTS["nonuniform"], "int8_asym", 1024, 256, (1280, 1100),
             D=D, g=g, seed=7)


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


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("blocks", list(LAYOUTS.values()), ids=list(LAYOUTS))
@pytest.mark.parametrize("sink,local", [(0, 0), (1, 4)])
def test_staged_kernels_match_plain_and_fused(cuda, quant, blocks, sink, local):
    _staged(cuda, blocks, quant, (S, 1234), sink, local)


@pytest.mark.parametrize("seq", [(1, 17), (31, 100), (2047, 513)],
                         ids=["edge", "tiny", "ragged"])
@pytest.mark.parametrize("D,g", [(128, 3), (64, 1), (128, 8), (64, 5)])
def test_staged_kernels_shapes_and_lengths(cuda, seq, D, g):
    _staged(cuda, LAYOUTS["nonuniform"], "int4_asym", seq, 1, 4, D=D, g=g, seed=5)
