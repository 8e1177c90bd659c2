"""The plans and orders of the split sparse-prefill and fused-decode kernels,
on the CPU.

``csrc/sparse_prefill.cu`` attends a (sequence, kv head, query block) cell
on the tensor cores in 64-key tiles: the cell's selected blocks, in
ascending order, laid end to end and cut every 64 keys
(``kernels.sparse_prefill.prefill_tile_keys``); keys past the last selected
token or at or past ``n_valid`` are zero-filled and masked, and a tile is
masked per key only when it holds such a key or reaches the cell's first
query position (``prefill_tile_needs_mask``).  The tiles of a cell are cut
into ``n_split`` runs (``prefill_runs``, ``prefill_split_plan``), each with
its own (m, l, acc) in base 2, P split into bf16 hi + lo with l from the
f32 P, then combined with weights 2^(m_s - max m).  ``csrc/fused_decode.cu``
selects into the page table and attends its slots in the runs of
``kernels.paged_attention.split_plan`` / ``split_ranges``.

The kernels run only on the card; here the plans are held to their
contracts, and f32 models of the two kernels' arithmetic (written below)
are held against JAX's ``sparse_prefill`` and ``fused_decode`` kernels in
interpret mode, as the JAX package's own tests run them, with
``parity.check_outputs``' limits: one bf16 rounding step per element
(1e-4 + 2^-7 |JAX|) and relative L2 1e-2 per row.  Inputs are bf16 values
(made with numpy from a seed), as on the card.
"""
import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import get_backend as jax_backend
from repro.backends import store as jstore
from repro.config import SparseConfig as JSparse
from repro.core.centroids import rank_query as j_rank_query
from repro.core.ragged import layout_for as j_layout_for
from repro.core.stacked import as_arrays as j_as_arrays
from repro.kernels import ops as jops

from repro_torch.backends import CentroidStore
from repro_torch.config import SparseConfig as TSparse
from repro_torch.core.centroids import rank_query as t_rank_query
from repro_torch.core.ragged import layout_for as t_layout_for
from repro_torch.core.stacked import as_arrays as t_as_arrays
from repro_torch.kernels import ops as tops
from repro_torch.kernels import parity
from repro_torch.kernels.paged_attention import split_plan, split_ranges
from repro_torch.kernels.sparse_prefill import (
    FILL, MAX_RUNS, TILE_KEYS, attend_blocks, attend_warpgroups, prefill_plan_cost,
    prefill_runs, prefill_split_plan, prefill_tile_keys, prefill_tile_needs_mask,
)

from test_torch_split_decode import split_merge

B, S, D, PS, BUDGET, BQ = 2, 512, 32, 16, 128, 64
BLOCKS = (16, 32, 64)
NEG = -1e30


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


# -- the gather of selected blocks into 64-key tiles ---------------------------


@pytest.mark.parametrize("bs", [16, 32, 64])
@pytest.mark.parametrize("n_valid", [1000, 1021, 4096])
def test_tiles_hold_every_selected_key_once_in_whole_blocks(bs, n_valid):
    rng = np.random.default_rng(bs + n_valid)
    blocks = sorted(rng.choice(4096 // bs, size=37, replace=False).tolist())
    tiles = prefill_tile_keys(blocks, bs, n_valid)
    assert all(len(t) == TILE_KEYS for t in tiles)
    assert len(tiles) == -(-len(blocks) * bs // TILE_KEYS)
    flat = [p for t in tiles for p in t]
    live = [b * bs + i for b in blocks for i in range(bs) if b * bs + i < n_valid]
    assert [p for p in flat if p >= 0] == live          # every live key once, in order
    # tile t holds blocks t * 64 / bs .. (t + 1) * 64 / bs - 1 whole
    for t, tile in enumerate(tiles):
        for i, p in enumerate(tile):
            j = t * TILE_KEYS + i
            if j < len(blocks) * bs and p >= 0:
                assert p == blocks[j // bs] * bs + j % bs
    # masked keys: past the last selected token, or at or past n_valid
    for j, p in enumerate(flat):
        past = j >= len(blocks) * bs
        assert (p < 0) == (past or blocks[j // bs] * bs + j % bs >= n_valid)


@pytest.mark.parametrize("bs", [16, 32, 64])
def test_tiles_masked_only_where_a_key_can_be(bs):
    """An unmasked tile has no masked key and every key before the cell's
    first query, so no causal mask can apply to any of its rows; a tile
    reaching the diagonal is masked."""
    q_start = 1280
    blocks = list(range(0, 8)) + list(range(q_start // bs - 3, q_start // bs + 64 // bs))
    tiles = prefill_tile_keys(blocks, bs, q_start + 40)
    flags = [prefill_tile_needs_mask(t, q_start) for t in tiles]
    for tile, flag in zip(tiles, flags):
        if not flag:
            assert min(tile) >= 0 and max(tile) < q_start
        if max(tile) >= q_start or min(tile) < 0:
            assert flag
    assert flags[-1] and not flags[0]


# -- the split plans -------------------------------------------------------------


@pytest.mark.parametrize("cells,rows,n_sm,d", [
    (64, 192, 132, 128), (64, 256, 132, 128), (8, 192, 132, 128),
    (256, 192, 132, 128), (512, 64, 132, 128), (1, 64, 132, 128), (64, 192, 1, 128),
    (64, 128, 132, 128), (64, 512, 132, 128), (128, 64, 132, 256), (8, 128, 132, 256),
], ids=["64-192-132", "64-256-132", "8-192-132", "256-192-132", "512-64-132",
        "1-64-132", "64-192-1", "64-128-132", "64-512-132", "128-64-132-d256",
        "8-128-132-d256"])
def test_prefill_split_plan_contract(cells, rows, n_sm, d):
    """The plan gives about two attention blocks per SM where MAX_RUNS
    allows, and among such run counts the one of least modeled time (whole
    waves, a cost per run), the fewest on a tie."""
    n = prefill_split_plan(cells, rows, n_sm, d)
    assert 1 <= n <= MAX_RUNS
    blocks = attend_blocks(cells, rows, d)
    ok = [k for k in range(1, MAX_RUNS + 1) if blocks * k >= FILL * 2 * n_sm]
    if ok:
        assert n in ok
    cost = {k: prefill_plan_cost(cells, rows, n_sm, k, d)
            for k in (ok or range(1, MAX_RUNS + 1))}
    assert cost[n] == min(cost.values()) and n == min(k for k in cost if cost[k] == cost[n])


def test_prefill_attention_blocks_by_group():
    """Warpgroups per attention block: every 64-row tile of a cell up to 3
    (one block per cell and run), two blocks of 2 at 256 rows."""
    assert [attend_warpgroups(r, 128) for r in (64, 128, 192, 256)] == [1, 2, 3, 2]
    assert [attend_blocks(10, r, 128) for r in (64, 128, 192, 256)] == [10, 10, 10, 20]


def test_prefill_attention_blocks_at_512_rows_and_head_dim_256():
    """qwen3-32b's group of 8 at query blocks of 64 (512 rows: four blocks
    of 2 warpgroups a cell); at head_dim 256 one warpgroup a block, so
    every 64-row tile is a block of its own, one resident per SM."""
    assert attend_warpgroups(512, 128) == 2 and attend_blocks(10, 512, 128) == 40
    assert [attend_warpgroups(r, 256) for r in (64, 128, 192, 512)] == [1, 1, 1, 1]
    assert [attend_blocks(10, r, 256) for r in (64, 128, 192, 512)] == [10, 20, 30, 80]
    # one block per SM at head_dim 256: twice the waves of head_dim 128's
    # two one-warpgroup blocks per SM
    assert prefill_plan_cost(264, 64, 132, 1, 256) == 2 * prefill_plan_cost(
        264, 64, 132, 1, 128)


def test_prefill_split_plan_at_the_serving_shape():
    """llama3.2-3b, B 1, chunk 512: 64 cells of 192 query rows, one
    384-thread block per cell and run (one fits on an SM); 4 runs give 256
    blocks, 1.94 per SM on an H100's 132 SMs.  qwen3-8b's group of 4 (256
    rows: two blocks of 2 warpgroups per cell) takes 2 runs."""
    assert prefill_split_plan(64, 3 * 64, 132, 128) == 4
    assert prefill_split_plan(64, 4 * 64, 132, 128) == 2
    # qwen3-32b (8 kv heads x 8 query blocks, 512 rows: 256 blocks a run)
    # and gemma-7b (16 x 8 cells of 64 rows at head_dim 256, one block an SM)
    assert prefill_split_plan(64, 8 * 64, 132, 128) == 1
    assert prefill_split_plan(128, 64, 132, 256) == 2


@pytest.mark.parametrize("n_tiles", [0, 1, 2, 7, 64, 70])
@pytest.mark.parametrize("n_split", [1, 2, 3, 8, 40])
def test_prefill_runs_attend_every_tile_once(n_tiles, n_split):
    runs = prefill_runs(n_tiles, n_split)
    assert len(runs) == n_split
    assert [t for a, b in runs for t in range(a, b)] == list(range(n_tiles))
    # empty runs come only after the last tile, and only when there are more
    # runs than a cell's tiles need; the kernel writes them (m, l) = (-1e30, 0)
    filled = [b > a for a, b in runs]
    assert filled == sorted(filled, reverse=True)
    per = -(-n_tiles // n_split) if n_tiles else 0
    assert sum(filled) == (-(-n_tiles // per) if per else 0)


def test_fused_split_plan_at_the_serving_shape():
    """The fused decode attends its table in split_plan's runs: B 4, 8 kv
    heads, 256 slots on 132 SMs -> 8 runs of 32 slots, none empty."""
    n = split_plan(4, 8, 256, 132)
    runs = split_ranges(256, n)
    assert n == 8 and all(b - a == 32 for a, b in runs)
    assert [s for a, b in runs for s in range(a, b)] == list(range(256))


# -- f32 model of the prefill kernel against JAX's kernel ----------------------


def prefill_model(q6, k_pages, v_pages, selected, bsz, n_valid, qb0, n_split):
    """The prefill attention kernel's arithmetic: per cell, its selected
    blocks in 64-key tiles, per run of tiles an online softmax in base 2
    (masked only on the tiles that need it), P = hi + lo in bf16 with l
    from the f32 P, then the runs combined with 2^(m_s - max m)."""
    Bq, H, nQB, g, bq, Dq = q6.shape
    S_ = k_pages.shape[2] * k_pages.shape[3]
    kd = k_pages.float().reshape(Bq, H, S_, Dq)
    vd = v_pages.float().reshape(Bq, H, S_, Dq)
    scale_log2 = math.log2(math.e) / math.sqrt(Dq)
    out = torch.zeros((Bq, H, nQB, g * bq, Dq))
    for b in range(Bq):
        nv = int(n_valid[b])
        for h in range(H):
            bs = int(bsz[h])
            for qb in range(nQB):
                q_start = (qb0 + qb) * bq
                blocks = torch.nonzero(selected[b, h, qb]).flatten().tolist()
                if q_start >= nv or not blocks:
                    continue
                qf = q6[b, h, qb].float().reshape(g * bq, Dq)
                qpos = q_start + torch.arange(g * bq) % bq
                tiles = prefill_tile_keys(blocks, bs, nv)
                states = []
                for a, e in prefill_runs(len(tiles), n_split):
                    m = torch.full((g * bq,), NEG)
                    l = torch.zeros(g * bq)
                    acc = torch.zeros((g * bq, Dq))
                    for tile in tiles[a:e]:
                        pos = torch.tensor(tile)
                        idx = pos.clamp(min=0)
                        s = qf @ torch.where(pos[:, None] >= 0, kd[b, h, idx], 0.0).T
                        if prefill_tile_needs_mask(tile, q_start):
                            ok = (pos[None] >= 0) & (pos[None] <= qpos[:, None])
                            s = torch.where(ok, s, -math.inf)
                        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(s * scale_log2 - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        hi = p.to(torch.bfloat16).float()
                        lo = (p - hi).to(torch.bfloat16).float()
                        vt = torch.where(pos[:, None] >= 0, vd[b, h, idx], 0.0)
                        acc = acc * alpha[:, None] + hi @ vt + lo @ vt
                        m = m_new
                    states.append((m, l, acc))
                if n_split == 1:
                    m, l, acc = states[0]
                    out[b, h, qb] = acc / l.clamp(min=1e-30)[:, None]
                    continue
                m_all = torch.stack([st[0] for st in states])
                w = torch.exp2(m_all - m_all.amax(0))
                l_all = (w * torch.stack([st[1] for st in states])).sum(0)
                acc = (w[..., None] * torch.stack([st[2] for st in states])).sum(0)
                out[b, h, qb] = acc / l_all.clamp(min=1e-30)[:, None]
    return out.reshape(q6.shape)


def _prefill_case(off, sq, n_valid, quant, seed, d=D, g=2):
    kw = dict(quant=quant, sink_pages=1, local_pages=4, prefill_block_q=BQ)
    jcfg, tcfg = JSparse(token_budget=BUDGET, **kw), TSparse(token_budget=BUDGET, **kw)
    jla = j_as_arrays(j_layout_for(BLOCKS, S, PS, BUDGET))
    tla = t_as_arrays(t_layout_for(BLOCKS, S, PS, BUDGET))
    rng = np.random.default_rng(seed)
    shape = (B, len(BLOCKS), S // PS, PS, d)
    k, v = (_bf16(rng.standard_normal(shape).astype(np.float32)).float().numpy()
            for _ in range(2))
    q = _bf16((rng.standard_normal((B, len(BLOCKS) * g, sq, d))
               * parity.QSCALE).astype(np.float32)).float().numpy()
    nv = np.asarray(n_valid, np.int32)
    offs = jnp.asarray(jla.row_offsets)
    codes, sc, ze = jstore.build_score_rows(jnp.asarray(k), jla, offs, jcfg, quant)
    jss = jax_backend("reference").prefill_score_rows(jnp.asarray(k), jla, offs, jcfg,
                                                      quant)
    rq = j_rank_query(jnp.asarray(q), jcfg.centroid_method, d)
    want, n_att = jops.sparse_prefill(
        jnp.asarray(q), rq, jnp.asarray(k), jnp.asarray(v), jss, jla, sink_pages=1,
        local_pages=4, block_q=BQ, n_valid=jnp.asarray(nv), chunk_offset=off,
        interpret=True)
    bits = 0 if quant == "none" else int(quant[3])
    tss = CentroidStore(torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(sc)),
                        torch.from_numpy(np.array(ze)), bits, False)
    tq = torch.from_numpy(q)
    trq = t_rank_query(tq, tcfg.centroid_method, d)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    extra, _ = parity.prefill_selection(tq, trq, kt, vt, tss, tla, tcfg, torch.from_numpy(nv),
                                        off)
    q6, _, _, _, qb0 = tops._prefill_query_blocks(tq, trq, tla, BQ, 1.0, torch.from_numpy(nv),
                                                  off)
    want = torch.from_numpy(np.array(want))
    np.testing.assert_array_equal(extra["selected"].sum(-1).numpy(), np.asarray(n_att))
    return q6, kt, vt, extra["selected"], tla, nv, qb0, want, sq


@pytest.mark.parametrize("off,sq,n_valid,d,g", [
    (256, 256, (512, 377), D, 2), (0, 192, (192, 70), D, 2),
    (256, 128, (512, 301), 256, 1), (256, 128, (384, 300), D, 8),
], ids=["later-chunk", "first-chunk", "head-dim-256", "rows-512"])
@pytest.mark.parametrize("quant", ["int4_asym", "none"])
def test_prefill_split_model_matches_jax_kernel(off, sq, n_valid, d, g, quant):
    """The model at 1, 2, 3 and 8 runs per cell against JAX's sparse_prefill
    kernel in interpret mode, every output row (dead rows and dead query
    blocks included: a dead query block attends nothing and gives 0); also
    at head_dim 256 and at a group of 8 (512 query rows a cell)."""
    q6, k, v, selected, la, nv, qb0, want, sq = _prefill_case(
        off, sq, n_valid, quant, seed=off + sq + (d if d != D else 0) + 8 * (g == 8),
        d=d, g=g)
    assert q6.shape[3] * q6.shape[4] == g * BQ
    keep = torch.ones(want.shape[:-1], dtype=torch.bool)
    for n_split in (1, 2, 3, 8):
        got6 = prefill_model(q6, k, v, selected, la.block_sizes, nv, qb0, n_split)
        got = tops._from_blocks(got6, sq)
        assert torch.isfinite(got).all()
        parity.check_outputs(got.to(torch.bfloat16), want, keep,
                             f"prefill model ({n_split} runs)")


def test_prefill_model_comparison_sees_a_missing_diagonal_mask(monkeypatch):
    """The comparison fails a model that masks only the keys past the last
    selected token, not the causal diagonal."""
    q6, k, v, selected, la, nv, qb0, want, sq = _prefill_case(
        256, 256, (512, 377), "int4_asym", seed=512)
    monkeypatch.setattr(sys.modules[__name__], "prefill_tile_needs_mask",
                        lambda tile, q_start: min(tile) < 0)
    bad = tops._from_blocks(prefill_model(q6, k, v, selected, la.block_sizes, nv,
                                          qb0, 2), sq)
    keep = torch.ones(want.shape[:-1], dtype=torch.bool)
    with pytest.raises(AssertionError):
        parity.check_outputs(bad.to(torch.bfloat16), want, keep, "unmasked diagonal")


# -- f32 model of the fused decode against JAX's kernel ------------------------


@pytest.mark.parametrize("seq,d", [((S, 301), D), ((1, 17), D), ((S, 301), 256)],
                         ids=["ragged", "edge", "ragged-head-dim-256"])
@pytest.mark.parametrize("quant", ["int4_asym", "int8_asym"])
def test_fused_split_model_matches_jax_kernel(seq, d, quant):
    """The fused kernel's page table (the port's plain version) equals JAX's
    fused kernel's exactly; the split-KV model over it at 1, 3, 8 and one
    slot per run (split_ranges, the kernel's runs) agrees with JAX's
    output within the bf16 rule; also at head_dim 256 (rank keys of 512)."""
    jcfg, tcfg = JSparse(token_budget=BUDGET, quant=quant), TSparse(token_budget=BUDGET,
                                                                    quant=quant)
    jla = j_as_arrays(j_layout_for(BLOCKS, S, PS, BUDGET))
    tla = t_as_arrays(t_layout_for(BLOCKS, S, PS, BUDGET))
    rng = np.random.default_rng(len(quant) + seq[1] + (d if d != D else 0))
    shape = (B, 3, S // PS, PS, d)
    k, v = (_bf16(rng.standard_normal(shape).astype(np.float32)).float().numpy()
            for _ in range(2))
    q = _bf16((rng.standard_normal((B, 3 * 2, d)) * parity.QSCALE).astype(
        np.float32)).float().numpy()
    sl = np.asarray(seq, np.int32)
    jst = jstore.build_store_codes(jnp.asarray(k), jla, jnp.asarray(jla.row_offsets),
                                   jcfg, quant)
    rq = j_rank_query(jnp.asarray(q), jcfg.centroid_method, d)
    want, jtbl, jvld = jops.fused_decode(jnp.asarray(q), rq, jnp.asarray(k), jnp.asarray(v),
                                         jst, jla, 1, 4, jnp.asarray(sl), interpret=True)
    tst = CentroidStore(*(torch.from_numpy(np.array(x)) for x in
                          (jst.codes, jst.scale, jst.zero)), jst.bits, jst.symmetric)
    tq = torch.from_numpy(q)
    _, tbl, vld = tops.fused_decode(tq, t_rank_query(tq, tcfg.centroid_method, d),
                                    torch.from_numpy(k), torch.from_numpy(v), tst, tla, 1,
                                    4, torch.from_numpy(sl))
    np.testing.assert_array_equal(np.asarray(jvld), vld.numpy())
    np.testing.assert_array_equal(np.asarray(jtbl)[np.asarray(jvld)],
                                  tbl.numpy()[vld.numpy()])
    want = torch.from_numpy(np.array(want)).float()
    keep = torch.ones(want.shape[:-1], dtype=torch.bool)
    P = tbl.shape[-1]
    for n_split in (1, 3, 8, P):
        got = split_merge(tq.to(torch.bfloat16), torch.from_numpy(k).to(torch.bfloat16),
                          torch.from_numpy(v).to(torch.bfloat16), tbl, vld,
                          torch.from_numpy(sl), PS, n_split)
        parity.check_outputs(got.to(torch.bfloat16), want, keep,
                             f"fused split model ({n_split} runs)")
