"""The split-KV paged decode of the port, on the CPU.

``csrc/paged_attention.cu`` cuts each (sequence, kv head) cell's slot list
into ``n_split`` contiguous runs (``kernels.paged_attention.split_plan`` /
``split_ranges``), keeps a softmax state (m, l, acc) per run and combines
the runs.  The kernel runs only on the card; here its plan is held to its
contract, and a plain f32 model of its arithmetic (per-run state, then the
combine, written below) is held against JAX's ``paged_attention`` in
interpret mode on the grid of ``tests/test_torch_staged.py``'s
paged-attention test, with ``parity.check_outputs``' limits: one bf16
rounding step per element (1e-4 + 2^-7 |JAX|) and relative L2 1e-2 per row.

A head whose slots are all invalid (no live token, l = 0 in every run)
gets the mean V row of its whole table in the kernel's combine and in the
model, as in JAX's kernel (its masked logits all equal the -1e30 start of
the running max, so each weighs exp(0) = 1); every head, that one too, is
compared with JAX.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.core.ragged import layout_for
from repro_torch.core.selection import select_page_table
from repro_torch.core.stacked import as_arrays
from repro_torch.kernels import parity
from repro_torch.kernels.paged_attention import split_plan, split_ranges

B, N_KV, S, D, PS, BUDGET_T = 2, 2, 512, 16, 16, 128
NEG_INF = -1e30


def split_merge(q, kp, vp, tbl, vld, sl, page_size, n_split):
    """f32 model of the kernel: (m, l, acc) per run of slots over its live
    tokens (m = -1e30, l = 0, acc = 0 for a run with none), then
    out = sum_s w_s acc_s / sum_s w_s l_s, w_s = exp(m_s - max m); a head
    whose runs hold no live token (l = 0) gets the mean V row of its
    table (pages clamped into range)."""
    Bq, n_q, Dq = q.shape
    n_kv, n_pages = kp.shape[1], kp.shape[2]
    g = n_q // n_kv
    qf = q.float().reshape(Bq, n_kv, g, Dq)
    states = []
    for a, b in split_ranges(tbl.shape[-1], n_split):
        t = tbl[..., a:b].long()
        n = b - a
        idx = t.clamp(0, n_pages - 1)[..., None, None].expand(-1, -1, -1, page_size, Dq)
        k = torch.gather(kp.float(), 2, idx).reshape(Bq, n_kv, n * page_size, Dq)
        v = torch.gather(vp.float(), 2, idx).reshape(Bq, n_kv, n * page_size, Dq)
        pos = (t[..., None] * page_size + torch.arange(page_size)).reshape(Bq, n_kv, -1)
        slot_ok = vld[..., a:b] & (t >= 0) & (t < n_pages)
        live = (pos < sl.long()[:, None, None]) & slot_ok[..., None].expand(
            -1, -1, -1, page_size).reshape(Bq, n_kv, -1)
        logits = torch.einsum("bhgd,bhld->bhgl", qf, k) / math.sqrt(Dq)
        logits = torch.where(live[:, :, None], logits, -math.inf)
        m = logits.amax(-1).clamp(min=NEG_INF) if n else torch.full(
            (Bq, n_kv, g), NEG_INF)
        p = torch.where(live[:, :, None], torch.exp(logits - m[..., None]), 0.0)
        states.append((m, p.sum(-1), torch.einsum("bhgl,bhld->bhgd", p, v)))
    m_all = torch.stack([s[0] for s in states])
    w = torch.exp(m_all - m_all.amax(0))
    l_all = (w * torch.stack([s[1] for s in states])).sum(0)
    acc = (w[..., None] * torch.stack([s[2] for s in states])).sum(0)
    out = acc / l_all.clamp(min=1e-30)[..., None]
    idx = tbl.long().clamp(0, n_pages - 1)[..., None, None].expand(-1, -1, -1, page_size, Dq)
    mean = torch.gather(vp.float(), 2, idx).flatten(2, 3).mean(2)       # [B, n_kv, D]
    out = torch.where((l_all > 0)[..., None], out, mean[:, :, None])
    return out.reshape(Bq, n_q, Dq)


# -- the plan -------------------------------------------------------------------


@pytest.mark.parametrize("B_,n_kv,p_sel,n_sm", [
    (4, 8, 256, 132), (1, 8, 256, 132), (1, 1, 1, 132), (2, 2, 8, 132),
    (1, 8, 3, 132), (16, 8, 256, 132), (64, 8, 256, 132), (3, 5, 77, 132),
    (4, 8, 256, 1), (1, 1, 0, 132),
])
def test_split_plan_contract(B_, n_kv, p_sel, n_sm):
    n = split_plan(B_, n_kv, p_sel, n_sm)
    assert 1 <= n <= max(1, p_sel)                      # never more runs than slots
    runs = split_ranges(p_sel, n)
    assert [s for a, b in runs for s in range(a, b)] == list(range(p_sel))
    assert p_sel == 0 or all(b > a for a, b in runs)     # the plan has no empty run
    if B_ * n_kv >= n_sm:
        assert n == 1                                    # the cells fill the SMs
    elif n < p_sel:
        assert B_ * n_kv * n >= n_sm                     # else at least one wave


def test_split_plan_at_the_serving_shape():
    """llama3.2-3b staged decode at B 4 on an H100 (132 SMs): 8 runs of 32
    slots, 256 thread blocks."""
    n = split_plan(4, 8, 256, 132)
    assert n == 8 and split_ranges(256, n)[1] == (32, 64)


@pytest.mark.parametrize("p_sel", [1, 8, 13, 256])
def test_forced_split_ranges_cover_every_slot_once(p_sel):
    for n in range(1, p_sel + 1):
        runs = split_ranges(p_sel, n)
        assert len(runs) == n
        assert [s for a, b in runs for s in range(a, b)] == list(range(p_sel))


# -- split-and-merge arithmetic against JAX -------------------------------------


def _case(g, dtype, case):
    lay = as_arrays(layout_for((16, 32), S, PS, BUDGET_T))
    rng = np.random.default_rng(g)
    shape = (B, N_KV, S // PS, PS, D)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    q = (rng.standard_normal((B, N_KV * g, D)) * parity.QSCALE).astype(np.float32)
    scores = rng.standard_normal((B, N_KV, lay.max_blocks)).astype(np.float32)
    sl = np.asarray((S - 5, 1 if case == "seq-len-1" else 100), np.int32)
    tbl, vld = select_page_table(torch.from_numpy(scores), lay, torch.from_numpy(sl))
    vld = vld & torch.from_numpy(rng.random(vld.shape) > 0.25)
    vld[..., 0] = True
    if case == "dead-head":
        vld[0, 1] = False
    tdt = getattr(torch, dtype)
    q_t, k_t, v_t = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jops.paged_attention(
        jnp.asarray(q_t.float().numpy(), jdt), jnp.asarray(k_t.float().numpy(), jdt),
        jnp.asarray(v_t.float().numpy(), jdt), jnp.asarray(tbl.numpy()),
        jnp.asarray(vld.numpy()), PS, jnp.asarray(sl), interpret=True,
    )
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    return q_t, k_t, v_t, tbl, vld, torch.from_numpy(sl), want


@pytest.mark.parametrize("case", ["ragged", "dead-head", "seq-len-1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 3, 8])
def test_split_merge_matches_jax_kernel(g, dtype, case):
    """n_split 1, 2, 7 and 8 (one slot per run: more runs than the live
    slots of the short sequence; 7 leaves the last runs empty)."""
    q, k, v, tbl, vld, sl, want = _case(g, dtype, case)
    P = tbl.shape[-1]
    assert P == 8
    pos = tbl[..., None] * PS + torch.arange(PS)
    tok = (pos < sl[:, None, None, None]) & vld[..., None] & (tbl >= 0)[..., None]
    live = tok.flatten(2).any(-1).repeat_interleave(g, dim=1)   # [B, n_q]
    assert bool(live.any()) and (case != "dead-head" or not live[0, g:2 * g].any())
    every = torch.ones_like(live)
    for n_split in (1, 2, 7, P):
        got = split_merge(q, k, v, tbl, vld, sl, PS, n_split)
        assert torch.isfinite(got).all()
        parity.check_outputs(got.to(q.dtype), want, every, f"split_merge({n_split})")
        if case == "dead-head":   # the dead head is JAX's mean, not 0
            assert got[0, g:2 * g].abs().amax() > 0
