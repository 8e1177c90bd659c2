"""The MoE FFN (no kernel: ``torch.bmm`` products) on the card against the
same function in f32 on the CPU, on the same bf16 inputs and weights.

A token's set of experts must be equal, or differ only in experts within
``parity.TIE_RTOL`` of its K-th probability (counted); queue positions and
drops must be equal wherever no such flip came first in the expert's
queue.  The output is a sum of K weighted expert rows that often cancel,
so the elementwise half of the bf16 rule of :mod:`repro_torch.kernels.parity`
cannot hold between a bf16 and an f32 run (JAX's own bf16 output misses it
against JAX's f32 output by over 100x); each row must be within
``parity.REL_L2`` of the f32 row, and the largest row error at most
``MOE_VS_BF16`` times that of the same function in bf16 on the CPU.

Raises ``AssertionError`` on a violation.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from repro_torch.kernels.parity import REL_L2, TIE_RTOL
from repro_torch.models.moe import moe_ffn

#: the card's largest row error against the f32 run, in units of the CPU
#: bf16 run's
MOE_VS_BF16 = 1.25


def _cpu_layer(layer, dtype):
    """The FFN weights of a ``DecoderLayer`` on the CPU in ``dtype`` (the
    router stays f32)."""
    cp = lambda t, dt: None if t is None else t.detach().to("cpu", dt)
    return SimpleNamespace(router=cp(layer.router, torch.float32),
                           up=cp(layer.up, dtype), gate=cp(layer.gate, dtype),
                           down=cp(layer.down, dtype))


def compare_moe_ffn(layer, x, cfg, group_size=512, n_tokens=None):
    """``moe_ffn`` on ``x``'s device against the same function in f32 and in
    bf16 on the CPU (module docstring's rule) -> {"tie_tokens",
    "tokens", "picks_held", "picks", "max_rel_l2", "max_rel_l2_cpu_bf16",
    "dropped", "dropped_f32"}."""
    kw = dict(group_size=group_size, n_tokens=n_tokens)
    r_dev, r32, r16 = {}, {}, {}
    y = moe_ffn(layer, x, cfg, routing=r_dev, **kw).to("cpu", torch.float32)
    xc = x.detach().to("cpu")
    y32 = moe_ffn(_cpu_layer(layer, torch.float32), xc.float(),
                  dataclasses.replace(cfg, dtype="float32"), routing=r32, **kw)
    y16 = moe_ffn(_cpu_layer(layer, xc.dtype), xc, cfg, routing=r16, **kw).float()
    E, K = cfg.moe.n_experts, cfg.moe.experts_per_token
    e32 = r32["experts"]
    G, gt, _ = e32.shape
    # picks as [G, gt, E] memberships, positions and kept flags
    def dense(r):
        e = r["experts"].cpu()
        pick = torch.zeros((G, gt, E), dtype=torch.bool).scatter_(2, e, True)
        pos = torch.full((G, gt, E), -1, dtype=torch.long).scatter_(
            2, e, r["positions"].cpu())
        kept = torch.zeros((G, gt, E), dtype=torch.bool).scatter_(
            2, e, r["kept"].cpu())
        return pick, pos, kept
    pick_d, pos_d, kept_d = dense(r_dev)
    pick_f, pos_f, kept_f = dense(r32)
    flip = pick_d ^ pick_f                                  # [G, gt, E]
    tie_tok = flip.any(-1)
    probs = r32["probs"]
    kth = probs.gather(2, e32[..., K - 1:K])                # [G, gt, 1]
    near = (probs - kth).abs() <= TIE_RTOL * kth.abs().clamp(min=1e-12)
    assert bool((near | ~flip).all()), (
        f"moe_ffn: {int((flip & ~near).any(-1).sum())} tokens pick other experts "
        f"than the f32 run beyond the near-tie tolerance")
    # an expert's queue is held up to its first flipped token
    first = torch.where(flip, torch.arange(gt)[None, :, None], gt).amin(1, keepdim=True)
    held = pick_f & ~flip & (torch.arange(gt)[None, :, None] < first)
    assert torch.equal(pos_d[held], pos_f[held]), "moe_ffn: queue positions differ"
    assert torch.equal(kept_d[held], kept_f[held]), "moe_ffn: dropped picks differ"
    n_live = y.numel() // y.shape[-1]          # the rows of x (not padding)
    rows = ~tie_tok.reshape(-1)[:n_live]
    flat = lambda t: t.reshape(-1, t.shape[-1])[rows]
    yf, y32f, y16f = flat(y), flat(y32), flat(y16)
    norm = y32f.norm(dim=-1)
    live = norm > 0
    assert not bool(yf[~live].any()), "moe_ffn: a token with every pick dropped is not 0"
    rel = (yf - y32f).norm(dim=-1)[live] / norm[live]
    rel16 = (y16f - y32f).norm(dim=-1)[live] / norm[live]
    m, m16 = float(rel.max()) if rel.numel() else 0.0, float(rel16.max()) if rel16.numel() else 0.0
    assert m <= REL_L2, f"moe_ffn: relative L2 error {m} > {REL_L2}"
    assert m <= MOE_VS_BF16 * m16 + 1e-6, (
        f"moe_ffn: row error {m} exceeds {MOE_VS_BF16} x the CPU bf16 run's {m16}")
    return {"tie_tokens": int(tie_tok.sum()), "tokens": G * gt,
            "picks_held": int(held.sum()), "picks": G * gt * K,
            "max_rel_l2": m, "max_rel_l2_cpu_bf16": m16,
            "dropped": int((~r_dev["kept"].cpu().reshape(-1, K)[:n_live]).sum()),
            "dropped_f32": int((~r32["kept"].reshape(-1, K)[:n_live]).sum())}
