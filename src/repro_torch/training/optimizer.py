"""AdamW with decoupled weight decay, a cosine schedule, global-norm
clipping and int8 error-feedback compression (counterpart of
``repro.training.optimizer``).

Mixed precision as in JAX: parameters may be bf16; the optimizer state (m,
v and an f32 master copy of every low-precision parameter) is f32, and
bias correction and the decoupled decay act on the master.  The trees are
dicts keyed by parameter name (``Module.named_parameters``), a None where
JAX holds a None leaf.  Where JAX builds new trees (the clipped gradients,
the new parameters), this updates in place: at full width the state is
most of the device's memory.  The schedule and the bias corrections are
f32 scalars computed on the host (``step`` is a Python int).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import TrainConfig

Tree = Dict[str, Optional[torch.Tensor]]


class OptState(NamedTuple):
    step: int
    m: Tree
    v: Tree
    master: Tree         # f32 master params (None where the param is f32)
    error: Tree          # compression error-feedback residual (or Nones)


def init_opt_state(params: Dict[str, torch.Tensor], compression: bool = False) -> OptState:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device) \
            if p.is_floating_point() else None

    m = {n: zeros32(p) for n, p in params.items()}
    v = {n: zeros32(p) for n, p in params.items()}
    master = {n: p.detach().to(torch.float32, copy=True)
              if p.is_floating_point() and p.dtype != torch.float32 else None
              for n, p in params.items()}
    error = {n: zeros32(p) if compression else None for n, p in params.items()}
    return OptState(0, m, v, master, error)


def lr_schedule(cfg: TrainConfig, step: int) -> float:
    """Linear warmup, then a cosine from 1 down to 0.1 of the peak, in f32
    as JAX computes it."""
    f32 = np.float32
    warm = min(f32(step) / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    t = np.clip(f32(step - cfg.warmup_steps)
                / f32(max(cfg.total_steps - cfg.warmup_steps, 1)), f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * t, dtype=f32))
    return float(f32(cfg.learning_rate) * warm * (f32(0.1) + f32(0.9) * cos))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (clipping factor ``min(1, max_norm / max(norm, 1e-9))``, global
    norm), both f32 device scalars.  JAX returns the clipped tree, whose
    leaves are f32 (a bf16 gradient times the f32 factor promotes); here
    :func:`adamw_update` multiplies each gradient's f32 upcast by the
    factor, which gives the same values without a second tree."""
    leaves = [g for g in grads.values() if g is not None]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return scale, gnorm


def compress_int8(g: torch.Tensor, residual: torch.Tensor):
    """-> (int8 codes, per-tensor scale, new residual).  Error feedback keeps
    the quantization noise from accumulating across steps."""
    gf = g.to(torch.float32) + residual
    scale = torch.clamp_min(torch.max(torch.abs(gf)) / 127.0, 1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.to(torch.float32) * scale


@torch.no_grad()
def adamw_update(cfg: TrainConfig, params: Dict[str, torch.Tensor], grads: Tree,
                 state: OptState) -> Tuple[OptState, Dict[str, object]]:
    """One AdamW step: clip by the global norm, then update ``params``, m,
    v and the masters in place -> (new state, ``{"grad_norm": device
    scalar, "lr": float}``)."""
    clip, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    f32 = np.float32
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
    bc1 = float(f32(1.0) - f32(b1) ** f32(step))
    bc2 = float(f32(1.0) - f32(b2) ** f32(step))
    for name, p in params.items():
        g, m, v = grads.get(name), state.m[name], state.v[name]
        if g is None or m is None:
            continue
        gf = g.to(torch.float32) * clip
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_((1 - b2) * gf * gf)
        del gf
        master = state.master[name]
        base = p if master is None else master
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps)).add_(base * wd)
        base.sub_(upd.mul_(lr))
        del upd
        if master is not None:
            p.copy_(master)
    return state._replace(step=step), {"grad_norm": gnorm, "lr": lr}
