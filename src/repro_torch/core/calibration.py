"""Per-head block-size calibration (paper §3.2, Eq. 2; counterpart of
``repro.core.calibration``).

Each head's attention recall is profiled at every candidate block size
under the token budget, and the head gets the largest size that keeps
``tau * Recall(h, B_min)``.  With no pretrained weights, the head roles are
generated: :func:`make_head_batch` lays a head's critical tokens out either
in runs (granularity-insensitive heads) or scattered (needle-like,
granularity-sensitive heads).

Random numbers come from ``torch.Generator``s on the caller's device: a
JAX ``fold_in(key, i)`` becomes :func:`fold_in`, a fresh generator seeded
from the parent's seed and ``i``, so every (layer, sample, head) draws the
same numbers on one device whichever backend scores them.  They are not
JAX's numbers: the tests feed both packages the same ``(q, K)``.

:func:`profile_heads` scores all heads of a layer at once, the heads along
the batch axis: one store build (one pooling launch on ``"cuda"``), one
scoring launch and one selection per (layer, sample, candidate).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.backends import get_backend
from repro_torch.core.centroids import rank_query
from repro_torch.core.ragged import RaggedLayout, uniform_layout
from repro_torch.core.recall import attention_probs, recall_from_mask
from repro_torch.core.selection import pages_to_token_mask, select_page_table
from repro_torch.core.stacked import LayoutArrays, as_arrays
from repro_torch.models import resolve_device


def fold_in(key: torch.Generator, *ids: int) -> torch.Generator:
    """A new generator on ``key``'s device, seeded from ``key``'s seed and
    ``ids`` (numpy's ``SeedSequence`` mixes them)."""
    seq = np.random.SeedSequence([key.initial_seed(), *ids])
    seed = int(seq.generate_state(1, np.uint64)[0])
    return torch.Generator(device=key.device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Synthetic head behaviour
# ---------------------------------------------------------------------------


def make_head_batch(
    key: torch.Generator,
    seq_len: int,
    head_dim: int,
    n_critical: int,
    cluster_width: int,
    signal: float = 8.0,
    noise: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One head's q ``[head_dim]`` and K ``[seq_len, head_dim]`` (f32, on
    ``key``'s device) with ``n_critical`` critical tokens in runs of
    ``cluster_width`` tokens on a grid, so that runs never overlap.

    Scattered criticals (width 1) need ``B <= budget / n`` to be captured;
    runs of 32 or more are captured at any candidate size."""
    dev = key.device
    direction = torch.randn(head_dim, generator=key, device=dev)
    direction = direction / torch.linalg.vector_norm(direction)
    run_len = max(1, min(cluster_width, n_critical))
    n_runs = max(1, n_critical // run_len)
    grid = seq_len // run_len
    starts = torch.randperm(grid, generator=key, device=dev)[:n_runs] * run_len
    positions = (starts[:, None] + torch.arange(run_len, device=dev)[None]).reshape(-1)
    critical = torch.zeros(seq_len, dtype=torch.bool, device=dev)
    critical[positions] = True
    keys = torch.randn((seq_len, head_dim), generator=key, device=dev) * noise
    keys = keys + torch.where(critical[:, None], signal * direction[None], 0.0)
    q = signal * direction + torch.randn(head_dim, generator=key, device=dev) * 0.1
    return q, keys


#: per-head profiles cycled across heads: (name, criticals as a fraction of
#: budget / 16, run width).  Insensitive (clustered), mid (sensitive beyond
#: B = 32) and needle (only B = 16 suffices) heads, as in Fig. 3/4.
HEAD_PROFILES = (
    ("insensitive", 0.5, 64),
    ("mid", 0.5, 1),
    ("needle", 1.0, 1),
)


def head_profile(h: int):
    return HEAD_PROFILES[h % len(HEAD_PROFILES)]


def make_model_like_batch(
    key: torch.Generator,
    n_heads: int,
    seq_len: int,
    head_dim: int,
    token_budget: int = 1024,
    profiles: Optional[Sequence[Tuple[str, float, int]]] = None,
):
    """-> (q ``[n_heads, D]``, K ``[n_heads, S, D]``, profile names): head
    ``h`` drawn from ``fold_in(key, h)`` with
    ``n_critical = max(4, frac * budget / 16)``."""
    qs, ks, names = [], [], []
    for h in range(n_heads):
        name, frac, width = profiles[h % len(profiles)] if profiles else head_profile(h)
        n_crit = max(4, int(frac * token_budget // 16))
        q, k = make_head_batch(fold_in(key, h), seq_len, head_dim, n_crit, width)
        qs.append(q)
        ks.append(k)
        names.append(name)
    return torch.stack(qs), torch.stack(ks), tuple(names)


# ---------------------------------------------------------------------------
# Recall profiling
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _layout_arrays(layout: RaggedLayout, device: torch.device) -> LayoutArrays:
    return as_arrays(layout, device)


def head_recall_at_block_size(
    q: torch.Tensor,               # [D], or [N, D] for N heads at once
    keys: torch.Tensor,            # [S, D], or [N, S, D]
    block_size: int,
    token_budget: int,
    method: str = "quest",
    page_size: int = 16,
    sink_pages: int = 1,
    local_pages: int = 4,
    backend: str = "reference",
    quant: str = "none",
) -> torch.Tensor:
    """Recall of each head at ``block_size`` under ``token_budget`` (paper
    Fig. 3) -> f32 ``[]`` or ``[N]``.  The store is built, scored and
    selected through the named backend, so the profile is taken on the
    store the serving path reads; batched heads are separate sequences of
    a one-head layout."""
    S, D = keys.shape[-2:]
    qs, ks = q.reshape(-1, D), keys.reshape(-1, S, D)
    n = qs.shape[0]
    layout = uniform_layout(1, block_size, S, page_size, token_budget)
    la = _layout_arrays(layout, keys.device)
    be = get_backend(backend)
    store = be.build_store(ks[:, None], layout, method, quant=quant)
    rq = rank_query(qs[:, None], method, D)                     # [N, 1, Dp]
    scores = be.scores(rq, store, la, 1)                        # [N, 1, M]
    seq_len = torch.full((n,), S, dtype=torch.int32, device=keys.device)
    table, valid = select_page_table(scores, la, seq_len, sink_pages, local_pages)
    mask = pages_to_token_mask(table, valid, la)                # [N, 1, S]
    rec = recall_from_mask(attention_probs(qs, ks), mask[:, 0])
    return rec.reshape(q.shape[:-1])


@dataclass(frozen=True)
class CalibrationResult:
    candidates: Tuple[int, ...]
    #: [n_layers, n_kv_heads, n_candidates] mean recall over samples
    recall: np.ndarray
    #: [n_layers, n_kv_heads] Eq.-2 assignment
    block_sizes: np.ndarray
    tau: float

    @property
    def avg_block_size(self) -> float:
        return float(self.block_sizes.mean())

    def as_tuple(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(tuple(int(b) for b in row) for row in self.block_sizes)


def assign_block_sizes(
    recall: np.ndarray, candidates: Sequence[int], tau: float
) -> np.ndarray:
    """Eq. (2): per head, the largest B with
    ``Recall(h, B) >= tau * Recall(h, B_min)``; ``recall[..., i]`` belongs
    to the i-th smallest candidate."""
    candidates = np.asarray(sorted(candidates))
    assert recall.shape[-1] == len(candidates)
    ok = recall >= tau * recall[..., 0:1] - 1e-9
    idx = np.where(ok, np.arange(len(candidates)), -1).max(axis=-1)
    return candidates[np.maximum(idx, 0)]


def profile_heads(
    key: torch.Generator,
    n_heads: int,
    seq_len: int,
    head_dim: int,
    candidates: Sequence[int],
    token_budget: int,
    n_samples: int = 8,
    method: str = "quest",
    profiles: Optional[Sequence[Tuple[str, float, int]]] = None,
    backend: str = "reference",
    quant: str = "none",
) -> np.ndarray:
    """-> recall ``[n_heads, n_candidates]`` (float64) averaged over
    ``n_samples`` calibration samples, sample ``s`` drawn from
    ``fold_in(key, s)`` on ``key``'s device."""
    acc = torch.zeros((n_heads, len(candidates)), dtype=torch.float64,
                      device=key.device)
    for s in range(n_samples):
        qs, ks, _ = make_model_like_batch(fold_in(key, s), n_heads, seq_len,
                                          head_dim, token_budget, profiles)
        for ci, b in enumerate(candidates):
            acc[:, ci] += head_recall_at_block_size(
                qs, ks, int(b), token_budget, method, backend=backend,
                quant=quant,
            ).to(torch.float64)
    return acc.cpu().numpy() / n_samples


def calibrate(
    key: torch.Generator,
    n_layers: int,
    n_kv_heads: int,
    head_dim: int,
    seq_len: int = 4096,
    candidates: Sequence[int] = (16, 32, 64),
    token_budget: int = 1024,
    tau: float = 0.98,
    n_samples: int = 4,
    method: str = "quest",
    backend: str = "reference",
    quant: str = "none",
    device="cuda",
) -> CalibrationResult:
    """Offline calibration pass -> per-(layer, kv head) assignment; layer
    ``l`` profiled from ``fold_in(key, l)``.  ``key`` must lie on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    if key.device.type != dev.type:
        raise ValueError(f"the generator is on {key.device}, the calibration "
                         f"runs on {dev}")
    candidates = tuple(sorted(int(c) for c in candidates))
    recall = np.zeros((n_layers, n_kv_heads, len(candidates)))
    for layer in range(n_layers):
        recall[layer] = profile_heads(
            fold_in(key, layer), n_kv_heads, seq_len, head_dim, candidates,
            token_budget, n_samples=n_samples, method=method, backend=backend,
            quant=quant,
        )
    sizes = assign_block_sizes(recall, candidates, tau)
    return CalibrationResult(candidates, recall, sizes, tau)


def calibrate_for_config(
    key: torch.Generator,
    cfg,
    seq_len: int = 4096,
    n_samples: int = 4,
    backend: str = "reference",
    device="cuda",
):
    """Calibrate under the model's own sparse settings (``tau``, candidate
    sizes, token budget at ``seq_len``, centroid method, quantization) ->
    ``(new_cfg, result)`` with the Eq.-2 assignment installed in
    ``new_cfg.sparse.block_sizes``."""
    sp = cfg.sparse
    result = calibrate(
        key, n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, seq_len=seq_len,
        candidates=sp.candidate_block_sizes,
        token_budget=sp.budget_for(seq_len), tau=sp.tau, n_samples=n_samples,
        method=sp.centroid_method, backend=backend, quant=sp.quant,
        device=device,
    )
    new_cfg = dataclasses.replace(
        cfg, sparse=dataclasses.replace(sp, block_sizes=result.as_tuple())
    )
    return new_cfg, result
