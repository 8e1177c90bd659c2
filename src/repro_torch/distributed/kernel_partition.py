"""Partitioning of the kernel calls over a ``(data, model)`` serving mesh
(counterpart of ``repro.distributed.kernel_partition``).

The decode and prefill kernels iterate a ``(batch, kv head)`` (and query
block) grid whose cells are independent, so the partitioning is *batch
rows over data, kv heads over model*.  JAX wraps the kernels in
``shard_map``; here each process of the mesh holds its own slice of the
cache and launches the SAME kernel over only its rows and kv heads.

Partitioning contract (JAX's, but for the store's row axis):

- batch axes (``q`` / ``rq`` / KV pages / store codes / ``seq_len``) split
  over the rule's ``batch`` axis when it divides the batch, else
  replicate;
- the kv-head axis (KV pages, decode-store ``scale`` / ``zero``, the
  per-head layout descriptors) splits over the ``kv_heads`` axis when it
  divides ``n_kv``: a GQA stack with fewer kv heads than the model axis
  degrades to replicated heads;
- q heads ride the kv-head split (the head axis is kv-head-major,
  ``n_q = n_kv * group``);
- **the store's flat row axis splits with the heads.**  JAX keeps it
  whole on every shard with a global ``tile_head``; the port's fused and
  scoring kernels index ``scale`` / ``zero`` by the tile's head, so a
  shard keeps only its own heads' rows: :func:`shard_layout` rebases
  ``row_offsets`` / ``scatter_rows`` and makes ``tile_head`` local, and
  each head's codes, scale and zero are byte-equal to its segment of the
  whole store;
- static kernel bounds are the whole call's on every shard: the layout's
  ``max_blocks`` / ``max_top_k`` / ``selected_pages``, and the split
  count of the three kernels that split a cell's work
  (``fused_decode``, ``paged_attention``, ``sparse_prefill``), which a
  shard would otherwise choose from its own, smaller, batch and head
  count and so sum a cell's partial softmax states in another order.

Each cell then computes on the same inputs with the same bounds, shard or
not: the backends launch the kernel on a shard's inputs with
:func:`decode_split` / :func:`prefill_split` as its ``n_split``, and the
model gathers the kv-head axis of the attention output before the
out-projection (``Transformer._gather_heads``), which then sums over the
whole head axis in the single-device order.  That holds for every
per-head kernel, so the staged pair (``centroid_scores_*`` -> selection
-> ``paged_attention``), ``flash_attention`` and the dense decode run on
local heads too (JAX replicates the staged kernels under GSPMD instead;
the numbers are the same).  The scoring kernel and flash split no cell.

Everything here is a function of the mesh sizes and a rank's
coordinates: :func:`shard_of` needs no process group, so one card can
launch every shard of a call in turn and stitch them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.ragged import RaggedLayout
from repro_torch.core.stacked import LayoutArrays

AxisVal = Union[None, str, Tuple[str, ...]]

# ---------------------------------------------------------------------------
# serving rule table
# ---------------------------------------------------------------------------

#: Logical-axis rules of the mesh serving engine (JAX's table): batch over
#: ``data``, kv heads over ``model``; ``heads`` / ``mlp`` / ``vocab``
#: replicate, since splitting them would reorder the float sums of the
#: out-projections and the LM head and break token identity.
SERVING_RULES: Dict[str, AxisVal] = {
    "batch": "data",
    "kv_heads": "model",
    "heads": None,
    "kv_pages": None,
    "kv_seq": None,
    "seq": None,
    "head_dim": None,
    "embed": None,
    "mlp": None,
    "vocab": None,
    "experts": None,
    "moe_group": None,
    "layers": None,
    "centroid_rows": None,
    "rank_width": None,
    "fsdp": None,
}


def serving_rules(overrides: Optional[Dict[str, AxisVal]] = None) -> Dict[str, AxisVal]:
    rules = dict(SERVING_RULES)
    if overrides:
        rules.update(overrides)
    return rules


def _pick_axis(mesh, rule_val: AxisVal, dim: int) -> Optional[str]:
    """First mesh axis named by the rule that is >1 and divides ``dim``
    (non-dividing axes degrade to replication)."""
    if rule_val is None:
        return None
    sizes = mesh.sizes
    axes = (rule_val,) if isinstance(rule_val, str) else tuple(rule_val)
    for a in axes:
        n = sizes.get(a, 1)
        if n > 1 and dim % n == 0:
            return a
    return None


def shard_axes(mesh, rules: Dict[str, AxisVal], batch: int, n_kv: int
               ) -> Tuple[Optional[str], Optional[str]]:
    """-> ``(batch_axis, head_axis)`` mesh-axis names (or None) for a
    kernel call over ``batch`` sequences and ``n_kv`` kv heads."""
    return (_pick_axis(mesh, rules.get("batch"), batch),
            _pick_axis(mesh, rules.get("kv_heads"), n_kv))


# ---------------------------------------------------------------------------
# one rank's slice of a call
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Shard:
    """One rank's slice of a call over ``batch`` sequences and ``n_kv`` kv
    heads (the whole call's sizes): batch rows ``[rows[0], rows[1])`` and
    kv heads ``[heads[0], heads[1])``."""

    batch: int
    n_kv: int
    rows: Tuple[int, int]
    heads: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.rows[1] - self.rows[0]

    @property
    def n_heads(self) -> int:
        return self.heads[1] - self.heads[0]

    @property
    def rows_split(self) -> bool:
        return self.n_rows != self.batch

    @property
    def heads_split(self) -> bool:
        return self.n_heads != self.n_kv

    @property
    def trivial(self) -> bool:
        """The whole call: no row and no head of it elsewhere."""
        return not (self.rows_split or self.heads_split)

    def one_row(self) -> "Shard":
        """The same heads in a call over one sequence (a prefill chunk)."""
        return dataclasses.replace(self, batch=1, rows=(0, 1))

    def take_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return x.narrow(dim, self.rows[0], self.n_rows)

    def take_heads(self, x: torch.Tensor, dim: int, group: int = 1) -> torch.Tensor:
        """This shard's heads of a kv-head-major axis of ``n_kv * group``
        heads (``group`` the GQA group of a q-head axis, 1 for kv heads)."""
        return x.narrow(dim, self.heads[0] * group, self.n_heads * group)

    def take(self, x: torch.Tensor, head_dim: int = 1, group: int = 1) -> torch.Tensor:
        """Rows (dim 0) and heads (``head_dim``) of a whole-call tensor."""
        return self.take_heads(self.take_rows(x), head_dim, group)


def _span(n: int, axis: Optional[str], sizes: Dict[str, int],
          coord: Dict[str, int]) -> Tuple[int, int]:
    if axis is None:
        return 0, n
    per = n // sizes[axis]
    return coord[axis] * per, (coord[axis] + 1) * per


def shard_of(mesh, coords, batch: int, n_kv: int) -> Shard:
    """The slice of a call over ``batch`` sequences and ``n_kv`` kv heads
    that the rank at ``coords`` (``(data, model)``) of ``mesh`` (a
    :class:`~.mesh.ServingMesh`) holds, by :func:`shard_axes` under
    :data:`SERVING_RULES`."""
    sizes = mesh.sizes
    coord = dict(zip(mesh.axis_names, coords))
    ba, ha = shard_axes(mesh, SERVING_RULES, batch, n_kv)
    return Shard(batch, n_kv, _span(batch, ba, sizes, coord),
                 _span(n_kv, ha, sizes, coord))


def every_shard(mesh_shape: Tuple[int, int], batch: int, n_kv: int):
    """-> ``[(coords, Shard)]`` for every rank of a ``(data, model)`` mesh
    (no process group)."""
    from repro_torch.distributed.mesh import ServingMesh

    mesh = ServingMesh.local(mesh_shape)
    return [((d, m), shard_of(mesh, (d, m), batch, n_kv))
            for d in range(mesh_shape[0]) for m in range(mesh_shape[1])]


# ---------------------------------------------------------------------------
# the layout and the stores of a shard
# ---------------------------------------------------------------------------


def shard_layout(la: LayoutArrays, heads: Tuple[int, int]) -> LayoutArrays:
    """The layout of kv heads ``[h0, h1)`` of ``la`` (one layer, or an
    ``[L, ...]`` stack): their per-head descriptors; their rows only, so
    ``row_offsets`` and ``scatter_rows`` are rebased to the first head's
    row (pads stay 0) and ``tile_head`` counts from ``h0``, padded over
    layers with 0 as :func:`~repro_torch.core.stacked.stack_layouts` pads;
    ``total_rows`` the most rows a layer's heads take; every other static
    bound (``max_blocks``, ``max_top_k``, ``selected_pages``, ...) the
    whole layout's.  The whole layout itself for all its heads."""
    h0, h1 = heads
    if (h0, h1) == (0, la.n_heads):
        return la
    stacked = la.row_offsets.ndim == 2
    hosts = la.host_layouts
    tr = la.tile_rows
    base = [lay.offsets[h0] for lay in hosts]
    n_rows = [lay.offsets[h1] - lay.offsets[h0] for lay in hosts]
    n_tiles = max(n_rows) // tr
    tiles = np.zeros((len(hosts), n_tiles), np.int32)
    for i, (lay, b, n) in enumerate(zip(hosts, base, n_rows)):
        tiles[i, :n // tr] = lay.tile_head[b // tr:(b + n) // tr] - h0
    dev = la.row_offsets.device
    base_t = torch.tensor(base, dtype=torch.int32, device=dev)
    if not stacked:
        tiles, base_t = tiles[0], base_t[0]
    heads1 = lambda t: t[..., h0:h1]
    heads2 = lambda t: t[..., h0:h1, :]
    scat = heads2(la.scatter_rows)
    mask = heads2(la.pad_mask)
    rebase = base_t[:, None, None] if stacked else base_t
    local = tuple(
        RaggedLayout(lay.block_sizes[h0:h1], lay.context_len, lay.page_size,
                     lay.token_budget, lay.tile_rows)
        for lay in hosts)
    return dataclasses.replace(
        la,
        scatter_rows=torch.where(mask, scat - rebase, 0).to(torch.int32).contiguous(),
        pad_mask=mask.contiguous(),
        block_starts=heads2(la.block_starts).contiguous(),
        block_sizes=heads1(la.block_sizes).contiguous(),
        slot_map=heads2(la.slot_map).contiguous(),
        within_map=heads2(la.within_map).contiguous(),
        pages_per_block=heads1(la.pages_per_block).contiguous(),
        tile_head=torch.as_tensor(tiles, dtype=torch.int32, device=dev),
        row_offsets=(heads1(la.row_offsets)
                     - (base_t[:, None] if stacked else base_t)).contiguous(),
        n_blocks=heads1(la.n_blocks).contiguous(),
        top_k=heads1(la.top_k).contiguous(),
        total_rows=n_tiles * tr,
        host_layouts=local,
    )


def row_span(la: LayoutArrays, heads: Tuple[int, int]) -> Tuple[int, int]:
    """``[start, stop)`` of heads ``[h0, h1)``'s rows in a one-layer
    layout's flat store."""
    lay = la.host
    return lay.offsets[heads[0]], lay.offsets[heads[1]]


def shard_store(store, la: LayoutArrays, shard: Shard, head_aligned_params: bool):
    """A one-layer :class:`~repro_torch.backends.CentroidStore` -> this
    shard's: its rows of sequences, its heads' flat rows of ``codes``,
    and of ``scale`` / ``zero`` its heads (the decode store's per-head
    ``[B, n_kv, Dp]``, ``head_aligned_params``) or the same rows (the
    prefill score segment's per-row ``[B, rows, 1]``)."""
    r0, r1 = row_span(la, shard.heads)

    def rows(t):
        return None if t is None else shard.take_rows(t)[:, r0:r1].contiguous()

    def params(t):
        if t is None:
            return None
        if head_aligned_params:
            return shard.take(t).contiguous()
        return rows(t)

    return dataclasses.replace(store, codes=rows(store.codes),
                               scale=params(store.scale), zero=params(store.zero))


# ---------------------------------------------------------------------------
# the whole call's split
# ---------------------------------------------------------------------------


def decode_split(shard: Optional[Shard], p_sel: int, device) -> Optional[int]:
    """Slot runs of the whole decode call (``split_plan`` over its batch and
    kv heads, ``p_sel`` page slots a head) for ``fused_decode`` and
    ``paged_attention``; None without a shard (the kernel plans its own,
    the whole call's) and off the card (the plain versions do not
    split)."""
    if shard is None or torch.device(device).type != "cuda":
        return None
    from repro_torch.kernels.paged_attention import _sm_count, split_plan

    return split_plan(shard.batch, shard.n_kv, p_sel, _sm_count(torch.device(device)))


def prefill_split(shard: Optional[Shard], q: torch.Tensor, block_q: int
                  ) -> Optional[int]:
    """Key-tile runs of the whole sparse prefill call
    (``prefill_split_plan`` over its ``batch * n_kv * nQB`` cells) for a
    shard's queries ``q`` ``[B, Hq, Sq, D]``; None as :func:`decode_split`."""
    if shard is None or q.device.type != "cuda":
        return None
    from repro_torch.kernels.paged_attention import _sm_count
    from repro_torch.kernels.sparse_prefill import prefill_split_plan

    g = q.shape[1] // shard.n_heads
    n_qb = -(-q.shape[2] // block_q)
    return prefill_split_plan(shard.batch * shard.n_kv * n_qb, g * block_q,
                              _sm_count(q.device), q.shape[-1])
