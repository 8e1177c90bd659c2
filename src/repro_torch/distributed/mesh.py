"""The serving mesh of one process (stands in for JAX's ``Mesh``).

JAX serves from one controller that owns every device of a
``(data, model)`` mesh; the port runs one process per device (SPMD over
``torch.distributed``).  A :class:`ServingMesh` holds the axis sizes,
this process's ``(data, model)`` coordinates, the subgroups of its model
axis (the processes that share its batch rows) and of its data axis (those
that share its kv heads), and the three collectives the engine needs:

- :meth:`ServingMesh.all_gather_heads` over ``model``: every rank's slice
  of a kv-head-major head axis, concatenated in rank order, so the
  reductions over heads that follow see the whole axis in the
  single-device order;
- :meth:`ServingMesh.gather_data` over ``data``: the sampled tokens and
  finite masks of every data rank's rows, in rank order;
- :meth:`ServingMesh.broadcast_data` over ``data``: a tensor from the data
  rank that owns a slot (a chunk's first token, a prefix page snapshot).

Rank ``r`` sits at ``divmod(r, model)``: a model group is ``model``
consecutive ranks.  :meth:`ServingMesh.local` builds a mesh with no
process group, for the slicing functions alone (its collectives raise).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

AXES = ("data", "model")


class ServingMesh:
    axis_names = AXES

    def __init__(self, shape: Tuple[int, int], coords: Tuple[int, int],
                 device, groups: Optional[Dict[str, object]] = None):
        self.shape = tuple(int(s) for s in shape)
        self.coords = tuple(int(c) for c in coords)
        if len(self.shape) != 2 or not all(
                0 <= c < s for c, s in zip(self.coords, self.shape)):
            raise ValueError(f"coords {coords} outside the mesh {shape}")
        self.device = torch.device(device)
        #: "data" / "model" -> the process group of that axis through this
        #: rank (absent for an axis of size 1, and for a local mesh)
        self._groups = groups

    @classmethod
    def join(cls, shape: Tuple[int, int], device) -> "ServingMesh":
        """This process's place on a mesh over the initialized process
        group (every process must call it, in the same order: it creates
        each axis's subgroups)."""
        import torch.distributed as dist

        data, model = shape
        rank = dist.get_rank()
        groups = {}
        if model > 1:
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)])
                if d == rank // model:
                    groups["model"] = g
        if data > 1:
            for m in range(model):
                g = dist.new_group([d * model + m for d in range(data)])
                if m == rank % model:
                    groups["data"] = g
        return cls(shape, divmod(rank, model), device, groups)

    @classmethod
    def local(cls, shape: Tuple[int, int], coords: Tuple[int, int] = (0, 0)
              ) -> "ServingMesh":
        """A mesh of sizes and coordinates on the CPU without a process
        group: enough to slice a call into its shards
        (:mod:`.kernel_partition`), not to run collectives."""
        return cls(shape, coords, "cpu", None)

    # -- geometry ---------------------------------------------------------

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(AXES, self.shape))

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def rank(self) -> int:
        return self.coords[0] * self.shape[1] + self.coords[1]

    @property
    def sharded(self) -> bool:
        """Whether any axis has more than one rank."""
        return self.size > 1

    def __repr__(self) -> str:
        return (f"ServingMesh(data={self.shape[0]}, model={self.shape[1]}, "
                f"coords={self.coords}, device={self.device})")

    # -- collectives ------------------------------------------------------

    def _group(self, axis: Optional[str]):
        """The process group of ``axis`` (None: the whole world)."""
        if self._groups is None:
            raise RuntimeError(f"{self!r} has no process group: a local mesh "
                               "slices calls, it runs no collective")
        return None if axis is None else self._groups[axis]

    def all_gather_heads(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This model rank's slice of a head axis -> the whole axis
        (every model rank's slice, in rank order, along ``dim``)."""
        n = self.shape[1]
        if n == 1:
            return x
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._group("model"))
        return torch.cat(parts, dim=dim)

    def gather_data(self, x: torch.Tensor) -> torch.Tensor:
        """This data rank's rows ``[n, ...]`` -> every data rank's, in rank
        order, along dim 0."""
        n = self.shape[0]
        if n == 1:
            return x
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._group("data"))
        return torch.cat(parts, dim=0)

    def broadcast_world(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank, in place; -> ``x``."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        dist.broadcast(x, src=0, group=self._group(None))
        return x

    def broadcast_data(self, x: torch.Tensor, src_data_rank: int) -> torch.Tensor:
        """``x`` of data rank ``src_data_rank`` (this model rank's column)
        on every data rank, in place; -> ``x``."""
        if self.shape[0] == 1:
            return x
        import torch.distributed as dist

        src = src_data_rank * self.shape[1] + self.coords[1]
        dist.broadcast(x, src=src, group=self._group("data"))
        return x
