"""Serving mesh construction (counterpart of ``repro.launch.mesh``).

The shape is derived from the world size of the process group, not
hardcoded: the largest ``model`` axis that divides it (capped by
``model_cap``, typically the model's kv-head count, so that tensor
parallelism never degrades to replication), with ``data`` taking the rest.
Where JAX counts the devices of one controller, the port counts the
processes of ``torch.distributed``, one per device.

:func:`make_serving_mesh` joins (or starts) the process group and returns
a :class:`~repro_torch.distributed.mesh.ServingMesh`: NCCL on the card,
gloo when the caller asks for the CPU.  It never falls back from one to
the other.  Nothing here touches ``torch.distributed`` at import.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.distributed.mesh import ServingMesh


def derive_mesh_shape(
    n_devices: Optional[int] = None,
    *,
    model_cap: Optional[int] = None,
    multi_pod: bool = False,
) -> Tuple[int, ...]:
    """Largest ``model`` axis dividing the device count (capped by
    ``model_cap``), ``data`` = the rest; ``multi_pod`` splits a leading pod
    axis of 2 when the count allows it.  ``n_devices`` defaults to the
    world size of the initialized process group (1 without one)."""
    n = _world_size() if n_devices is None else n_devices
    assert n >= 1
    pod = 1
    if multi_pod and n % 2 == 0:
        pod = 2
        n //= pod
    cap = n if model_cap is None else max(1, min(model_cap, n))
    model = max(d for d in range(1, cap + 1) if n % d == 0)
    data = n // model
    return (pod, data, model) if multi_pod else (data, model)


def parse_mesh_arg(arg: str) -> Tuple[int, int]:
    """``--mesh data,model`` flag value -> ``(data, model)`` shape."""
    parts = [p.strip() for p in arg.split(",")]
    if len(parts) != 2:
        raise ValueError(f"--mesh expects 'data,model' (e.g. '4,2'), got {arg!r}")
    return int(parts[0]), int(parts[1])


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_serving_mesh(
    shape: Optional[Sequence[int]] = None,
    *,
    n_kv_heads: Optional[int] = None,
    device="cuda",
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> ServingMesh:
    """``(data, model)`` mesh of the processes of one serving job.

    The process group is initialized here unless it already is: from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) or from ``init_method`` (a
    ``file://`` or ``tcp://`` URL) with ``rank`` and ``world_size``.  A
    process with neither is a world of one (``tcp://localhost`` on a free
    port).  The backend is NCCL for ``device="cuda"`` (each process takes
    the card ``LOCAL_RANK``), gloo for ``"cpu"``.

    ``shape=None`` derives the shape from the world size with the
    ``model`` axis capped by ``n_kv_heads``; a world of one yields the
    degenerate ``(1, 1)`` mesh, on which the engine takes the
    single-device path.  Raises when the shape's product is not the world
    size, and when CUDA is asked for and absent (no fallback to the CPU).
    """
    import torch.distributed as dist

    dev = torch.device(device)
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(dev.type)
    if backend is None:
        raise ValueError(f"serving mesh on {dev.type!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' for a gloo mesh of "
                "CPU processes")
        local = int(os.environ.get("LOCAL_RANK", dev.index or 0))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if init_method is None and "MASTER_ADDR" not in os.environ:
            if (world_size or 1) != 1:
                raise ValueError(
                    "a world of several processes needs init_method or "
                    "torchrun's environment")
            init_method, rank, world_size = f"tcp://localhost:{_free_port()}", 0, 1
        kw = {} if init_method is None else dict(
            init_method=init_method, rank=rank, world_size=world_size)
        dist.init_process_group(backend, **kw)
    elif dist.get_backend() != backend:
        raise RuntimeError(
            f"the process group runs {dist.get_backend()}, the mesh on "
            f"{dev.type} needs {backend}")
    world = dist.get_world_size()
    if shape is None:
        shape = derive_mesh_shape(world, model_cap=n_kv_heads)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2:
        raise ValueError(f"serving mesh is (data, model), got {shape}")
    if shape[0] * shape[1] != world:
        raise ValueError(
            f"mesh {shape[0]},{shape[1]} needs {shape[0] * shape[1]} processes; "
            f"the world size is {world}")
    return ServingMesh.join(shape, dev)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
