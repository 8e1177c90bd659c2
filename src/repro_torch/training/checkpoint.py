"""Atomic checkpoints of a training state (counterpart of
``repro.training.checkpoint``).

Layout, JAX's:  <dir>/step_<N>/
                  manifest.json   {step, keys: [{key, kind, dtype, shape}]}
                  arrays.npz      flat leaf arrays keyed by path

Writes go to ``step_<N>.tmp``, then ``os.rename``: a crash mid-write never
corrupts the latest checkpoint (a restart resumes from the one before).
A state is nested dicts and :class:`~repro_torch.training.optimizer.
OptState` tuples over tensors, Nones and Python ints; keys are the paths
joined by "/" (``params/layers.0.wq``, ``opt/m/embed``, ``opt/step``).
bf16 tensors travel bit-exactly as their uint16 bits
(:func:`repro_torch.convert.to_numpy`).  Restore copies into the tensors
of a like-shaped state, in place, after checking every shape and dtype.
Retention keeps the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import to_numpy, to_torch


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """A state -> its (key, leaf) pairs in order (the module docstring's
    keys)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return [kv for k, sub in tree.items()
                for kv in flatten(sub, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _unflatten_like(like, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(**{k: _unflatten_like(sub, leaves, f"{prefix}{k}/")
                             for k, sub in like._asdict().items()})
    if isinstance(like, dict):
        return {k: _unflatten_like(sub, leaves, f"{prefix}{k}/")
                for k, sub in like.items()}
    return leaves[prefix[:-1]]


def _dirs(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n.split("_")[1]) for n in os.listdir(directory)
                  if n.startswith("step_") and not n.endswith(".tmp"))


def save_checkpoint(directory: str, step: int, state: Dict[str, Any]) -> str:
    """Atomically write ``state`` -> the checkpoint's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {}
    meta = {"step": step, "keys": []}
    for key, leaf in flatten(state):
        if leaf is None:
            meta["keys"].append({"key": key, "kind": "none"})
        elif isinstance(leaf, torch.Tensor):
            arrays[key] = to_numpy(leaf)
            meta["keys"].append({"key": key, "kind": "tensor",
                                 "dtype": str(leaf.dtype).removeprefix("torch."),
                                 "shape": list(leaf.shape)})
        else:
            meta["keys"].append({"key": key, "kind": "int", "value": int(leaf)})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    steps = _dirs(directory)
    return steps[-1] if steps else None


@torch.no_grad()
def restore_checkpoint(directory: str, like: Dict[str, Any], step: Optional[int] = None
                       ) -> Tuple[Optional[int], Optional[Dict[str, Any]]]:
    """Restore into the tensors of ``like`` (shapes and dtypes checked) ->
    (step, the state: ``like``'s structure with its tensors overwritten and
    its ints replaced), or (None, None) when no checkpoint exists."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None, None
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        meta = {e["key"]: e for e in json.load(f)["keys"]}
    leaves = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in flatten(like):
            entry = meta[key]
            kind = ("none" if leaf is None else
                    "tensor" if isinstance(leaf, torch.Tensor) else "int")
            if entry["kind"] != kind:
                raise ValueError(f"checkpoint {path}: {key} is {entry['kind']}, "
                                 f"the state's {kind}")
            if kind != "tensor":
                leaves[key] = entry.get("value")
                continue
            want = (list(leaf.shape), str(leaf.dtype).removeprefix("torch."))
            if [entry["shape"], entry["dtype"]] != list(want):
                raise ValueError(f"checkpoint {path}: {key} is {entry['shape']} "
                                 f"{entry['dtype']}, the state's {want}")
            arr = data[key]
            t = to_torch(arr.view(np.int16) if entry["dtype"] == "bfloat16" else arr,
                         leaf.device)
            leaf.copy_(t.view(torch.bfloat16) if entry["dtype"] == "bfloat16" else t)
            leaves[key] = leaf
    return step, _unflatten_like(like, leaves)


def prune_checkpoints(directory: str, keep: int):
    for s in _dirs(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
