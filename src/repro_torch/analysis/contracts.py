"""Contract verifier on fake tensors: ``python -m repro_torch.analysis.contracts``
(counterpart of ``repro.analysis.contracts``).

Every (config, backend) cell builds the model and its cache and runs
``decode_step`` and ``prefill_chunk`` under ``FakeTensorMode``: no weight,
no allocation, no launch.  The ``"cuda"`` and ``"dense"`` backends reach
the kernel wrappers, whose abstract rules (``repro_torch.kernels._build``)
check the kernels' argument contracts (dtypes, shapes, head_dim, group,
bits, contiguity) and return outputs of the kernels' shapes, as
``pallas_call`` checks its shapes at trace time.  Each cell runs two sparse
settings on one model: the config's own (staged decode, dense chunks) and
the port's main path (fused decode, sparse prefill).  The checks, named as
in JAX:

- ``plan_hygiene``: the plan's layout descriptors are host numpy integers
  and Python ints (a plan is cached and shared by every device and mode);
- ``cache_agreement``: each layer's ``cache["la"]`` equals
  ``plan.stacked(device).layer(l)`` in shapes and dtypes, ``seq_len`` is
  ``int32[B]``;
- ``step_stability``: ``decode_step`` returns ``[B, vocab]`` logits; both
  steps keep the cache's entries, shapes and dtypes, and every cache
  tensor they return is the very tensor they were given (what
  ``serving.graphs.DecodeGraph`` requires of a captured step); on the
  kernel backends no wrapper ran its plain version or launched;
- ``host_sync``: a data-dependent host read inside a step (``.item()``, a
  ``nonzero``), with its call site;
- ``sharding_coverage``: every cache entry passes
  :func:`repro_torch.distributed.params.cache_entry_covered`;
- ``cross_backend_agreement``: every backend gives the same output specs.

The grid is JAX's: ``("llama3.2-3b", "qwen3-8b")`` smoke variants with
``SparseConfig(enabled=True)`` on ``("dense", "reference", "cuda")``, at
the smallest widths the kernels take (head_dim 64) and the card's dtype
(bfloat16), where JAX's smoke variant has head_dim 16 in float32: the
abstract rules refuse those, as the kernels would.

The fake tensors lie on ``--device`` (``cuda`` by default).  A PyTorch
built without CUDA cannot index a fake CUDA tensor (Python indexing takes
a CUDA device guard), so there the cells run on fake ``meta`` tensors,
which the abstract rules and every device check treat alike; the report
names the device used (``fake_device``).  The command exits 1 on any
failure and writes JSON only to ``--output``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_CONFIGS = ("llama3.2-3b", "qwen3-8b")
DEFAULT_BACKENDS = ("dense", "reference", "cuda")
#: the port's main path, checked on every cell beside the config's own
#: sparse settings
VARIANTS = {"default": {}, "main_path": {"fused_decode": True, "sparse_prefill": True}}
#: the smoke variant's widths raised to what the kernels take
KERNEL_HEAD_DIM = 64
KERNEL_DTYPE = "bfloat16"


class ContractFailure(Exception):
    pass


class HostSync(ContractFailure):
    pass


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ContractFailure(message)


def fake_device(device: str) -> torch.device:
    """The device the fake tensors lie on: ``device``, or ``meta`` for CUDA
    on a PyTorch built without it (module docstring)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        return torch.device("meta")
    return dev


def fake_mode(dev: torch.device):
    from torch._subclasses.fake_tensor import FakeTensorMode

    # on meta, tensors made from Python data come out real (meta is
    # dataless, so converting them hides nothing)
    return FakeTensorMode(allow_non_fake_inputs=dev.type == "meta")


def contract_config(name: str, backend: str):
    from repro_torch.configs import get_config, smoke_variant

    cfg = smoke_variant(get_config(name))
    return dataclasses.replace(
        cfg, head_dim=KERNEL_HEAD_DIM, dtype=KERNEL_DTYPE,
        sparse=dataclasses.replace(cfg.sparse, enabled=True, backend=backend))


# ------------------------------------------------------------ the cache

def _flatten(x, path: str = ""):
    """(path, value) for every tensor and host value of a cache."""
    from repro_torch.core.stacked import LayoutArrays

    if torch.is_tensor(x):
        yield path, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _flatten(v, f"{path}.{k}" if path else str(k))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _flatten(v, f"{path}.{i}")
    elif isinstance(x, LayoutArrays):
        for f in dataclasses.fields(x):
            yield from _flatten(getattr(x, f.name), f"{path}.{f.name}")
    else:
        yield path, x


def _spec(v):
    if torch.is_tensor(v):
        return (tuple(v.shape), str(v.dtype), v.device.type)
    if v is None or isinstance(v, (bool, int, float, str)):
        return ("host", v)
    return ("host", type(v).__name__)


def entry_specs(cache) -> List[Tuple[str, tuple]]:
    return [(p, _spec(v)) for p, v in _flatten(cache)]


def cache_entries(cache):
    """(name, value) of every cache entry: the top-level keys but
    ``layers``, and each layer's entries by their own names."""
    for name, v in cache.items():
        if name == "layers":
            for e in v:
                yield from e.items()
        else:
            yield name, v


def fake_like(x, device=None):
    """``x`` with every tensor (in tuples, lists, dicts and dataclasses such
    as ``LayoutArrays`` and ``CentroidStore``) replaced by an empty tensor
    of its shape, strides and dtype on ``device`` (its own by default);
    under a ``FakeTensorMode`` these are fake copies."""
    if torch.is_tensor(x):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device=x.device if device is None else device)
    if isinstance(x, (tuple, list)):
        return type(x)(fake_like(v, device) for v in x)
    if isinstance(x, dict):
        return {k: fake_like(v, device) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        changes = {f.name: fake_like(getattr(x, f.name), device)
                   for f in dataclasses.fields(x) if torch.is_tensor(getattr(x, f.name))}
        return dataclasses.replace(x, **changes) if changes else x
    return x


def output_specs(out) -> list:
    """[(shape, dtype, device type)] of a call's output tensors, in order."""
    return [_spec(v) for _, v in _flatten(out)]


def abstract_call(fn, *args, device=None, **kwargs):
    """``fn`` on fake copies of its arguments (on ``device`` when given)
    under a fresh ``FakeTensorMode`` -> its outputs' specs: a kernel
    wrapper's abstract rule, without a card."""
    dev = torch.device(device) if device is not None else None
    with fake_mode(dev or torch.device("cpu")):
        out = fn(*fake_like(args, dev), **fake_like(kwargs, dev))
    return output_specs(out)


# ------------------------------------------------------------ the checks

def _check_host_int(name: str, arr) -> None:
    _require(isinstance(arr, np.ndarray) and not torch.is_tensor(arr),
             f"{name} must be host numpy at plan time, got {type(arr).__name__} "
             "(a tensor here rides the cached plan onto every device and "
             "into every fake mode)")
    _require(arr.dtype.kind in "iub",
             f"{name} must be an integer/bool descriptor, got dtype {arr.dtype}")


def _check_host_ints(name: str, values) -> None:
    _require(isinstance(values, tuple) and all(
        isinstance(v, (int, np.integer)) and not torch.is_tensor(v) for v in values),
        f"{name} must be a tuple of host ints, got {type(values).__name__}")


def check_plan_hygiene(model, context_len: int) -> None:
    """The plan's descriptors are host numpy integers and Python ints."""
    plan = model.attention_plan(context_len)
    for f in dataclasses.fields(plan):
        _require(not torch.is_tensor(getattr(plan, f.name)),
                 f"plan.{f.name} is a tensor")
    for li, lay in enumerate(plan.layouts):
        for attr in ("scatter_rows", "pad_mask", "block_starts", "slot_map",
                     "within_map", "tile_head"):
            _check_host_int(f"layout[{li}].{attr}", getattr(lay, attr))
        for attr in ("block_sizes", "n_blocks", "top_k", "pages_per_block",
                     "offsets", "padded_n_blocks"):
            _check_host_ints(f"layout[{li}].{attr}", getattr(lay, attr))


def check_cache_agreement(model, cache, batch: int, context_len: int) -> None:
    """Each layer's ``la`` matches ``plan.stacked(device).layer(l)``;
    ``seq_len`` is int32[batch]."""
    sl = cache["seq_len"]
    _require(tuple(sl.shape) == (batch,) and sl.dtype == torch.int32,
             f"cache seq_len must be int32[{batch}], got {sl.dtype}"
             f"[{tuple(sl.shape)}]")
    plan = model.attention_plan(context_len)
    if not plan.active:
        _require(all(la is None for la in cache["la"]),
                 "an inactive plan's cache holds layouts")
        return
    stk = plan.stacked(model.device)
    _require(len(cache["la"]) == plan.n_layers,
             f"cache holds {len(cache['la'])} layouts for {plan.n_layers} layers")
    for l, la in enumerate(cache["la"]):
        want = entry_specs(stk.layer(l))
        got = entry_specs(la)
        _require(got == want,
                 f"la[{l}] differs from plan.stacked(device).layer({l}): "
                 f"{[a for a, b in zip(got, want) if a != b][:3]}")


def _site(exc: BaseException) -> str:
    """The innermost frame of an exception's traceback outside torch and
    this module: the step code that raised."""
    skip = (str(Path(torch.__file__).parent), __file__)
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith(skip)]
    if not frames:
        return "?"
    f = frames[-1]
    return f"{Path(f.filename).name}:{f.lineno} ({f.name})"


def _step(name: str, fn):
    from torch._subclasses.fake_tensor import (
        DataDependentOutputException,
        DynamicOutputShapeException,
    )

    try:
        return fn()
    except (DataDependentOutputException, DynamicOutputShapeException) as e:
        raise HostSync(f"{name} reads device data on the host at {_site(e)}: "
                       f"{type(e).__name__}: {e}") from e


def _stable(step: str, before, after, given: Dict[str, torch.Tensor], cache):
    _require(len(before) == len(after),
             f"{step} changed the cache's entry count {len(before)} -> "
             f"{len(after)} (a captured step holds every tensor)")
    for (pi, si), (po, so) in zip(before, after):
        _require(pi == po and si == so,
                 f"{step} cache drift at {pi!r}: {si} -> ({po!r}, {so})")
    for path, t in _flatten(cache):
        if torch.is_tensor(t):
            _require(t is given[path],
                     f"{step} replaced cache tensor {path!r}: a captured "
                     "decode graph would read the old one")


def check_step_stability(model, cache, batch: int):
    """Both steps keep the cache's entries, specs and tensor objects, and
    decode emits ``[batch, vocab]`` logits -> the output specs, for the
    cross-backend comparison."""
    dev = model.device
    before = entry_specs(cache)
    given = {p: t for p, t in _flatten(cache) if torch.is_tensor(t)}
    tokens = torch.zeros((batch,), dtype=torch.int64, device=dev)
    logits, out = _step("decode_step", lambda: model.decode_step(cache, tokens))
    _require(tuple(logits.shape) == (batch, model.cfg.vocab_size),
             f"decode logits {tuple(logits.shape)} != ({batch}, "
             f"{model.cfg.vocab_size})")
    _require(out is cache, "decode_step returned another cache")
    after = entry_specs(out)
    _stable("decode_step", before, after, given, out)

    sp = model.cfg.sparse
    chunk = max(sp.prefill_block_q, sp.page_size)
    ctoks = torch.zeros((chunk,), dtype=torch.int64, device=dev)
    plog, out = _step("prefill_chunk",
                      lambda: model.prefill_chunk(cache, 0, ctoks, 0, chunk))
    _require(tuple(plog.shape) == (model.cfg.vocab_size,),
             f"prefill logits {tuple(plog.shape)} != ({model.cfg.vocab_size},)")
    _require(out is cache, "prefill_chunk returned another cache")
    _stable("prefill_chunk", before, entry_specs(out), given, out)
    return (_spec(logits), _spec(plog), after)


def check_sharding_coverage(cache) -> None:
    """Every cache entry is held by the cache axes or planted on purpose."""
    from repro_torch.distributed.params import cache_entry_covered

    for name, v in cache_entries(cache):
        ndim = v.ndim if torch.is_tensor(v) else 0
        _require(cache_entry_covered(name, ndim),
                 f"cache entry {name!r} ({_spec(v)}) is not covered by "
                 "repro_torch.distributed.params.CACHE_AXES and would "
                 "silently replicate across the model axis — add its axes "
                 "(or name a planted entry with its reason)")


def _kernel_calls():
    from repro_torch import kernels

    return {k: (v["launches"], v["plain_calls"]) for k, v in kernels.counts().items()}


def verify_cell(config_name: str, backend: str, batch: int, context_len: int,
                device: str = "cuda"):
    """All checks of one (config, backend) cell -> (failures, output specs
    by variant or None)."""
    from repro_torch.backends.base import CudaBackend
    from repro_torch.models import Transformer

    failures: List[dict] = []
    dev = fake_device(device)

    def run(check, fn, variant=None):
        try:
            return fn()
        except HostSync as e:
            check, msg = "host_sync", str(e)
        except ContractFailure as e:
            msg = str(e)
        except Exception as e:  # the fake run itself failed
            msg = f"{type(e).__name__}: {e} (at {_site(e)})"
        failures.append({"check": check, "config": config_name,
                         "backend": backend, "variant": variant, "message": msg})
        return None

    cfg = contract_config(config_name, backend)
    specs = {}
    with fake_mode(dev):
        model = run("abstract_init", lambda: Transformer(cfg, device=dev))
        if model is None:
            return failures, None
        run("plan_hygiene", lambda: check_plan_hygiene(model, context_len))
        for variant, overrides in VARIANTS.items():
            view = model.with_sparse(**overrides) if overrides else model
            cache = run("abstract_cache",
                        lambda: view.init_cache(batch, context_len), variant)
            if cache is None:
                continue
            run("cache_agreement",
                lambda: check_cache_agreement(view, cache, batch, context_len),
                variant)
            run("sharding_coverage", lambda: check_sharding_coverage(cache), variant)
            calls = _kernel_calls()
            specs[variant] = run(
                "step_stability", lambda: check_step_stability(view, cache, batch),
                variant)
            moved = {k: (v[0] - calls[k][0], v[1] - calls[k][1])
                     for k, v in _kernel_calls().items() if v != calls[k]}
            if (isinstance(view.backend, CudaBackend)
                    and not getattr(view.backend, "plain", False)):
                run("step_stability", lambda: _require(
                    not moved, "kernel wrappers launched or ran their plain "
                    f"versions on fake tensors (launches, plain calls): {moved}"),
                    variant)
    return failures, (specs if all(s is not None for s in specs.values()) else None)


def run_contracts(configs: Sequence[str] = DEFAULT_CONFIGS,
                  backends: Sequence[str] = DEFAULT_BACKENDS,
                  batch: int = 2, context_len: int = 512,
                  device: str = "cuda") -> dict:
    """The grid -> report dict (JAX's keys, plus the devices)."""
    failures: List[dict] = []
    cells = 0
    for config_name in configs:
        specs_by_backend: Dict[str, object] = {}
        for backend in backends:
            cells += 1
            cell_failures, specs = verify_cell(config_name, backend, batch,
                                               context_len, device)
            failures.extend(cell_failures)
            if specs is not None:
                specs_by_backend[backend] = specs
        if len(specs_by_backend) > 1:
            items = sorted(specs_by_backend.items())
            ref_name, ref = items[0]
            for name, specs in items[1:]:
                if specs != ref:
                    failures.append({
                        "check": "cross_backend_agreement", "config": config_name,
                        "backend": name, "variant": None,
                        "message": (f"output specs differ from backend "
                                    f"{ref_name!r} on {config_name!r} — parity "
                                    "oracles compare these outputs elementwise"),
                    })
    return {
        "tool": "repro_torch.analysis.contracts",
        "configs": list(configs),
        "backends": list(backends),
        "configs_covered": len(configs),
        "backends_covered": len(backends),
        "cells": cells,
        "batch": batch,
        "context_len": context_len,
        "device": device,
        "fake_device": str(fake_device(device)),
        "n_failures": len(failures),
        "failures": failures,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.contracts",
        description="Contract verifier on fake tensors over backends x configs.",
    )
    parser.add_argument("--configs", nargs="+", default=list(DEFAULT_CONFIGS))
    parser.add_argument("--backends", nargs="+", default=list(DEFAULT_BACKENDS))
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--context-len", type=int, default=512)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--output", default=None, help="write the JSON report here")
    args = parser.parse_args(argv)
    report = run_contracts(configs=args.configs, backends=args.backends,
                           batch=args.batch, context_len=args.context_len,
                           device=args.device)
    for f in report["failures"]:
        where = f" ({f['variant']})" if f["variant"] else ""
        print(f"FAIL [{f['config']} x {f['backend']}{where}] {f['check']}: "
              f"{f['message']}")
    print(f"contracts: {report['cells']} cells ({report['backends_covered']} "
          f"backends x {report['configs_covered']} configs) on fake "
          f"{report['fake_device']} tensors, {report['n_failures']} failure(s)")
    if args.output:
        Path(args.output).write_text(json.dumps(report, indent=2) + "\n")
    return 1 if report["n_failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
