"""One process of a CPU serving mesh (gloo), for ``test_torch_mesh_serving``.

    python tests/_mesh_worker.py ARGS.json RANK

``ARGS.json`` names the mesh shape, the arch (its smoke variant), the gloo store (a ``file://`` path),
the weights (an ``.npz`` of the port's parameters, bfloat16 as raw uint16
bits, written by :func:`save_weights`), the serving and sparse settings
and an output directory.  The process joins the mesh, serves the oracle
traffic of :func:`traffic` on its engine and writes ``rank{RANK}.npz``:
every request's tokens, the engine's prefix hits and preemptions, the
shape of its first layer's ``k`` / ``v`` entries, per decode step the
logits of the rows it holds, their slots and the slots then decoding, and
every strided tensor the kernel wrappers were handed (the card's wrappers
refuse one; on the CPU they run their plain versions, which take any).

:func:`serve` is the same run in one process without a mesh (the parent's
reference).  Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

#: the oracle traffic of the JAX package's mesh serving test: 4 requests
#: sharing a 64-token prefix, 64 tokens of their own, 12 new tokens each
N_REQUESTS, PREFIX, BODY, NEW_TOKENS = 4, 64, 64, 12


def traffic(vocab: int):
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, PREFIX).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, BODY).astype(np.int32)])
            for _ in range(N_REQUESTS)]


def prefix_embeddings(cfg):
    """Per request, a ``"vlm"`` / ``"audio"`` model's front-end embeddings
    ``[n_prefix_embeddings, d]`` (numpy seed 1); None for any other."""
    if cfg.family not in ("vlm", "audio"):
        return [None] * N_REQUESTS
    rng = np.random.default_rng(1)
    return [rng.standard_normal((cfg.n_prefix_embeddings, cfg.d_model)).astype(np.float32)
            for _ in range(N_REQUESTS)]


def config(sparse: dict, arch: str = "llama3.2-3b"):
    from repro_torch.configs import get_config, smoke_variant

    cfg = smoke_variant(get_config(arch))
    return dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse, **sparse))


def save_weights(model, path):
    """The port model's parameters -> ``path`` (.npz)."""
    from repro_torch.convert import to_numpy

    np.savez(path, **{name: to_numpy(p) for name, p in model.named_parameters()})


def load_weights(cfg, path):
    from repro_torch.convert import to_torch
    from repro_torch.models import Transformer

    model = Transformer(cfg, device="cpu")
    arrays = np.load(path)
    with torch.no_grad():
        for name, p in model.named_parameters():
            a = arrays[name]
            t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                 if p.dtype == torch.bfloat16 else to_torch(a))
            p.copy_(t)
    return model


def watch_strides():
    """-> the set that every call of the fused decode's, the sparse
    prefill's or the paged attention's plain version adds the name of a
    strided tensor argument to (the card's wrappers get the same tensors)."""
    from repro_torch.kernels import fused_decode, paged_attention, sparse_prefill

    strided = set()
    for mod, name in ((fused_decode, "fused_decode_plain"),
                      (sparse_prefill, "sparse_prefill_plain"),
                      (paged_attention, "paged_attention_plain")):
        fn = getattr(mod, name)

        def watched(*a, _fn=fn, _name=name, **k):
            strided.update(f"{_name} argument {i}" for i, t in enumerate(a)
                           if isinstance(t, torch.Tensor) and not t.is_contiguous())
            return _fn(*a, **k)

        setattr(mod, name, watched)
    return strided


def record_steps(eng):
    """Record every decode step's logits on ``eng`` -> the list of
    ``(logits, slots held, slots decoding)`` it fills."""
    steps = []
    view = eng._rung_models[0]
    step = view.decode_step

    def recorded(cache, tokens):
        logits, cache = step(cache, tokens)
        decoding = [i for i, s in enumerate(eng.slots)
                    if s is not None and s.state == "decode"]
        steps.append((logits.clone(), (eng._r0, eng._r1), decoding))
        return logits, cache

    view.decode_step = recorded
    return steps


def serve(model, cfg, serve_kw: dict, mesh=None):
    """-> (engine, {req_id: tokens}, recorded steps)."""
    from repro_torch.config import ServeConfig
    from repro_torch.serving import Engine, Request

    eng = Engine(cfg, model, ServeConfig(**serve_kw), seed=0, device="cpu",
                 mesh=mesh)
    steps = record_steps(eng)
    for rid, (prompt, emb) in enumerate(zip(traffic(cfg.vocab_size),
                                            prefix_embeddings(cfg))):
        eng.submit(Request(rid, prompt, max_new_tokens=NEW_TOKENS, prefix_emb=emb))
    done = eng.run_until_done(max_ticks=600)
    pins = eng.prefix_cache.pages() if eng.prefix_cache is not None else set()
    assert eng.pool.assert_consistent(known_pins=pins) == []
    return eng, {r.req_id: list(r.output) for r in done}, steps


def main(args_path: str, rank: int):
    args = json.loads(Path(args_path).read_text())
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_serving_mesh

    shape = tuple(args["shape"])
    cfg = config(args["sparse"], args["arch"])
    mesh = make_serving_mesh(shape, n_kv_heads=cfg.n_kv_heads, device="cpu",
                             init_method=args["init_method"], rank=rank,
                             world_size=shape[0] * shape[1])
    model = load_weights(cfg, args["weights"])
    strided = watch_strides()
    eng, out, steps = serve(model, cfg, args["serve"], mesh)
    k = eng.cache["layers"][0]["k"]
    np.savez(
        Path(args["out"]) / f"rank{rank}.npz",
        result=json.dumps({
            "coords": list(mesh.coords), "outputs": out,
            "prefix_hits": eng.metrics.prefix_hit_tokens,
            "preemptions": eng.metrics.preemptions,
            "k_shape": list(k.shape), "v_shape": list(eng.cache["layers"][0]["v"].shape),
            "rows": [[r0, r1] for _, (r0, r1), _ in steps[:1]][0],
            "decoding": [d for _, _, d in steps],
            "strided": sorted(strided),
        }),
        logits=np.stack([lg.numpy() for lg, _, _ in steps]),
    )
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main(sys.argv[1], int(sys.argv[2]))
