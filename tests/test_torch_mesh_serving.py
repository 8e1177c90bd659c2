"""The port's mesh serving engine on the CPU: ``Engine(mesh=...)`` over
gloo processes held to the port's single-device engine and to JAX's.

The traffic is JAX's mesh oracle's (``tests/test_distributed.py``): the
smoke llama3.2-3b (2 kv heads), sparse prefill and the fused decode, 4
requests sharing a 64-token prefix, 12 new tokens each, a pool of 17 pages
(prefix hits and a preemption), chunks of 64.  The parent draws JAX's
weights, carries them into the port (``repro_torch.convert``) and writes
them once to an ``.npz``; each mesh is one process per rank running
``tests/_mesh_worker.py`` (no JAX), joined by a ``file://`` store.

- (1, 2): kv heads split, one per rank; every decode step's logits are
  bitwise the single-device engine's (the model axis is held bitwise);
- (2, 2): batch rows split too (2 rows a rank), tokens identical (a
  projection over 2 rows rounds apart from one over 4 on the CPU; the
  largest logit difference is printed);
- (1, 4): 2 kv heads on a model axis of 4 degrade to replicated heads,
  logits bitwise;
- the other paths and configs, each against the port's single-device
  engine: the staged decode with single-shot prefill and seeded sampling
  at (2, 2), the ``"dense"`` backend and granite-moe-3b-a800m at (1, 2),
  the inactive plan and internvl2-2b's prefix-embedding requests at (2,
  1).

Every request's tokens equal the single-device port engine's and JAX's
(its engine wrapped in ``clear_slots_on_install``, ``ROADMAP.md`` §3), and
no kernel wrapper is handed a strided tensor (the card's refuse one).
The features the mesh engine does not serve raise ``NotImplementedError``
naming themselves.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _mesh_worker as worker
from _jax_slot_reset import clear_slots_on_install
from repro.config import ServeConfig as JServe
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.models import Transformer as JTransformer
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch.config import ServeConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.distributed.mesh import ServingMesh
from repro_torch.models import Transformer
from repro_torch.resilience import FaultInjector, default_storm
from repro_torch.serving import Engine

ROOT = Path(__file__).resolve().parents[1]
SPARSE = dict(backend="cuda", sparse_prefill=True, fused_decode=True)
SERVE = dict(max_batch=4, max_context=256, prefill_chunk=64,
             prefill_tokens_per_tick=128, pool_pages=17, temperature=0.0)
#: mesh -> whether its logits must be bitwise the single-device engine's
#: (only the data axis may round apart)
MESHES = {(1, 2): True, (2, 2): False, (1, 4): True}
#: the other paths and ("attn",) configs served on a mesh, each against
#: the port's single-device engine: (arch, mesh, sparse settings, serving
#: settings)
LLAMA = "llama3.2-3b"
VARIANTS = {
    "staged-single-shot-sampled": (LLAMA, (2, 2), dict(SPARSE, fused_decode=False),
                                   dict(SERVE, prefill_chunk=0, temperature=0.6)),
    "dense-backend": (LLAMA, (1, 2), dict(backend="dense", sparse_prefill=False), SERVE),
    "inactive-plan": (LLAMA, (2, 1), dict(SPARSE, enabled=False), SERVE),
    # MoE with its batch whole, kv heads split (2 of 2)
    "granite-moe": ("granite-moe-3b-a800m", (1, 2), SPARSE, SERVE),
    # prefix embeddings: single-shot prefills on the owning data rank
    "internvl2-prefix": ("internvl2-2b", (2, 1), SPARSE, dict(SERVE, pool_pages=None)),
}
WORKER_TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's single-device runs, and every mesh's ranks
    (all meshes' processes started together) -> dict."""
    tmp = tmp_path_factory.mktemp("mesh")
    jb = j_smoke(j_get_config("llama3.2-3b"))
    jcfg = dataclasses.replace(jb, sparse=dataclasses.replace(
        jb.sparse, backend="reference", sparse_prefill=True))
    params = JTransformer(jcfg).init(jax.random.PRNGKey(0))
    cfg = worker.config(SPARSE)
    weights = tmp / "weights.npz"
    worker.save_weights(params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                        device="cpu"), weights)
    procs = {}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    runs = {(None, shape): (LLAMA, weights, SPARSE, SERVE) for shape in MESHES}
    variants = {}
    for name, (arch, shape, sparse, serve) in VARIANTS.items():
        vcfg = worker.config(sparse, arch)
        path = weights
        if arch != LLAMA:
            path = tmp / f"{arch}.npz"
            worker.save_weights(Transformer(vcfg, device="cpu").init(
                torch.Generator().manual_seed(0)), path)
        variants[name] = (vcfg, path, serve)
        runs[name, shape] = (arch, path, sparse, serve)
    for (name, shape), (arch, path, sparse, serve) in runs.items():
        out = tmp / f"{name}-{shape[0]}x{shape[1]}"
        out.mkdir()
        args = out / "args.json"
        args.write_text(json.dumps(dict(
            shape=shape, arch=arch, init_method=f"file://{out / 'store'}",
            weights=str(path), sparse=sparse, serve=serve, out=str(out))))
        procs[name, shape] = (out, [subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_mesh_worker.py"), str(args), str(r)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(shape[0] * shape[1])])

    jeng = clear_slots_on_install(JEngine(jcfg, params, JServe(**SERVE), seed=0))
    for rid, prompt in enumerate(worker.traffic(jcfg.vocab_size)):
        jeng.submit(JRequest(rid, prompt, max_new_tokens=worker.NEW_TOKENS))
    jax_out = {r.req_id: list(r.output) for r in jeng.run_until_done(max_ticks=600)}
    eng, single, steps = worker.serve(worker.load_weights(cfg, weights), cfg, SERVE)
    variants = {name: worker.serve(worker.load_weights(vcfg, path), vcfg, serve)[1]
                for name, (vcfg, path, serve) in variants.items()}

    meshes = {}
    try:
        logs = {key: [p.communicate(timeout=WORKER_TIMEOUT)[0].decode()[-3000:]
                      for p in ps] for key, (_, ps) in procs.items()}
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
    for key, (out, ps) in procs.items():
        assert [p.returncode for p in ps] == [0] * len(ps), logs[key]
        ranks = []
        for r in range(len(ps)):
            z = np.load(out / f"rank{r}.npz")
            res = json.loads(str(z["result"]))
            res["outputs"] = {int(k): v for k, v in res["outputs"].items()}
            res["logits"] = z["logits"]
            ranks.append(res)
        meshes[key] = ranks
    return dict(jax=jax_out, single=single, eng=eng, variants=variants,
                logits=np.stack([lg.numpy() for lg, _, _ in steps]),
                decoding=[d for _, _, d in steps], meshes=meshes)


def test_single_device_oracles(runs):
    """The port's single-device engine serves JAX's oracle traffic as JAX's
    engine does, with prefix hits and a preemption."""
    assert runs["single"] == runs["jax"]
    assert len(runs["single"]) == 4
    assert all(len(o) == worker.NEW_TOKENS for o in runs["single"].values())
    m = runs["eng"].metrics
    assert m.prefix_hit_tokens > 0 and m.preemptions >= 1


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_serving_token_identical(runs, shape):
    data, model = shape
    n_kv = 2
    want_rows = 4 // data
    want_heads = n_kv // model if n_kv % model == 0 else n_kv
    diffs = []
    for res in runs["meshes"][None, shape]:
        assert res["outputs"] == runs["single"] == runs["jax"], res["coords"]
        assert res["prefix_hits"] == runs["eng"].metrics.prefix_hit_tokens > 0
        assert res["preemptions"] == runs["eng"].metrics.preemptions >= 1
        assert res["k_shape"][:2] == res["v_shape"][:2] == [want_rows, want_heads]
        assert res["decoding"] == runs["decoding"]
        assert res["strided"] == [], "a kernel on the card takes no strided input"
        r0, r1 = res["rows"]
        assert (r0, r1) == (res["coords"][0] * want_rows,
                            (res["coords"][0] + 1) * want_rows)
        lg, ref = res["logits"], runs["logits"][:, r0:r1]
        assert lg.shape == ref.shape
        if MESHES[shape]:
            assert np.array_equal(lg, ref), res["coords"]
        diffs.append(float(np.abs(lg - ref).max()))
    print(f"mesh {data}x{model}: largest decode-step logit difference to the "
          f"single-device engine {max(diffs):.3e}")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_mesh_serving_paths_token_identical(runs, name):
    """The staged decode with single-shot prefill and seeded sampling at
    temperature 0.6 at (2, 2); the ``"dense"`` backend and granite-moe-3b-
    a800m's smoke variant at (1, 2); the inactive plan and internvl2-2b's
    smoke variant with 8 prefix embeddings a request at (2, 1): every
    request's tokens as the port's single-device engine serves them, no
    strided kernel input."""
    arch, (data, model), _, _ = VARIANTS[name]
    want = runs["variants"][name]
    assert len(want) == 4 and all(len(o) == worker.NEW_TOKENS for o in want.values())
    for res in runs["meshes"][name, (data, model)]:
        assert res["outputs"] == want, res["coords"]
        assert res["strided"] == []
        assert res["k_shape"][:2] == [4 // data, 2 // model]


def _model(arch="llama3.2-3b", **sparse):
    cfg = smoke_variant(get_config(arch))
    cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse, **sparse))
    return cfg, Transformer(cfg, device="cpu")


REFUSED = {
    "tiered": (dict(hbm_pages=40, host_pages=20), {}, "tiered memory"),
    "faults": ({}, dict(fault_injector=FaultInjector(default_storm(), seed=0)),
               "fault injection"),
    "telemetry": ({}, dict(telemetry=True), "sparsity telemetry"),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_mesh_refuses_unserved_features(what):
    """A mesh that splits anything refuses tiered memory, fault injection
    and sparsity telemetry before any collective (a local mesh of sizes
    and coordinates alone suffices to see it)."""
    serve, kw, name = REFUSED[what]
    cfg, model = _model()
    mesh = ServingMesh.local((1, 2))
    with pytest.raises(NotImplementedError, match=name):
        Engine(cfg, model, ServeConfig(**{**SERVE, "pool_pages": None, **serve}),
               device="cpu", mesh=mesh, **kw)


@pytest.mark.parametrize("arch,shape,name,view_raises", [
    ("recurrentgemma-9b", (1, 2), "recurrent families", True),
    ("rwkv6-3b", (2, 1), "recurrent families", True),
    ("granite-moe-3b-a800m", (2, 1), "MoE over data", False),
])
def test_mesh_refuses_unserved_models(arch, shape, name, view_raises):
    """The recurrent families on any split, an MoE model with its batch
    split over data (its groups and capacity follow the local batch)."""
    cfg, model = _model(arch)
    mesh = ServingMesh.local(shape)
    with pytest.raises(NotImplementedError, match=name):
        Engine(cfg, model, ServeConfig(max_batch=2, max_context=256), device="cpu",
               mesh=mesh)
    if view_raises:
        with pytest.raises(NotImplementedError, match=name):
            model.with_mesh(mesh)


def test_set_fault_injector_refused_on_a_mesh():
    """An injector attached after construction is refused the same way; the
    decode step of a split mesh is not captured."""
    cfg, model = _model()
    eng = Engine(cfg, model, ServeConfig(**SERVE), device="cpu",
                 mesh=ServingMesh.local((1, 2)))
    assert eng._shard.heads == (0, 1) and eng._graphed is False
    with pytest.raises(NotImplementedError, match="fault injection"):
        eng.set_fault_injector(FaultInjector(default_storm(), seed=0))


def test_make_serving_mesh_refuses_what_it_cannot_be(tmp_path):
    """CUDA asked for and absent raises (no fallback to the CPU); a shape
    whose product is not the world size names the world size."""
    from repro_torch.launch.mesh import make_serving_mesh

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_serving_mesh((1, 1))
    code = (
        "import sys; sys.path.insert(0, 'src')\n"
        "from repro_torch.launch.mesh import make_serving_mesh\n"
        "m = make_serving_mesh(None, device='cpu')\n"
        "import torch.distributed as dist\n"
        "print(m.shape, dist.get_backend())\n"
        "try:\n"
        "    make_serving_mesh((2, 2), device='cpu')\n"
        "except ValueError as e:\n"
        "    print(e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "(1, 1) gloo"
    assert lines[1] == "mesh 2,2 needs 4 processes; the world size is 1"
