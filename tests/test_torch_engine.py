"""Serving-level parity of the PyTorch port with the JAX engine, on the CPU,
plus the port's import hygiene and device rules.

Both engines serve the smoke variant of llama3.2-3b (float32, fixed
non-uniform block sizes, max_context 512, sparse prefill on) at
temperature 0 with chunked prefill; two requests share a page-aligned
prefix, so the second is served from the prefix cache, and a tight page
pool forces preemption and replay.  The port decodes with the fused decode
kernel and with the staged path (``SparseConfig.fused_decode``).  The token
streams must be identical and the port's page pool must audit clean at
drain.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _jax_slot_reset import clear_slots_on_install
from repro.config import ServeConfig as JServe
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.models import Transformer as JTransformer
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch.config import ServeConfig as TServe
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest

ROOT = Path(__file__).resolve().parents[1]
SPARSE = dict(token_budget=128, block_sizes=((16, 32), (64, 16)),
              sparse_prefill=True, prefill_block_q=64)
SERVE = dict(max_batch=2, max_context=512, prefill_chunk=128,
             prefill_tokens_per_tick=192, temperature=0.0)


def _prompts():
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 256, 160)
    return [
        np.concatenate([shared, rng.integers(0, 256, 140)]),
        np.concatenate([shared, rng.integers(0, 256, 90)]),
        rng.integers(0, 256, 210),
        rng.integers(0, 256, 75),
    ]


@pytest.mark.parametrize("fused_decode", [True, False], ids=["fused", "staged"])
@pytest.mark.parametrize(
    "new_tokens,pool_pages", [(5, None), (24, 28)], ids=["roomy", "preempting"]
)
def test_engine_token_streams_match_jax(new_tokens, pool_pages, fused_decode):
    """The "preempting" pool is too small for every sequence's decode
    growth: sequences are preempted, re-admitted (prefix-cache hits) and
    replay their committed tokens through the decode path."""
    jb, tb = j_smoke(j_get_config("llama3.2-3b")), t_smoke(t_get_config("llama3.2-3b"))
    jcfg = dataclasses.replace(
        jb, sparse=dataclasses.replace(jb.sparse, backend="reference", **SPARSE))
    tcfg = dataclasses.replace(
        tb, sparse=dataclasses.replace(tb.sparse, backend="cuda",
                                       fused_decode=fused_decode, **SPARSE))
    params = JTransformer(jcfg).init(jax.random.PRNGKey(3))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")

    serve = dict(SERVE, pool_pages=pool_pages)
    jeng = clear_slots_on_install(JEngine(jcfg, params, JServe(**serve), seed=0))
    teng = TEngine(tcfg, model, TServe(**serve), seed=0, device="cpu")
    for eng, Req in ((jeng, JRequest), (teng, TRequest)):
        for i, p in enumerate(_prompts()):
            eng.submit(Req(req_id=i, prompt=p.astype(np.int32),
                           max_new_tokens=new_tokens))
    jout = {r.req_id: list(r.output) for r in jeng.run_until_done()}
    tout = {r.req_id: list(r.output) for r in teng.run_until_done()}
    assert tout == jout
    assert len(tout) == 4 and all(len(o) == new_tokens for o in tout.values())
    snap, jsnap = teng.metrics.snapshot(), jeng.metrics.snapshot()
    assert snap["prefix_hit_tokens"] == jsnap["prefix_hit_tokens"] > 0
    assert snap["preemptions"] == jsnap["preemptions"]
    assert (snap["preemptions"] > 0) == (pool_pages is not None)
    assert teng.pool.assert_consistent(known_pins=teng.prefix_cache.pages()) == []
    assert teng.pool.used_pages == teng.prefix_cache.n_pages


def test_sampler_keys_tokens_by_sequence_and_position():
    """T > 0: a row's draw depends only on (seed, seq_id, position), never
    on its batch row; T == 0 is argmax with the first index winning."""
    from repro_torch.serving.sampler import sample

    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((3, 256), generator=gen)
    a = sample(logits, [7, 8, 9], [4, 4, 4], temperature=0.8, seed=1)
    b = sample(logits.flip(0), [9, 8, 7], [4, 4, 4], temperature=0.8, seed=1)
    assert torch.equal(a, b.flip(0))
    draws = {int(sample(logits[:1], [7], [p], temperature=0.8, seed=1)[0])
             for p in range(32)}
    assert len(draws) > 1                       # positions draw independently
    top = torch.topk(logits[0], 20).indices.tolist()
    assert draws <= set(top)                    # top-k = 20 mask
    tied = torch.zeros((1, 256))
    tied[0, [5, 9]] = 1.0
    assert int(sample(tied, [0], [0], temperature=0.0)[0]) == 5


# -- hygiene -------------------------------------------------------------------


def _port_modules():
    pkg = ROOT / "src" / "repro_torch"
    for f in sorted(pkg.rglob("*.py")):
        rel = f.relative_to(pkg.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def test_port_imports_no_jax_and_nothing_of_repro():
    mods = list(_port_modules())
    for m in ("kernels.fused_decode", "kernels.block_centroid", "kernels.topk_threshold",
              "kernels.flash_attention", "core.calibration", "core.recall",
              "memory.manager", "memory.page_io", "obs.trace", "obs.validate",
              "obs.cost", "serving.frontend", "launch.serve", "models.moe", "models.moe_check",
              "configs.granite_moe_3b", "configs.grok1_314b", "configs.internvl2_2b",
              "configs.musicgen_large", "models.rglru", "models.rwkv6",
              "configs.recurrentgemma_9b", "configs.rwkv6_3b", "training.data",
              "training.optimizer", "training.checkpoint", "training.train_loop",
              "launch.train", "launch.mesh", "distributed.mesh",
              "distributed.kernel_partition", "distributed.params",
              "core.estimation", "analysis.pragmas", "analysis.rules",
              "analysis.lint", "analysis.contracts"):
        assert f"repro_torch.{m}" in mods
    code = (
        "import sys\n"
        f"for m in {mods!r}: __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True)
    assert res.stdout.strip() == ""


def test_chip_smoke_imports_no_jax_and_nothing_of_repro():
    src = (ROOT / "chip_smoke.py").read_text()
    bad = re.findall(r"^\s*(?:from|import)\s+(jax|repro)\b(?!_)", src, re.M)
    assert bad == []
    assert "repro_torch" in src


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CPU-only rule is moot")
    cfg = t_smoke(t_get_config("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEngine(cfg, None, TServe(**SERVE))
    from repro_torch.models import Transformer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(cfg)
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke"])
    from repro_torch.launch import train
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import Trainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, TrainConfig(checkpoint_dir=None), DataConfig(cfg.vocab_size, 64, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])


def test_unported_engine_options_raise():
    """A mesh is ported for the ``("attn",)`` stack; on a mesh that splits
    the call, tiered memory is not (``tests/test_torch_mesh_serving.py``
    holds every refusal)."""
    tb = t_smoke(t_get_config("llama3.2-3b"))
    cfg = dataclasses.replace(tb, sparse=dataclasses.replace(tb.sparse, **SPARSE))
    from repro_torch.distributed.mesh import ServingMesh
    from repro_torch.models import Transformer

    model = Transformer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="tiered memory"):
        TEngine(cfg, model, TServe(**SERVE, hbm_pages=40, host_pages=20),
                device="cpu", mesh=ServingMesh.local((1, 2)))
