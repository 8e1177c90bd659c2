"""The port's mesh rules held to the JAX package's, on the CPU.

- ``derive_mesh_shape``, ``parse_mesh_arg``, ``serving_rules`` and
  ``shard_axes`` (the port's on its ``ServingMesh``, JAX's on its
  ``fake_mesh`` stand-in) return what JAX's return on the cases of
  ``tests/test_distributed.py``;
- the logical axes of every cache entry the ``("attn",)`` stack allocates
  equal JAX's ``logical_axes_for_cache`` (its cycle axis dropped), but for
  the decode store's ``scale`` / ``zero``, which split over heads as JAX's
  kernel partitioning splits them (``_store_spec_tree``), and the flat
  store row axis, which the port splits with the heads by design;
- the store rule of JAX's ``test_layout_and_store_spec_trees``: a shard's
  decode-store ``scale`` / ``zero`` are its heads', the score segment's
  per-row params its rows';
- for llama3.2-3b's full-width plan (ragged block sizes, 28 layers) at
  ``model`` 2, 4 and 8, every shard's layout is the whole one's heads
  (rows rebased) and every shard's decode store and score segment, built
  from its heads' keys on its layout as the engine builds them, are
  byte-equal to its heads' segments of the whole store.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.backends import CentroidStore as JCentroidStore
from repro.distributed import kernel_partition as jkp
from repro.distributed import params as jparams
from repro.launch import mesh as jmesh

from repro_torch.backends import build_plan
from repro_torch.backends.base import CentroidStore
from repro_torch.backends.store import build_score_rows, build_store_codes
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.quantization import store_bits
from repro_torch.distributed import kernel_partition as kp
from repro_torch.distributed import params
from repro_torch.distributed.mesh import ServingMesh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import Transformer


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: the suite runs in parallel workers, and torch's
    default pool (a thread per core in every worker) oversubscribes the
    cores (the store builds below took 50x longer so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fake_mesh(**axes):
    """JAX's mesh stand-in (``tests/test_distributed.py``)."""
    return SimpleNamespace(axis_names=tuple(axes),
                           devices=SimpleNamespace(shape=tuple(axes.values())))


DERIVE = [((8,), dict(model_cap=2)), ((8,), {}), ((8,), dict(model_cap=3)),
          ((1,), dict(model_cap=16)), ((6,), dict(model_cap=4)),
          ((512,), dict(model_cap=16)),
          ((512,), dict(model_cap=16, multi_pod=True)),
          ((7,), dict(model_cap=16, multi_pod=True))]


@pytest.mark.parametrize("args,kw", DERIVE, ids=[f"{a[0]}-{k}" for a, k in DERIVE])
def test_derive_mesh_shape_equals_jax(args, kw):
    assert tmesh.derive_mesh_shape(*args, **kw) == jmesh.derive_mesh_shape(*args, **kw)


@pytest.mark.parametrize("arg", ["4,2", " 1 , 8 ", "4", "2,2,2"])
def test_parse_mesh_arg_equals_jax(arg):
    try:
        want = jmesh.parse_mesh_arg(arg)
    except ValueError:
        with pytest.raises(ValueError):
            tmesh.parse_mesh_arg(arg)
        return
    assert tmesh.parse_mesh_arg(arg) == want


def test_serving_rules_equal_jax():
    assert kp.serving_rules() == jkp.serving_rules()
    over = {"batch": ("data", "model"), "kv_heads": None}
    assert kp.serving_rules(over) == jkp.serving_rules(over)


#: (mesh axes, batch, n_kv) of JAX's test_shard_axes_divisibility_and_gqa_degradation
AXES_CASES = [((4, 2), 8, 2), ((4, 2), 1, 2), ((2, 4), 8, 2), ((1, 1), 8, 2),
              ((2, 2), 4, 2), ((1, 4), 4, 2), ((1, 16), 4, 8), ((4, 1), 3, 8)]


@pytest.mark.parametrize("shape,batch,n_kv", AXES_CASES)
def test_shard_axes_equal_jax(shape, batch, n_kv):
    want = jkp.shard_axes(fake_mesh(data=shape[0], model=shape[1]),
                          jkp.serving_rules(), batch, n_kv)
    assert kp.shard_axes(ServingMesh.local(shape), kp.serving_rules(), batch,
                         n_kv) == want
    # every rank's slice: the axis splits evenly where it is picked, and
    # the slices tile the call
    shards = kp.every_shard(shape, batch, n_kv)
    for (d, m), s in shards:
        assert s.rows_split == (want[0] is not None)
        assert s.heads_split == (want[1] is not None)
    rows = sorted({s.rows for _, s in shards})
    heads = sorted({s.heads for _, s in shards})
    assert rows[0][0] == 0 and rows[-1][1] == batch
    assert heads[0][0] == 0 and heads[-1][1] == n_kv
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert all(a[1] == b[0] for a, b in zip(heads, heads[1:]))


def _smoke_cache():
    cfg = smoke_variant(get_config("llama3.2-3b"))
    cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, backend="cuda", sparse_prefill=True))
    return Transformer(cfg, device="cpu").init_cache(2, 256)


def test_cache_axes_equal_jax_but_the_store_split():
    """Entry by entry against JAX's cache rule (and, for the decode store's
    affine params, its kernel spec), under the serving rules."""
    cache = _smoke_cache()
    entries = {"seq_len": cache["seq_len"], **cache["layers"][0]}
    assert set(entries) == set(params.CACHE_AXES)
    rules = kp.serving_rules()
    jstore = JCentroidStore(np.zeros((2, 8, 8), np.uint8),
                            np.ones((2, 2, 16), np.float32),
                            np.zeros((2, 2, 16), np.float32), 4, False)
    spec = jkp._store_spec_tree(jstore, "data", "model", head_aligned_params=True)
    for name, t in entries.items():
        if name == "seq_len":
            j = jparams.logical_axes_for_cache("seq_len", t.ndim)
        else:
            j = jparams.logical_axes_for_cache(f"pos0/{name}", t.ndim + 1)[1:]
        want = tuple(None if a is None else jkp.SERVING_RULES.get(a) for a in j)
        if name in ("scale", "zero"):
            assert want == ("data", None, None)
            want = tuple(spec.scale)
        got = tuple(None if a is None else rules.get(a)
                    for a in params.logical_axes_for_cache(name, t.ndim))
        if name in params.ROW_AXIS_ENTRIES:
            # the flat row axis: whole in JAX, split by head segment here
            assert want[1] is None and got[1] == "model"
            got = got[:1] + (None,) + got[2:]
        assert got == want, name
    assert params.logical_axes_for_cache("k", 3) == (None,) * 3
    assert params.logical_axes_for_cache("_telemetry", 3) == (None,) * 3


def _ragged_plan(ctx=16384):
    """llama3.2-3b's full-width plan with ragged per-head block sizes (a
    different rotation in every layer, so the layers' row counts differ)."""
    cfg = get_config("llama3.2-3b")
    sizes = (16, 32, 64, 16, 32, 64, 32, 16)
    rows = tuple(sizes[l % 3:] + sizes[:l % 3] for l in range(cfg.n_layers))
    cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, block_sizes=rows, quant="int4_asym"))
    return cfg, build_plan(cfg, ctx)


def test_store_rule_of_jax_spec_trees():
    """JAX's ``test_layout_and_store_spec_trees`` store rule on a shard:
    the decode store's per-head params split over heads with the codes'
    batch, the score segment's per-row params follow its rows."""
    cfg, plan = _ragged_plan()
    la = plan.stacked("cpu").layer(0)
    n_kv, rows = cfg.n_kv_heads, la.total_rows
    gen = torch.Generator().manual_seed(0)
    store = CentroidStore(torch.randint(0, 255, (4, rows, 8), generator=gen,
                                        dtype=torch.uint8),
                          torch.rand((4, n_kv, 16), generator=gen),
                          torch.rand((4, n_kv, 16), generator=gen), 4)
    score = CentroidStore(store.codes, torch.rand((4, rows, 1), generator=gen),
                          torch.rand((4, rows, 1), generator=gen), 4)
    for (d, m), s in kp.every_shard((2, 2), 4, n_kv):
        r0, r1 = kp.row_span(la, s.heads)
        dec = kp.shard_store(store, la, s, head_aligned_params=True)
        assert torch.equal(dec.codes, store.codes[s.rows[0]:s.rows[1], r0:r1])
        assert torch.equal(dec.scale, store.scale[s.rows[0]:s.rows[1],
                                                  s.heads[0]:s.heads[1]])
        pre = kp.shard_store(score, la, s, head_aligned_params=False)
        assert torch.equal(pre.scale, score.scale[s.rows[0]:s.rows[1], r0:r1])
        assert pre.scale.shape[1] == r1 - r0 != n_kv


@pytest.mark.parametrize("model", [2, 4, 8])
def test_shard_layout_is_the_whole_ones_heads(model):
    """Every layer of the stacked full-width plan, every shard: per-head
    descriptors sliced, rows rebased, tiles local, static bounds global."""
    cfg, plan = _ragged_plan()
    stk = plan.stacked("cpu")
    for _, s in kp.every_shard((1, model), 4, cfg.n_kv_heads):
        h0, h1 = s.heads
        sl = kp.shard_layout(stk, s.heads)
        for f in ("max_blocks", "max_top_k", "selected_pages", "page_size",
                  "tile_rows", "context_len", "token_budget", "max_block_size"):
            assert getattr(sl, f) == getattr(stk, f), f
        for l, lay in enumerate(stk.host_layouts):
            w, sh = stk.layer(l), sl.layer(l)
            base = lay.offsets[h0]
            for f in ("pad_mask", "block_starts", "block_sizes", "slot_map",
                      "within_map", "pages_per_block", "n_blocks", "top_k"):
                assert torch.equal(getattr(sh, f), getattr(w, f)[h0:h1]), f
            assert torch.equal(sh.row_offsets, w.row_offsets[h0:h1] - base)
            assert torch.equal(sh.scatter_rows, torch.where(
                w.pad_mask[h0:h1], w.scatter_rows[h0:h1] - base, 0))
            n_t = (lay.offsets[h1] - base) // lay.tile_rows
            t0 = base // lay.tile_rows
            assert torch.equal(sh.tile_head[:n_t], w.tile_head[t0:t0 + n_t] - h0)
            assert not sh.tile_head[n_t:].any()
            assert sh.host.offsets[-1] == lay.offsets[h1] - base


@pytest.mark.parametrize("model", [2, 4, 8])
def test_shard_store_segments_byte_equal(model):
    """Two layers of the full-width plan at an 8192-token context, INT4
    decode store and score segment: built on each shard's heads and
    layout, each head's codes / scale / zero equal its segment of the
    whole store, byte for byte."""
    cfg, plan = _ragged_plan(8192)
    sp = cfg.sparse
    stk = plan.stacked("cpu")
    gen = torch.Generator().manual_seed(1)
    k = torch.randn((2, cfg.n_kv_heads, 8192 // sp.page_size, sp.page_size,
                     cfg.resolved_head_dim), generator=gen).to(torch.bfloat16)
    for l in (0, 1):
        la = stk.layer(l)
        whole = build_store_codes(k, la, sp)
        wcodes, wsc, wze = build_score_rows(k, la, sp)
        lay = la.host
        for _, s in kp.every_shard((1, model), 2, cfg.n_kv_heads):
            sla = kp.shard_layout(stk, s.heads).layer(l)
            kk = s.take(k)
            part = build_store_codes(kk, sla, sp)
            pcodes, psc, pze = build_score_rows(kk, sla, sp)
            assert part.codes.shape[1] == sla.total_rows
            base = lay.offsets[s.heads[0]]
            for h in range(*s.heads):
                seg = slice(lay.offsets[h], lay.offsets[h + 1])
                loc = slice(lay.offsets[h] - base, lay.offsets[h + 1] - base)
                assert torch.equal(part.codes[:, loc], whole.codes[:, seg])
                assert torch.equal(pcodes[:, loc], wcodes[:, seg])
                assert torch.equal(psc[:, loc], wsc[:, seg])
                assert torch.equal(pze[:, loc], wze[:, seg])
            assert torch.equal(part.scale, s.take(whole.scale))
            assert torch.equal(part.zero, s.take(whole.zero))
            assert store_bits(sp.quant) == part.bits == 4
