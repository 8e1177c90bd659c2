"""The port's contract verifier (``repro_torch.analysis.contracts``) and the
kernel wrappers' abstract rules, on the CPU.

The grid of six cells passes, the ``"cuda"`` cells through the wrappers'
abstract rules (never a plain version); JAX's negative cases are carried
over, with the port's own (a replaced cache tensor, a host read in a
step); each of the eight wrappers, given fake CUDA copies of real inputs,
returns its plain version's output shapes and dtypes on the CUDA device,
raises the real wrapper's error on a bad shape, moves no counter and
never loads a library; the decode logits and every cache entry have the
shapes of JAX's abstract evaluation of the same config.
"""
import dataclasses
import math
from contextlib import contextmanager

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import kernels
from repro_torch.analysis import contracts as C
from repro_torch.backends.store import build_score_rows, build_store_codes
from repro_torch.config import SparseConfig
from repro_torch.core.centroids import rank_query
from repro_torch.core.ragged import layout_for
from repro_torch.core.stacked import as_arrays
from repro_torch.kernels import _build, ops
from repro_torch.kernels import block_centroid as bc
from repro_torch.kernels import centroid_score as cs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sparse_prefill as spf
from repro_torch.kernels import topk_threshold as tk


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


@pytest.fixture
def abstract_calls(monkeypatch):
    """Records, per wrapper, each ``_build.is_abstract`` verdict."""
    seen = []
    orig = _build.is_abstract

    def spy(*tensors):
        r = orig(*tensors)
        seen.append(r)
        return r

    monkeypatch.setattr(_build, "is_abstract", spy)
    return seen


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_full_grid_passes_through_the_abstract_rules(device, abstract_calls):
    before = kernels.counts()
    report = C.run_contracts(device=device)
    assert report["n_failures"] == 0, report["failures"]
    assert (report["cells"], report["configs_covered"], report["backends_covered"]) == (6, 2, 3)
    assert report["tool"] == "repro_torch.analysis.contracts"
    assert report["fake_device"] == ("meta" if device == "cuda" and not
                                     torch.backends.cuda.is_built() else device)
    # the reference backend calls the plain versions itself; the kernel
    # backends only reached the abstract rules
    assert abstract_calls and all(abstract_calls)
    moved = {k: v for k, v in kernels.counts().items() if v != before[k]}
    assert all(v["launches"] == before[k]["launches"] for k, v in moved.items())


def test_cuda_cells_reach_the_wrappers_and_no_plain_version(abstract_calls):
    before = kernels.counts()
    report = C.run_contracts(backends=("cuda",))
    assert report["n_failures"] == 0, report["failures"]
    assert kernels.counts() == before              # neither launches nor plain calls
    # staged decode (scores + paged attention), flash chunks, fused decode,
    # sparse prefill: 5 wrappers x 2 layers x 2 configs, each verdict True
    assert len([r for r in abstract_calls if r]) >= 20


def test_jax_smoke_widths_are_refused_as_the_kernels_would(monkeypatch):
    """JAX's smoke variant (head_dim 16, float32) on ``"cuda"``: the abstract
    rules raise the wrappers' errors, the reference backend passes."""
    monkeypatch.setattr(C, "KERNEL_HEAD_DIM", 0)
    monkeypatch.setattr(C, "KERNEL_DTYPE", "float32")
    report = C.run_contracts(configs=("llama3.2-3b",), backends=("cuda", "reference"))
    fails = report["failures"]
    assert fails and {f["backend"] for f in fails} == {"cuda"}
    assert {f["check"] for f in fails} == {"step_stability"}
    assert any("expected torch.bfloat16" in f["message"] for f in fails)


def test_cli_writes_only_its_output(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert C.main(["--configs", "llama3.2-3b", "--backends", "cuda", "--output",
                   str(out)]) == 0
    assert "contracts: 1 cells" in capsys.readouterr().out
    import json

    assert json.loads(out.read_text())["n_failures"] == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["report.json"]


# ---------------------------------------------------------------------------
# JAX's negative cases, and the port's own
# ---------------------------------------------------------------------------


def test_host_descriptor_guard_rejects_tensors():
    C._check_host_int("ok", np.arange(4, dtype=np.int32))
    with pytest.raises(C.ContractFailure, match="host numpy"):
        C._check_host_int("bad", torch.arange(4))
    with pytest.raises(C.ContractFailure, match="integer"):
        C._check_host_int("bad", np.arange(4.0))
    with pytest.raises(C.ContractFailure, match="host ints"):
        C._check_host_ints("bad", (1, torch.tensor(2)))


def test_sharding_coverage_rejects_unknown_entry():
    t = torch.zeros
    C.check_sharding_coverage({"seq_len": t(2), "max_context": 512,
                               "layers": [{"k": t(2, 2, 4, 16, 8)}], "la": [None]})
    with pytest.raises(C.ContractFailure, match="mystery_buffer"):
        C.check_sharding_coverage({"seq_len": t(2),
                                   "layers": [{"mystery_buffer": t(2, 8, 4)}]})
    # a known entry at another rank is not covered either
    with pytest.raises(C.ContractFailure, match="'k'"):
        C.check_sharding_coverage({"layers": [{"k": t(2, 4, 8)}]})


def _model(backend="reference"):
    from repro_torch.models import Transformer

    cfg = C.contract_config("llama3.2-3b", backend)
    return Transformer(cfg, device=C.fake_device("cuda"))


@contextmanager
def _fake():
    with C.fake_mode(C.fake_device("cuda")):
        yield


def test_step_stability_detects_entry_drift():
    with _fake():
        model = _model()

        class Drifting:
            cfg, device = model.cfg, model.device

            def decode_step(self, cache, tokens):
                logits, cache = model.decode_step(cache, tokens)
                cache["stowaway"] = tokens
                return logits, cache

            prefill_chunk = staticmethod(model.prefill_chunk)

        cache = model.init_cache(2, 512)
        with pytest.raises(C.ContractFailure, match="entry count"):
            C.check_step_stability(Drifting(), cache, 2)


def test_step_stability_detects_a_replaced_cache_tensor():
    with _fake():
        model = _model()

        class Replacing:
            cfg, device = model.cfg, model.device

            def decode_step(self, cache, tokens):
                logits, cache = model.decode_step(cache, tokens)
                e = cache["layers"][1]
                e["k"] = e["k"] + 0          # same spec, another tensor
                return logits, cache

            prefill_chunk = staticmethod(model.prefill_chunk)

        cache = model.init_cache(2, 512)
        with pytest.raises(C.ContractFailure, match="replaced cache tensor 'layers.1.k'"):
            C.check_step_stability(Replacing(), cache, 2)


def test_a_host_read_in_a_step_fails_host_sync(monkeypatch):
    from repro_torch.models.transformer import Transformer

    step = Transformer.decode_step

    def reading(self, cache, tokens):
        cache["seq_len"].max().item()             # a host read of device data
        return step(self, cache, tokens)

    monkeypatch.setattr(Transformer, "decode_step", reading)
    report = C.run_contracts(configs=("llama3.2-3b",), backends=("cuda",))
    checks = {f["check"] for f in report["failures"]}
    assert checks == {"host_sync"}, report["failures"]
    msg = report["failures"][0]["message"]
    assert "decode_step reads device data on the host" in msg
    assert "test_torch_contracts.py" in msg and "(reading)" in msg


def test_plan_hygiene_rejects_a_tensor_in_a_layout(monkeypatch):
    with _fake():
        model = _model()
    plan = model.attention_plan(512)
    lay = plan.layouts[0]
    monkeypatch.setitem(lay.__dict__, "slot_map", torch.as_tensor(lay.slot_map))
    with pytest.raises(C.ContractFailure, match=r"layout\[0\].slot_map must be host numpy"):
        C.check_plan_hygiene(model, 512)


def test_resolve_device_accepts_cuda_only_under_a_fake_mode():
    from repro_torch.models.transformer import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CPU-only rule is moot")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with FakeTensorMode():
        assert resolve_device("cuda") == torch.device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


# ---------------------------------------------------------------------------
# each wrapper's abstract rule
# ---------------------------------------------------------------------------

B, N_KV, G, D, CTX, PS, BUDGET = 2, 2, 2, 64, 512, 16, 128


@pytest.fixture(scope="module")
def real_inputs():
    """Real CPU inputs of every wrapper at a small shape the kernels take
    (bf16, head_dim 64, GQA group 2, INT4 quest store)."""
    gen = torch.Generator().manual_seed(0)
    sparse = SparseConfig(token_budget=BUDGET, quant="int4_asym", sparse_prefill=True,
                          local_pages=1)
    la = as_arrays(layout_for((16, 32), CTX, PS, BUDGET))
    k, v = (torch.randn((B, N_KV, CTX // PS, PS, D), generator=gen).to(torch.bfloat16)
            for _ in range(2))
    q = torch.randn((B, N_KV * G, D), generator=gen).to(torch.bfloat16)
    rq = rank_query(q, sparse.centroid_method, D).contiguous()
    seq_len = torch.tensor([CTX, 300], dtype=torch.int32)
    st = build_store_codes(k, la, sparse)
    st32 = build_store_codes(k, la, sparse, quant="none")
    table, valid = fd.fused_decode_plain(q, rq, k, v, st.codes, st.scale, st.zero, la,
                                         seq_len, bits=4, symmetric=False, sink_pages=1,
                                         local_pages=1)[1:]
    qp = torch.randn((B, N_KV * G, 64, D), generator=gen).to(torch.bfloat16)
    rqp = rank_query(qp, sparse.centroid_method, D)
    q6, rq6, k_sel, n_valid, qb0 = ops._prefill_query_blocks(
        qp, rqp, la, 64, 1.0, torch.tensor([256, 200], dtype=torch.int32), 192)
    pc, psc, pz = build_score_rows(k, la, sparse)
    scores = ops.centroid_scores(rq, st, la, N_KV).contiguous()
    qf = torch.randn((1, N_KV * G, 64, D), generator=gen).to(torch.bfloat16)
    kf, vf = (torch.randn((1, N_KV, CTX, D), generator=gen).to(torch.bfloat16)
              for _ in range(2))
    kl = torch.tensor([320], dtype=torch.int32)
    quant = dict(bits=4, symmetric=False)
    return {
        "fused_decode": (fd.fused_decode, (q, rq, k, v, st.codes, st.scale, st.zero, la,
                                           seq_len),
                         dict(quant, sink_pages=1, local_pages=1)),
        "sparse_prefill": (spf.sparse_prefill, (q6, rq6, k, v, pc, psc, pz, la, k_sel,
                                                n_valid, qb0),
                           dict(quant, block_q=64, sink_pages=1, local_pages=1,
                                return_selected=True)),
        "centroid_scores_quantized": (cs.centroid_scores_quantized,
                                      (rq, st.codes, st.scale, st.zero, la.tile_head,
                                       la.tile_rows), quant),
        "centroid_scores_f32": (cs.centroid_scores_f32,
                                (rq, st32.codes, N_KV, la.tile_head, la.tile_rows), {}),
        "paged_attention": (pa.paged_attention, (q, k, v, table, valid, seq_len, PS), {}),
        "pool_rank_keys": (bc.pool_rank_keys, (k.reshape(B, N_KV, CTX, D), 16, "quest"),
                           {}),
        "topk_threshold": (tk.topk_threshold, (scores, la.top_k), {}),
        "flash_attention": (fa.flash_attention, (qf, kf, vf, True, 256, kl), {}),
    }


#: an argument made the wrong shape, and the real wrapper's ValueError
BAD = {
    "fused_decode": (5, lambda t: t[:, :1], "scale has shape"),
    "sparse_prefill": (9, lambda t: t[:1], "n_valid has shape"),
    "centroid_scores_quantized": (2, lambda t: t[:1], "scale has shape"),
    "centroid_scores_f32": (1, lambda t: t[:, :-64], "tile_head has shape"),
    "paged_attention": (4, lambda t: t[..., :-1], "page_valid has shape"),
    "pool_rank_keys": (0, lambda t: t[..., :48], "head_dim"),
    "topk_threshold": (1, lambda t: t[:-1], "k_per_head has 1 values, not 2"),
    "flash_attention": (1, lambda t: t[:, :1, :, :32], "k has shape"),
}


def _no_library(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the abstract rule reached the library or the card")

    monkeypatch.setattr(_build, "load", refuse)
    for m in (pa, fd, spf):
        monkeypatch.setattr(m, "_sm_count", refuse)


@pytest.mark.parametrize("name", sorted(BAD))
def test_wrapper_abstract_rule_matches_its_plain_version(name, real_inputs, monkeypatch):
    _no_library(monkeypatch)
    fn, args, kw = real_inputs[name]
    plain = C.output_specs(fn(*args, **kw))            # CPU tensors: the plain version
    kernels.reset_counts()
    fake = C.abstract_call(fn, *args, device="cuda", **kw)
    assert kernels.counts() == {k: {"launches": 0, "plain_calls": 0}
                                for k in kernels.counts()}
    assert [s[:2] for s in fake] == [s[:2] for s in plain]
    assert {s[2] for s in fake} == {"cuda"} and {s[2] for s in plain} == {"cpu"}
    # the same rule on meta tensors, with no mode at all
    meta = C.output_specs(fn(*C.fake_like(args, "meta"), **C.fake_like(kw, "meta")))
    assert [s[:2] for s in meta] == [s[:2] for s in plain]
    assert kernels.counts()[name] == {"launches": 0, "plain_calls": 0}

    i, bad, match = BAD[name]
    args = list(args)
    args[i] = bad(args[i]).contiguous()
    with pytest.raises(ValueError, match=match):
        C.abstract_call(fn, *args, device="cuda", **kw)
    # the real wrapper's own check, as the card runs it: the abstract rule
    # shares it (a CPU tensor takes the plain version, so ask the rule on meta)
    with pytest.raises(ValueError, match=match):
        fn(*C.fake_like(tuple(args), "meta"), **C.fake_like(kw, "meta"))


def test_abstract_rule_checks_contiguity_and_forced_splits(real_inputs, monkeypatch):
    _no_library(monkeypatch)
    fn, args, kw = real_inputs["paged_attention"]
    q = args[0]
    strided = torch.empty_strided(q.shape, (q.shape[1] * q.shape[2] * 2, q.shape[2], 1),
                                  dtype=q.dtype)
    with pytest.raises(ValueError, match="q must be contiguous"):
        C.abstract_call(fn, strided, *args[1:], device="cuda")
    with pytest.raises(ValueError, match="n_split 99 not in"):
        C.abstract_call(fn, *args, device="cuda", n_split=99)
    assert C.abstract_call(fn, *args, device="cuda", n_split=3) == [
        (tuple(q.shape), "torch.bfloat16", "cuda")]
    fn, args, kw = real_inputs["fused_decode"]
    with pytest.raises(ValueError, match="n_split 0 not in"):
        C.abstract_call(fn, *args, device="cuda", n_split=0, **kw)


# ---------------------------------------------------------------------------
# against JAX's abstract evaluation
# ---------------------------------------------------------------------------

#: JAX's LayoutArrays leaves, in its flatten order
JAX_LAYOUT_FIELDS = ("scatter_rows", "pad_mask", "block_starts", "block_sizes",
                     "slot_map", "within_map", "pages_per_block", "tile_head",
                     "topk_valid", "row_offsets", "n_blocks", "top_k")


def _jax_specs(cfg_t, batch, ctx):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, smoke_variant
    from repro.distributed.params import _path_str
    from repro.models.transformer import Transformer

    cfg = smoke_variant(get_config(cfg_t.name.removesuffix("-smoke")))
    sp = cfg_t.sparse
    cfg = dataclasses.replace(
        cfg, head_dim=cfg_t.head_dim, dtype=cfg_t.dtype,
        sparse=dataclasses.replace(cfg.sparse, enabled=True,
                                   token_budget=sp.token_budget,
                                   fused_decode=sp.fused_decode,
                                   sparse_prefill=sp.sparse_prefill))
    m = Transformer(cfg)
    cache = jax.eval_shape(lambda: m.init_cache(batch, ctx))
    params = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0)))
    logits, _ = jax.eval_shape(m.decode_step, params, cache,
                               jax.ShapeDtypeStruct((batch,), jnp.int32))
    flat, _ = jax.tree_util.tree_flatten_with_path(cache)
    return tuple(logits.shape), {_path_str(p): tuple(x.shape) for p, x in flat}


@pytest.mark.parametrize("config", C.DEFAULT_CONFIGS)
@pytest.mark.parametrize("variant", sorted(C.VARIANTS))
def test_logits_and_cache_shapes_equal_jaxs(config, variant):
    """The port's cache entry = JAX's leaf with its leading cycle (layer)
    axis dropped:

    - ``seq_len`` <-> ``seq_len``;
    - ``layers.{l}.{name}`` <-> ``pos0/{name}[l]`` (k, v, codes, scale,
      zero; pcodes, pscale, pzero under sparse prefill);
    - ``la.{l}.{field}`` <-> ``_layouts/{i}[l]``, ``i`` the field's place in
      JAX's LayoutArrays.

    On purpose, the port keeps no ``topk_valid`` (its selection reads
    validity from the ranked values) and no ``_offsets`` (``la.row_offsets``
    per layer), and holds ``max_context`` (a host int).  ``ROADMAP.md`` §3's
    shape differences are elsewhere: a mesh shard's own store rows (no mesh
    here) and an inactive plan's padded last page
    (:func:`test_inactive_plan_pads_its_last_page`)."""
    batch, ctx = 2, 512
    cfg = C.contract_config(config, "cuda")
    cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse,
                                                              **C.VARIANTS[variant]))
    j_logits, j = _jax_specs(cfg, batch, ctx)
    with _fake():
        from repro_torch.models import Transformer

        model = Transformer(cfg, device=C.fake_device("cuda"))
        cache = model.init_cache(batch, ctx)
        specs = C.check_step_stability(model, cache, batch)
    assert specs[0][0] == j_logits == (batch, cfg.vocab_size)
    port = {p: s[0] for p, s in C.entry_specs(cache) if s[0] != "host"}
    want = {"seq_len": j.pop("seq_len")}
    for path, shape in j.items():
        head, _, name = path.partition("/")
        for l in range(shape[0]):
            if head == "pos0":
                want[f"layers.{l}.{name}"] = shape[1:]
            elif head == "_layouts" and JAX_LAYOUT_FIELDS[int(name)] != "topk_valid":
                want[f"la.{l}.{JAX_LAYOUT_FIELDS[int(name)]}"] = shape[1:]
    assert "_offsets" in j and "_layouts/8" in j         # JAX only, on purpose
    assert port == want
    assert dict(C.entry_specs(cache))["max_context"] == ("host", ctx)


def test_inactive_plan_pads_its_last_page():
    """``ROADMAP.md`` §3: below twice the budget JAX's cache is dense
    ``[nc, B, n_kv, S, hd]``; the port's is paged with the last page
    padded, ``[B, n_kv, ceil(S / page), page, hd]``."""
    batch, ctx = 2, 200                  # under twice the budget, off the page grid
    cfg = C.contract_config("llama3.2-3b", "cuda")
    cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse,
                                                              token_budget=128))
    _, j = _jax_specs(cfg, batch, ctx)
    with _fake():
        from repro_torch.models import Transformer

        model = Transformer(cfg, device=C.fake_device("cuda"))
        cache = model.init_cache(batch, ctx)
        C.check_step_stability(model, cache, batch)
    ps = cfg.sparse.page_size
    nc, b, n_kv, s, hd = j["pos0/k"]
    assert (b, s) == (batch, ctx)
    assert tuple(cache["layers"][0]["k"].shape) == (b, n_kv, math.ceil(s / ps), ps, hd)
    assert cache["la"] == [None] * nc


# ---------------------------------------------------------------------------
# what the verifier found in the port, repaired
# ---------------------------------------------------------------------------


def test_layouts_build_as_fake_tensors_on_a_device_this_build_lacks():
    """Under a fake mode a layout descriptor is an empty tensor of its shape
    (``core/stacked.py::_t``): from numpy the mode would build a real host
    tensor and move it for real, which a CPU-only build cannot do for
    CUDA."""
    from torch._subclasses.fake_tensor import is_fake

    from repro_torch.core.stacked import stack_layouts

    lay = layout_for((16, 32), CTX, PS, BUDGET)
    with FakeTensorMode():
        stk = stack_layouts([lay, lay], "cuda")
    real = stack_layouts([lay, lay])
    for f in ("scatter_rows", "pad_mask", "slot_map", "tile_head", "top_k"):
        t, r = getattr(stk, f), getattr(real, f)
        assert is_fake(t) and t.device.type == "cuda"
        assert (t.shape, t.dtype) == (r.shape, r.dtype)


def test_recall_profile_caches_no_tensor_of_a_fake_touch():
    """``head_recall_at_block_size`` once kept its layout tensors in an
    ``lru_cache`` keyed by (layout, device) (RPT001): a first touch under
    ``FakeTensorMode`` handed fake tensors to the next real call."""
    from repro_torch.core.calibration import head_recall_at_block_size

    gen = torch.Generator().manual_seed(3)
    q, keys = torch.randn((2, 64), generator=gen), torch.randn((2, 1024, 64), generator=gen)
    want = head_recall_at_block_size(q, keys, 32, 256)
    with FakeTensorMode() as mode:
        fake = head_recall_at_block_size(mode.from_tensor(q), mode.from_tensor(keys), 32, 256)
    assert fake.shape == want.shape
    assert torch.equal(head_recall_at_block_size(q, keys, 32, 256), want)
