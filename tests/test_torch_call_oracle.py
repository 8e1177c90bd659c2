"""Phase 10a's per-call oracle of ``chip_smoke.py`` (``call_oracle``,
``decode_fault``, ``flash_fault``, ``oracle_misses``) on the CPU, where
the kernel wrappers run their plain versions, so every clean call must be
held:

- one fused decode call (``test_torch_parity``'s case) and one flash call:
  the clean outputs are held by ``parity.hold_fused_decode`` /
  ``hold_flash_attention``; the faulted copies (a selected page swapped
  for the lowest-scored live page the plain selection left out; a seeded
  1% of the elements moved by 4 bf16 steps) are flagged;
- granite-moe's smoke variant served through ``Engine`` in runs D (flash
  chunks, fused decode) and S (sparse prefill, fused decode) under
  ``call_oracle`` with the faults on layer 1: every clean call of the
  three kernels held, one per wrapper call, every layer-1 call faulted
  and flagged, and the served tokens those of the same engine without
  the oracle (it hands back the wrappers' outputs).

A few seconds.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.config import ServeConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels import ops, parity
from repro_torch.models import Transformer
from repro_torch.serving import Engine, Request

from test_torch_dense_engine import prompts
from test_torch_parity import _decode_case

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _no_cuda_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_decode_fault_is_flagged_and_the_clean_call_held():
    q, rq, k, v, store, la, sparse, seq_len = _decode_case()
    args = (q, rq.float(), k, v, store.codes, store.scale, store.zero, la, seq_len)
    kw = dict(bits=store.bits, symmetric=store.symmetric,
              sink_pages=sparse.sink_pages, local_pages=sparse.local_pages)
    kernel = ops.fused_decode(q, rq, k, v, store, la, sparse.sink_pages,
                              sparse.local_pages, seq_len)
    plain = ops.fused_decode_reference(q, rq, k, v, store, la, sparse.sink_pages,
                                       sparse.local_pages, seq_len)

    def hold(out):
        return parity.hold_fused_decode(q, rq.float(), store.codes, store.scale,
                                        store.zero, la, store.bits, store.symmetric,
                                        sparse.sink_pages, sparse.local_pages,
                                        seq_len, out, plain)

    assert hold(kernel)["near_ties"] == 0
    bad, swapped = chip_smoke.decode_fault(torch, args, kw, kernel, plain)
    assert bool(swapped.all())          # both sequences hold more than T tokens
    assert torch.equal(bad[2], kernel[2])
    assert int((bad[1] != kernel[1]).sum()) == swapped.numel()
    with pytest.raises(AssertionError, match="not a near tie"):
        hold(bad)
    change = chip_smoke.kv_rows_rel(torch, bad[0], kernel[0], k.shape[1])
    assert min(change) > 0


def test_flash_fault_is_flagged_and_the_clean_call_held():
    gen = torch.Generator().manual_seed(3)
    q, k, v = ((torch.randn(s, generator=gen) * 1.5).to(torch.bfloat16)
               for s in ((1, 8, 128, 64), (1, 4, 384, 64), (1, 4, 384, 64)))
    out = ops.flash_attention(q, k, v, True, 256, 384)
    plain = ops.flash_attention_reference(q, k, v, True, 256, 384)
    assert parity.hold_flash_attention(out, plain)["max_abs_err"] == 0.0
    bad = chip_smoke.flash_fault(torch, out, seed=0)
    moved = bad != out
    assert 0.005 < float(moved.float().mean()) < 0.02
    with pytest.raises(AssertionError, match="output error"):
        parity.hold_flash_attention(bad, plain)


def _serve(sparse_prefill, oracle=None):
    base = smoke_variant(get_config("granite-moe-3b-a800m"))
    cfg = dataclasses.replace(base, sparse=dataclasses.replace(
        base.sparse, backend="cuda", fused_decode=True, sparse_prefill=sparse_prefill))
    model = Transformer(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = Engine(cfg, model, ServeConfig(max_batch=2, max_context=512, prefill_chunk=128,
                                         temperature=0.0), device="cpu")
    for i, p in enumerate(prompts(cfg.vocab_size)[:3]):
        eng.submit(Request(req_id=i, prompt=p.astype(np.int32), max_new_tokens=6))
    kernels.reset_counts()
    if oracle is None:
        done = eng.run_until_done()
    else:
        with oracle:
            done = eng.run_until_done()
    counts = {k: c["plain_calls"] for k, c in kernels.counts().items() if c["plain_calls"]}
    return {r.req_id: list(r.output) for r in done}, counts, model.cfg.n_layers


@pytest.mark.parametrize("run", ["D", "S"])
def test_oracle_holds_every_call_and_flags_every_fault_while_serving(run):
    sparse = run == "S"
    want, _, _ = _serve(sparse)
    stats = chip_smoke.oracle_stats()
    got, counts, n_layers = _serve(sparse, chip_smoke.call_oracle(stats, fault_layer=1))
    assert got == want
    # on the CPU each wrapper call runs its plain version once: the run's
    # "launches"
    assert set(counts) == ({"sparse_prefill", "fused_decode"} if sparse
                           else {"flash_attention", "fused_decode"})
    assert chip_smoke.oracle_misses(run, stats, counts, 1, n_layers) == []
    for name, n in counts.items():
        assert stats["calls"][name]["held"] == n and not stats["calls"][name]["flagged"]
    dec = stats["faults"]["fused_decode"]
    assert dec["calls"] > 0 and dec["flagged"] == dec["calls"] and not dec["missed"]
    assert all(s > 0 for s in dec["swapped"])
    fl = stats["faults"]["flash_attention"]
    if sparse:
        assert fl["calls"] == 0
    else:
        assert fl["calls"] == counts["flash_attention"] // n_layers == fl["flagged"]
        # the flash fault moves rows far less than the tolerance's row rule
        assert max(c[1] for c in fl["change"]) < parity.REL_L2
