"""Serving parity of the dense family with the JAX engine, on the CPU.

For llama3.1-8b, qwen1.5-4b, qwen3-32b, gemma-7b and nemotron-4-340b, both
engines serve the arch's smoke variant (float32, fixed non-uniform block
sizes, four prompts, two sharing a 150-token prefix) at temperature 0
through ``test_torch_dense_engine.serve_both`` (the JAX engine wrapped in
``_jax_slot_reset.clear_slots_on_install``), in the repo's default
configuration (dense chunked prefill, fused sparse decode) and with sparse
prefill: token streams identical, prefix-cache hits equal to JAX's (144
tokens dense, 128 aligned to the 64-token query block under sparse
prefill), the port's page pool clean at drain.
"""
import pytest

import test_torch_dense_engine as dense_engine
from test_torch_dense_engine import check_streams, serve_both
from test_torch_dense_family import ARCHS, BLOCK_SIZES, _one_thread  # noqa: F401
from repro_torch.configs import get_config, smoke_variant


@pytest.mark.parametrize("sparse_prefill", [False, True], ids=["default", "sparse-prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_token_streams_match_jax(arch, sparse_prefill, monkeypatch):
    n_kv = smoke_variant(get_config(arch)).n_kv_heads
    monkeypatch.setitem(dense_engine.SPARSE, "sparse_prefill", sparse_prefill)
    monkeypatch.setitem(dense_engine.SPARSE, "block_sizes", BLOCK_SIZES[n_kv])
    jeng, teng, jout, tout = serve_both(arch, "cuda", True, "reference", {}, 5)
    snap = check_streams(jeng, teng, jout, tout, 5)
    assert snap["prefix_hit_tokens"] == (128 if sparse_prefill else 144)
