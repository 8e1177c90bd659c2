"""Logits of the dense family's smoke variants against JAX on the CPU:
for llama3.1-8b, qwen1.5-4b, qwen3-32b, gemma-7b and nemotron-4-340b, at
f32 with weights carried from JAX's init by ``params_from_jax``, prefill
and three decode steps give logits within 1e-4 and greedy tokens identical
to JAX's through the ``"cuda"`` backend's plain versions, for the default
configuration (dense prefill; fused and staged sparse decode) and for
sparse prefill.  (A file of its own beside ``test_torch_dense_family.py``
so that neither parallel worker carries all of the family.)
"""
import pytest

from test_torch_dense_family import (  # noqa: F401  (module-scoped fixture)
    ARCHS, VARIANT_IDS, VARIANTS, _cfgs, _one_thread, _prefill_and_decode,
)


@pytest.mark.parametrize("fused,sparse_prefill", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, fused, sparse_prefill):
    _prefill_and_decode(*_cfgs(arch, fused_decode=fused, sparse_prefill=sparse_prefill))
