"""The port's training loss and gradients against JAX's on the CPU
(``Transformer.loss`` and ``forward_train``, JAX's
``jax.value_and_grad(model.loss)``), same weights (``params_from_jax``),
same tokens (numpy seed 0), on llama3.2-3b's smoke variant; the same
checks on the other families live in ``test_torch_train_grads_moe.py``
(granite-moe-3b-a800m), ``test_torch_train_grads_families.py``
(internvl2-2b, musicgen-large, rwkv6-3b) and
``test_torch_train_grads_recurrent.py`` (recurrentgemma-9b), which import
this file's helpers:

- f32: loss within 1e-5 relative, every parameter's gradient within 1e-4
  relative L2 (an MoE's aux loss against JAX's ``forward_train``'s too;
  a ``"vlm"`` / ``"audio"`` model with prefix embeddings);
- bf16: loss within 1e-4 relative, every gradient within 5e-2 relative
  L2 (the two frameworks round bf16 activations in different places;
  measured 1.9e-2 at worst);
- the loss with a label chunk that leaves a remainder (95 positions in
  chunks of 40) against JAX's at the same chunk;
- remat "none", "full" and "dots" give bitwise the same loss and
  gradients; "dots" recomputes no ``aten.mm`` (the projections) and
  "full" recomputes them;
- chip_smoke's rope power check (layer 1's queries rotated one position
  on) fails the f32 gate on that layer's wq and wk.

About 15 s in one process (JAX's gradients compiled once per model), 40
s under the tier-1 run's six workers.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.models import Transformer as JTransformer

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import jax_leaf, params_from_jax
from repro_torch.training.train_loop import trainable

from test_torch_dense_family import _one_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

#: recurrentgemma at 5 layers runs one cycle and two remainder layers
LAYERS = {"recurrentgemma-9b": 5}
B, S = 2, 96
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 1e-4, 5e-2


@functools.lru_cache(maxsize=None)
def _jax_case(arch, dtype="float32"):
    """(JAX model, its params, the carried weights as numpy, tokens, prefix
    embeddings or None, JAX's loss, JAX's gradients as f32 numpy)."""
    jc = dataclasses.replace(j_smoke(j_get_config(arch)), dtype=dtype,
                             n_layers=LAYERS.get(arch, j_smoke(j_get_config(arch)).n_layers))
    jm = JTransformer(jc)
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    prefix = None
    if jc.family in ("vlm", "audio"):
        prefix = rng.standard_normal((B, jc.n_prefix_embeddings, jc.d_model)).astype(np.float32)
    f = jax.jit(jax.value_and_grad(lambda p, t, pe: jm.loss(p, t, pe)))
    loss, grads = f(params, jnp.asarray(toks), None if prefix is None else jnp.asarray(prefix))
    return (jm, params, jax.tree.map(np.asarray, params), toks, prefix, float(loss),
            jax.tree.map(lambda a: np.asarray(a, np.float32), grads))


def _port_model(arch, dtype="float32"):
    """The port's model with ``_jax_case``'s weights (a fresh copy)."""
    tree = _jax_case(arch, dtype)[2]
    tc = t_smoke(t_get_config(arch))
    tc = dataclasses.replace(tc, dtype=dtype, n_layers=LAYERS.get(arch, tc.n_layers))
    return params_from_jax(tree, tc, device="cpu")


def _port_grads(model, toks, prefix, **kw):
    params = trainable(model)
    loss = model.loss(torch.as_tensor(toks),
                      None if prefix is None else torch.as_tensor(prefix), **kw)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def _rel_l2(model, got, jgrads):
    return {n: float(np.linalg.norm(g.float().numpy() - w) / np.linalg.norm(w))
            for n, g in got.items() for w in [jax_leaf(jgrads, model.cfg, n)]}


def check_loss_and_grads(arch, dtype="float32"):
    """Loss and every gradient of ``arch``'s smoke variant against JAX's
    at the tolerances of ``dtype``; an MoE's aux loss too."""
    jm, params, _, toks, prefix, jloss, jgrads = _jax_case(arch, dtype)
    model = _port_model(arch, dtype)
    loss, grads = _port_grads(model, toks, prefix)
    loss_rtol, grad_rtol = ((LOSS_RTOL, GRAD_RTOL) if dtype == "float32" else
                            (BF16_LOSS_RTOL, BF16_GRAD_RTOL))
    assert all(g.dtype == p.dtype for g, p in zip(grads.values(), model.parameters()))
    assert float(loss) == pytest.approx(jloss, rel=loss_rtol)
    assert sum(g.numel() for g in grads.values()) == sum(
        a.size for a in jax.tree.leaves(jgrads))
    rel = _rel_l2(model, grads, jgrads)
    assert max(rel.values()) <= grad_rtol, rel
    if model.cfg.moe is not None:
        _, jaux = jm.forward_train(params, jnp.asarray(toks))
        with torch.no_grad():
            _, aux = model.forward_train(torch.as_tensor(toks))
        assert float(aux) > 0 and float(aux) == pytest.approx(float(jaux), rel=LOSS_RTOL)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def check_remat_bitwise(arch):
    """Remat "none", "full" and "dots": bitwise the same loss and
    gradients; the backward pass of "dots" runs the "none" pass's
    ``aten.mm`` calls, that of "full" more (the cycles' forward again)."""
    toks = _jax_case(arch)[3]
    model = _port_model(arch)
    params = trainable(model)
    out, backward_mm = {}, {}
    for remat in ("none", "full", "dots"):
        loss = model.loss(torch.as_tensor(toks), remat=remat)
        with _CountMM() as count:
            grads = torch.autograd.grad(loss, list(params.values()))
        out[remat], backward_mm[remat] = (loss.detach(), grads), count.mm
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)
    assert backward_mm["dots"] == backward_mm["none"] < backward_mm["full"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    check_loss_and_grads("llama3.2-3b", dtype)


def test_label_chunk_remainder_matches_jax():
    jm, params, _, toks, _, _, _ = _jax_case("llama3.2-3b")
    jloss = float(jax.jit(lambda p, t: jm.loss(p, t, label_chunk=40))(params, jnp.asarray(toks)))
    model = _port_model("llama3.2-3b")
    with torch.no_grad():
        loss = float(model.loss(torch.as_tensor(toks), label_chunk=40))
        whole = float(model.loss(torch.as_tensor(toks)))
    assert loss == pytest.approx(jloss, rel=LOSS_RTOL)
    assert loss == pytest.approx(whole, rel=LOSS_RTOL)


def test_remat_policies_are_bitwise_equal():
    check_remat_bitwise("llama3.2-3b")


def test_rope_fault_fails_the_gate():
    _, _, _, toks, prefix, _, jgrads = _jax_case("llama3.2-3b")
    model = _port_model("llama3.2-3b")
    with chip_smoke.train_fault(model.layers[1], "rope"):
        _, grads = _port_grads(model, toks, prefix)
    rel = _rel_l2(model, grads, jgrads)
    assert {n for n, r in rel.items() if r > GRAD_RTOL} >= {"layers.1.wq", "layers.1.wk"}
