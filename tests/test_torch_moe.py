"""The port's MoE FFN (``repro_torch.models.moe.moe_ffn``) against JAX's
``repro.models.moe.moe_ffn`` (``impl="einsum"``, the path JAX serves) on
the same numpy-seeded inputs and weights, on the CPU.

Expert ids and queue positions must be exactly JAX's (``lax.top_k``'s
order: the lower expert index first among equal probabilities), the same
picks dropped; outputs within 1e-5 at f32.  At bf16 the two cannot agree
within one bf16 step per element: XLA rounds its bf16 SiLU otherwise than
torch, and where a token's expert terms cancel JAX's own bf16 output lies
up to ~150 such steps from JAX's f32 output on the same bf16 inputs.  So
at bf16 every row must be within the row half of the bf16 rule of
``repro_torch.kernels.parity`` (1e-2 relative L2) of JAX's bf16 row, the
port's largest relative L2 distance from JAX's f32 output (same bf16
inputs and weights) at most ``BF16_VS_JAX`` times JAX's own, and a token
whose every pick was dropped zero.  Cases: the smoke variant's lossless capacity; granite's published
40 experts top-8 at capacity factor 1.25 (lossy) on a 512-token group, on
a 300-of-512 padded chunk buffer (``n_tokens``: the port routes the live
rows only, JAX the whole buffer) and on a decode step (``group_size =
B``); a router with tied columns; several groups; all four activations;
and a token count that does not split into equal groups, which JAX's
reshape refuses and the port refuses with a ``ValueError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.models import moe as jmoe

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import to_torch
from repro_torch.kernels import parity
from repro_torch.models import moe_check
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import DecoderLayer

F32_ATOL = 1e-5
BF16_VS_JAX = 1.25
GRANITE = "granite-moe-3b-a800m"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch=GRANITE, smoke=False, dtype="float32", d=64, ff=32, **kw):
    """(JAX, port) configs of ``arch`` at width ``d`` / ``ff`` (the smoke
    variant's with ``smoke``), overridden by ``kw``."""
    j, t = j_get_config(arch), t_get_config(arch)
    if smoke:
        j, t = j_smoke(j), t_smoke(t)
    over = dict(d_model=d, d_ff=ff, dtype=dtype, **kw)
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def weights(jcfg, tcfg, seed=0, tie=None):
    """JAX's ``init_moe`` parameters and a port layer holding the same
    weights; ``tie`` (pairs of expert ids) copies router columns so their
    probabilities are equal."""
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    if tie:
        w = np.array(p["router"]["w"])
        for a, b in tie:
            w[:, b] = w[:, a]
        p = dict(p, router={"w": jnp.asarray(w)})
    layer = DecoderLayer(tcfg, getattr(torch, tcfg.dtype), "cpu")
    with torch.no_grad():
        layer.router.copy_(to_torch(np.asarray(p["router"]["w"])))
        for name in ("up", "gate", "down"):
            if name in p:
                getattr(layer, name).copy_(to_torch(np.asarray(p[name])))
    assert (layer.gate is None) == ("gate" not in p)
    assert layer.router.dtype == torch.float32
    return p, layer


def inputs(shape, dtype, seed=1, skew=0.0):
    """Seeded activations; ``skew`` adds one shared direction to every
    token, so the router favours a few experts and their queues overflow."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x += skew * rng.standard_normal(shape[-1]).astype(np.float32)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    return xj, to_torch(np.asarray(xj))


def jax_routing(p, x, cfg, group_size):
    """JAX's picks for ``x`` [B, S, d]: (expert ids, positions, kept), each
    [G, gt, K], by ``moe_ffn``'s own router and its einsum positions."""
    moe = cfg.moe
    E, K = moe.n_experts, moe.experts_per_token
    B, S, d = x.shape
    T = B * S
    G = max(1, T // group_size)
    gt = T // G
    _, top_e, _ = jmoe._router(p, x.reshape(G, gt, d), E, K)
    onehot = jax.nn.one_hot(top_e, E, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot.reshape(G, gt * K, E), axis=1) - 1).reshape(G, gt, K, E)
    pos = (pos * onehot).sum(-1)
    C = tmoe.capacity(gt, E, K, moe.capacity_factor)
    return np.asarray(top_e), np.asarray(pos), np.asarray(pos) < C


def check(jcfg, tcfg, p, layer, xj, xt, group_size=512, live=None):
    """Both FFNs on the same inputs (the port on the first ``live`` rows of
    a one-sequence buffer) -> the number of dropped picks among the rows
    held."""
    yj, _ = jmoe.moe_ffn(p, xj, jcfg, group_size=group_size)
    routing = {}
    if live is None:
        yt = tmoe.moe_ffn(layer, xt, tcfg, group_size=group_size, routing=routing)
        rows = slice(None)
    else:
        yt = tmoe.moe_ffn(layer, xt[:, :live], tcfg, group_size=group_size,
                          n_tokens=xt.shape[1], routing=routing)
        rows = slice(0, live)
    e, pos, kept = jax_routing(p, xj, jcfg, group_size)
    K = jcfg.moe.experts_per_token
    flat = lambda a: a.reshape(-1, K)[rows]
    np.testing.assert_array_equal(flat(routing["experts"].numpy()), flat(e))
    np.testing.assert_array_equal(flat(routing["positions"].numpy()), flat(pos))
    np.testing.assert_array_equal(flat(routing["kept"].numpy()), flat(kept))
    want = np.asarray(yj.astype(jnp.float32))[:, rows]
    got = yt.float().numpy()
    assert got.shape == want.shape and yt.dtype == xt.dtype
    if tcfg.dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        f32 = lambda a: a.astype(jnp.float32)
        p32 = {k: ({"w": f32(v["w"])} if isinstance(v, dict) else f32(v))
               for k, v in p.items()}
        exact = np.asarray(jmoe.moe_ffn(p32, f32(xj), dataclasses.replace(
            jcfg, dtype="float32"), group_size=group_size)[0])[:, rows]
        norm = np.linalg.norm(exact, axis=-1)
        live = norm > 0
        assert not np.any(got[~live]) and not np.any(want[~live])
        rel = lambda a, b: np.linalg.norm(a - b, axis=-1)[live] / norm[live]
        assert rel(got, want).max() <= parity.REL_L2
        assert rel(got, exact).max() <= BF16_VS_JAX * rel(want, exact).max()
    return int((~flat(kept)).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_capacity_is_lossless(dtype):
    jcfg, tcfg = cfgs(smoke=True, dtype=dtype)
    assert dataclasses.astuple(tcfg.moe) == dataclasses.astuple(jcfg.moe)
    assert (tcfg.moe.n_experts, tcfg.moe.experts_per_token) == (4, 2)
    p, layer = weights(jcfg, tcfg)
    xj, xt = inputs((2, 48, 64), dtype, skew=2.0)
    assert check(jcfg, tcfg, p, layer, xj, xt) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_published_capacity_drops_as_jax(dtype):
    """40 experts top-8, capacity factor 1.25: C = 128 places for 512 x 8
    picks; a skewed router overflows some queues."""
    jcfg, tcfg = cfgs(dtype=dtype)
    assert tcfg.moe.capacity_factor == 1.25 and tcfg.moe.n_experts == 40
    assert tmoe.capacity(512, 40, 8, 1.25) == 128
    p, layer = weights(jcfg, tcfg)
    xj, xt = inputs((1, 512, 64), dtype, skew=1.5)
    assert check(jcfg, tcfg, p, layer, xj, xt) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_chunk_buffer_routes_as_jax(dtype):
    """A last prefill chunk: 300 live rows of a 512-row buffer.  JAX routes
    the whole buffer (its padding rows hold other values); the port only
    the live rows, with groups and capacity from the buffer's 512."""
    jcfg, tcfg = cfgs(dtype=dtype)
    p, layer = weights(jcfg, tcfg, seed=4)
    xj, xt = inputs((1, 512, 64), dtype, seed=5, skew=1.5)
    assert check(jcfg, tcfg, p, layer, xj, xt, live=300) > 0
    # routing only the live rows as a group of their own would size the
    # queues at int(1.25 * 300 * 8 / 40) = 75 places, not 128
    assert tmoe.capacity(300, 40, 8, 1.25) == 75


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_groups_by_batch(dtype):
    """Decode: one group of the B slots (``group_size = B``)."""
    jcfg, tcfg = cfgs(dtype=dtype)
    p, layer = weights(jcfg, tcfg, seed=6)
    xj, xt = inputs((4, 1, 64), dtype, seed=7, skew=3.0)
    assert tmoe.groups(4, 4) == (1, 4) and tmoe.capacity(4, 40, 8, 1.25) == 4
    assert check(jcfg, tcfg, p, layer, xj, xt, group_size=4) == 0


def test_tied_router_columns_pick_the_lower_expert():
    jcfg, tcfg = cfgs(n_layers=2)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, n_experts=8,
                                                               experts_per_token=2))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, n_experts=8,
                                                               experts_per_token=2))
    p, layer = weights(jcfg, tcfg, seed=8, tie=[(1, 5), (1, 6), (3, 2), (0, 7)])
    xj, xt = inputs((1, 256, 64), "float32", seed=9, skew=1.0)
    check(jcfg, tcfg, p, layer, xj, xt)
    routing = {}
    tmoe.moe_ffn(layer, xt, tcfg, routing=routing)
    e = routing["experts"].reshape(-1, 2)
    # equal probabilities: the lower index is picked first, and a tied
    # higher index only with it
    assert bool((e[:, 0] != 5).all() and (e[:, 0] != 6).all())
    probs = routing["probs"].reshape(-1, 8)
    assert torch.equal(probs[:, 1], probs[:, 5]) and torch.equal(probs[:, 3], probs[:, 2])
    assert bool(((e == 1).any(-1)).any())


def test_several_groups():
    jcfg, tcfg = cfgs()
    p, layer = weights(jcfg, tcfg, seed=10)
    xj, xt = inputs((2, 512, 64), "float32", seed=11, skew=1.5)
    assert tmoe.groups(1024, 256) == (4, 256)
    assert check(jcfg, tcfg, p, layer, xj, xt, group_size=256) > 0


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu2", "gelu"])
def test_activations(activation):
    jcfg, tcfg = cfgs(arch="grok-1-314b", smoke=True, activation=activation)
    assert (tcfg.moe.n_experts, tcfg.moe.experts_per_token) == (4, 2)
    p, layer = weights(jcfg, tcfg, seed=12)
    xj, xt = inputs((1, 64, 64), "float32", seed=13)
    check(jcfg, tcfg, p, layer, xj, xt, group_size=16)


def test_uneven_groups_raise_as_jax():
    """1101 tokens at group size 512: G = 2 does not divide T."""
    jcfg, tcfg = cfgs(smoke=True)
    p, layer = weights(jcfg, tcfg)
    xj, xt = inputs((1, 1101, 64), "float32")
    with pytest.raises(TypeError):
        jmoe.moe_ffn(p, xj, jcfg)
    with pytest.raises(ValueError, match="must divide T"):
        tmoe.moe_ffn(layer, xt, tcfg)
    # 1100 tokens split into two groups of 550, in both
    check(jcfg, tcfg, p, layer, xj[:, :1100], xt[:, :1100])


def test_compare_moe_ffn_holds_and_fails_a_faulty_run(monkeypatch):
    """``moe_check.compare_moe_ffn`` (the card's check against the CPU's f32
    run) passes for the function itself on a 300-of-512 buffer at the
    published capacity, counting the live rows' drops, and fails when the
    first run's output is off by 3% or one of its picks moves to another
    expert."""
    jcfg, tcfg = cfgs(dtype="bfloat16")
    _, layer = weights(jcfg, tcfg, seed=14)
    _, xt = inputs((1, 512, 64), "bfloat16", seed=15, skew=1.5)
    res = moe_check.compare_moe_ffn(layer, xt[:, :300], tcfg, n_tokens=512)
    assert res["tie_tokens"] == 0 and res["picks_held"] == res["picks"] == 4096
    assert 0 < res["dropped"] == res["dropped_f32"] < 300 * 8
    orig_ffn, orig_route = tmoe.moe_ffn, tmoe.route
    calls = []

    def scaled(*args, **kw):
        calls.append(1)
        y = orig_ffn(*args, **kw)
        return y * 1.03 if len(calls) == 1 else y

    monkeypatch.setattr(tmoe, "moe_ffn", scaled)
    with pytest.raises(AssertionError, match="relative L2"):
        moe_check.compare_moe_ffn(layer, xt, tcfg)
    monkeypatch.setattr(tmoe, "moe_ffn", orig_ffn)

    def moved(*args):
        top_p, top_e, probs = orig_route(*args)
        if not calls:
            top_e = top_e.clone()
            top_e[0, 5, 0] = (top_e[0, 5, 0] + 1) % 40
        calls.append(1)
        return top_p, top_e, probs

    calls.clear()
    monkeypatch.setattr(tmoe, "route", moved)
    with pytest.raises(AssertionError, match="other experts"):
        moe_check.compare_moe_ffn(layer, xt, tcfg)
