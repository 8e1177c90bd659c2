"""The port's training substrate against JAX's, part by part, on the CPU:

- ``MeshPlan`` and ``TrainConfig`` carry JAX's fields and defaults (the
  checkpoint directory apart: the port's own, never JAX's);
- ``batch_for_step`` bitwise JAX's for several (seed, step, shard,
  shards), with and without the copy structure, and ``DataIterator``'s
  replay after ``seek``;
- ``lr_schedule`` over warmup, cosine and past the end; ``clip_by_global_norm``
  (its factor times each gradient equals JAX's clipped tree, above and
  below the limit); ``compress_int8`` (codes and scale equal, residual
  within an f32 rounding); three ``adamw_update`` steps in f32 and with
  bf16 parameters and their f32 master (parameters, m, v and master);
- checkpoints: a stale ``.tmp`` never counts as the latest and is
  replaced, retention keeps the newest, a restore is bitwise (bf16, f32,
  ints, Nones) into the like state's tensors, and a shape, dtype or kind
  that differs raises.

About 10 s in one process and under the tier-1 run's six workers.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MeshPlan as JMeshPlan
from repro.config import TrainConfig as JTrainConfig
from repro.training import data as jdata
from repro.training import optimizer as jopt

from repro_torch.config import MeshPlan, TrainConfig
from repro_torch.convert import to_numpy, to_torch
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data, optimizer

from test_torch_dense_family import _one_thread  # noqa: F401


def test_configs_carry_jax_fields():
    for jcls, tcls in ((JMeshPlan, MeshPlan), (JTrainConfig, TrainConfig)):
        jf = {f.name: f.default for f in dataclasses.fields(jcls)}
        tf = {f.name: f.default for f in dataclasses.fields(tcls)}
        assert set(jf) == set(tf)
        for name in jf:
            if name != "checkpoint_dir":
                assert jf[name] == tf[name], name
    assert TrainConfig().checkpoint_dir != JTrainConfig().checkpoint_dir


@pytest.mark.parametrize("seq_len,seed,step,shard,n_shards", [
    (256, 0, 0, 0, 1), (256, 3, 17, 2, 4), (100, 1, 5, 1, 2), (64, 0, 9, 0, 1)])
def test_batch_for_step_bitwise_jax(seq_len, seed, step, shard, n_shards):
    jc = jdata.DataConfig(vocab_size=1000, seq_len=seq_len, global_batch=8, seed=seed)
    tc = data.DataConfig(vocab_size=1000, seq_len=seq_len, global_batch=8, seed=seed)
    want = np.asarray(jdata.batch_for_step(jc, step, shard, n_shards))
    got = data.batch_for_step(tc, step, shard, n_shards, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_data_iterator_replays_after_seek():
    tc = data.DataConfig(vocab_size=500, seq_len=128, global_batch=4)
    it = data.DataIterator(tc, device="cpu")
    first = [it.next() for _ in range(4)]
    it.seek(2)
    assert torch.equal(it.next(), first[2]) and it.step == 3
    with pytest.raises(ValueError):
        data.batch_for_step(tc, 0, 0, 3, device="cpu")


def test_lr_schedule_matches_jax():
    for cfg in (TrainConfig(warmup_steps=10, total_steps=100, learning_rate=1e-3),
                TrainConfig(warmup_steps=2, total_steps=20)):
        jc = JTrainConfig(warmup_steps=cfg.warmup_steps, total_steps=cfg.total_steps,
                          learning_rate=cfg.learning_rate)
        for s in (0, 1, 2, 5, 10, 11, 50, 99, 100, 150):
            want = float(jopt.lr_schedule(jc, jnp.asarray(s, jnp.int32)))
            assert optimizer.lr_schedule(cfg, s) == pytest.approx(want, rel=1e-6), s


def _tree(seed, shapes, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * scale).astype(dtype) for n, s in shapes.items()}


SHAPES = {"a": (16, 8), "b": (8,), "c": (3, 4, 5)}


@pytest.mark.parametrize("scale", [1.0, 0.01], ids=["clipped", "unclipped"])
def test_clip_by_global_norm_matches_jax(scale):
    g = _tree(0, SHAPES, scale=scale)
    want, want_norm = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    factor, norm = optimizer.clip_by_global_norm({k: torch.as_tensor(v) for k, v in g.items()},
                                                 1.0)
    assert float(norm) == pytest.approx(float(want_norm), rel=1e-6)
    assert (float(factor) < 1.0) == (scale == 1.0)
    for k, v in g.items():
        np.testing.assert_allclose((torch.as_tensor(v) * factor).numpy(),
                                   np.asarray(want[k]), rtol=1e-6, atol=0)


def test_compress_int8_matches_jax():
    rng = np.random.default_rng(1)
    g = rng.standard_normal(300).astype(np.float32)
    res = (rng.standard_normal(300) * 1e-3).astype(np.float32)
    jq, js, jr = jopt.compress_int8(jnp.asarray(g), jnp.asarray(res))
    q, s, r = optimizer.compress_int8(torch.as_tensor(g), torch.as_tensor(res))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """Three steps from fresh state (so m and v are nonzero and the bias
    corrections move) with JAX's defaults, a large and a small gradient."""
    jdt = jnp.dtype(dtype)
    p0 = {k: np.asarray(jnp.asarray(v, jnp.float32).astype(jdt))
          for k, v in _tree(2, SHAPES).items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: to_torch(v) for k, v in p0.items()}
    cfg = TrainConfig(warmup_steps=1, total_steps=10, learning_rate=1e-2)
    jcfg = JTrainConfig(warmup_steps=1, total_steps=10, learning_rate=1e-2)
    jstate, tstate = jopt.init_opt_state(jp), optimizer.init_opt_state(tp)
    assert (tstate.master["a"] is None) == (dtype == "float32")
    for i, scale in enumerate((3.0, 0.01, 1.0)):
        g = {k: np.asarray(jnp.asarray(v).astype(jdt))
             for k, v in _tree(10 + i, SHAPES, scale=scale).items()}
        jp, jstate, jm = jopt.adamw_update(jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()},
                                           jstate)
        tstate, tm = optimizer.adamw_update(cfg, tp, {k: to_torch(v) for k, v in g.items()},
                                            tstate)
        assert tstate.step == int(jstate.step) == i + 1
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    for k in SHAPES:
        for name, want, got in (("m", jstate.m[k], tstate.m[k]), ("v", jstate.v[k], tstate.v[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9,
                                       err_msg=f"{name} {k}")
        if dtype == "bfloat16":
            np.testing.assert_allclose(tstate.master[k].numpy(), np.asarray(jstate.master[k]),
                                       rtol=1e-6, err_msg=f"master {k}")
            # the bf16 params are the masters rounded: equal, or one bf16 step
            # apart where the masters straddle a rounding boundary
            got = tp[k].float().numpy()
            want = np.asarray(jp[k].astype(jnp.float32))
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
            assert np.mean(got == want) > 0.9
        else:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


# -- checkpoints ---------------------------------------------------------------------


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(4, 6, generator=gen).to(torch.bfloat16),
              "b": torch.randn(6, generator=gen)}
    opt = optimizer.init_opt_state(params)
    opt.m["w"].normal_(generator=gen)
    return {"params": params, "opt": opt._replace(step=7)}


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    d = str(tmp_path)
    state = _state(0)
    path = ckpt.save_checkpoint(d, 7, state)
    assert os.path.basename(path) == "step_00000007"
    like = _state(1)
    w_like = like["params"]["w"]
    step, got = ckpt.restore_checkpoint(d, like)
    assert step == 7 and got["opt"].step == 7
    assert got["params"]["w"] is w_like                  # restored in place
    for (k, a), (_, b) in zip(ckpt.flatten(state), ckpt.flatten(got)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        else:
            assert a == b, k
    np.testing.assert_array_equal(to_numpy(state["params"]["w"]),
                                  np.load(os.path.join(path, "arrays.npz"))["params/w"])


def test_checkpoint_restore_checks_shapes_dtypes_kinds(tmp_path):
    d = str(tmp_path)
    assert ckpt.restore_checkpoint(d, _state()) == (None, None)
    ckpt.save_checkpoint(d, 1, _state())
    for mutate in (lambda s: s["params"].__setitem__("b", torch.zeros(5)),
                   lambda s: s["params"].__setitem__("b", torch.zeros(6, dtype=torch.bfloat16)),
                   lambda s: s["opt"].master.__setitem__("b", torch.zeros(6))):
        like = _state()
        mutate(like)
        with pytest.raises(ValueError):
            ckpt.restore_checkpoint(d, like)


def test_checkpoint_atomicity_and_retention(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 3, _state())
    # a write that crashed after step 3: its .tmp is never the latest
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.latest_step(d) == 3
    ckpt.save_checkpoint(d, 9, _state())
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000009"]
    for s in (12, 15, 18):
        ckpt.save_checkpoint(d, s, _state())
        ckpt.prune_checkpoints(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000015", "step_00000018"]
    assert ckpt.latest_step(d) == 18
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
