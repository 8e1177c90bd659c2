"""The port's trainer against JAX's on the CPU (llama3.2-3b's smoke
variant, f32, JAX's test sizes: global batch 4 of 128 tokens, lr 1e-3,
warmup 2, checkpoints every 5 steps):

- from one state (JAX's ``Trainer.init_state`` carried over by
  ``train_state_from_jax``), 10 steps of the port's ``Trainer`` against
  JAX's: every loss within 1e-4 relative, the parameters after them within
  1e-3 relative L2;
- ``grad_accum`` 2 against JAX's ``grad_accum`` 2 (losses 1e-4) and
  against the port's ``grad_accum`` 1 (losses 1e-4, as JAX's own test
  holds its two at 2e-3);
- the same checkpoints written at the same steps.

The restart path and the launcher are in ``test_torch_train_launch.py``.
About 20 s in one process, 25 s under the tier-1 run's six workers.
"""
import os

import jax
import numpy as np

from repro.config import MeshPlan as JMeshPlan
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.training.data import DataConfig as JDataConfig
from repro.training.train_loop import Trainer as JTrainer

from repro_torch.config import MeshPlan, TrainConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import jax_leaf, train_state_from_jax
from repro_torch.training.data import DataConfig
from repro_torch.training.train_loop import Trainer

from test_torch_dense_family import _one_thread  # noqa: F401

ARCH = "llama3.2-3b"
STEPS, LOSS_RTOL, PARAM_RTOL = 10, 1e-4, 1e-3


def _cfgs(ckpt_dir, **kw):
    tc = dict(checkpoint_every=5, total_steps=30, warmup_steps=2, learning_rate=1e-3)
    return (TrainConfig(checkpoint_dir=str(ckpt_dir / "port"), **tc, **kw),
            JTrainConfig(checkpoint_dir=str(ckpt_dir / "jax"), **tc, **kw))


def _data():
    return (DataConfig(vocab_size=256, seq_len=128, global_batch=4),
            JDataConfig(vocab_size=256, seq_len=128, global_batch=4))


def _port_run(tmp_path, jtree, grad_accum):
    """The port's run of ``STEPS`` from JAX's state ``jtree`` (numpy)."""
    tc, _ = _cfgs(tmp_path)
    dc, _ = _data()
    cfg = smoke_variant(get_config(ARCH))
    model, opt = train_state_from_jax(jtree, cfg, device="cpu")
    tr = Trainer(cfg, tc, dc, MeshPlan(grad_accum=grad_accum), device="cpu")
    return tr.run(STEPS, state={"params": dict(model.named_parameters()), "opt": opt},
                  resume=False)


def _both(tmp_path, grad_accum):
    """(JAX's run, the port's run from JAX's initial state, that state)."""
    _, jtc = _cfgs(tmp_path)
    _, jdc = _data()
    jtr = JTrainer(j_smoke(j_get_config(ARCH)), jtc, jdc, JMeshPlan(grad_accum=grad_accum))
    jstate = jtr.init_state()
    jtree = jax.tree.map(np.asarray, jstate)
    out = _port_run(tmp_path, jtree, grad_accum)
    return jtr.run(STEPS, state=jstate, resume=False), out, jtree


def test_trainer_follows_jax_from_one_state(tmp_path):
    jout, out, _ = _both(tmp_path, 1)
    cfg = smoke_variant(get_config(ARCH))
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=LOSS_RTOL)
    assert out["losses"][-1] < out["losses"][0] - 0.1
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32), jout["state"]["params"])
    for name, p in out["state"]["params"].items():
        want = jax_leaf(jparams, cfg, name)
        rel = np.linalg.norm(p.detach().numpy() - want) / np.linalg.norm(want)
        assert rel <= PARAM_RTOL, name
    assert out["state"]["opt"].step == int(jout["state"]["opt"].step) == STEPS
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_grad_accum_matches_jax_and_full_batch(tmp_path):
    jout, out, jtree = _both(tmp_path, 2)
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=LOSS_RTOL)
    full = _port_run(tmp_path / "one", jtree, 1)
    np.testing.assert_allclose(out["losses"], full["losses"], rtol=LOSS_RTOL)
