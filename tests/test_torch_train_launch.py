"""The port's restart path and training launcher on the CPU (llama3.2-3b's
smoke variant, f32, ``test_torch_trainer.py``'s sizes):

- a failure injected at step 8 and the restart from the step-5
  checkpoint end bitwise where the uninterrupted run ends (losses,
  parameters, m and v);
- ``checkpoint_dir`` None writes nothing;
- the launcher in process (``main``): a run, a ``--no-resume`` run that
  starts afresh in an empty directory (the same losses) and refuses the
  first run's (JAX's launcher parses the flag and resumes all the same),
  and a longer run that resumes; a directory that holds another run's
  later checkpoint: ``--no-resume`` refuses it and leaves it as it was,
  a resume past ``--steps`` trains nothing and says so; as a subprocess,
  ``--device cpu --smoke --no-resume`` with a failure injected (one
  restart, from this run's own checkpoint; exit 0, checkpoints at steps
  5 and 6).

About 15 s in one process, 40 s under the tier-1 run's six workers.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.config import TrainConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import train as launch_train
from repro_torch.training.train_loop import Trainer, run_with_restarts

from test_torch_dense_family import _one_thread  # noqa: F401
from test_torch_trainer import ARCH, _cfgs, _data

ROOT = Path(__file__).resolve().parents[1]


def test_injected_failure_restart_is_bitwise(tmp_path):
    cfg = smoke_variant(get_config(ARCH))
    dc, _ = _data()
    tc, _ = _cfgs(tmp_path / "a")
    failing = Trainer(cfg, tc, dc, inject_failure_at=8, device="cpu")
    out_a = run_with_restarts(failing, 12)
    assert out_a["fault_log"].failures == [8] and out_a["fault_log"].restarts == 1
    assert len(out_a["losses"]) == 12 - 5
    tc, _ = _cfgs(tmp_path / "b")
    out_b = Trainer(cfg, tc, dc, device="cpu").run(12, resume=False)
    assert out_a["losses"] == out_b["losses"][5:]
    for name, p in out_b["state"]["params"].items():
        assert torch.equal(out_a["state"]["params"][name], p), name
    for tree in ("m", "v"):
        for name, t in getattr(out_b["state"]["opt"], tree).items():
            assert torch.equal(getattr(out_a["state"]["opt"], tree)[name], t), name


def test_no_checkpoint_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = smoke_variant(get_config(ARCH))
    dc, _ = _data()
    tc = TrainConfig(checkpoint_dir=None, checkpoint_every=1, warmup_steps=1, total_steps=2)
    out = Trainer(cfg, tc, dc, device="cpu").run(2)
    assert len(out["losses"]) == 2 and os.listdir(tmp_path) == []


SMALL = ["--smoke", "--device", "cpu", "--seq-len", "64", "--global-batch", "2"]


def test_launcher_no_resume_starts_afresh(tmp_path, capsys):
    base = SMALL + ["--ckpt-dir", str(tmp_path / "a")]
    first = launch_train.main(base + ["--steps", "6"])
    again = launch_train.main(SMALL + ["--ckpt-dir", str(tmp_path / "b"), "--steps", "6",
                                       "--no-resume"])
    assert again["fault_log"].restarts == 0 and again["losses"] == first["losses"]
    with pytest.raises(ValueError, match="empty checkpoint directory"):
        launch_train.main(base + ["--steps", "6", "--no-resume"])
    longer = launch_train.main(base + ["--steps", "7"])
    assert longer["fault_log"].restarts == 1 and len(longer["losses"]) == 1
    assert "restarts=1" in capsys.readouterr().out.splitlines()[-1]


def test_launcher_with_a_stale_later_checkpoint(tmp_path, capsys):
    """Another run's step-20 checkpoint in the directory: ``--no-resume``
    neither trains nor prunes it; a resume lands past ``--steps 6``."""
    stale = tmp_path / "ckpt"
    launch_train.main(SMALL + ["--ckpt-dir", str(stale), "--steps", "20"])
    kept = sorted(os.listdir(stale))
    assert kept[-1] == "step_00000020"
    with pytest.raises(ValueError, match="holds step 20's checkpoint"):
        launch_train.main(SMALL + ["--ckpt-dir", str(stale), "--steps", "6", "--no-resume",
                                   "--inject-failure-at", "3"])
    assert sorted(os.listdir(stale)) == kept
    out = launch_train.main(SMALL + ["--ckpt-dir", str(stale), "--steps", "6"])
    assert out["losses"] == [] and out["fault_log"].restarts == 1
    assert capsys.readouterr().out.splitlines()[-1].startswith("nothing to train")


def test_launcher_subprocess_restarts(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--steps", "6", "--seq-len", "64", "--global-batch", "2", "--ckpt-dir",
         str(tmp_path), "--inject-failure-at", "5", "--no-resume"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1].endswith("restarts=1 stragglers=0")
    assert sorted(os.listdir(tmp_path)) == ["step_00000005", "step_00000006"]
