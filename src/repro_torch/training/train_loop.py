"""Fault-tolerant training loop (counterpart of ``repro.training.train_loop``).

- **train step**: loss (chunked CE, plus the MoE aux loss) -> gradients by
  autograd -> AdamW in place; with ``MeshPlan.grad_accum > 1`` the batch
  splits into micro-batches whose gradients are summed in f32 and
  averaged, as JAX's scan does.
- **checkpoint / restart**: atomic checkpoints every
  ``checkpoint_every`` steps and at the last; ``run`` resumes from the
  latest, and the deterministic data pipeline replays the same batches.
- **straggler watchdog**: steps slower than ``straggler_factor`` x the
  running median are recorded in the fault log.
- **simulated failures**: ``inject_failure_at`` raises once mid-run, to
  drive the restart path (:func:`run_with_restarts`).

The model's parameters are the live state: the trainer turns gradients on
for its model's float parameters (the port creates them without), and a
state passed to :meth:`Trainer.run` is copied into them.  The loss goes to
the host every step, as JAX's ``device_get`` does, so step times are
device times.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config import MeshPlan, ModelConfig, TrainConfig
from repro_torch.models import Transformer
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, DataIterator
from repro_torch.training.optimizer import OptState, adamw_update, init_opt_state


@dataclass
class FaultLog:
    stragglers: List[Dict] = field(default_factory=list)
    restarts: int = 0
    failures: List[int] = field(default_factory=list)


def trainable(model: Transformer) -> Dict[str, torch.nn.Parameter]:
    """Turn gradients on for ``model``'s float parameters -> them by name
    (the trees of :class:`~repro_torch.training.optimizer.OptState`)."""
    params = {}
    for name, p in model.named_parameters():
        if p.is_floating_point():
            p.requires_grad_(True)
            params[name] = p
    return params


def loss_and_grads(model: Transformer, params: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, plan: MeshPlan,
                   prefix_fn: Optional[Callable] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, gradients by name): in the parameters' dtypes for one
    batch, or f32 averages over ``plan.grad_accum`` micro-batches (rows of
    ``tokens`` in order)."""

    def one(tb):
        prefix = prefix_fn(tb) if prefix_fn is not None else None
        loss = model.loss(tb, prefix, remat=plan.remat)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), dict(zip(params, grads))

    if plan.grad_accum <= 1:
        return one(tokens)
    B = tokens.shape[0]
    if B % plan.grad_accum:
        raise ValueError(f"batch {B} does not split into {plan.grad_accum} micro-batches")
    micro = B // plan.grad_accum
    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    grad_sum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    for i in range(plan.grad_accum):
        loss, grads = one(tokens[i * micro:(i + 1) * micro])
        loss_sum = loss_sum + loss
        for n, g in grads.items():
            grad_sum[n].add_(g.to(torch.float32))
        del grads
    for g in grad_sum.values():
        g.div_(plan.grad_accum)
    return loss_sum / plan.grad_accum, grad_sum


def make_train_step(model: Transformer, train_cfg: TrainConfig, plan: MeshPlan,
                    prefix_fn: Optional[Callable] = None):
    """-> ``train_step(opt_state, tokens) -> (opt_state, metrics)``, which
    updates the model's parameters in place."""
    params = trainable(model)

    def train_step(opt_state: OptState, tokens: torch.Tensor):
        loss, grads = loss_and_grads(model, params, tokens, plan, prefix_fn)
        opt_state, metrics = adamw_update(train_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step


class Trainer:
    """JAX's ``Trainer`` on one device (``"cuda"`` unless ``device`` says
    otherwise): its model, state, data, watchdog and checkpoints."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        data_cfg: DataConfig,
        plan: Optional[MeshPlan] = None,
        inject_failure_at: Optional[int] = None,
        n_data_shards: int = 1,
        device="cuda",
    ):
        self.model = Transformer(model_cfg, device=device)
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.data_cfg = data_cfg
        self.plan = plan or MeshPlan()
        self.fault_log = FaultLog()
        self.inject_failure_at = inject_failure_at
        self.n_data_shards = n_data_shards
        self.params = trainable(self.model)
        self._step_fn = make_train_step(self.model, train_cfg, self.plan)
        #: wall seconds of each step run, loss on the host included
        self.durations: List[float] = []

    # -- state --------------------------------------------------------------

    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights from a ``torch.Generator`` seeded ``seed`` on the
        model's device (:meth:`Transformer.init`), a fresh optimizer state
        -> ``{"params", "opt"}`` (the params are the model's own)."""
        self.model.init(torch.Generator(device=self.model.device).manual_seed(seed))
        return {"params": self.params,
                "opt": init_opt_state(self.params, self.plan.grad_compression)}

    @torch.no_grad()
    def _install(self, state: Dict[str, Any]) -> Dict[str, Any]:
        for name, p in self.params.items():
            if state["params"][name] is not p:
                p.copy_(state["params"][name])
        return {"params": self.params, "opt": state["opt"]}

    # -- fault hooks ----------------------------------------------------------

    def _watchdog(self, step: int, dt: float):
        self.durations.append(dt)
        if len(self.durations) >= 5:
            med = sorted(self.durations)[len(self.durations) // 2]
            if dt > self.train_cfg.straggler_factor * med:
                self.fault_log.stragglers.append(
                    {"step": step, "duration": dt, "median": med}
                )

    # -- main loop -------------------------------------------------------------

    def run(self, steps: int, state=None, resume: bool = True) -> Dict[str, Any]:
        cfg = self.train_cfg
        state = self.init_state(cfg.seed) if state is None else self._install(state)
        start = 0
        if resume and cfg.checkpoint_dir is not None:
            got_step, got = ckpt.restore_checkpoint(cfg.checkpoint_dir, state)
            if got is not None:
                state, start = got, got_step
                self.fault_log.restarts += 1

        it = DataIterator(self.data_cfg, self.n_data_shards, device=self.model.device)
        it.seek(start)
        losses = []
        for step in range(start, steps):
            if self.inject_failure_at is not None and step == self.inject_failure_at:
                self.inject_failure_at = None  # fire once
                self.fault_log.failures.append(step)
                raise RuntimeError(f"injected node failure at step {step}")
            tokens = it.next()
            t0 = time.monotonic()
            opt, metrics = self._step_fn(state["opt"], tokens)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            self._watchdog(step, dt)
            state = {"params": self.params, "opt": opt}
            losses.append(loss)
            if cfg.checkpoint_dir is not None and (
                    (step + 1) % cfg.checkpoint_every == 0 or step + 1 == steps):
                ckpt.save_checkpoint(cfg.checkpoint_dir, step + 1, state)
                ckpt.prune_checkpoints(cfg.checkpoint_dir, cfg.keep_checkpoints)
        return {"state": state, "losses": losses, "fault_log": self.fault_log}


def run_with_restarts(trainer: Trainer, steps: int, max_restarts: int = 3,
                      resume: bool = True):
    """Survive (injected or real) failures by restarting from the latest
    checkpoint, the single-host analogue of a cluster supervisor.
    ``resume`` False starts the first run afresh (JAX always resumes) and
    refuses a checkpoint directory that already holds a checkpoint, so a
    restart resumes only from what this run wrote, and retention never
    weighs this run's checkpoints against another's."""
    ckpt_dir = trainer.train_cfg.checkpoint_dir
    if not resume and ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
        raise ValueError(
            f"not resuming, but {ckpt_dir} holds step {ckpt.latest_step(ckpt_dir)}'s "
            "checkpoint: give an empty checkpoint directory")
    attempts = 0
    while True:
        try:
            return trainer.run(steps, resume=resume or attempts > 0)
        except RuntimeError:
            attempts += 1
            if attempts > max_restarts:
                raise
