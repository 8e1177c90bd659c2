"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 100 [--smoke] [--grad-accum 2] [--device cpu]

``--smoke`` trains the reduced same-family config (CPU-runnable with
``--device cpu``); without it the full config.  The loop checkpoints
atomically to ``--ckpt-dir``, resumes from the latest checkpoint, restarts
after a failure and logs straggler events.  Weights are random
(``Trainer.init_state``, a generator seeded 0 on the device).

Divergences from JAX's launcher, on purpose: ``--no-resume`` is honoured
(the first run starts afresh and refuses a ``--ckpt-dir`` that already
holds a checkpoint; a restart after a failure still resumes, from this
run's checkpoints), where JAX parses it and ignores it;
``--inject-failure-at STEP`` raises once at that step, to drive the
restart path; ``--device`` picks the device (``cuda`` by default); a
resume from a checkpoint at or past ``--steps`` trains nothing and says
so.
"""
from __future__ import annotations

import argparse

from repro_torch.config import MeshPlan, TrainConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.training.data import DataConfig
from repro_torch.training.train_loop import Trainer, run_with_restarts


def main(argv=None):
    """Parse ``argv`` (default: ``sys.argv[1:]``), train, print the
    summary -> the run's output (``Trainer.run``'s dict)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=TrainConfig.checkpoint_dir)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    seq = args.seq_len or (256 if args.smoke else 4096)
    gb = args.global_batch or (8 if args.smoke else 256)

    tc = TrainConfig(
        learning_rate=args.lr,
        total_steps=args.steps,
        warmup_steps=max(2, args.steps // 20),
        checkpoint_every=max(5, args.steps // 10),
        checkpoint_dir=args.ckpt_dir,
    )
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=gb)
    trainer = Trainer(cfg, tc, dc, MeshPlan(grad_accum=args.grad_accum, remat="dots"),
                      inject_failure_at=args.inject_failure_at, device=args.device)
    out = run_with_restarts(trainer, args.steps, resume=not args.no_resume)
    losses = out["losses"]
    if not losses:
        print(f"nothing to train: resumed at or past step {args.steps}; "
              f"restarts={out['fault_log'].restarts}")
        return out
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
          f"restarts={out['fault_log'].restarts} "
          f"stragglers={len(out['fault_log'].stragglers)}")
    return out


if __name__ == "__main__":
    main()
