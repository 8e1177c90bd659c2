#!/usr/bin/env python3
"""Control run for ``chip_smoke.py`` phase 13 a)'s gradient gate, on the card.

    python3 tools/train_grad_control.py --batches 4

llama3.2-3b at full width and 2 layers, phase 13 a)'s model; random
weights (generator seed 0) in bf16 and an f32 copy of the same values;
``--batches`` sequences of ``chip_smoke.TRAIN_S`` tokens, one at a time,
as phase 13 a) draws them (``batch_for_step``, data seeds 1, 2, ...,
rows 0 and 1 of each; phase 13 a) takes the first), remat "dots".
Prints, per sequence, per leaf, the bf16 gradient's (cosine, relative L2)
against the f32 copy's: clean, then with each of phase 13's power checks
on layer 1 (``chip_smoke.train_fault``: "rope", "mask"), and the leaves
``chip_smoke.grad_misses`` flags.  Each row names the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=1)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/train_grad_control.py needs a CUDA device")

    import chip_smoke as cs
    from repro_torch.config import MeshPlan
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.training.data import DataConfig, batch_for_step
    from repro_torch.training.train_loop import loss_and_grads, trainable

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(dev)
    cfg = dataclasses.replace(get_config("llama3.2-3b"), n_layers=cs.TRAIN_GRAD_LAYERS)
    model = Transformer(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    model32 = cs.upcast(torch, model, dev)
    p16, p32 = trainable(model), trainable(model32)
    plan = MeshPlan(remat="dots")
    for b in range(args.batches):
        seed, row = 1 + b // 2, b % 2
        toks = batch_for_step(DataConfig(cfg.vocab_size, cs.TRAIN_S, 2, seed=seed), 0,
                              device=dev)[row:row + 1]
        ref = loss_and_grads(model32, p32, toks, plan)[1]

        def report(what):
            diff = cs.grad_diff(torch, loss_and_grads(model, p16, toks, plan)[1], ref)
            print(json.dumps({"device": card, "run": what, "data_seed": seed, "row": row,
                              "seq": cs.TRAIN_S, "flagged": sorted(cs.grad_misses(diff)),
                              "leaves": {n: [round(c, 6), round(r, 5)]
                                         for n, (c, r) in diff.items()}}), flush=True)

        report("clean")
        for kind in ("rope", "mask"):
            with cs.train_fault(model.layers[1], kind):
                report(kind)
        del ref


if __name__ == "__main__":
    main()
