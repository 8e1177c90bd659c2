#!/usr/bin/env python3
"""Serve ``chip_smoke.py``'s fused llama3.2-3b run with this tree and with an
older checkout in turns, on one NVIDIA GPU, and compare their end-to-end
times.

    python3 tools/serve_parent_check.py <checkout> [--rounds N]

``<checkout>`` is a repository tree with its own ``chip_smoke.py`` (e.g.
the parent commit unpacked with ``git archive``).  Each run is a fresh
process that imports that tree's ``chip_smoke`` (and so its own
``repro_torch``), builds its kernels, makes the model from seed 0 and
serves the six requests of ``chip_smoke.traffic`` through the fused
path (``backend="cuda"``, ``fused_decode``, ``sparse_prefill``, INT4
store, the phase's block-size pattern), as ``chip_smoke.serve`` does
first.  Runs go other, this, this, other per round.  Each prints TTFT
p50, TPOT p50, the wall time of the run, and the mean host time of one
``decode_step`` / ``prefill_chunk`` call (the time to issue it, no
synchronisation).  All lines go to ``chiprun_out/serve_parent_check.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: run in a fresh interpreter: argv[1] is the tree whose chip_smoke serves
RUN = r"""
import dataclasses, json, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import torch
from repro_torch.kernels import _build
from repro_torch.configs import get_config
from repro_torch.models import Transformer

dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
base = get_config(cs.ARCH)
pattern = tuple(tuple((16, 32, 64)[(l + h) % 3] for h in range(base.n_kv_heads))
                for l in range(base.n_layers))
cfg = dataclasses.replace(base, sparse=dataclasses.replace(
    base.sparse, backend="cuda", fused_decode=True, sparse_prefill=True,
    quant="int4_asym", block_sizes=pattern, token_budget=cs.BUDGET))
model = Transformer(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
torch.cuda.synchronize()
host = {"decode_step": [], "prefill_chunk": []}
for name in host:
    def timed(*a, _fn=getattr(model, name), _name=name, **k):
        t0 = time.perf_counter()
        r = _fn(*a, **k)
        host[_name].append(time.perf_counter() - t0)
        return r
    setattr(model, name, timed)
eng = cs.make_engine(cfg, model, dev, range(len(cs.PROMPT_LENS)), cs.NEW_TOKENS)
run = cs.run_engine(torch, model, eng)
cs.check_served(eng, run["done"], len(cs.PROMPT_LENS), cs.NEW_TOKENS, cfg.vocab_size)
snap = eng.metrics.snapshot()
print("RESULT " + json.dumps({
    "ttft_p50_s": snap["ttft_p50"], "tpot_p50_ms": snap["tpot_p50"] * 1e3,
    "wall_s": run["wall"], "decode_steps": len(host["decode_step"]),
    "prefill_chunks": len(host["prefill_chunk"]),
    "decode_step_host_ms": 1e3 * sum(host["decode_step"]) / len(host["decode_step"]),
    "prefill_chunk_host_ms": 1e3 * sum(host["prefill_chunk"]) / len(host["prefill_chunk"]),
    "tokens": {str(r.req_id): r.output for r in run["done"]}}), flush=True)
"""


def serve_once(tree: Path) -> dict:
    res = subprocess.run([sys.executable, "-c", RUN, str(tree)], capture_output=True,
                         text=True, timeout=600, cwd=tree)
    lines = [l for l in res.stdout.splitlines() if l.startswith("RESULT ")]
    if res.returncode or not lines:
        raise SystemExit(f"serving with {tree} failed ({res.returncode}):\n"
                         f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkout", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    trees = {"other": args.checkout.resolve(), "this": ROOT}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    records, runs = [], {"other": [], "this": []}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            r = serve_once(trees[name])
            runs[name].append(r)
            rec = {"tree": name, "card": card,
                   **{k: v for k, v in r.items() if k != "tokens"}}
            print(json.dumps(rec), flush=True)
            records.append(rec)
    same = all(r["tokens"] == runs["this"][0]["tokens"]
               for r in runs["this"] + runs["other"])
    keys = ("ttft_p50_s", "tpot_p50_ms", "wall_s", "decode_step_host_ms",
            "prefill_chunk_host_ms")
    summary = {"summary": "fused llama3.2-3b serving, six requests; medians over "
                          f"{2 * args.rounds} runs each", "card": card,
               "tokens_identical": same,
               **{f"{n}_{k}": statistics.median(r[k] for r in runs[n])
                  for n in runs for k in keys}}
    print(json.dumps(summary), flush=True)
    records.append(summary)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "serve_parent_check.json").write_text(
        "\n".join(json.dumps(r) for r in records) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
