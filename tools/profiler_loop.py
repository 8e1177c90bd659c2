#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 4 (device time of every kernel at the
serving shapes under ``torch.profiler``) several times in one process, on
one NVIDIA GPU, and count the profiler sessions that recorded no device
time.

    python3 tools/profiler_loop.py [--loops N]

Phase 2's checks run once to make phase 4's inputs; then phase 4 runs
``N`` times (default 6).  Every profiler session goes through
``chip_smoke.profiled`` (the one owner of a session's lifecycle); this
script wraps it to keep, per session: its number, the phase-4 function
it timed (``stage``, and its session number within the loop), the kernel
rows it recorded, their summed device ms, the recordings it took and the
warnings the profiler raised, so that a session recorded again can be
held against the same session of the other loops.  A
phase-4 loop whose session failed (three empty recordings in a row) is
counted as failed and the script goes on.  Prints one summary JSON line
(``{"loops": N, "passed": k, "sessions": s, "retried": r, ...}``) and
writes every session's record to ``chiprun_out/profiler_loop.json``.

The environment's ``TEARDOWN_CUPTI`` is left as given (``chip_smoke.py``'s
``main`` sets it to 0 when unset; this script does not): ``1`` makes
Kineto tear CUPTI down after every session and set it up again at the
next, ``0`` keeps it set up.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loops", type=int, default=6)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("profiler_loop: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
           f"{torch.cuda.get_device_name(0)}")
    warnings.simplefilter("always")
    sessions = []
    profiled = cs.profiled
    loop, stage = None, None

    def recording(torch_, run, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rec = {"n": len(sessions), "loop": loop, "stage": stage,
                   "i": sum(s["loop"] == loop for s in sessions)}
            sessions.append(rec)
            retried = cs.PROFILER["retried"]
            try:
                rows = profiled(torch_, run, **kw)
            except SystemExit as exc:
                rec.update(failed=str(exc))
                raise
            finally:
                rec["warnings"] = [str(w.message)[:160] for w in caught]
        rec.update(rows=len(rows), tries=1 + cs.PROFILER["retried"] - retried,
                   ms=sum(r[0] for r in rows))
        return rows

    cs.profiled = recording

    dec = cs.check_fused_decode(torch, dev)
    scored = {q: cs.check_centroid_scores(torch, dec, q) for q in ("int4_asym", "none")}
    att = cs.check_paged_attention(torch, dec, scored["int4_asym"])
    pool = cs.check_pool_rank_keys(torch, dev, dec)
    topk = cs.check_topk_threshold(torch, dev, dec, scored["int4_asym"])
    ident = cs.check_paged_identity(torch, dev)
    stages = (("fused_decode", lambda: cs.time_fused_decode(torch, dec)),
              ("sparse_prefill", lambda: cs.time_sparse_prefill(torch, dev)),
              ("centroid_scores_int4",
               lambda: cs.time_centroid_scores(torch, dec, scored["int4_asym"])),
              ("centroid_scores_f32",
               lambda: cs.time_centroid_scores(torch, dec, scored["none"])),
              ("paged_attention", lambda: cs.time_paged_attention(torch, dec, att)),
              ("pool_rank_keys", lambda: cs.time_pool_rank_keys(torch, pool)),
              ("topk_threshold", lambda: cs.time_topk_threshold(torch, topk)),
              ("flash_attention", lambda: cs.time_flash_attention(torch, dev)),
              ("flash_chunk", lambda: cs.time_flash_chunk(torch, dev)),
              ("paged_identity", lambda: cs.time_paged_identity(torch, ident)))
    passed = 0
    for loop in range(args.loops):
        t0 = time.perf_counter()
        try:
            for stage, run in stages:
                run()
            passed += 1
            verdict = "passed"
        except SystemExit as exc:
            verdict = f"FAILED: {exc}"
        mine = [s for s in sessions if s["loop"] == loop]
        cs.log(f"phase 4 loop {loop}: {verdict}; {len(mine)} profiler sessions, "
               f"{sum(s.get('tries', 2) > 1 for s in mine)} recorded again, "
               f"{time.perf_counter() - t0:.1f}s")
    retried = []
    for s in sessions:
        if s.get("tries", 2) > 1:
            others = sorted(o["ms"] for o in sessions
                            if o["i"] == s["i"] and o is not s and "ms" in o)
            retried.append({"n": s["n"], "stage": s["stage"], "ms": s.get("ms"),
                            "others_median_ms": others[len(others) // 2]
                            if others else None})
    summary = {"loops": args.loops, "passed": passed, "sessions": len(sessions),
               "retried": retried,
               "failed_sessions": [s for s in sessions if "failed" in s],
               "warnings": sorted({w for s in sessions for w in s["warnings"]}),
               "device": torch.cuda.get_device_name(0)}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profiler_loop.json").write_text(json.dumps(
        {"summary": summary, "sessions": sessions}, indent=1))
    print(json.dumps(summary))
    return 0 if passed == args.loops else 1


if __name__ == "__main__":
    sys.exit(main())
