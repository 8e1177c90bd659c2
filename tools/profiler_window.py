#!/usr/bin/env python3
"""Count ``torch.profiler`` recordings that come back short of kernels, on
one NVIDIA GPU, with the work started at once after the session opens
(as ``chip_smoke.profiled`` does), after a host wait, and with a host
wait before the session closes.

    python3 tools/profiler_window.py     # about 5 minutes

The work is a decode-step-like chain of ``LAYERS`` layers (a bf16
projection, an RMS norm, a softmax, a second projection) on a batch of
8, run eagerly and as one CUDA graph replay.  Each of ``SESSIONS``
rounds records every (work, mode) pair once, in turns: a session of
device activity only, opened after a synchronize; mode "now" runs the
work at once, "gap" waits ``GAP_MS`` on the host first, "tail" runs it
at once and waits ``GAP_MS`` after the closing synchronize; then the
session closes.  A recording's kernels are counted; the count most
recordings of a work agree on is the full count, and a recording below
it is short (none: empty).  A short recording's kernels, in order of
start, are a prefix of the full recording's, a suffix, or neither
("other").  Per recording it also keeps the first kernel's start after
the session's trace start (µs).  Prints one JSON line per (work, mode):
sessions, short and empty recordings, the counts seen, where the short
ones' kernels sit, and the first kernel's start (min / median) in all
and in the short recordings; writes them to
``chiprun_out/profiler_window.json``.  The environment's
``TEARDOWN_CUPTI`` defaults to 0, as in ``chip_smoke.py``.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SESSIONS, LAYERS, GAP_MS = 2000, 5, 1.0


def main() -> int:
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    if not torch.cuda.is_available():
        print("profiler_window: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    d, b = 4096, 8
    w1 = [torch.randn(d, d, device=dev, generator=gen, dtype=torch.bfloat16) * d ** -0.5
          for _ in range(LAYERS)]
    w2 = [torch.randn(d, d, device=dev, generator=gen, dtype=torch.bfloat16) * d ** -0.5
          for _ in range(LAYERS)]
    x0 = torch.randn(b, d, device=dev, generator=gen, dtype=torch.bfloat16)
    out = torch.empty_like(x0)

    def step():
        x = x0
        for a, c in zip(w1, w2):
            h = x @ a
            h = h * torch.rsqrt(h.float().pow(2).mean(-1, keepdim=True) + 1e-6).to(h.dtype)
            h = torch.softmax(h.float().view(b, 32, -1), -1).view(b, d).to(h.dtype)
            x = x + h @ c
        out.copy_(x)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    works = {"eager": step, "graph": graph.replay}
    acts = [torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA

    def wait(s):
        t_end = time.perf_counter() + s
        while time.perf_counter() < t_end:
            pass

    def record(work, head_s, tail_s):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            wait(head_s)
            work()
            torch.cuda.synchronize()
            wait(tail_s)
        dev_ev = sorted((e for e in prof.events() if e.device_type == cuda),
                        key=lambda e: e.time_range.start)
        first = dev_ev[0].time_range.start if dev_ev else None
        return len(dev_ev), first, tuple(e.name for e in dev_ev)

    for work in works.values():
        for _ in range(3):
            work()
    recs = collections.defaultdict(list)
    t0 = time.perf_counter()
    g = GAP_MS / 1e3
    modes = {"now": (0.0, 0.0), "gap": (g, 0.0), "tail": (0.0, g)}
    for _ in range(SESSIONS):
        for wname, work in works.items():
            for mode, (head_s, tail_s) in modes.items():
                recs[(wname, mode)].append(record(work, head_s, tail_s))
    wall = time.perf_counter() - t0

    def where(names, full_names):
        if names == full_names[:len(names)]:
            return "prefix"
        if names == full_names[len(full_names) - len(names):]:
            return "suffix"
        return "other"

    summary = []
    for wname in works:
        every = [r for m in modes for r in recs[(wname, m)]]
        full = collections.Counter(n for n, _, _ in every).most_common(1)[0][0]
        full_names = next(names for n, _, names in every if n == full)
        for mode in modes:
            rs = recs[(wname, mode)]
            firsts = [f for _, f, _ in rs if f is not None]
            short = [r for r in rs if r[0] < full]
            summary.append({
                "work": wname, "mode": mode, "sessions": len(rs), "full_kernels": full,
                "short": len(short), "empty": sum(n == 0 for n, _, _ in rs),
                "counts": dict(sorted(collections.Counter(n for n, _, _ in rs).items())),
                "short_where": dict(collections.Counter(
                    where(names, full_names) for n, _, names in short if n)),
                "first_us_min": min(firsts) if firsts else None,
                "first_us_median": statistics.median(firsts) if firsts else None,
                "short_first_us": sorted(f for _, f, _ in short if f is not None)[:50]})
    meta = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
            "cuda": torch.version.cuda, "layers": LAYERS, "gap_ms": GAP_MS,
            "teardown_cupti": os.environ["TEARDOWN_CUPTI"], "wall_s": wall}
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "profiler_window.json").write_text(json.dumps(
        {"meta": meta, "summary": summary}, indent=1))
    print(json.dumps(meta))
    for row in summary:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
