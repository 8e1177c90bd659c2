#!/usr/bin/env python3
"""Hold this tree's dense flash kernel against an older checkout's, on one
NVIDIA GPU: bitwise-equal outputs on the TPU kernel's contract (queries at
offset 0, ``Sq = Sk = k_len``) and device time in turns.

    python3 tools/flash_parent_check.py <checkout>

``<checkout>`` is a repository tree whose ``csrc/flash_attention.cu`` has
the interface before the query offset and the key length were added
(``flash_attention_launch(q, k, v, out, B, Hq, Hkv, S, D, causal, scale,
stream)``, S a multiple of 64), e.g. the parent commit unpacked with
``git archive``.  Its kernel is built with ``nvcc`` from its own sources
into a temporary directory; this tree's runs through its wrapper
(``repro_torch.kernels.flash_attention``, which passes ``q_offset`` 0 and
no key length).

Cases (bf16, queries scaled as in ``repro_torch.kernels.parity``): causal
and not at B 1, 24 / 8 heads, D 128, S 16384 and S 4160 (the last query
tile half full); B 2, 32 / 8 heads, D 64, S 1024.  Every output must be
bitwise equal.  Then the S 16384 causal call is timed by the device time
of its kernel (``torch.profiler``, 10 calls) in the order other, this,
this, other, over twelve rounds; each round's ratio (this over other,
the mean of its two calls each) bounds the difference.  Then, as the
finer measure, twelve profiler sessions each launch the two kernels in
turns (20 pairs, the first of a pair alternating), so that a drift of
the card's clock falls on both alike; each session gives one ratio of
their summed device times.  Also prints both builds' register and
spill lines (``-Xptxas -v``).  Prints one JSON object per line and
writes them to ``chiprun_out/flash_parent_check.json``.
"""
from __future__ import annotations

import ctypes
import json
import math
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

CASES = [(1, 24, 8, 16384, 128), (1, 24, 8, 4160, 128), (2, 32, 8, 1024, 64)]
ROUNDS = 12


def build(tree: Path, tmp: Path, name: str):
    """nvcc of ``tree``'s flash kernel with the package's flags -> (library
    path, the compiler's register / spill lines)."""
    from repro_torch.kernels import _build

    src = tree / "src" / "repro_torch" / "csrc"
    out = tmp / f"libflash_{name}.so"
    cmd = [_build._nvcc(), *_build.FLAGS, "-o", str(out), str(src / "flash_attention.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"the {name} checkout's flash kernel did not build:\n{res.stderr}")
    lines = [l.strip() for l in res.stderr.splitlines()
             if "registers" in l or "spill" in l or "Compiling entry" in l]
    return out, lines


def build_other(other: Path, tmp: Path):
    out, _ = build(other, tmp, "other")
    fn = ctypes.CDLL(str(out)).flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def device_ms(torch, fn, iters=10):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            total += (getattr(ev, "self_cuda_time_total", 0) if t is None else t)
    if total <= 0:
        raise SystemExit("the profiler recorded no device time")
    return total / 1e3 / iters


def kernel_keys(torch, fn):
    """Names of the device kernels one call of ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA}


def interleaved_ratio(torch, fns, keys, pairs=20):
    """One profiler session launching ``fns["other"]`` and ``fns["this"]``
    in turns -> (this ms, other ms) per call, from their kernels' summed
    device times."""
    total = {"other": 0.0, "this": 0.0}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(pairs):
            for name in (("other", "this") if i % 2 == 0 else ("this", "other")):
                fns[name]()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        for name in total:
            if ev.key in keys[name]:
                t = getattr(ev, "self_device_time_total", None)
                total[name] += getattr(ev, "self_cuda_time_total", 0) if t is None else t
    if not all(total.values()):
        raise SystemExit("the profiler recorded no time for one of the kernels")
    return total["this"] / 1e3 / pairs, total["other"] / 1e3 / pairs


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        print("flash_parent_check: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import parity

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    records = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        records.append(rec)

    with tempfile.TemporaryDirectory() as tmp:
        other = build_other(Path(sys.argv[1]).resolve(), Path(tmp))
        for name, tree in (("other", Path(sys.argv[1]).resolve()), ("this", ROOT)):
            emit({"ptxas": name, "lines": build(tree, Path(tmp), f"{name}_report")[1]})

        def run_other(q, k, v, causal):
            o = torch.empty_like(q)
            B, Hq, S, D = q.shape
            rc = other(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
                       k.shape[1], S, D, int(causal), 1.0 / math.sqrt(D),
                       torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"CUDA error {rc} at launch")
            return o

        gen = torch.Generator(device=dev).manual_seed(0)
        timed = None
        for B, hq, hkv, S, D in CASES:
            q = (torch.randn((B, hq, S, D), generator=gen, device=dev)
                 * parity.QSCALE).to(torch.bfloat16)
            k, v = (torch.randn((B, hkv, S, D), generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
            for causal in (True, False):
                a, b = run_other(q, k, v, causal), fa.flash_attention(q, k, v, causal)
                torch.cuda.synchronize()
                same = bool(torch.equal(a, b))
                emit({"case": [B, hq, hkv, S, D], "causal": causal, "bitwise_equal": same,
                      "max_abs_diff": float((a.float() - b.float()).abs().max())})
                if not same:
                    raise SystemExit("FAILED: the outputs differ from the other checkout's")
            if (S, D) == (16384, 128):
                timed = (q, k, v)
        q, k, v = timed
        fns = {"other": lambda: run_other(q, k, v, True),
               "this": lambda: fa.flash_attention(q, k, v, True)}
        times = {"other": [], "this": []}
        for _ in range(ROUNDS):
            for name in ("other", "this", "this", "other"):
                times[name].append(device_ms(torch, fns[name]))
        keys = {name: kernel_keys(torch, fn) for name, fn in fns.items()}
        if keys["this"] & keys["other"]:
            raise SystemExit("the two builds' kernels share a name: cannot tell them apart")
        inter = [interleaved_ratio(torch, fns, keys) for _ in range(ROUNDS)]
    med = {n: statistics.median(t) for n, t in times.items()}
    ratios = [(times["this"][2 * r] + times["this"][2 * r + 1])
              / (times["other"][2 * r] + times["other"][2 * r + 1]) for r in range(ROUNDS)]
    emit({"timing": "flash_attention causal, B 1, 24/8 heads, D 128, S 16384, "
                    "device ms per call", "card": card,
          "other_ms": times["other"], "this_ms": times["this"],
          "other_median_ms": med["other"], "this_median_ms": med["this"],
          "this_over_other": med["this"] / med["other"],
          "round_ratios": ratios, "round_ratio_median": statistics.median(ratios),
          "round_ratio_range": [min(ratios), max(ratios)]})
    r_int = [t / o for t, o in inter]
    emit({"timing": "the same, the two kernels in turns within each profiler session "
                    "(20 pairs a session)", "card": card,
          "this_ms": [t for t, _ in inter], "other_ms": [o for _, o in inter],
          "session_ratios": r_int, "session_ratio_median": statistics.median(r_int),
          "session_ratio_mean": statistics.mean(r_int),
          "session_ratio_range": [min(r_int), max(r_int)],
          "sessions_this_slower": sum(r > 1 for r in r_int)})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_parent_check.json").write_text(
        "\n".join(json.dumps(r) for r in records) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
