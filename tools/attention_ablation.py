#!/usr/bin/env python3
"""Ablations of the port's two attention kernels on one NVIDIA GPU.

    python3 tools/attention_ablation.py

``flash_attention``: each variant is ``csrc/flash_attention.cu`` with one
design choice taken back, built by ``nvcc`` from a patched copy of the
sources in a temporary directory and timed (CUDA events, causal, B 1,
24/8 heads, D 128, S 16384) in turns with the others over three rounds.
The variants that compute the same function are held against the plain
version at S 4096 with ``repro_torch.kernels.parity``'s limits:

- ``as built``;
- ``no lo product``: P rounded once to bf16 (fails the comparison; timed
  for what the second product costs);
- ``no exp``: the softmax's exponential left out (wrong; timed for what it
  costs);
- ``libm exp2``: ``exp2f`` instead of ``ex2.approx``;
- ``rescale always``: every row of O rescaled at every key tile;
- ``mask every tile``: the causal mask computed on every key tile, not
  only from the warpgroup's diagonal on;
- ``one warpgroup per block``: 64 query rows per block, two blocks per SM.

``paged_attention``: the kernel at llama3.2-3b's staged decode shape
(B 4, 8 kv heads x g 3, D 128, 256 slots of 16 tokens, all live) with
its split count forced to 1, 2, 4, 8, 16, 32 and by ``split_plan``,
timed by the device time of its kernels (``torch.profiler``), beside
``scaled_dot_product_attention`` on the gathered K/V.

Prints one JSON object per line and writes them to
``chiprun_out/attention_ablation.json``.  Needs CUDA and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

FLASH_VARIANTS = {
    "as built": [],
    "no lo product": [("flash_attention.cu", "    pv<D>(o, p_lo, v_tile);\n", "")],
    "no exp": [("attn_tile.cuh", "s[i] = ex2(fmaf(s[i], scale_log2, -m[h]));",
                "s[i] = fmaf(s[i], scale_log2, -m[h]);")],
    "libm exp2": [("attn_tile.cuh", '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                   "  y = exp2f(x);")],
    "rescale always": [(
        "flash_attention.cu",
        "    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) rescale(o, alpha);",
        "    rescale(o, alpha);")],
    "mask every tile": [("flash_attention.cu", "    if (causal && j >= diag0) {",
                         "    if (causal) {"),
                        ("flash_attention.cu",
                         "    if ((TAIL || causal) && j >= mask_from) {",
                         "    if (TAIL || causal) {")],
    "one warpgroup per block": [
        ("flash_attention.cu", "static constexpr int NWG = D == 256 ? 1 : 2;",
         "static constexpr int NWG = 1;"),
        ("flash_attention.cu", "__launch_bounds__(Shape<D>::NTHR, 1)",
         "__launch_bounds__(Shape<D>::NTHR, 2)"),
    ],
}
#: variants that compute the function and must pass the comparison
EXACT = {"as built", "libm exp2", "rescale always", "mask every tile",
         "one warpgroup per block"}


def emit(rec, out):
    print(json.dumps(rec), flush=True)
    out.append(rec)


def event_ms(torch, fn, warmup, iters):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(torch, fn, iters):
    """Summed device time of the kernels ``fn`` launches, per call, by kernel."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0)
            rows[ev.key[:60]] = t / 1e3 / iters
    return sum(rows.values()), rows


def build_flash_variants(tmp: Path):
    from repro_torch.kernels import _build

    sources = {f: (_build.CSRC / f).read_text()
               for f in ("flash_attention.cu", "attn_tile.cuh", "common.cuh")}
    procs = {}
    for name, patches in FLASH_VARIANTS.items():
        files = dict(sources)
        for f, old, new in patches:
            if old not in files[f]:
                raise SystemExit(f"variant {name!r}: {f} no longer holds {old!r}")
            files[f] = files[f].replace(old, new)
        d = tmp / name.replace(" ", "_")
        d.mkdir()
        for f, text in files.items():
            (d / f).write_text(text)
        cmd = [_build._nvcc(), *_build.FLAGS, "-o", str(d / "lib.so"),
               str(d / "flash_attention.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), d)
    fns = {}
    for name, (proc, d) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} did not build:\n{err}")
        fn = ctypes.CDLL(str(d / "lib.so")).flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def flash_ablation(torch, out):
    from repro_torch.kernels import parity, ref

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_flash_variants(Path(tmp))

        def run(fn, q, k, v, causal):
            o = torch.empty_like(q)
            B, Hq, S, D = q.shape
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, S,
                    B, Hq, k.shape[1], S, S, D, 0, int(causal), 1.0 / math.sqrt(D),
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"CUDA error {rc} at launch")
            return o

        gen = torch.Generator(device=dev).manual_seed(0)
        S = 16384
        q, k, v = (torch.randn((1, h, S, 128), generator=gen, device=dev).to(torch.bfloat16)
                   for h in (24, 8, 8))
        qs = (q[:, :, :4096].float() * parity.QSCALE).to(torch.bfloat16)
        ks, vs = k[:, :, :4096].contiguous(), v[:, :, :4096].contiguous()
        plain = {c: ref.flash_attention_ref(qs, ks, vs, c) for c in (True, False)}
        checks = {}
        for name in EXACT:
            uses = []
            for c in (True, False):
                o = run(fns[name], qs, ks, vs, c)
                torch.cuda.synchronize()
                keep = torch.ones(o.shape[:-1], dtype=torch.bool, device=dev)
                uses.append(parity.check_outputs(o, plain[c], keep, name)[2])
            checks[name] = uses
        times = {name: [] for name in fns}
        for _ in range(3):
            for name, fn in fns.items():
                times[name].append(event_ms(torch, lambda: run(fn, q, k, v, True), 2, 10))
    base = sorted(times["as built"])[1]
    for name, ts in times.items():
        med = sorted(ts)[1]
        emit({"kernel": "flash_attention", "variant": name, "ms": [round(t, 4) for t in ts],
              "median_ms": round(med, 4), "vs_as_built": round(med / base, 4),
              "tol_use_causal_full": [round(u, 3) for u in checks.get(name, [])] or None},
             out)


def paged_ablation(torch, out):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import parity

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    B, n_kv, g, D, ps, n_pages, P = 4, 8, 3, 128, 16, 1024, 256
    kp, vp = (torch.randn((B, n_kv, n_pages, ps, D), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    q = (torch.randn((B, n_kv * g, D), generator=gen, device=dev)
         * parity.QSCALE).to(torch.bfloat16)
    tbl = torch.stack([torch.randperm(n_pages, generator=gen, device=dev)[:P]
                       for _ in range(B * n_kv)]).reshape(B, n_kv, P).to(torch.int32)
    vld = torch.ones((B, n_kv, P), dtype=torch.bool, device=dev)
    sl = torch.full((B,), n_pages * ps, dtype=torch.int32, device=dev)
    plan = pa.split_plan(B, n_kv, P, torch.cuda.get_device_properties(dev).multi_processor_count)
    bytes_ = 2 * q.numel() * 2 + 2 * B * n_kv * P * ps * D * 2 + tbl.numel() * 5 + B * 4
    for n in (1, 2, 4, 8, 16, 32, None):
        parity.compare_paged_attention(q, kp, vp, tbl, vld, ps, sl, n_split=n)
        ms, rows = device_ms(torch, lambda: pa.paged_attention(q, kp, vp, tbl, vld, sl, ps,
                                                               n_split=n), 50)
        emit({"kernel": "paged_attention", "n_split": n if n else f"plan ({plan})",
              "device_ms": round(ms, 5), "by_kernel_ms": {k: round(t, 5) for k, t in rows.items()},
              "bound_ms": round(bytes_ / 3.35e12 * 1e3, 5)}, out)
    idx = tbl.long()[..., None, None].expand(-1, -1, -1, ps, D)
    sk, sv = (torch.gather(x, 2, idx).reshape(B, n_kv, P * ps, D) for x in (kp, vp))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms, _ = device_ms(torch, lambda: sdpa(q.reshape(B, n_kv, g, D), sk, sv), 50)
    emit({"kernel": "paged_attention", "library": "SDPA on gathered K/V",
          "device_ms": round(ms, 5)}, out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_ablation: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = []
    emit({"card": card}, out)
    flash_ablation(torch, out)
    paged_ablation(torch, out)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "attention_ablation.json").write_text("\n".join(json.dumps(r) for r in out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
