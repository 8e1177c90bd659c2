#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure is fatal, exit code != 0):

1. build the hand-written CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print the card's name and power
   limit;
2. hold each kernel against its plain PyTorch version on the card at
   llama3.2-3b layer shapes (n_kv 8, GQA group 3, head_dim 128, Dp 256,
   max_context 16384, budget 4096, block sizes 16/32/64, batch 4) with the
   rule of ``repro_torch.kernels.parity``: decode page tables and prefill
   block maps exact up to near ties, every output element within one bf16
   rounding step and every output row within 1e-2 relative L2; and show
   that leaving one page out per head breaks that rule;
3. serve full-width llama3.2-3b (28 layers, bf16, random weights from a
   seeded generator) through ``Engine``: 6 requests of 4-12k prompt tokens,
   two sharing a 2048-token prefix, 32 new tokens each; the kernels' launch
   counters are zeroed just before and read just after, and the plain
   versions must not be called; then three of those requests (one a
   prefix-cache hit) are served again through ``Engine`` with the kernels
   and with their plain versions, the plain run fed the kernel run's
   tokens: every step's logits must be finite, and the two runs' logits
   must have a cosine similarity of at least 0.9995;
4. time each kernel (CUDA events) and its plain version at the serving
   shapes and compute its bound from this run's inputs.

The next-to-last lines are the card and the ``{"kernels": [...]}`` record;
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the repository beside it, the script exits non-zero and prints no
result.  Long output goes to ``chiprun_out/chip_smoke.log``.  With
``--profile`` the serving phase runs under ``torch.profiler`` (device
activity) and the device time by kernel is printed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
#: flop/s, f32 flop/s outside the tensor cores.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

N_KV, G, D, CTX, BUDGET, PS = 8, 3, 128, 16384, 4096, 16
BLOCKS = (16, 32, 64, 16, 32, 64, 32, 16)
#: serving traffic: prompt lengths, shared prefix of the first two, new tokens
PROMPT_LENS = (9000, 6500, 12000, 4000, 11000, 7200)
PREFIX, NEW_TOKENS, CHUNK, MAX_BATCH = 2048, 32, 512, 4
ARCH = "llama3.2-3b"
#: end-to-end agreement of the kernel path with the plain path: which
#: requests of the serving traffic (1 shares 0's prefix), their new tokens,
#: and the least cosine similarity of the two paths' logits at each step.
AGREE_REQS, AGREE_NEW, LOGIT_COS = (0, 1, 3), 8, 0.9995

LOG = []


def log(*a):
    msg = " ".join(str(x) for x in a)
    LOG.append(msg)
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def cuda_time_ms(torch, fn, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(bytes_, f32_ops, bf16_ops):
    t_bytes = bytes_ / HBM_BPS
    t_ops = f32_ops / F32_FLOPS + bf16_ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def layer_inputs(torch, dev, B, seed):
    from repro_torch.config import SparseConfig
    from repro_torch.core.ragged import layout_for
    from repro_torch.core.stacked import as_arrays

    sparse = SparseConfig(token_budget=BUDGET, quant="int4_asym",
                          sparse_prefill=True)
    la = as_arrays(layout_for(BLOCKS, CTX, PS, BUDGET), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (B, N_KV, CTX // PS, PS, D)
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return sparse, la, gen, k, v


def check_fused_decode(torch, dev):
    from repro_torch.backends.store import build_store_codes
    from repro_torch.core.centroids import rank_query
    from repro_torch.core.sparse_attention import paged_attention_reference
    from repro_torch.kernels import parity

    B = 4
    sparse, la, gen, k, v = layer_inputs(torch, dev, B, seed=1)
    q = torch.randn((B, N_KV * G, D), generator=gen, device=dev)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    seq_len = torch.tensor([CTX, CTX * 3 // 4 + 1, CTX * 7 // 16 - 3, CTX // 7],
                           dtype=torch.int32, device=dev)
    store = build_store_codes(k, la, sparse)
    rq = rank_query(q, sparse.centroid_method, D)
    res = parity.compare_fused_decode(q, rq, k, v, store, la, sparse, seq_len)
    log(f"fused_decode check: valid exact, near-tie blocks {res['near_ties']} "
        f"(heads {res['tie_heads']}), max_abs_err {res['max_abs_err']:.3e}, "
        f"max rel L2 {res['max_rel_l2']:.3e} (limit {parity.REL_L2}), "
        f"{res['tol_use']:.2f} of the elementwise limit {parity.OUT_ATOL} + "
        f"2^-7 |plain|")
    # power of the comparison: leave out one full selected page per (b, head)
    # of the plain version's table; most rows must move by more than REL_L2
    out_p, tbl_p, vld_p = res["plain"]
    mid = (vld_p.cumsum(-1) == vld_p.sum(-1, keepdim=True) // 2 + 1) & vld_p
    dropped = paged_attention_reference(q, k, v, tbl_p, vld_p & ~mid, PS, seq_len)
    moved = ((dropped.float() - out_p.float()).norm(dim=-1)
             / out_p.float().norm(dim=-1)).flatten()
    med = float(moved.median())
    log(f"fused_decode check power: one page left out per head moves a row by "
        f"median rel L2 {med:.3e}; {float((moved > parity.REL_L2).float().mean()):.2f} "
        f"of rows exceed the limit")
    if not med > parity.REL_L2:
        fail("the fused_decode comparison cannot see a page left out")
    _, table, valid = res["kernel"]
    return {"err": res["max_abs_err"], "table": table, "valid": valid,
            "args": (q, rq, k, v, store, la, sparse.sink_pages,
                     sparse.local_pages, seq_len)}


def check_sparse_prefill(torch, dev):
    from repro_torch.backends.base import CentroidStore
    from repro_torch.backends.store import build_score_rows
    from repro_torch.core.centroids import rank_query
    from repro_torch.core.quantization import store_bits
    from repro_torch.kernels import parity

    B, SQ, OFF = 4, CHUNK, CTX // 2
    sparse, la, gen, k, v = layer_inputs(torch, dev, B, seed=2)
    q = torch.randn((B, N_KV * G, SQ, D), generator=gen, device=dev)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    # ragged live lengths: later sequences end inside the chunk, leaving
    # dead trailing query blocks
    n_valid = torch.tensor([OFF + SQ, OFF + SQ * 3 // 5, OFF + SQ // 8, OFF + 1],
                           dtype=torch.int32, device=dev)
    codes, sc, ze = build_score_rows(k, la, sparse)
    ss = CentroidStore(codes, sc, ze, store_bits(sparse.quant), False)
    rq = rank_query(q, sparse.centroid_method, D)
    res = parity.compare_sparse_prefill(q, rq, k, v, ss, la, sparse, n_valid,
                                        OFF)
    log(f"sparse_prefill check: n_attended exact, selected blocks equal but "
        f"{res['near_ties']} near-tie blocks (in {res['tie_cells']} cells), "
        f"max_abs_err {res['max_abs_err']:.3e}, max rel L2 "
        f"{res['max_rel_l2']:.3e} (limit {parity.REL_L2}), {res['tol_use']:.2f} "
        f"of the elementwise limit")
    return {"err": res["max_abs_err"]}


# ---------------------------------------------------------------------------
# phase 4: times and bounds at the serving shapes
# ---------------------------------------------------------------------------


def time_fused_decode(torch, dec):
    from repro_torch.kernels import ops

    q, rq, k, v, store, la, sink, local, seq_len = dec["args"]
    ms = cuda_time_ms(torch, lambda: ops.fused_decode(*dec["args"]), 5, 50)
    plain_ms = cuda_time_ms(
        torch, lambda: ops.fused_decode_reference(*dec["args"]), 1, 3)
    lay = la.host
    # rows the function needs: blocks starting before each sequence's end
    nblk = torch.tensor(lay.n_blocks, device=q.device)
    bsz = torch.tensor(lay.block_sizes, device=q.device)
    live_rows = torch.minimum(nblk, (seq_len.long()[:, None] + bsz - 1) // bsz)
    n_rows = int(live_rows.sum())               # over (b, h)
    row_bytes = store.codes.shape[-1] * store.codes.element_size()
    # selected live tokens per (b, h), from the kernel's own page table
    tbl, vld = dec["table"].long(), dec["valid"]
    pos = tbl[..., None] * PS + torch.arange(PS, device=tbl.device)
    live = (pos < seq_len.long()[:, None, None, None]) & vld[..., None]
    tokens = int(live.sum())
    bytes_ = (q.numel() * 2 + rq.numel() * 4 + n_rows * row_bytes
              + 2 * store.scale.numel() * 4 + 2 * tokens * D * 2
              + q.numel() * 2 + tbl.numel() * 4 + vld.numel())
    f32_ops = 2 * n_rows * G * rq.shape[-1]
    bf16_ops = 4 * tokens * G * D
    b_ms, by = bound(bytes_, f32_ops, bf16_ops)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}


def time_sparse_prefill(torch, dev):
    """B=1, one prefill chunk at offset CTX/2: one slot's chunk as the engine
    issues it."""
    from repro_torch.backends.store import build_score_rows
    from repro_torch.backends.base import CentroidStore
    from repro_torch.core.centroids import rank_query
    from repro_torch.core.quantization import store_bits
    from repro_torch.kernels import ops, parity

    B, SQ, OFF = 1, CHUNK, CTX // 2
    sparse, la, gen, k, v = layer_inputs(torch, dev, B, seed=3)
    q = torch.randn((B, N_KV * G, SQ, D), generator=gen, device=dev).to(torch.bfloat16)
    n_valid = torch.tensor([OFF + SQ], dtype=torch.int32, device=dev)
    codes, sc, ze = build_score_rows(k, la, sparse)
    ss = CentroidStore(codes, sc, ze, store_bits(sparse.quant), False)
    rq = rank_query(q, sparse.centroid_method, D)
    kw = dict(sink_pages=sparse.sink_pages, local_pages=sparse.local_pages,
              block_q=sparse.prefill_block_q, topk_scale=sparse.prefill_topk_scale,
              n_valid=n_valid, chunk_offset=OFF)
    ms = cuda_time_ms(torch, lambda: ops.sparse_prefill(q, rq, k, v, ss, la, **kw), 3, 20)
    plain_ms = cuda_time_ms(
        torch, lambda: ops.sparse_prefill_reference(q, rq, k, v, ss, la, **kw), 1, 2)

    extra, _ = parity.prefill_selection(q, rq, k, v, ss, la, sparse, n_valid, OFF)
    sel, cand, qpos_live = extra["selected"], extra["cand"], extra["live_rows"]
    lay = la.host
    bsz = torch.tensor(lay.block_sizes, device=dev)[None, :, None, None]
    M = sel.shape[-1]
    starts = torch.arange(M, device=dev)[None, None, None, :] * bsz
    nv = n_valid.long()[:, None, None, None]
    keys = torch.clamp(torch.minimum(bsz, nv - starts), min=0)
    # K/V each needed once per (b, h): union of the blocks any query block attends
    union = sel.any(dim=2)
    kv_tokens = int((keys[:, :, 0] * union).sum())
    cand_union = cand.any(dim=2)
    n_cand_rows = int(cand_union.sum())
    row_bytes = ss.codes.shape[-1] * ss.codes.element_size() + 8
    Dp = rq.shape[-1]
    bytes_ = (q.numel() * 2 + rq.numel() * 4 + n_cand_rows * row_bytes
              + 2 * kv_tokens * D * 2 + q.numel() * 2 + sel[..., 0].numel() * 4)
    # scoring: live query rows x candidate blocks x Dp multiply-adds (f32)
    f32_ops = 2 * Dp * float((cand.sum(-1) * qpos_live[:, None, :]).sum())
    # attention: causal (live row, selected key) pairs x D, for QK^T and PV
    bf16_ops = 4 * D * float(extra["pairs"].sum())
    b_ms, by = bound(bytes_, f32_ops, bf16_ops)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------


def profile_summary(torch, prof, wall_s: float):
    """Device time by kernel from a torch.profiler run of device activity
    only: the top kernels and the device busy share of the profiled wall
    time (one stream, so kernel times do not overlap)."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"profile: device busy {busy_ms:.0f} ms of {wall_s * 1e3:.0f} ms wall "
        f"({100 * busy_ms / max(wall_s * 1e3, 1e-9):.1f}%)")
    for ms, n, key in rows[:12]:
        log(f"profile: {ms:10.1f} ms {100 * ms / max(busy_ms, 1e-9):5.1f}% "
            f"of device  x{n:6d}  {key[:90]}")
    if not rows:
        fail("the profiler recorded no device time")


def traffic(vocab: int):
    """The serving phase's prompts (numpy seed 0): ``PROMPT_LENS`` tokens
    each, the first two sharing a ``PREFIX``-token prefix."""
    import numpy as np

    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, PREFIX)
    prompts = []
    for i, n in enumerate(PROMPT_LENS):
        p = rng.integers(0, vocab, n)
        if i < 2:
            p[:PREFIX] = prefix
        prompts.append(p.astype(np.int32))
    return prompts


def make_engine(cfg, model, dev, req_ids, new_tokens):
    from repro_torch.config import ServeConfig
    from repro_torch.serving import Engine, Request

    serve_cfg = ServeConfig(max_batch=MAX_BATCH, max_context=CTX,
                            prefill_chunk=CHUNK, temperature=0.0)
    eng = Engine(cfg, model, serve_cfg, device=dev)
    prompts = traffic(cfg.vocab_size)
    for i in req_ids:
        eng.submit(Request(req_id=i, prompt=prompts[i], max_new_tokens=new_tokens))
    return eng


def check_served(eng, done, n_requests, new_tokens, vocab):
    if len(done) != n_requests:
        fail(f"served {len(done)} of {n_requests} requests")
    for r in done:
        if len(r.output) != new_tokens or not all(0 <= t < vocab for t in r.output):
            fail(f"request {r.req_id}: bad output {r.output[:8]}...")
    if eng.pool.assert_consistent(known_pins=eng.prefix_cache.pages()):
        fail("page pool leaked pages")
    if eng.metrics.snapshot()["prefix_hit_tokens"] <= 0:
        fail("the shared prefix was not served from the prefix cache")


def serve_recorded(eng, forced=None):
    """Run ``eng`` to the end, recording every sampled row's logits by
    (request, position) -> (finished requests, logits, tokens).  With
    ``forced`` ({(request, position): token}) the engine is fed those tokens
    in place of its own samples."""
    logits, tokens = {}, {}
    sample = eng._sample

    def recording(seq_ids, positions, lg):
        toks, fin = sample(seq_ids, positions, lg)
        for r, key in enumerate(zip(seq_ids, positions)):
            logits[key] = lg[r].float().cpu()
            if forced is not None:
                toks[r] = forced[key]
            tokens[key] = int(toks[r])
        return toks, fin

    eng._sample = recording
    done = eng.run_until_done(max_ticks=2000)
    return done, logits, tokens


def agree_with_plain(torch, model, cfg, dev):
    """End-to-end check of the served path at the serving shapes: requests
    ``AGREE_REQS`` (the second shares the first's prefix, a prefix-cache
    hit) go through ``Engine`` (chunked prefill, store refresh, batched
    decode over ragged lengths) once with the kernels and once with their
    plain versions.  The plain run is fed the kernel run's tokens, so each
    step's logits compare at the same inputs: they must be finite, of the
    vocabulary's size, and their cosine similarity at least ``LOGIT_COS``
    (bf16 rounding and near-tie selections differ between the two)."""
    from repro_torch import kernels
    from repro_torch.backends import get_backend

    runs = {}
    for name in ("cuda", "reference"):
        model.backend = get_backend(name)
        eng = make_engine(cfg, model, dev, AGREE_REQS, AGREE_NEW)
        kernels.reset_counts()
        forced = runs["cuda"][1] if runs else None
        done, logits, tokens = serve_recorded(eng, forced)
        check_served(eng, done, len(AGREE_REQS), AGREE_NEW, cfg.vocab_size)
        c = kernels.counts()
        launched = sum(v["launches"] for v in c.values())
        plain = sum(v["plain_calls"] for v in c.values())
        if (name == "cuda") != (launched > 0 and plain == 0):
            fail(f"agreement run '{name}': {launched} kernel launches, "
                 f"{plain} plain calls")
        runs[name] = (logits, tokens)
        del eng
        torch.cuda.empty_cache()
    model.backend = get_backend("cuda")
    lk_all, lp_all = runs["cuda"][0], runs["reference"][0]
    if lk_all.keys() != lp_all.keys():
        fail("the kernel and plain runs sampled at different steps")
    worst, same = 1.0, 0
    for key, lk in lk_all.items():
        lp = lp_all[key]
        if lk.shape != (cfg.vocab_size,) or not bool(torch.isfinite(lk).all()):
            fail(f"kernel-path logits at {key} of shape {tuple(lk.shape)} are not finite")
        worst = min(worst, float(torch.nn.functional.cosine_similarity(lk, lp, dim=0)))
        same += int(lk.argmax() == lp.argmax())
    log(f"end to end vs plain: Engine, requests {AGREE_REQS} x {AGREE_NEW} new "
        f"tokens, plain run fed the kernel run's tokens: min logit cosine "
        f"{worst:.6f} (>= {LOGIT_COS}) over {len(lk_all)} steps, greedy tokens "
        f"equal at {same} of {len(lk_all)}")
    if not worst >= LOGIT_COS:
        fail(f"kernel-path logits drift from the plain path: cosine {worst}")


def serve(torch, dev, profile: bool = False):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer

    base = get_config(ARCH)
    pattern = tuple(
        tuple((16, 32, 64)[(l + h) % 3] for h in range(base.n_kv_heads))
        for l in range(base.n_layers)
    )
    cfg = dataclasses.replace(base, sparse=dataclasses.replace(
        base.sparse, backend="cuda", sparse_prefill=True,
        quant="int4_asym", block_sizes=pattern, token_budget=BUDGET,
    ))
    t0 = time.perf_counter()
    model = Transformer(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"weights: {sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params "
        f"bf16, init {time.perf_counter() - t0:.1f}s")
    eng = make_engine(cfg, model, dev, range(len(PROMPT_LENS)), NEW_TOKENS)

    steps = {"decode_step": 0, "prefill_chunk": 0}
    for name in steps:
        def counted(*a, _fn=getattr(model, name), _name=name, **k):
            steps[_name] += 1
            return _fn(*a, **k)
        setattr(model, name, counted)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profile:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            done = eng.run_until_done(max_ticks=2000)
            torch.cuda.synchronize()
    else:
        done = eng.run_until_done(max_ticks=2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name in steps:
        delattr(model, name)
    if profile:
        profile_summary(torch, prof, wall)
    counts = kernels.counts()
    snap = eng.metrics.snapshot()
    check_served(eng, done, len(PROMPT_LENS), NEW_TOKENS, cfg.vocab_size)
    for name, c in counts.items():
        if c["launches"] <= 0:
            fail(f"{name} was not launched while serving")
        if c["plain_calls"]:
            fail(f"{name}'s plain version ran {c['plain_calls']} times while serving")
    dec_tok = snap["decode_tokens"]
    log(f"serving: {len(done)} requests finished, {dec_tok} tokens "
        f"(+{snap['prefill_tokens_computed']} prefill), prefix-hit tokens "
        f"{snap['prefix_hit_tokens']}, ticks {snap['ticks']}, wall {wall:.1f}s")
    log(f"serving: TTFT p50 {snap['ttft_p50']:.3f}s, TPOT p50 "
        f"{snap['tpot_p50'] * 1e3:.1f}ms, decode tok/s "
        f"{dec_tok / max(wall, 1e-9):.1f} (over the whole run)")
    log(f"serving: launches {json.dumps(counts)}; decode steps "
        f"{steps['decode_step']}, prefill chunks {steps['prefill_chunk']}")
    del eng
    torch.cuda.empty_cache()
    agree_with_plain(torch, model, cfg, dev)
    del model
    torch.cuda.empty_cache()
    return counts, steps


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="run the serving phase under torch.profiler and print "
                         "device time by kernel (serving numbers then include "
                         "the profiler's overhead)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s")
    for name, rep in _build.PTXAS_REPORT.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    dec = check_fused_decode(torch, dev)
    pre = check_sparse_prefill(torch, dev)

    counts, steps = serve(torch, dev, profile=args.profile)

    t_dec = time_fused_decode(torch, dec)
    t_pre = time_sparse_prefill(torch, dev)
    kernels_line = [
        {"name": "fused_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_decode.cu",
         "replaces": "src/repro/kernels/fused_decode.py:333",
         "launches": counts["fused_decode"]["launches"],
         "max_abs_err": dec["err"], **t_dec, "library_ms": None},
        {"name": "sparse_prefill", "route": "cuda",
         "source": "src/repro_torch/csrc/sparse_prefill.cu",
         "replaces": "src/repro/kernels/sparse_prefill.py:355",
         "launches": counts["sparse_prefill"]["launches"],
         "max_abs_err": pre["err"], **t_pre, "library_ms": None},
    ]
    for k in kernels_line:
        log(f"{k['name']}: {k['ms']:.4f} ms/launch, plain {k['plain_ms']:.3f} ms, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
            f"launches while serving {k['launches']}")
    log(f"launches per decode step "
        f"{counts['fused_decode']['launches'] / steps['decode_step']:.1f}, "
        f"per prefill chunk "
        f"{counts['sparse_prefill']['launches'] / steps['prefill_chunk']:.1f}; "
        f"library_ms null: no single PyTorch call scores, selects and attends")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.log").write_text("\n".join(LOG) + "\n")
    print(card)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
