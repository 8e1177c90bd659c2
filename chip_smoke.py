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
   rules of ``repro_torch.kernels.parity``: decode page tables and prefill
   block maps exact up to near ties, staged block scores (INT4 and f32
   stores) within 1e-5 of the head's largest, the staged page sets equal
   to the fused kernel's, every output element within one bf16 rounding
   step and every output row within 1e-2 relative L2; and show that a page
   left out per head, or a score moved by twice its tolerance, breaks them.
   The fused decode and the sparse prefill are also held against their
   plain versions with their split counts forced (1 and 5 runs), and all
   of it again at the shapes phase 3b gives them (qwen3-8b: GQA group 4,
   Q1's live lengths, the last chunk of its 9000-token prompt);
3. serve full-width llama3.2-3b (28 layers, bf16, random weights from a
   seeded generator) through ``Engine``: 6 requests of 4-12k prompt tokens,
   two sharing a 2048-token prefix, 32 new tokens each, with the fused
   decode kernel, and three of them (one a prefix-cache hit) with the
   staged kernels and telemetry; each run's
   kernel launch counts are zeroed just before and read just after, the
   run must have launched its path's kernels and no other, and called no
   plain version.  Then those three requests are served again with the
   fused kernel and telemetry (which launches
   the scoring kernel too), with the staged kernels and with the plain
   versions, the later two fed the first run's tokens: every step's logits
   must be finite, every pair of runs must reach a logit cosine of at least
   0.9995, and the sparsity counters must be identical.  One request is
   served on an f32 store (staged kernels, then plain);
   Then the calibrated assignment of phase 2b is installed and requests 0
   and 3 are served with the fused kernel, then through the plain versions
   fed the same tokens (logit cosine at least 0.9995);
5. (run after phase 3, on its weights and fused configuration) the
   degradation ladder and a fault storm: requests 0, 1, 3 and 5 (24 new
   tokens) served fault-free (run F, no injector), then fed F's tokens
   under a plan built from F's schedule (run L: a prefill fault on rung
   0, a decode fault on staged, a NaN row on staged, re-promotion back to
   fused) and under ``default_storm()`` with request 5 poisoned on every
   tick and a stuck clock that trips the watchdog (run S).  Every rung
   must run whole decode ticks that launch its own kernels once per
   layer and no other rung's, nothing may be lost, the pool must audit
   clean, request 5 must fail as a sampler anomaly past its budget and
   every other request end ok, and every committed position's logits
   must be within a cosine of 0.9995 of F's.  Every serving run without an
   injector must end on rung 0 with no degradation (no hidden fallback);
3b. serve full-width qwen3-8b (36 layers, d_model 4096, 32 / 8 heads,
   untied head, bf16, random weights from a seeded generator) through
   ``Engine`` at max_batch 4, chunks of 512, 32 new tokens, temperature 0,
   in five runs, each of which must launch its path's kernels and no
   other and call no plain version: Q1 the repo's default configuration
   (``"cuda"``, fused decode, ``sparse_prefill`` off: dense chunked
   prefill through ``flash_attention``) on requests 0, 1 and 3; Q2 the
   ``"dense"`` backend (``flash_attention``, ``paged_attention`` over the
   identity page table) on the same; Q3 an inactive plan (max_context
   4096: dense prefill and decode, no store) on prompts of 3000 and 2000
   tokens sharing a 1000-token prefix, and 1000; Q4 as Q1 with
   single-shot prefill (``prefill_chunk`` 0) on request 3; Q5 the sparse
   main path (``sparse_prefill``, fused decode) on requests 0 and 3.  Q1,
   Q2 and Q5 are served again through the plain versions, fed the kernel
   run's tokens: logit cosine at least 0.9995;
4. (run between phases 2b and 3, so that its profiler sessions come
   before the long ones of ``--profile``) time each kernel, its plain
   version and, where one PyTorch call computes the same function, that
   call, at the serving shapes, and compute its bound from this run's
   inputs.  ``fused_decode``, ``sparse_prefill`` (at chunk offsets 0,
   8192 and 15872; the kernel line takes 8192),
   ``centroid_scores_*``, ``paged_attention``, ``pool_rank_keys`` and
   ``topk_threshold`` and their library calls are timed by the device time
   of their kernels (``torch.profiler``; all but ``paged_attention`` in
   three rounds, in turns with their library calls), since back-to-back
   calls of a wrapper below about 0.05 ms time its host work under CUDA
   events (logged beside); ``fused_decode`` and ``sparse_prefill`` also
   print their device time by kernel, and ``fused_decode`` its time
   forced to one run of slots.  Then time the dense flash kernel over
   a 16384-token prompt against the 32 sparse-prefill chunks of 512 tokens
   of the same prompt (the dense baseline), by CUDA events and by device
   time, with SDPA beside; then the flash kernel at the chunk shape of
   dense prefill (32 / 8 heads, 512 queries at offset 8192 over 8704 live
   keys; SDPA with the equivalent boolean mask beside it; the kernel
   line's numbers, the S x S ones under ``sxs_*``) and ``paged_attention``
   over the identity page table of dense decode (B 4, 32 / 8 heads, mean
   live 12000; SDPA on the dense view beside it; ``identity_*`` keys).

Phase 2 also holds the three kernels off the serving path against their
plain versions: ``pool_rank_keys`` on llama3.2-3b K (bf16, B 4) and on f32
calibration keys for every method and block size (quest bitwise, mean /
arkvale within 1e-6 of the row's largest magnitude; the quest INT4 store
bytes of the ``"cuda"`` and ``"reference"`` backends identical; a moved
token shows in its block only; one pooled channel moved past the
tolerance fails the comparison), ``topk_threshold`` on the padded decode
scores and a grid of ties and +-inf (bitwise; its set equal to
``rank_blocks``' selection), ``flash_attention`` at B 1, 24/8 heads,
S 4096, causal and not.  It holds ``flash_attention`` with a query offset
and a key length as chunked dense prefill calls it (32 / 8 heads: 512
queries at offsets 8192 and 5003, one at 12345, over the keys written so
far of a 16384-row buffer; a key tile of one head left out must fail the
comparison) and ``paged_attention`` over dense decode's identity page
table (B 4, 32 / 8 heads, 1024 pages, ragged live lengths).  Phase 2b calibrates llama3.2-3b at full width
(28 layers x 8 kv heads, context 16384, budget 4096, INT4 quest store,
tau 0.98, 4 samples) through ``calibrate_for_config`` on the ``"cuda"``
backend and again on ``"reference"`` from the same seed: the assignments
must be identical, the recall within 1e-4, and the cuda run must have
launched the pooling and scoring kernels and called no plain version.

6. (after phase 5 on llama3.2-3b, after phase 3b on qwen3-8b) the
   compiled decode step: every serving engine of phases 3, 3b and 5
   captures each kernel rung's ``decode_step`` once as a CUDA graph
   (``repro_torch.serving.graphs``) and replays it every tick.  a) On a
   cache of random K/V at B 4 and ragged lengths near 16384, the eager and
   the graphed step run from the same state (fused and staged, each with
   and without telemetry; on qwen3-8b also the ``"dense"`` backend, the
   inactive plan at max_context 4096, and fused and dense near 9k tokens):
   logits and every written cache tensor (k, v, codes, seq_len,
   telemetry) must be bitwise equal, or else agree at a logit cosine of
   0.99999 with the same argmax (max |diff| per tensor printed).  b) Phase
   3's fused run and Q1 are served again under ``step_graphs_disabled()``,
   fed the graphed run's tokens: the eager run's greedy tokens must be the
   graphed run's.  c) Each variant's step is timed eager and graphed over
   15 rounds in turns (CUDA events), its device-busy ms per step printed
   (``torch.profiler``), and one profiled replay's launches of each decode
   kernel must equal the bookkeeping's for one step.  d) Every served run
   prints its decode steps and graph replays by rung; a kernel rung's
   decode step that is not a replay fails the script.

7. (after phase 6 on llama3.2-3b, on phase 3's weights and fused
   configuration, graphed) tiered KV memory: requests 0, 1, 3 and 5 (24
   new tokens, every prompt prefilled in its first ticks) served on a flat
   pool (run F) and on a tiered pool of 1552 device pages (the 1548 they
   hold and one a slot) and 1024 pinned host pages (run T), where request
   3's sink page is demoted around the shield once it decodes: T's tokens
   must equal F's, T must move bytes and keep its budget, the pool audit
   clean, and the forced miss stall request 3 with a finite row while the
   others commit.  Run O serves them on 1280 device pages (overcommitted;
   at full depth a decoding sequence's working set is every page it holds,
   so O holds admissions back: its tokens are counted against F's, its
   budget checked).  Run S serves them on T's pool under
   ``default_storm()`` seed 7, fed T's tokens, with one sink page demoted
   after every tick so that page I/O runs on the storm's ticks:
   ``host_io`` and ``promote_delay`` must fire, nothing be lost, every
   non-finite row be one the storm poisoned and every committed position's
   logits be within a cosine of 0.9995 of T's.  It prints the tiering
   counters, each request's working set against its pages, ms per page
   demotion and promotion (CUDA events) beside the PCIe Gen5 x16 bound,
   TTFT and TPOT p50 of F, T and O, the scoring launches the page masks
   add, and the graphed decode step with and without the masks (phase 6's
   method).

The next-to-last lines are the card and the ``{"kernels": [...]}`` record;
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the repository beside it, the script exits non-zero and prints no
result.  Long output goes to ``chiprun_out/chip_smoke.log``.  With
``--profile`` the fused and the staged serving runs go under
``torch.profiler`` (device activity) and the device time by kernel is
printed.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
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
#: requests of the staged serving run: those of the agreement check, since
#: with all six the script took 1.68x the first slice's time on the card
STAGED_REQS = AGREE_REQS
#: calibration (paper §3.2, Eq. 2) at full width: generator seed, samples
#: per layer, and the requests served with the calibrated assignment
CAL_SEED, CAL_SAMPLES, CAL_REQS = 0, 4, (0, 3)
CANDIDATES = (16, 32, 64)
#: forced split counts at which the fused decode kernel is also checked
FUSED_FORCED_SPLITS = (1, 5)
#: ... and the sparse prefill kernel (key-tile runs per cell)
PREFILL_FORCED_SPLITS = (1, 5)
#: dense flash attention: sequence length of the check against the plain
#: version (its [24, S, S] f32 logits fit in memory) and of the timing
FLASH_CHECK_S, FLASH_TIME_S = 4096, CTX
#: qwen3-8b at full width (phase 3b) and its GQA group
QWEN, QG = "qwen3-8b", 4
#: flash attention as chunked dense prefill calls it: a chunk at the middle
#: of the context over the keys written so far of a CTX-row cache row, and
#: at an offset that is no multiple of the 64-key tile
FLASH_CHUNK_OFF, FLASH_ODD_OFF = CTX // 2, 5003
#: dense decode over the identity page table: live lengths (mean 12000)
IDENTITY_LIVE = (CTX, 12000, 11001, 8615)
#: phase 3b's runs: requests of Q1 / Q2 (0 and 1 share the prefix), Q4
#: (single-shot prefill) and Q5 (sparse prefill); Q3 (plan inactive) serves
#: its own traffic: max_context, prompt lengths and their shared prefix
Q_REQS, Q4_REQS, Q5_REQS = (0, 1, 3), (3,), (0, 3)
Q3_CTX, Q3_LENS, Q3_PREFIX = 4096, (3000, 2000, 1000), 1000
#: phase 2's checks of fused_decode and sparse_prefill at qwen3-8b's heads
#: (N_KV x QG): Q1's live lengths halfway through its decode (its fourth
#: slot empty), and the last chunk of its 9000-token request
QWEN_DECODE_LIVE = tuple(PROMPT_LENS[i] + NEW_TOKENS // 2 for i in Q_REQS) + (1,)
QWEN_PREFILL_OFF = PROMPT_LENS[0] // CHUNK * CHUNK
QWEN_PREFILL_VALID = (PROMPT_LENS[0], QWEN_PREFILL_OFF + CHUNK,
                      QWEN_PREFILL_OFF + CHUNK * 3 // 5, QWEN_PREFILL_OFF + 1)

#: phase 5, the degradation ladder and a fault storm on phase 3's weights
#: and fused main-path configuration: the requests (0 and 1 share the
#: prefix), their new tokens, the clean decode ticks per re-promotion in
#: run L (24 tokens give about 25 decode ticks, too few for three windows
#: of the default 8), and the request the storm poisons on every tick
LADDER_REQS, LADDER_NEW, LADDER_REPROMOTE, STORM_VICTIM = (0, 1, 3, 5), 24, 4, 5
#: the kernels of the rungs' decode steps: (launched per layer, never)
RUNG_DECODE = {
    "fused": ({"fused_decode"}, {"centroid_scores_quantized", "paged_attention"}),
    "staged": ({"centroid_scores_quantized", "paged_attention"}, {"fused_decode"}),
    "reference": (set(), {"fused_decode", "centroid_scores_quantized",
                          "paged_attention", "sparse_prefill"}),
}

LOG = []
T_START = time.perf_counter()


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


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call of ``fn``: the summed times of the kernels it
    launches (``torch.profiler``), without the time the device waits for
    the host between calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in device_time_rows(torch, prof)) / iters


def short(name: str) -> str:
    """A kernel's name as the profiler gives it, without its namespace,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip() or name[:40]


def kernel_breakdown(torch, fn, iters: int) -> str:
    """Device ms per call of ``fn`` by kernel (``torch.profiler``), as text."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return ", ".join(f"{short(name)} {ms / iters:.4f}"
                     for ms, _, name in device_time_rows(torch, prof))


def device_rounds(torch, fns: dict, iters: int, rounds: int = 3) -> dict:
    """Device time per call (``device_ms``) of each function of ``fns``,
    timed in turns over ``rounds`` rounds -> name -> (median, [each
    round])."""
    got = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            got[name].append(device_ms(torch, fn, iters))
    return {name: (sorted(v)[len(v) // 2], v) for name, v in got.items()}


def fmt_rounds(v) -> str:
    return "/".join(f"{x:.4f}" for x in v)


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


def check_fused_decode(torch, dev, g=G, live=None, seed=1):
    """The fused kernel against its plain version at ``N_KV * g`` query
    heads and live lengths ``live`` (default: llama3.2-3b's group and
    ragged lengths up to CTX), at its planned and forced split counts, with
    the comparison's power check."""
    from repro_torch.backends.store import build_store_codes
    from repro_torch.core.centroids import rank_query
    from repro_torch.core.sparse_attention import paged_attention_reference
    from repro_torch.kernels import parity

    B = 4
    live = live or (CTX, CTX * 3 // 4 + 1, CTX * 7 // 16 - 3, CTX // 7)
    sparse, la, gen, k, v = layer_inputs(torch, dev, B, seed=seed)
    q = torch.randn((B, N_KV * g, D), generator=gen, device=dev)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    seq_len = torch.tensor(live, dtype=torch.int32, device=dev)
    log(f"fused_decode check at {N_KV * g}/{N_KV} heads, live {live}:")
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
    err = res["max_abs_err"]
    # the kernel at forced split counts: one run (the block writes the
    # output) and 5 (runs of unequal length), held against the plain
    # version; their page tables must equal the planned launch's
    for n_split in FUSED_FORCED_SPLITS:
        r = parity.compare_fused_decode(q, rq, k, v, store, la, sparse, seq_len,
                                        n_split=n_split)
        same = torch.equal(r["kernel"][1], table) and torch.equal(r["kernel"][2], valid)
        err = max(err, r["max_abs_err"])
        log(f"fused_decode check, n_split forced to {n_split}: valid exact, near-tie "
            f"blocks {r['near_ties']}, max_abs_err {r['max_abs_err']:.3e}, max rel L2 "
            f"{r['max_rel_l2']:.3e}, {r['tol_use']:.2f} of the elementwise limit; "
            f"page table equal to the planned launch's: {same}")
        if not same:
            fail(f"fused_decode with {n_split} runs selects other pages")
    return {"err": err, "table": table, "valid": valid,
            "sparse": sparse,
            "args": (q, rq, k, v, store, la, sparse.sink_pages,
                     sparse.local_pages, seq_len)}


def check_sparse_prefill(torch, dev, g=G, off=CTX // 2, valid=None, seed=2):
    """The sparse prefill kernel against its plain version on a CHUNK-query
    chunk at ``off`` with ``N_KV * g`` query heads and live lengths
    ``valid`` (default: llama3.2-3b's group and ragged lengths ending
    inside the chunk), at its planned and forced split counts."""
    from repro_torch.backends.base import CentroidStore
    from repro_torch.backends.store import build_score_rows
    from repro_torch.core.centroids import rank_query
    from repro_torch.core.quantization import store_bits
    from repro_torch.kernels import parity

    B, SQ, OFF = 4, CHUNK, off
    sparse, la, gen, k, v = layer_inputs(torch, dev, B, seed=seed)
    q = torch.randn((B, N_KV * g, SQ, D), generator=gen, device=dev)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    # ragged live lengths: later sequences end inside the chunk, leaving
    # dead trailing query blocks
    valid = valid or (OFF + SQ, OFF + SQ * 3 // 5, OFF + SQ // 8, OFF + 1)
    n_valid = torch.tensor(valid, dtype=torch.int32, device=dev)
    log(f"sparse_prefill check at {N_KV * g}/{N_KV} heads, offset {OFF}, live {valid}:")
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
    err = res["max_abs_err"]
    for n_split in PREFILL_FORCED_SPLITS:
        r = parity.compare_sparse_prefill(q, rq, k, v, ss, la, sparse, n_valid, OFF,
                                          n_split=n_split)
        err = max(err, r["max_abs_err"])
        log(f"sparse_prefill check, n_split forced to {n_split}: n_attended exact, "
            f"{r['near_ties']} near-tie blocks, max_abs_err {r['max_abs_err']:.3e}, "
            f"max rel L2 {r['max_rel_l2']:.3e}, {r['tol_use']:.2f} of the elementwise "
            f"limit")
    return {"err": err}


def check_centroid_scores(torch, dec, quant):
    """The staged scoring kernel on the fused check's inputs (same keys,
    queries and ragged lengths) with a ``quant`` store: scores against the
    plain version, the page tables selected from the two, and the staged
    page sets against the fused kernel's on the same store, which must be
    equal with no near tie (both score through one device function)."""
    from repro_torch.backends.store import build_store_codes
    from repro_torch.kernels import ops, parity

    q, rq, k, v, store, la, sink, local, seq_len = dec["args"]
    sparse = dataclasses.replace(dec["sparse"], quant=quant)
    if quant != store_quant(store):
        store = build_store_codes(k, la, sparse)
    res = parity.compare_centroid_scores(rq, store, la, sparse, seq_len)
    _, f_tbl, f_vld = ops.fused_decode(q, rq, k, v, store, la, sink, local, seq_len)
    torch.cuda.synchronize()
    same = parity.page_sets_equal(res["table"], res["valid"], f_tbl, f_vld)
    log(f"centroid_scores check ({quant}): max_abs_err {res['max_abs_err']:.3e}, "
        f"max error {res['max_rel_err']:.3e} of the head's largest |score| "
        f"(limit {parity.SCORE_RTOL}); page tables from kernel and plain scores: "
        f"valid exact, {res['near_ties']} near-tie blocks; staged page sets equal "
        f"to the fused kernel's: {same}")
    if not same:
        fail(f"staged page sets ({quant}) differ from the fused kernel's")
    # power: one score moved by twice the tolerance must fail the comparison
    bad = res["kernel"].clone()
    top = float(res["plain"][0, 0, : la.host.n_blocks[0]].abs().max())
    bad[0, 0, 1] = res["plain"][0, 0, 1] + 2 * parity.SCORE_RTOL * top
    try:
        parity.check_scores(bad, res["plain"], la, "power check")
    except AssertionError:
        log(f"centroid_scores check power ({quant}): one score moved by twice the "
            "tolerance fails the comparison")
    else:
        fail("the centroid_scores comparison cannot see a moved score")
    return {"err": res["max_abs_err"], "store": store, "plain": res["plain"],
            "kernel": res["kernel"]}


def store_quant(store):
    if store.bits == 0:
        return "none"
    return f"int{store.bits}_{'sym' if store.symmetric else 'asym'}"


def check_paged_attention(torch, dec, scored):
    """The paged-attention kernel on the page table selected from the plain
    scores, slots in rank order as the staged decode passes them."""
    from repro_torch.core.selection import select_page_table
    from repro_torch.kernels import ops, parity

    q, rq, k, v, store, la, sink, local, seq_len = dec["args"]
    tbl, vld = select_page_table(scored["plain"], la, seq_len, sink, local)
    res = parity.compare_paged_attention(q, k, v, tbl, vld, PS, seq_len)
    log(f"paged_attention check: max_abs_err {res['max_abs_err']:.3e}, max rel L2 "
        f"{res['max_rel_l2']:.3e} (limit {parity.REL_L2}), {res['tol_use']:.2f} of "
        f"the elementwise limit {parity.OUT_ATOL} + 2^-7 |plain|")
    # power: leave out one selected page per (b, head)
    mid = (vld.cumsum(-1) == vld.sum(-1, keepdim=True) // 2 + 1) & vld
    dropped = ops.paged_attention_reference(q, k, v, tbl, vld & ~mid, PS, seq_len)
    out_p = res["plain"].float()
    moved = ((dropped.float() - out_p).norm(dim=-1) / out_p.norm(dim=-1)).flatten()
    keep = torch.ones(out_p.shape[:-1], dtype=torch.bool, device=out_p.device)
    try:
        parity.check_outputs(dropped, res["plain"], keep, "power check")
    except AssertionError:
        log(f"paged_attention check power: one page left out per head moves a row "
            f"by median rel L2 {float(moved.median()):.3e} and fails the comparison")
    else:
        fail("the paged_attention comparison cannot see a page left out")
    return {"err": res["max_abs_err"], "table": tbl, "valid": vld}


def check_pool_rank_keys(torch, dev, dec):
    """The pooling kernel on the fused check's K (bf16, B 4, the serving
    cache) and on one layer of f32 calibration keys (the 8 kv heads as 8
    sequences, as ``profile_heads`` batches them), every method and block
    size; one moved token; the quest INT4 stores of both backends."""
    from repro_torch.backends import get_backend
    from repro_torch.core.calibration import make_model_like_batch
    from repro_torch.core.centroids import METHODS
    from repro_torch.kernels import block_centroid, parity

    q, rq, k, v, store, la, sink, local, seq_len = dec["args"]
    k_serve = k.reshape(k.shape[0], N_KV, CTX, D)
    gen = torch.Generator(device=dev).manual_seed(CAL_SEED)
    k_cal = make_model_like_batch(gen, N_KV, CTX, D, BUDGET)[1][:, None]
    err = 0.0
    for what, keys in (("bf16 serving K", k_serve), ("f32 calibration K", k_cal)):
        worst = {}
        for method in METHODS:
            for bs in CANDIDATES:
                res = parity.compare_pool_rank_keys(keys, bs, method)
                err = max(err, res["max_abs_err"])
                worst[method] = max(worst.get(method, 0.0), res["max_rel_err"])
        log(f"pool_rank_keys check ({what} {tuple(keys.shape)}): quest bitwise "
            f"equal, largest error of the row's largest magnitude per method "
            f"{json.dumps({m: float(f'{e:.3e}') for m, e in worst.items()})} "
            f"(limit {parity.POOL_RTOL}), block sizes {CANDIDATES}")
    t = 5 * 16 + 3
    moved = k_cal.clone()
    moved[1, 0, t] += 4.0
    for method in METHODS:
        a = block_centroid.pool_rank_keys(k_cal, 16, method)
        b = block_centroid.pool_rank_keys(moved, 16, method)
        changed = (a != b).any(-1)
        if not (bool(changed[1, 0, t // 16]) and int(changed.sum()) == 1):
            fail(f"pool_rank_keys ({method}): a moved token changed rows "
                 f"{changed.nonzero().tolist()}, not only its block's")
    log("pool_rank_keys check power: one token's key moved changes its block's "
        "rank key and no other, every method")
    # power: one pooled channel moved just past the tolerance (one ulp for
    # quest, twice POOL_RTOL of its row's largest magnitude for mean and
    # arkvale) must fail the comparison
    for method in METHODS:
        want = block_centroid.pool_rank_keys_plain(k_cal, 16, method)
        bad = block_centroid.pool_rank_keys(k_cal, 16, method)
        x = want[2, 0, 7, 5]
        bad[2, 0, 7, 5] = (torch.nextafter(x, x + 1) if method == "quest" else
                           x + 2 * parity.POOL_RTOL * want[2, 0, 7].abs().max())
        try:
            parity.check_pool(bad, want, method, "power check")
        except AssertionError:
            continue
        fail(f"the pool_rank_keys comparison ({method}) cannot see one moved channel")
    log("pool_rank_keys check power: one pooled channel moved past the tolerance "
        "(one ulp for quest) fails the comparison, every method")
    stores = {be: get_backend(be).build_store(k_serve, la.host, "quest", "int4_asym")
              for be in ("cuda", "reference")}
    a, b = stores["cuda"], stores["reference"]
    if not (torch.equal(a.codes, b.codes) and torch.equal(a.scale, b.scale)
            and torch.equal(a.zero, b.zero)):
        fail("build_store: the cuda backend's quest INT4 store differs from the "
             "reference backend's")
    log(f"build_store (quest, int4_asym, block sizes {BLOCKS}): cuda and "
        f"reference backends' codes, scale and zero identical")
    return {"err": err, "k_cal": k_cal, "k_serve": k_serve}


def check_topk_threshold(torch, dev, dec, scored):
    """The threshold kernel on the padded decode scores of the staged check
    (raw, and masked / pinned as the selection sees them) and on a grid of
    ties and +-inf: bitwise equal to the plain version, its set that of a
    stable sort, and on the masked scores ``rank_blocks``' selection."""
    from repro_torch.core.selection import mask_and_pin_scores, rank_blocks
    from repro_torch.kernels import parity

    q, rq, k, v, store, la, sink, local, seq_len = dec["args"]
    s = scored["kernel"].contiguous()                         # [4, 8, 1024]
    parity.compare_topk_threshold(s, la.top_k)
    masked = mask_and_pin_scores(s, la, seq_len, sink, local).contiguous()
    res = parity.compare_topk_threshold(masked, la.top_k)
    _, idx = rank_blocks(s, la, seq_len, sink, local)
    kmax = idx.shape[-1]
    first_k = (torch.arange(kmax, device=dev)[None, None, :]
               < la.top_k[None, :, None]).expand_as(idx)
    ranked = torch.zeros_like(masked, dtype=torch.bool).scatter(-1, idx.long(), first_k)
    if not torch.equal(res["selected"], ranked):
        fail("topk_threshold: the threshold's set differs from rank_blocks' selection")
    gen = torch.Generator(device=dev).manual_seed(5)
    grid = torch.round(torch.randn(s.shape, generator=gen, device=dev) * 2)
    grid[:, :, ::13] = float("-inf")
    grid[:, :, 3::17] = float("inf")
    grid[:, 2, 512:] = -1e30
    M = grid.shape[-1]
    ks = torch.randint(1, M + 1, (N_KV,), generator=gen, device=dev, dtype=torch.int32)
    ks[0], ks[1] = 1, M
    parity.compare_topk_threshold(grid.contiguous(), ks)
    log(f"topk_threshold check: padded decode scores {tuple(s.shape)} raw and "
        f"masked, and a grid of ties and +-inf: thresholds and counts bitwise "
        f"equal to the plain version; the set above the threshold plus the first "
        f"K - count ties equals rank_blocks' selection")
    return {"err": 0.0, "scores": masked, "k": la.top_k}


def check_flash_attention(torch, dev):
    """The dense flash kernel at B 1, 24 query / 8 kv heads, D 128,
    S ``FLASH_CHECK_S``, causal and not, against the plain version."""
    from repro_torch.kernels import parity

    gen = torch.Generator(device=dev).manual_seed(11)
    S = FLASH_CHECK_S
    q = (torch.randn((1, N_KV * G, S, D), generator=gen, device=dev)
         * parity.QSCALE).to(torch.bfloat16)
    k, v = (torch.randn((1, N_KV, S, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    err = 0.0
    for causal in (True, False):
        res = parity.compare_flash_attention(q, k, v, causal)
        err = max(err, res["max_abs_err"])
        if causal:
            plain = res["plain"]
        log(f"flash_attention check ({'causal' if causal else 'not causal'}, S {S}): "
            f"max_abs_err {res['max_abs_err']:.3e}, max rel L2 {res['max_rel_l2']:.3e} "
            f"(limit {parity.REL_L2}), {res['tol_use']:.2f} of the elementwise limit "
            f"{parity.OUT_ATOL} + 2^-7 |plain|")
    # power: the causal output of query head 0 with one 64-key tile (keys
    # S/2 .. S/2 + 63) left out must fail the comparison
    t0 = S // 2
    keep = torch.ones((S, S), dtype=torch.bool, device=dev).tril_()
    keep[:, t0:t0 + 64] = False
    logits = (q[0, 0].float() @ k[0, 0].float().T) * D ** -0.5
    dropped = plain.clone()
    dropped[0, 0] = (torch.softmax(torch.where(keep, logits, -1e30), -1)
                     @ v[0, 0].float()).to(q.dtype)
    moved = ((dropped[0, 0, t0:].float() - plain[0, 0, t0:].float()).norm(dim=-1)
             / plain[0, 0, t0:].float().norm(dim=-1))
    rows = torch.ones(plain.shape[:-1], dtype=torch.bool, device=dev)
    try:
        parity.check_outputs(dropped, plain, rows, "power check")
    except AssertionError:
        log(f"flash_attention check power: one key tile of one head left out moves "
            f"its rows at and after the tile by median rel L2 "
            f"{float(moved.median()):.3e} and fails the comparison")
    else:
        fail("the flash_attention comparison cannot see a key tile left out")
    return {"err": err}


def flash_chunk_inputs(torch, dev, seed):
    """A chunk of CHUNK queries at qwen3-8b's 32 / 8 heads (D 128) and a
    CTX-row K / V buffer, as ``prefill_chunk`` hands the flash kernel a
    slot's cache row."""
    from repro_torch.kernels import parity

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((1, N_KV * QG, CHUNK, D), generator=gen, device=dev)
         * parity.QSCALE).to(torch.bfloat16)
    k, v = (torch.randn((1, N_KV, CTX, D), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


def check_flash_offset(torch, dev):
    """The flash kernel with a query offset and a key length, as chunked
    dense prefill calls it, against its plain version: a CHUNK-query chunk
    at offset ``FLASH_CHUNK_OFF`` over the keys written so far
    (``FLASH_CHUNK_OFF + CHUNK`` of CTX rows), the same at
    ``FLASH_ODD_OFF`` (no multiple of the key tile), one query at offset
    12345 (at CTX 16384).  Power: the chunk's output with one 64-key tile
    of one head left out must fail the comparison."""
    from repro_torch.kernels import parity

    q, k, v = flash_chunk_inputs(torch, dev, seed=12)
    err, plain = 0.0, None
    for off, sq in ((FLASH_CHUNK_OFF, CHUNK), (FLASH_ODD_OFF, CHUNK),
                    (CTX * 3 // 4 + 57, 1)):
        qs = q[:, :, :sq].contiguous()
        res = parity.compare_flash_attention(qs, k, v, True, off, off + sq)
        err = max(err, res["max_abs_err"])
        if off == FLASH_CHUNK_OFF:
            plain = res["plain"]
        log(f"flash_attention offset check (32/8 heads, {sq} queries at offset {off}, "
            f"keys [0, {off + sq}) of {CTX}): max_abs_err {res['max_abs_err']:.3e}, "
            f"max rel L2 {res['max_rel_l2']:.3e} (limit {parity.REL_L2}), "
            f"{res['tol_use']:.2f} of the elementwise limit")
    off, n = FLASH_CHUNK_OFF, FLASH_CHUNK_OFF + CHUNK
    t0 = off // 2
    pos = off + torch.arange(CHUNK, device=dev)
    keep = torch.arange(n, device=dev)[None, :] <= pos[:, None]
    keep[:, t0:t0 + 64] = False
    logits = (q[0, 0].float() @ k[0, 0, :n].float().T) * D ** -0.5
    dropped = plain.clone()
    dropped[0, 0] = (torch.softmax(torch.where(keep, logits, -1e30), -1)
                     @ v[0, 0, :n].float()).to(q.dtype)
    moved = ((dropped[0, 0].float() - plain[0, 0].float()).norm(dim=-1)
             / plain[0, 0].float().norm(dim=-1))
    rows = torch.ones(plain.shape[:-1], dtype=torch.bool, device=dev)
    try:
        parity.check_outputs(dropped, plain, rows, "power check")
    except AssertionError:
        log(f"flash_attention offset check power: one key tile of one head left out "
            f"(keys {t0}..{t0 + 63}) moves its rows by median rel L2 "
            f"{float(moved.median()):.3e} and fails the comparison")
    else:
        fail("the flash_attention offset comparison cannot see a key tile left out")
    return {"err": err}


def check_paged_identity(torch, dev):
    """The paged-attention kernel over dense decode's identity page table
    (the ``"dense"`` backend, an inactive plan) at qwen3-8b's shape: B 4,
    32 / 8 heads, CTX / PS pages, live lengths ``IDENTITY_LIVE``."""
    from repro_torch.backends import get_backend
    from repro_torch.kernels import parity

    B = len(IDENTITY_LIVE)
    gen = torch.Generator(device=dev).manual_seed(13)
    kp, vp = (torch.randn((B, N_KV, CTX // PS, PS, D), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    q = (torch.randn((B, N_KV * QG, D), generator=gen, device=dev)
         * parity.QSCALE).to(torch.bfloat16)
    live = torch.tensor(IDENTITY_LIVE, dtype=torch.int32, device=dev)
    tbl, vld = get_backend("cuda").full_page_table(kp, live)
    res = parity.compare_paged_attention(q, kp, vp, tbl, vld, PS, live)
    log(f"paged_attention identity-table check (B {B}, 32/8 heads, {CTX // PS} pages, "
        f"live {list(IDENTITY_LIVE)}): max_abs_err {res['max_abs_err']:.3e}, max rel "
        f"L2 {res['max_rel_l2']:.3e}, {res['tol_use']:.2f} of the elementwise limit")
    return {"err": res["max_abs_err"], "args": (q, kp, vp, tbl, vld, live)}


# ---------------------------------------------------------------------------
# phase 2b: calibration (paper §3.2, Eq. 2) at full width
# ---------------------------------------------------------------------------


def calibrate_phase(torch, dev):
    """``calibrate_for_config`` on llama3.2-3b at full width, once through
    the kernels (``"cuda"``) and once through the plain versions
    (``"reference"``) from the same generator seed; each run's counts zeroed
    just before and read just after."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import calibrate_for_config, head_profile

    import numpy as np

    base = get_config(ARCH)
    cfg = dataclasses.replace(base, sparse=dataclasses.replace(
        base.sparse, token_budget=BUDGET, quant="int4_asym", tau=0.98,
        candidate_block_sizes=CANDIDATES))
    runs = {}
    for backend, launched in (("cuda", {"pool_rank_keys", "centroid_scores_quantized"}),
                              ("reference", set())):
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_cfg, res = calibrate_for_config(
            torch.Generator(device=dev).manual_seed(CAL_SEED), cfg, seq_len=CTX,
            n_samples=CAL_SAMPLES, backend=backend, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.counts()
        expect_path(f"calibration ({backend})", counts, launched)
        runs[backend] = {"cfg": new_cfg, "result": res, "counts": counts}
        log(f"calibration ({backend}): {cfg.n_layers} layers x {cfg.n_kv_heads} kv heads, "
            f"head_dim {cfg.resolved_head_dim}, context {CTX}, budget {BUDGET}, "
            f"{CAL_SAMPLES} samples, wall {wall:.1f}s; launches "
            f"{json.dumps({n: c['launches'] for n, c in counts.items() if c['launches']})}")
    rk, rr = runs["cuda"]["result"], runs["reference"]["result"]
    diff = float(abs(rk.recall - rr.recall).max())
    same = bool((rk.block_sizes == rr.block_sizes).all())
    log(f"calibration: cuda vs reference assignments identical: {same}; recall "
        f"max abs difference {diff:.3e} (limit 1e-4)")
    if not same:
        fail("the cuda and reference calibrations assign different block sizes")
    if not diff <= 1e-4:
        fail(f"the cuda and reference recall differ by {diff}")
    log("calibration assignment (layer: kv heads): " + "; ".join(
        f"{l}: {''.join('SML'[CANDIDATES.index(b)] for b in row)}"
        for l, row in enumerate(rk.as_tuple())) + "  (S 16, M 32, L 64)")
    names = [head_profile(h)[0] for h in range(N_KV)]
    per_profile = {}
    for name in dict.fromkeys(names):
        hs = [h for h in range(N_KV) if names[h] == name]
        per_profile[name] = [round(float(rk.recall[:, hs, i].mean()), 4)
                             for i in range(len(CANDIDATES))]
    log(f"calibration mean recall per head profile at block sizes {CANDIDATES}: "
        f"{json.dumps(per_profile)}")
    idx = np.searchsorted(CANDIDATES, rk.block_sizes)
    adaptive = float(np.take_along_axis(rk.recall, idx[..., None], -1).mean())
    uniform = {b: round(float(rk.recall[..., i].mean()), 4)
               for i, b in enumerate(CANDIDATES)}
    log(f"Table 1 proxy (calibration samples): adaptive recall {adaptive:.4f} at "
        f"average block size {rk.avg_block_size:.2f}; uniform recall "
        f"{json.dumps(uniform)}")
    return {"cfg": runs["cuda"]["cfg"], "result": rk,
            "launches": runs["cuda"]["counts"]["pool_rank_keys"]["launches"]}


# ---------------------------------------------------------------------------
# phase 4: times and bounds at the serving shapes
# ---------------------------------------------------------------------------


def time_fused_decode(torch, dec):
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    q, rq, k, v, store, la, sink, local, seq_len = dec["args"]
    kernel = lambda: ops.fused_decode(*dec["args"])
    one_run = lambda: ops.fused_decode(*dec["args"], n_split=1)
    dev_t = device_rounds(torch, {"kernel": kernel, "one_run": one_run}, 20)
    ms, rounds = dev_t["kernel"]
    event_ms = cuda_time_ms(torch, kernel, 5, 50)
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
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = pa.split_plan(q.shape[0], N_KV, tbl.shape[-1], n_sm)
    log(f"fused_decode, device ms per call by kernel: {kernel_breakdown(torch, kernel, 20)}")
    log(f"fused_decode (B {q.shape[0]}, {plan} runs x {q.shape[0] * N_KV} cells = "
        f"{plan * q.shape[0] * N_KV} blocks): device {ms:.4f} ms/launch (rounds "
        f"{fmt_rounds(rounds)}; CUDA events {event_ms:.4f}); forced to one run "
        f"{dev_t['one_run'][0]:.4f} (rounds {fmt_rounds(dev_t['one_run'][1])}); "
        f"bound {b_ms:.4f} ms ({by}), {b_ms / ms:.3f} of the bound")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}


#: chunk offsets at which sparse_prefill is timed: the first chunk, the
#: middle of the context (the kernel line's numbers) and the last chunk
PREFILL_OFFSETS = (0, CTX // 2, CTX - CHUNK)


def prefill_bound(torch, q, rq, k, v, ss, la, sparse, n_valid, off):
    """Least time of one sparse_prefill call on these inputs: the bytes it
    must move (queries, rank queries, the candidate score rows, the K/V of
    the blocks any query block attends, the output) and its operations
    (f32 scoring of live query rows x candidate blocks, bf16 QK^T and PV
    over the causal (live row, selected key) pairs)."""
    from repro_torch.kernels import parity

    dev = q.device
    extra, _ = parity.prefill_selection(q, rq, k, v, ss, la, sparse, n_valid, off)
    sel, cand, live_rows = extra["selected"], extra["cand"], extra["live_rows"]
    bsz = torch.tensor(la.host.block_sizes, device=dev)[None, :, None, None]
    M = sel.shape[-1]
    starts = torch.arange(M, device=dev)[None, None, None, :] * bsz
    nv = n_valid.long()[:, None, None, None]
    keys = torch.clamp(torch.minimum(bsz, nv - starts), min=0)
    kv_tokens = int((keys[:, :, 0] * sel.any(dim=2)).sum())
    n_cand_rows = int(cand.any(dim=2).sum())
    row_bytes = ss.codes.shape[-1] * ss.codes.element_size() + 8
    Dp = rq.shape[-1]
    bytes_ = (q.numel() * 2 + rq.numel() * 4 + n_cand_rows * row_bytes
              + 2 * kv_tokens * D * 2 + q.numel() * 2 + sel[..., 0].numel() * 4)
    f32_ops = 2 * Dp * float((cand.sum(-1) * live_rows[:, None, :]).sum())
    bf16_ops = 4 * D * float(extra["pairs"].sum())
    return bound(bytes_, f32_ops, bf16_ops)


def time_sparse_prefill(torch, dev):
    """B 1, one prefill chunk of CHUNK tokens as the engine issues it, at the
    chunk offsets ``PREFILL_OFFSETS``: device time of the call's kernels
    (``device_rounds``, three rounds) beside CUDA events around
    back-to-back calls; the bound from each offset's inputs.  The kernel
    line takes the middle offset's numbers."""
    from repro_torch.backends.store import build_score_rows
    from repro_torch.backends.base import CentroidStore
    from repro_torch.core.centroids import rank_query
    from repro_torch.core.quantization import store_bits
    from repro_torch.kernels import ops, sparse_prefill as sp

    B, SQ = 1, CHUNK
    sparse, la, gen, k, v = layer_inputs(torch, dev, B, seed=3)
    q = torch.randn((B, N_KV * G, SQ, D), generator=gen, device=dev).to(torch.bfloat16)
    codes, sc, ze = build_score_rows(k, la, sparse)
    ss = CentroidStore(codes, sc, ze, store_bits(sparse.quant), False)
    rq = rank_query(q, sparse.centroid_method, D)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    nQB = SQ // sparse.prefill_block_q
    n_split = sp.prefill_split_plan(B * N_KV * nQB, G * sparse.prefill_block_q, n_sm)
    rows = G * sparse.prefill_block_q
    blocks = n_split * sp.attend_blocks(B * N_KV * nQB, rows)
    res = {}
    for off in PREFILL_OFFSETS:
        n_valid = torch.tensor([off + SQ], dtype=torch.int32, device=dev)
        kw = dict(sink_pages=sparse.sink_pages, local_pages=sparse.local_pages,
                  block_q=sparse.prefill_block_q, topk_scale=sparse.prefill_topk_scale,
                  n_valid=n_valid, chunk_offset=off)
        # the kernel's wrapper on query blocks laid out beforehand, and the
        # entry point that lays them out (two copies) and calls it
        q6, rq6, k_sel, nv, qb0 = ops._prefill_query_blocks(
            q, rq, la, sparse.prefill_block_q, sparse.prefill_topk_scale, n_valid, off)
        kernel = lambda: sp.sparse_prefill(
            q6, rq6, k, v, ss.codes, ss.scale, ss.zero, la, k_sel, nv, qb0,
            bits=ss.bits, symmetric=ss.symmetric, block_q=sparse.prefill_block_q,
            sink_pages=sparse.sink_pages, local_pages=sparse.local_pages)
        call = lambda: ops.sparse_prefill(q, rq, k, v, ss, la, **kw)
        dev_t = device_rounds(torch, {"kernel": kernel, "call": call}, 20)
        ms, rounds = dev_t["kernel"]
        event_ms = cuda_time_ms(torch, kernel, 3, 20)
        b_ms, by = prefill_bound(torch, q, rq, k, v, ss, la, sparse, n_valid, off)
        res[off] = {"ms": ms, "event_ms": event_ms, "bound_ms": b_ms, "bound_by": by}
        log(f"sparse_prefill at offset {off}, device ms per call by kernel: "
            f"{kernel_breakdown(torch, kernel, 20)}")
        log(f"sparse_prefill (B 1, chunk {SQ} at offset {off}, {n_split} runs x "
            f"{B * N_KV * nQB} cells = {blocks} attention blocks of "
            f"{sp.attend_warpgroups(rows)} warpgroups): device {ms:.4f} "
            f"ms/call (rounds {fmt_rounds(rounds)}; CUDA events {event_ms:.4f}), bound "
            f"{b_ms:.4f} ms ({by}), {b_ms / ms:.3f} of the bound; "
            f"ops.sparse_prefill with its layout copies {dev_t['call'][0]:.4f} "
            f"(rounds {fmt_rounds(dev_t['call'][1])})")
    mid = PREFILL_OFFSETS[1]
    n_valid = torch.tensor([mid + SQ], dtype=torch.int32, device=dev)
    kw = dict(sink_pages=sparse.sink_pages, local_pages=sparse.local_pages,
              block_q=sparse.prefill_block_q, topk_scale=sparse.prefill_topk_scale,
              n_valid=n_valid, chunk_offset=mid)
    plain_ms = cuda_time_ms(
        torch, lambda: ops.sparse_prefill_reference(q, rq, k, v, ss, la, **kw), 1, 2)
    r = res[mid]
    return {"ms": r["ms"], "plain_ms": plain_ms, "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "event_ms": r["event_ms"],
            "ms_by_offset": {str(o): round(x["ms"], 5) for o, x in res.items()}}


def time_centroid_scores(torch, dec, scored):
    """One B = 4 scoring launch over the whole store (every row is scored).
    Library yardstick for the f32 store: one ``torch.matmul`` of the rows by
    all n_q rank queries, every head's queries against every row (a superset
    of the work); none dequantizes split-half INT4.  The kernel and the
    yardstick are timed by device time (``device_rounds``), in turns; CUDA
    events around back-to-back calls, which time the wrapper's host work at
    this size, are logged beside them."""
    from repro_torch.kernels import centroid_score as cs

    q, rq, k, v, _, la, sink, local, seq_len = dec["args"]
    st = scored["store"]
    B, n_q, Dp = rq.shape
    rows = st.codes.shape[1]
    if st.bits:
        args = (rq, st.codes, st.scale, st.zero, la.tile_head, la.tile_rows)
        kw = dict(bits=st.bits, symmetric=st.symmetric)
        fns = {"kernel": lambda: cs.centroid_scores_quantized(*args, **kw)}
    else:
        args = (rq, st.codes, None, None, la.tile_head, la.tile_rows)
        kw = dict(bits=0, symmetric=False, n_kv=N_KV)
        rq_t = rq.transpose(1, 2).contiguous()
        fns = {"kernel": lambda: cs.centroid_scores_f32(rq, st.codes, N_KV, la.tile_head,
                                                        la.tile_rows),
               "library": lambda: torch.matmul(st.codes, rq_t)}
    dev_t = device_rounds(torch, fns, 50)
    ms, rounds = dev_t["kernel"]
    library_ms = dev_t["library"][0] if "library" in dev_t else None
    event_ms = cuda_time_ms(torch, fns["kernel"], 5, 50)
    plain_ms = cuda_time_ms(torch, lambda: cs.centroid_scores_plain(*args, **kw), 1, 5)
    bytes_ = (rq.numel() * 4 + st.codes.numel() * st.codes.element_size()
              + (2 * st.scale.numel() * 4 if st.bits else 0)
              + la.tile_head.numel() * 4 + B * rows * 4)
    f32_ops = 2 * B * rows * G * Dp
    b_ms, by = bound(bytes_, f32_ops, 0)
    lib = ("none" if library_ms is None else f"device {library_ms:.4f} "
           f"(rounds {fmt_rounds(dev_t['library'][1])})")
    log(f"centroid_scores ({'INT' + str(st.bits) if st.bits else 'f32'} store, B {B}, "
        f"{rows} rows x Dp {Dp}): device {ms:.4f} ms/launch (rounds "
        f"{fmt_rounds(rounds)}; CUDA events {event_ms:.4f}), torch.matmul {lib}, "
        f"bound {b_ms:.4f} ms ({by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms}


def time_paged_attention(torch, dec, att):
    """One B = 4 launch on the staged page table of the check (rank order).
    Library yardstick: ``scaled_dot_product_attention`` over the selected
    K/V gathered beforehand (the gather is not timed), each head's group as
    its query rows, the token mask as ``attn_mask``.  The kernel and the
    yardstick are timed by the device time of their kernels
    (``device_ms``): back-to-back calls of the wrapper take longer on the
    host than on the device, so CUDA events around them (logged too) time
    the host."""
    from repro_torch.kernels import paged_attention as pa

    q, rq, k, v, _, la, sink, local, seq_len = dec["args"]
    tbl, vld = att["table"], att["valid"]
    B, n_q, _ = q.shape
    args = (q, k, v, tbl, vld, seq_len, PS)
    kernel = lambda: pa.paged_attention(*args)
    ms = device_ms(torch, kernel, 50)
    event_ms = cuda_time_ms(torch, kernel, 5, 50)
    plain_ms = cuda_time_ms(torch, lambda: pa.paged_attention_plain(*args), 1, 5)
    P = tbl.shape[-1]
    pos = tbl.long()[..., None] * PS + torch.arange(PS, device=q.device)
    live = ((pos < seq_len.long()[:, None, None, None]) & vld[..., None])
    live = live.reshape(B, N_KV, P * PS)
    idx = tbl.long()[..., None, None].expand(-1, -1, -1, PS, D)
    sel_k = torch.gather(k, 2, idx).reshape(B, N_KV, P * PS, D)
    sel_v = torch.gather(v, 2, idx).reshape(B, N_KV, P * PS, D)
    q4 = q.reshape(B, N_KV, G, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(q4, sel_k, sel_v, attn_mask=live[:, :, None, :])
    library_ms = device_ms(torch, library, 50)
    library_event_ms = cuda_time_ms(torch, library, 5, 50)
    tokens = int(live.sum())
    bytes_ = (2 * q.numel() * 2 + 2 * tokens * D * 2 + tbl.numel() * 4
              + vld.numel() + seq_len.numel() * 4)
    f32_ops = 4 * tokens * G * D
    b_ms, by = bound(bytes_, f32_ops, 0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"paged_attention (B {B}, {pa.split_plan(B, N_KV, P, n_sm)} "
        f"splits): device {ms:.4f} ms/call (CUDA events over back-to-back calls "
        f"{event_ms:.4f}), SDPA device {library_ms:.4f} (events {library_event_ms:.4f}), "
        f"bound {b_ms:.4f} ms ({by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms}


def time_pool_rank_keys(torch, pool):
    """One calibration launch (8 kv heads as sequences x 16384 tokens x 128
    f32, quest, block size 16: the most rank keys), and the bf16 serving
    cache (B 4), whose numbers go under ``serving_*`` keys.  Library
    yardstick: ``torch.aminmax`` over the block axis, the same max and min
    in one call, not concatenated or padded.  Kernel and yardstick by device
    time, in turns (``device_rounds``); CUDA events logged beside them."""
    from repro_torch.kernels import block_centroid as bc

    out = {}
    for what, keys in (("calibration", pool["k_cal"]), ("serving", pool["k_serve"])):
        blocks = keys.reshape(*keys.shape[:2], keys.shape[2] // 16, 16, keys.shape[3])
        fns = {"kernel": lambda: bc.pool_rank_keys(keys, 16, "quest"),
               "library": lambda: torch.aminmax(blocks, dim=-2)}
        dev_t = device_rounds(torch, fns, 50)
        ms, library_ms = dev_t["kernel"][0], dev_t["library"][0]
        event_ms = cuda_time_ms(torch, fns["kernel"], 5, 50)
        plain_ms = cuda_time_ms(torch, lambda: bc.pool_rank_keys_plain(keys, 16, "quest"), 1, 5)
        out_bytes = keys.numel() // 16 * 2 * 4
        b_ms, by = bound(keys.numel() * keys.element_size() + out_bytes,
                         2 * keys.numel(), 0)
        out[what] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                     "library_ms": library_ms}
        log(f"pool_rank_keys ({what}, {tuple(keys.shape)} {str(keys.dtype)[6:]}, quest, "
            f"block 16): device {ms:.4f} ms/launch (rounds "
            f"{fmt_rounds(dev_t['kernel'][1])}; CUDA events {event_ms:.4f}), plain "
            f"{plain_ms:.3f} ms, torch.aminmax device {library_ms:.4f} (rounds "
            f"{fmt_rounds(dev_t['library'][1])}), bound {b_ms:.4f} ms ({by})")
    return {**out["calibration"],
            **{f"serving_{k}": v for k, v in out["serving"].items()}}


def time_topk_threshold(torch, topk):
    """One launch on the masked decode scores ``[4, 8, 1024]``, K_h from the
    layout.  Library yardstick: ``torch.topk`` of the largest K_h (values
    and indices, in no promised tie order).  Both by device time, in
    turns."""
    from repro_torch.kernels import topk_threshold as tk

    s, k = topk["scores"], topk["k"]
    kmax = int(k.max())
    fns = {"kernel": lambda: tk.topk_threshold(s, k),
           "library": lambda: torch.topk(s, kmax, dim=-1)}
    dev_t = device_rounds(torch, fns, 100)
    ms, library_ms = dev_t["kernel"][0], dev_t["library"][0]
    event_ms = cuda_time_ms(torch, fns["kernel"], 5, 100)
    plain_ms = cuda_time_ms(torch, lambda: tk.topk_threshold_plain(s, k), 2, 20)
    B, H, M = s.shape
    # 33 passes of a compare and a count over each score (integer work,
    # counted at the f32 CUDA-core rate)
    b_ms, by = bound(s.numel() * 4 + k.numel() * 4 + B * H * 8, 2 * 33 * s.numel(), 0)
    log(f"topk_threshold ({tuple(s.shape)}): device {ms:.4f} ms/launch (rounds "
        f"{fmt_rounds(dev_t['kernel'][1])}; CUDA events {event_ms:.4f}), torch.topk "
        f"device {library_ms:.4f} (rounds {fmt_rounds(dev_t['library'][1])}), bound "
        f"{b_ms:.5f} ms ({by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms}


def time_flash_attention(torch, dev):
    """Dense causal flash attention over one 16384-token prompt of one layer
    (B 1, 24 query / 8 kv heads, D 128) and the 32 sparse-prefill chunks of
    512 tokens of the same prompt, K and V (the dense baseline).  Library
    yardstick: ``scaled_dot_product_attention`` with ``is_causal``."""
    from repro_torch.backends.base import CentroidStore
    from repro_torch.backends.store import build_score_rows
    from repro_torch.core.centroids import rank_query
    from repro_torch.core.quantization import store_bits
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    S = FLASH_TIME_S
    sparse, la, gen, kp, vp = layer_inputs(torch, dev, 1, seed=3)
    q = torch.randn((1, N_KV * G, S, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = kp.reshape(1, N_KV, S, D), vp.reshape(1, N_KV, S, D)
    ms = cuda_time_ms(torch, lambda: fa.flash_attention(q, k, v, True), 3, 20)
    plain_ms = cuda_time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True), 1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        library = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        library()
    except TypeError:       # no enable_gqa: K/V expanded beforehand, not timed
        ke, ve = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
        library = lambda: sdpa(q, ke, ve, is_causal=True)
    library_ms = cuda_time_ms(torch, library, 3, 10)
    pairs = N_KV * G * S * (S + 1) // 2
    b_ms, by = bound((2 * q.numel() + k.numel() + v.numel()) * 2, 0, 4 * D * pairs)

    codes, sc, ze = build_score_rows(kp, la, sparse)
    ss = CentroidStore(codes, sc, ze, store_bits(sparse.quant), False)
    rq = rank_query(q, sparse.centroid_method, D)
    kw = dict(sink_pages=sparse.sink_pages, local_pages=sparse.local_pages,
              block_q=sparse.prefill_block_q, topk_scale=sparse.prefill_topk_scale)
    chunks = [(q[:, :, c:c + CHUNK].contiguous(), rq[:, :, c:c + CHUNK].contiguous(),
               torch.tensor([c + CHUNK], dtype=torch.int32, device=dev), c)
              for c in range(0, S, CHUNK)]

    def sparse_prompt():
        for qc, rqc, nv, off in chunks:
            ops.sparse_prefill(qc, rqc, kp, vp, ss, la, n_valid=nv, chunk_offset=off, **kw)

    sparse_ms = cuda_time_ms(torch, sparse_prompt, 1, 1)
    dev_t = device_rounds(torch, {"flash": lambda: fa.flash_attention(q, k, v, True),
                                  "sdpa": library, "sparse": sparse_prompt}, 3)
    d_flash, d_sdpa, d_sparse = (dev_t[n][0] for n in ("flash", "sdpa", "sparse"))
    log(f"dense baseline: flash_attention over the {S}-token prompt (causal, one "
        f"layer) {ms:.3f} ms against {sparse_ms:.3f} ms for its {len(chunks)} "
        f"sparse_prefill chunks of {CHUNK}: dense / sparse = {ms / sparse_ms:.3f}; "
        f"SDPA {library_ms:.3f} ms (CUDA events)")
    log(f"dense baseline by device time (three rounds): flash {d_flash:.4f} ms "
        f"({fmt_rounds(dev_t['flash'][1])}), SDPA {d_sdpa:.4f} "
        f"({fmt_rounds(dev_t['sdpa'][1])}), the {len(chunks)} sparse_prefill chunks "
        f"{d_sparse:.4f} ({fmt_rounds(dev_t['sparse'][1])}): dense flash / sparse = "
        f"{d_flash / d_sparse:.3f}, SDPA / sparse = {d_sdpa / d_sparse:.3f}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms, "sparse_ms": sparse_ms, "device_ms": d_flash,
            "library_device_ms": d_sdpa}


def time_flash_chunk(torch, dev):
    """The flash kernel at the chunk shape of dense prefill (qwen3-8b's 32 /
    8 heads, D 128, CHUNK queries at offset ``FLASH_CHUNK_OFF`` over the
    keys written so far of a CTX-row buffer), by the device time of its
    kernel in three rounds, in turns with its library call:
    ``scaled_dot_product_attention`` on the live keys with the equivalent
    boolean mask (K / V sliced beforehand, not timed)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = flash_chunk_inputs(torch, dev, seed=14)
    off = FLASH_CHUNK_OFF
    n = off + CHUNK
    kernel = lambda: fa.flash_attention(q, k, v, True, off, n)
    ks, vs = k[:, :, :n].contiguous(), v[:, :, :n].contiguous()
    mask = (torch.arange(n, device=dev)[None, :]
            <= off + torch.arange(CHUNK, device=dev)[:, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        library = lambda: sdpa(q, ks, vs, attn_mask=mask, enable_gqa=True)
        library()
    except TypeError:       # no enable_gqa: K/V expanded beforehand, not timed
        ke, ve = ks.repeat_interleave(QG, dim=1), vs.repeat_interleave(QG, dim=1)
        library = lambda: sdpa(q, ke, ve, attn_mask=mask)
    dev_t = device_rounds(torch, {"kernel": kernel, "library": library}, 20)
    ms, library_ms = dev_t["kernel"][0], dev_t["library"][0]
    event_ms = cuda_time_ms(torch, kernel, 3, 20)
    plain_ms = cuda_time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True, off, n),
                            1, 3)
    pairs = N_KV * QG * sum(off + i + 1 for i in range(CHUNK))
    b_ms, by = bound((2 * q.numel() + 2 * N_KV * n * D) * 2, 0, 4 * D * pairs)
    log(f"flash_attention at the chunk shape (B 1, 32/8 heads, {CHUNK} queries at offset "
        f"{off}, {n} live keys): device {ms:.4f} ms/call (rounds "
        f"{fmt_rounds(dev_t['kernel'][1])}; CUDA events {event_ms:.4f}), SDPA with the "
        f"boolean mask device {library_ms:.4f} (rounds {fmt_rounds(dev_t['library'][1])}), "
        f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({by}), {b_ms / ms:.3f} of the bound")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms, "event_ms": event_ms}


def time_paged_identity(torch, ident):
    """The paged-attention kernel over the identity page table of dense
    decode (B 4, 32 / 8 heads, live ``IDENTITY_LIVE``) by device time, in
    turns with its library call: ``scaled_dot_product_attention`` over the
    dense view of the same K / V, each head's group as its query rows, the
    live keys as ``attn_mask``."""
    from repro_torch.kernels import paged_attention as pa

    q, kp, vp, tbl, vld, live = ident["args"]
    B = q.shape[0]
    kernel = lambda: pa.paged_attention(q, kp, vp, tbl, vld, live, PS)
    kd, vd = kp.reshape(B, N_KV, CTX, D), vp.reshape(B, N_KV, CTX, D)
    mask = (torch.arange(CTX, device=q.device)[None, :] < live[:, None])[:, None, None, :]
    q4 = q.reshape(B, N_KV, QG, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(q4, kd, vd, attn_mask=mask)
    dev_t = device_rounds(torch, {"kernel": kernel, "library": library}, 50)
    ms, library_ms = dev_t["kernel"][0], dev_t["library"][0]
    plain_ms = cuda_time_ms(
        torch, lambda: pa.paged_attention_plain(q, kp, vp, tbl, vld, live, PS), 1, 5)
    tokens = int(live.long().sum()) * N_KV
    bytes_ = (2 * q.numel() * 2 + 2 * tokens * D * 2 + tbl.numel() * 4 + vld.numel()
              + live.numel() * 4)
    b_ms, by = bound(bytes_, 4 * tokens * QG * D, 0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"paged_attention over the identity table (B {B}, 32/8 heads, "
        f"{tbl.shape[-1]} pages, live {list(IDENTITY_LIVE)}, "
        f"{pa.split_plan(B, N_KV, tbl.shape[-1], n_sm)} splits): device {ms:.4f} "
        f"ms/call (rounds {fmt_rounds(dev_t['kernel'][1])}), SDPA on the dense view "
        f"device {library_ms:.4f} (rounds {fmt_rounds(dev_t['library'][1])}), plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({by}), {b_ms / ms:.3f} of the bound")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------


def device_time_rows(torch, prof):
    """(device ms, launches, kernel name) per kernel of a torch.profiler run
    of device activity only, largest first."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / 1e3, ev.count, ev.key))
    if not rows:
        fail("the profiler recorded no device time")
    return sorted(rows, reverse=True)


def profile_summary(torch, prof, wall_s: float):
    """Device time by kernel from a torch.profiler run: the top kernels and
    the device busy share of the profiled wall time (one stream, so kernel
    times do not overlap)."""
    rows = device_time_rows(torch, prof)
    busy_ms = sum(r[0] for r in rows)
    log(f"profile: device busy {busy_ms:.0f} ms of {wall_s * 1e3:.0f} ms wall "
        f"({100 * busy_ms / max(wall_s * 1e3, 1e-9):.1f}%)")
    for ms, n, key in rows[:12]:
        log(f"profile: {ms:10.1f} ms {100 * ms / max(busy_ms, 1e-9):5.1f}% "
            f"of device  x{n:6d}  {key[:90]}")


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


def q3_traffic(vocab: int):
    """Run Q3's prompts (numpy seed 1): ``Q3_LENS`` tokens each, the first
    two sharing a ``Q3_PREFIX``-token prefix (no multiple of the 64-token
    query block, so the chunk after the installed prefix starts off it)."""
    import numpy as np

    rng = np.random.default_rng(1)
    prefix = rng.integers(0, vocab, Q3_PREFIX)
    prompts = []
    for i, n in enumerate(Q3_LENS):
        p = rng.integers(0, vocab, n)
        if i < 2:
            p[:Q3_PREFIX] = prefix
        prompts.append(p.astype(np.int32))
    return prompts


def use_config(model, cfg, backend=None):
    """Point ``model`` (same weights) at ``cfg``'s sparse settings: the
    backend (or ``backend``, an instance), fused or staged decode, the
    store's quantization."""
    from repro_torch.backends import get_backend

    model.cfg = cfg
    model.backend = backend or get_backend(cfg.sparse.backend)


def make_engine(cfg, model, dev, req_ids, new_tokens, telemetry=False,
                prompts=None, backend=None, **serve_kw):
    """An ``Engine`` over ``model`` with ``cfg`` (``backend`` in place of
    its registered backend), max_batch ``MAX_BATCH``, context CTX, chunks
    of CHUNK (``serve_kw`` overrides), temperature 0, and requests
    ``req_ids`` of ``prompts`` (default: ``traffic``) submitted."""
    from repro_torch.config import ServeConfig
    from repro_torch.serving import Engine, Request

    use_config(model, cfg, backend)
    serve_cfg = ServeConfig(**{**dict(max_batch=MAX_BATCH, max_context=CTX,
                                      prefill_chunk=CHUNK, temperature=0.0),
                               **serve_kw})
    eng = Engine(cfg, model, serve_cfg, device=dev, telemetry=telemetry)
    prompts = traffic(cfg.vocab_size) if prompts is None else prompts
    for i in req_ids:
        eng.submit(Request(req_id=i, prompt=prompts[i], max_new_tokens=new_tokens))
    return eng


def check_served(eng, done, n_requests, new_tokens, vocab, prefix_hit=True):
    if len(done) != n_requests:
        fail(f"served {len(done)} of {n_requests} requests")
    for r in done:
        if len(r.output) != new_tokens or not all(0 <= t < vocab for t in r.output):
            fail(f"request {r.req_id}: bad output {r.output[:8]}...")
    pins = eng.prefix_cache.pages() if eng.prefix_cache is not None else None
    if eng.pool.assert_consistent(known_pins=pins):
        fail("page pool leaked pages")
    snap = eng.metrics.snapshot()
    if prefix_hit and snap["prefix_hit_tokens"] <= 0:
        fail("the shared prefix was not served from the prefix cache")
    if eng._fault is None and (snap["degradations"] or eng._rung):
        # no hidden fallback: without injected faults the ladder never moves
        fail(f"a run without faults left rung 0: {snap['degradations_by_rung']}")
    if eng._fault is None and (snap["sampler_anomalies"] or snap["retries"]):
        fail(f"a run without faults saw {snap['sampler_anomalies']} non-finite rows "
             f"and {snap['retries']} retries")


def run_engine(torch, eng, forced=None, record=False, profile=False,
               probe=None, tick_hook=None):
    """Run ``eng`` to the end with every kernel's counts set to 0 just before
    and read just after -> dict with the finished requests, the counts, the
    model steps taken, the wall time, the ``LadderProbe`` (``probe``, or a
    new one) and, with ``record``, every sampled row's logits and token by
    (request, position) and the tick it was last sampled at.  With
    ``forced`` ({(request, position): token}) the engine is fed those tokens
    in place of its own samples.  ``tick_hook(engine, tick, samples)`` runs
    after every tick, after the probe."""
    from repro_torch import kernels
    from repro_torch.serving.probe import LadderProbe, SampleRecorder

    samples = SampleRecorder(eng, forced) if record else None
    probe = probe or LadderProbe(eng)
    callback = probe
    if tick_hook is not None:
        def callback(e, tick):
            probe(e, tick)
            tick_hook(e, tick, samples)
    prof = None
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profile:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            done = eng.run_until_done(max_ticks=2000, tick_callback=callback)
            torch.cuda.synchronize()
    else:
        done = eng.run_until_done(max_ticks=2000, tick_callback=callback)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    probe.detach()
    run = {"done": done, "counts": counts, "wall": wall, "prof": prof,
           "probe": probe, "logits": {}, "tokens": {}, "ticks": {},
           "graph_steps": graph_steps(eng, probe),
           "steps": {name: sum(k == kind for st in probe.steps.values()
                               for _, k, _ in st)
                     for name, kind in (("decode_step", "decode"),
                                        ("prefill_chunk", "chunk"))}}
    if samples is not None:
        samples.detach()
        run.update(logits=samples.logits, tokens=samples.tokens, ticks=samples.ticks)
    return run


def graph_steps(eng, probe):
    """Phase 6 d): decode steps and graph replays by rung of a served run
    -> {rung: {"decode_steps": n, "replays": m}}.  Fails if a kernel rung
    of an engine built with graphs took an eager decode step."""
    steps = {}
    for st in probe.steps.values():
        for rung, kind, _ in st:
            steps[rung] = steps.get(rung, 0) + (kind == "decode")
    out = {}
    for rung, n in sorted(steps.items()):
        graph = eng._step_graphs.get(rung)
        replays = graph.replays if graph is not None else 0
        name = eng._ladder[rung][0]
        if eng._graphed and not eng._rung_models[rung].backend.plain and replays != n:
            fail(f"rung {name} took {n} decode steps and {replays} graph replays")
        out[name] = {"decode_steps": n, "replays": replays}
    return out


def expect_path(what, counts, launched):
    """The run went through exactly the kernels in ``launched`` (each
    launched at least once, every other kernel never) and called no plain
    version; with ``launched`` empty, through the plain versions only."""
    for name, c in counts.items():
        if launched and c["plain_calls"]:
            fail(f"{what}: {name}'s plain version ran {c['plain_calls']} times")
        if (c["launches"] > 0) != (name in launched):
            fail(f"{what}: {name} launched {c['launches']} times")
    if not launched and not any(c["plain_calls"] for c in counts.values()):
        fail(f"{what}: no plain version ran")


def log_serving(what, run, snap):
    dec_tok, wall = snap["decode_tokens"], run["wall"]
    log(f"{what}: {len(run['done'])} requests finished, {dec_tok} tokens "
        f"(+{snap['prefill_tokens_computed']} prefill), prefix-hit tokens "
        f"{snap['prefix_hit_tokens']}, ticks {snap['ticks']}, wall {wall:.1f}s")
    log(f"{what}: TTFT p50 {snap['ttft_p50']:.3f}s, TPOT p50 "
        f"{snap['tpot_p50'] * 1e3:.1f}ms, decode tok/s "
        f"{dec_tok / max(wall, 1e-9):.1f} (over the whole run)")
    launched = {n: c["launches"] for n, c in run["counts"].items() if c["launches"]}
    log(f"{what}: launches {json.dumps(launched)}; decode steps "
        f"{run['steps']['decode_step']}, prefill chunks {run['steps']['prefill_chunk']}; "
        f"decode steps and graph replays by rung {json.dumps(run['graph_steps'])}")


#: the sparsity counters of ``Engine(telemetry=True)`` that must agree
#: between runs fed the same tokens (they depend on lengths and layout only)
SPARSITY_KEYS = ("sparsity_steps", "blocks_per_step", "pages_per_step",
                 "budget_utilization", "forced_frac", "prefill_chunks",
                 "prefill_blocks_attended", "prefill_blocks_frac")


def agree_with_plain(torch, model, cfgs, dev):
    """End-to-end check of the served paths at the serving shapes: requests
    ``AGREE_REQS`` (the second shares the first's prefix, a prefix-cache
    hit) go through ``Engine`` with telemetry (chunked prefill, store
    refresh, batched decode over ragged lengths) with the fused kernel
    (whose telemetry launches the scoring kernel too), with the staged
    kernels and with the plain versions.  The later two runs are fed the
    first run's tokens, so each step's logits compare at the same inputs:
    they must be finite, of the vocabulary's size, and every pair of runs
    must reach a cosine similarity of at least ``LOGIT_COS`` (bf16 rounding
    and near-tie selections differ); the sparsity counters must be equal."""
    plain_cfg = dataclasses.replace(cfgs["staged"], sparse=dataclasses.replace(
        cfgs["staged"].sparse, backend="reference"))
    runs = {}
    for name, cfg, launched in (
        ("fused", cfgs["fused"],
         {"fused_decode", "sparse_prefill", "centroid_scores_quantized"}),
        ("staged", cfgs["staged"],
         {"centroid_scores_quantized", "paged_attention", "sparse_prefill"}),
        ("plain", plain_cfg, set()),
    ):
        eng = make_engine(cfg, model, dev, AGREE_REQS, AGREE_NEW, telemetry=True)
        forced = runs["fused"]["tokens"] if runs else None
        run = run_engine(torch, eng, forced=forced, record=True)
        check_served(eng, run["done"], len(AGREE_REQS), AGREE_NEW, cfg.vocab_size)
        expect_path(f"agreement run '{name}'", run["counts"], launched)
        run["snap"] = eng.metrics.snapshot()
        runs[name] = run
        del eng
        torch.cuda.empty_cache()
    ref_keys = runs["fused"]["logits"].keys()
    for name, run in runs.items():
        if run["logits"].keys() != ref_keys:
            fail(f"the {name} run sampled at other steps than the fused run")
        for key, lg in run["logits"].items():
            if lg.shape != (cfgs["fused"].vocab_size,) or not bool(torch.isfinite(lg).all()):
                fail(f"{name} logits at {key} of shape {tuple(lg.shape)} are not finite")
    for a, b in (("fused", "staged"), ("fused", "plain"), ("staged", "plain")):
        worst, same = 1.0, 0
        for key, la in runs[a]["logits"].items():
            lb = runs[b]["logits"][key]
            worst = min(worst, float(torch.nn.functional.cosine_similarity(la, lb, dim=0)))
            same += int(la.argmax() == lb.argmax())
        log(f"end to end {a} vs {b}: Engine, requests {AGREE_REQS} x {AGREE_NEW} new "
            f"tokens, fed the fused run's tokens: min logit cosine {worst:.6f} "
            f"(>= {LOGIT_COS}) over {len(ref_keys)} steps, greedy tokens equal at "
            f"{same} of {len(ref_keys)}")
        if not worst >= LOGIT_COS:
            fail(f"{a} and {b} logits drift apart: cosine {worst}")
    tel = {n: {k: r["snap"][k] for k in SPARSITY_KEYS} for n, r in runs.items()}
    log(f"telemetry, fused run: {json.dumps(tel['fused'])}")
    for name in ("staged", "plain"):
        if tel[name] != tel["fused"]:
            fail(f"the {name} run's sparsity counters differ from the fused run's: "
                 f"{tel[name]}")
    log("telemetry: fused, staged and plain counters identical")


def serve_f32_store(torch, model, cfg, dev):
    """Request 3 (no prefix hit) through the staged kernels on an
    unquantized f32 store (``quant="none"``), so ``centroid_scores_f32``
    runs on a serving path, then through the plain versions fed the same
    tokens; logit cosine at least ``LOGIT_COS``."""
    f32_cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse, quant="none"))
    plain_cfg = dataclasses.replace(f32_cfg, sparse=dataclasses.replace(
        f32_cfg.sparse, backend="reference"))
    runs = {}
    for name, c, launched in (
        ("staged f32", f32_cfg,
         {"centroid_scores_f32", "paged_attention", "sparse_prefill"}),
        ("plain f32", plain_cfg, set()),
    ):
        eng = make_engine(c, model, dev, (3,), AGREE_NEW)
        forced = runs["staged f32"]["tokens"] if runs else None
        run = run_engine(torch, eng, forced=forced, record=True)
        check_served(eng, run["done"], 1, AGREE_NEW, c.vocab_size, prefix_hit=False)
        expect_path(f"{name} run", run["counts"], launched)
        runs[name] = run
        del eng
        torch.cuda.empty_cache()
    lk, lp = runs["staged f32"]["logits"], runs["plain f32"]["logits"]
    if lk.keys() != lp.keys():
        fail("the f32-store runs sampled at different steps")
    worst = min(float(torch.nn.functional.cosine_similarity(lk[k], lp[k], dim=0))
                for k in lk)
    log(f"f32 store (quant none), request 3 x {AGREE_NEW} new tokens: staged kernels "
        f"vs plain min logit cosine {worst:.6f} over {len(lk)} steps; launches "
        f"{json.dumps({n: c['launches'] for n, c in runs['staged f32']['counts'].items() if c['launches']})}")
    if not worst >= LOGIT_COS:
        fail(f"f32-store staged logits drift from the plain path: cosine {worst}")
    return runs["staged f32"]["counts"]


def serve_calibrated(torch, model, cfg, cal_cfg, dev):
    """Requests ``CAL_REQS`` with the calibrated assignment installed, through
    the fused kernel, then through the plain versions fed the same tokens:
    logit cosine at least ``LOGIT_COS``."""
    cal = dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, block_sizes=cal_cfg.sparse.block_sizes))
    plain = dataclasses.replace(cal, sparse=dataclasses.replace(
        cal.sparse, backend="reference"))
    runs = {}
    for name, c, launched in (("fused", cal, {"fused_decode", "sparse_prefill"}),
                              ("plain", plain, set())):
        eng = make_engine(c, model, dev, CAL_REQS, AGREE_NEW)
        forced = runs["fused"]["tokens"] if runs else None
        run = run_engine(torch, eng, forced=forced, record=True)
        check_served(eng, run["done"], len(CAL_REQS), AGREE_NEW, c.vocab_size,
                     prefix_hit=False)
        expect_path(f"calibrated {name} run", run["counts"], launched)
        runs[name] = run
        del eng
        torch.cuda.empty_cache()
    lk, lp = runs["fused"]["logits"], runs["plain"]["logits"]
    if lk.keys() != lp.keys():
        fail("the calibrated runs sampled at different steps")
    for key, lg in (*lk.items(), *lp.items()):
        if lg.shape != (cfg.vocab_size,) or not bool(torch.isfinite(lg).all()):
            fail(f"calibrated logits at {key} are not finite")
    worst = min(float(torch.nn.functional.cosine_similarity(lk[k], lp[k], dim=0))
                for k in lk)
    log(f"calibrated assignment, requests {CAL_REQS} x {AGREE_NEW} new tokens: fused "
        f"kernels vs plain (fed the same tokens) min logit cosine {worst:.6f} "
        f"(>= {LOGIT_COS}) over {len(lk)} steps; launches "
        f"{json.dumps({n: c['launches'] for n, c in runs['fused']['counts'].items() if c['launches']})}")
    if not worst >= LOGIT_COS:
        fail(f"calibrated fused logits drift from the plain path: cosine {worst}")


# ---------------------------------------------------------------------------
# phase 5: the degradation ladder and a fault storm at full width
# ---------------------------------------------------------------------------


def decode_timer(torch, profiled=False):
    """-> (a ``decode_hook`` for ``LadderProbe``, the times it records by
    rung).  Each decode step's host time and the CUDA-event time from its
    start to its end on the stream (stream wall time: idle gaps between
    its kernels count); with ``profiled``, its device-busy time instead:
    the summed times of the kernels it launched, from a ``torch.profiler``
    session around the step (synchronized on both sides)."""
    times = {}

    def hook(rung, call):
        if profiled:
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                out = call()
                torch.cuda.synchronize()
            times.setdefault(rung, []).append(
                sum(r[0] for r in device_time_rows(torch, prof)))
            return out
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out = call()
        ev[1].record()
        times.setdefault(rung, []).append((time.perf_counter() - t0, ev))
        return out

    return hook, times


def step_times(torch, times, ladder):
    """Mean ms of a decode step by rung name: host and stream wall time
    (``host_ms``, ``stream_ms``), or device-busy time (``busy_ms``) for a
    profiled run."""
    def mean(v):
        return sum(v) / len(v)

    torch.cuda.synchronize()
    out = {}
    for rung, xs in sorted(times.items()):
        if isinstance(xs[0], float):
            out[ladder[rung][0]] = {"steps": len(xs), "busy_ms": mean(xs)}
        else:
            out[ladder[rung][0]] = {
                "steps": len(xs), "host_ms": mean([h * 1e3 for h, _ in xs]),
                "stream_ms": mean([ev[0].elapsed_time(ev[1]) for _, ev in xs])}
    return out


def ladder_plan(probe, repromote):
    """Run L's plan from run F's schedule (which depends on lengths only, so
    L, whose faults restore nothing, keeps it): a prefill fault on the last
    tick with a chunk (rung 0 -> staged; the reference rung prefills dense,
    so it must see no chunk), a decode fault on the next decode step
    (staged -> reference); ``repromote`` clean decode ticks later (back on
    staged) one whole staged tick, then a NaN row of one request (staged
    -> reference); then two windows of ``repromote`` clean ticks back to
    fused.  -> (plan, tick of the first fault)."""
    chunk_ticks = sorted(t for t, st in probe.steps.items()
                         if any(k == "chunk" for _, k, _ in st))
    decodes = {t: ids for t, st in probe.steps.items() for _, k, ids in st
               if k == "decode"}
    t_p = chunk_ticks[-1]
    after = sorted(t for t in decodes if t > t_p)
    if len(after) < 3 * repromote + 4:
        fail(f"run F has {len(after)} decode ticks from tick {t_p}: too few for "
             f"the ladder's three windows of {repromote} clean ticks")
    t_nan = after[repromote + 2]
    plan = [dict(site="prefill", tick=t_p, count=1),
            dict(site="decode", tick=after[0], count=1),
            dict(site="decode_nan", tick=t_nan, seq_id=min(decodes[t_nan]), count=1)]
    return plan, t_p


def check_rung_launches(what, probe, ladder, n_layers):
    """Every rung ran at least one whole decode tick, and each such tick
    launched its rung's kernels once per layer and none of the others."""
    whole = probe.whole_decode_ticks()
    for rung, (name, _) in enumerate(ladder):
        if not whole.get(rung):
            fail(f"{what}: rung {name} ran no whole decode tick")
        want, never = RUNG_DECODE[name]
        for t in whole[rung]:
            got = probe.launches[t]
            if any(got[k] != n_layers for k in want) or any(got[k] for k in never):
                fail(f"{what}: tick {t} on rung {name} launched "
                     f"{ {k: v for k, v in got.items() if v} }")
    return {ladder[r][0]: len(ts) for r, ts in whole.items()}


def committed_logits(torch, what, run, ref, vocab):
    """The logits at every (request, position) a run committed: finite, of
    the vocabulary's size, at a cosine of at least ``LOGIT_COS`` to run F's
    -> (the least cosine, the number of positions)."""
    keys = [(r.req_id, i) for r in run["reqs"] for i in range(len(r.output))]
    worst = 1.0
    for key in keys:
        lg = run["logits"][key]
        if lg.shape != (vocab,) or not bool(torch.isfinite(lg).all()):
            fail(f"{what}: logits at {key} are not finite")
        worst = min(worst, float(torch.nn.functional.cosine_similarity(
            lg, ref["logits"][key], dim=0)))
    if not worst >= LOGIT_COS:
        fail(f"{what}: logits drift from the fault-free run: cosine {worst}")
    return worst, len(keys)


def serve_ladder(torch, model, cfg, dev):
    """Phase 5: requests ``LADDER_REQS`` x ``LADDER_NEW`` tokens on phase 3's
    fused main path (``"cuda"``, fused decode, sparse prefill), one engine
    per run.  F runs fault-free (no injector) and records logits and
    tokens.  L, fed F's tokens, runs ``ladder_plan`` (``repromote_after``
    ``LADDER_REPROMOTE``): the ladder goes fused -> staged -> reference,
    back to staged, down again on a NaN row, and back to fused (exactly
    one degradation to staged, two to reference, three re-promotions);
    every rung must run whole decode ticks with its own launches, every
    request end ok with no retry.  S, fed F's tokens, runs
    ``default_storm()`` with a NaN row of ``STORM_VICTIM`` on every tick
    and a stuck clock of ``watchdog_ticks`` + 2 ticks: the victim must fail
    (sampler anomaly, past its budget), every other request end ok, the
    watchdog fire, a checkpoint restore, and the tiered-memory sites fire 0
    times.  In L and S every non-finite row must be one the plan poisoned.
    Every committed position's logits must be finite and within
    ``LOGIT_COS`` of F's; L's logits before its first fault are compared
    bitwise (reported).  L is run once more free (not fed), its decode
    steps each under the profiler for their device-busy time by rung, and
    the streams equal to F's counted."""
    from repro_torch.config import ResilienceConfig
    from repro_torch.resilience import FaultInjector, FaultSpec, default_storm
    from repro_torch.serving.probe import LadderProbe

    vocab, n_layers = cfg.vocab_size, cfg.n_layers
    prompts = traffic(vocab)

    def one_run(name, plan=None, forced=None, profiled=False, **res_kw):
        eng = make_engine(cfg, model, dev, LADDER_REQS, LADDER_NEW, prompts=prompts,
                          resilience=ResilienceConfig(**res_kw))
        reqs = [s.req for s in eng.scheduler.waiting]
        inj, poisoned = None, []
        if plan is not None:
            inj = FaultInjector([FaultSpec(**d) for d in plan])
            rows_of = inj.poison_rows

            def poison_rows(*a):
                rows = rows_of(*a)
                poisoned.append(len(rows))
                return rows

            inj.poison_rows = poison_rows
            eng.set_fault_injector(inj)
        hook, times = decode_timer(torch, profiled)
        run = run_engine(torch, eng, forced=forced, record=True,
                         probe=LadderProbe(eng, decode_hook=hook))
        run.update(reqs=reqs, snap=eng.metrics.snapshot(), inj=inj,
                   ladder=eng._ladder, rung=eng._rung,
                   times=step_times(torch, times, eng._ladder))
        pins = eng.prefix_cache.pages()
        if eng.pool.assert_consistent(known_pins=pins):
            fail(f"run {name}: page pool leaked pages")
        if any(not r.done for r in reqs):
            fail(f"run {name}: requests lost")
        if run["snap"]["sampler_anomalies"] != sum(poisoned):
            # no hidden fallback: every non-finite row is one the plan poisoned
            fail(f"run {name}: {run['snap']['sampler_anomalies']} non-finite rows, "
                 f"{sum(poisoned)} poisoned")
        log_serving(f"phase 5 run {name}", run, run["snap"])
        what = ("device-busy ms (profiled)" if profiled
                else "host ms, stream wall ms from CUDA events")
        log(f"phase 5 run {name}: mean decode step by rung ({what}): "
            f"{json.dumps(run['times'])}")
        keys = ("degradations_by_rung", "repromotions", "retries", "checkpoints_restored",
                "watchdog_fires", "sampler_anomalies", "requests_failed", "preemptions")
        log(f"phase 5 run {name}: {json.dumps({k: run['snap'][k] for k in keys})}"
            + (f", faults fired {json.dumps(inj.fired)}" if inj else ""))
        log(f"phase 5 run {name}: steps by tick (rung, kind, decoding requests): "
            + json.dumps({t: [[r, k[0], ids] for r, k, ids in st]
                          for t, st in sorted(run["probe"].steps.items())}))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return run

    f = one_run("F")
    for r in f["reqs"]:
        if r.status != "ok" or len(r.output) != LADDER_NEW:
            fail(f"run F: request {r.req_id} ended {r.status} with {len(r.output)} tokens")
    if f["snap"]["degradations"] or f["rung"] or f["snap"]["sampler_anomalies"]:
        fail("run F (no injector) left rung 0 or saw a non-finite row")
    expect_path("phase 5 run F", f["counts"], {"fused_decode", "sparse_prefill"})

    plan, t_first = ladder_plan(f["probe"], LADDER_REPROMOTE)
    log(f"phase 5 run L plan: {json.dumps(plan)}")
    ladder = one_run("L", plan, forced=f["tokens"], repromote_after=LADDER_REPROMOTE)
    snap = ladder["snap"]
    if [n for n, _ in ladder["ladder"]] != ["fused", "staged", "reference"]:
        fail(f"run L: ladder {ladder['ladder']}")
    # the plan's three faults, each one rung down; three re-promotions back
    if (snap["degradations_by_rung"] != {"staged": 1, "reference": 2}
            or snap["repromotions"] != 3 or ladder["rung"] != 0):
        fail(f"run L: degradations {snap['degradations_by_rung']}, repromotions "
             f"{snap['repromotions']}, final rung {ladder['rung']}")
    for r in ladder["reqs"]:
        if r.status != "ok" or len(r.output) != LADDER_NEW or r.failure is not None:
            fail(f"run L: request {r.req_id} ended {r.status}")
    if snap["retries"]:
        fail(f"run L: {snap['retries']} retries (the ladder absorbs every fault)")
    whole = check_rung_launches("run L", ladder["probe"], ladder["ladder"], n_layers)
    worst_l, n_l = committed_logits(torch, "run L", ladder, f, vocab)
    early = [k for k, t in ladder["ticks"].items() if t < t_first]
    same = sum(int(torch.equal(ladder["logits"][k], f["logits"][k])) for k in early)
    log(f"phase 5 run L: whole decode ticks by rung {json.dumps(whole)}; min logit "
        f"cosine to F {worst_l:.6f} over {n_l} committed positions (>= {LOGIT_COS}); "
        f"before the first fault (tick {t_first}) logits bitwise equal to F's at "
        f"{same} of {len(early)} positions")

    storm = [dataclasses.asdict(s) for s in default_storm()]
    watchdog = ResilienceConfig().watchdog_ticks
    stuck_from = max(f["ticks"].values()) // 2
    storm += [dict(site="decode_nan", seq_id=STORM_VICTIM),
              dict(site="tick_stuck", from_tick=stuck_from,
                   until_tick=stuck_from + watchdog + 1)]
    s = one_run("S", storm, forced=f["tokens"])
    snap = s["snap"]
    for r in s["reqs"]:
        if r.req_id == STORM_VICTIM:
            if (r.status != "failed" or r.failure["reason"] != "sampler_anomaly"
                    or r.failure["retries"] <= ResilienceConfig().failure_budget):
                fail(f"run S: request {r.req_id} ended {r.status} {r.failure}")
        elif r.status != "ok" or len(r.output) != LADDER_NEW:
            fail(f"run S: request {r.req_id} ended {r.status} with {len(r.output)} tokens")
    if snap["watchdog_fires"] < 1 or snap["checkpoints_restored"] < 1:
        fail(f"run S: watchdog fires {snap['watchdog_fires']}, checkpoint restores "
             f"{snap['checkpoints_restored']}")
    if s["inj"].fired.get("host_io", 0) or s["inj"].fired.get("promote_delay", 0):
        fail(f"run S: tiered-memory sites fired {s['inj'].fired}")
    worst_s, n_s = committed_logits(torch, "run S", s, f, vocab)
    log(f"phase 5 run S: failure {json.dumps(next(r.failure for r in s['reqs'] if r.req_id == STORM_VICTIM))}; "
        f"min logit cosine to F {worst_s:.6f} over {n_s} committed positions")

    # L once more, not fed F's tokens, each decode step under the profiler
    free = one_run("L free", plan, profiled=True, repromote_after=LADDER_REPROMOTE)
    same_streams = sum(int(list(r.output) == [f["tokens"][(r.req_id, i)]
                                              for i in range(LADDER_NEW)])
                       for r in free["reqs"])
    log(f"phase 5: run L free (not fed F's tokens): {same_streams} of "
        f"{len(LADDER_REQS)} token streams equal to F's; wall F {f['wall']:.2f}s, "
        f"L {ladder['wall']:.2f}s, S {s['wall']:.2f}s, L free {free['wall']:.2f}s "
        f"(profiler sessions included)")
    return {"counts": ladder["counts"]}


# ---------------------------------------------------------------------------
# phase 6: the compiled decode step
# ---------------------------------------------------------------------------

#: the CUDA kernels of a decode step, as the profiler names them -> the
#: wrappers that launch each of them once per call (``combine_kernel``
#: follows a split launch only when it has more than one run: left out)
DECODE_KERNELS = {
    "score_rows_kernel": ("fused_decode", "centroid_scores_quantized",
                          "centroid_scores_f32"),
    "fused_select_kernel": ("fused_decode",),
    "split_attention_kernel": ("fused_decode", "paged_attention"),
}
#: the step's timing: rounds (the variants in turns, eager and graphed),
#: and per round the warm-up and timed steps of each (CUDA events)
STEP_ROUNDS, STEP_WARMUP, STEP_ITERS = 15, 1, 2
#: least logit cosine of a graphed step to the eager one when they are not
#: bitwise equal
GRAPH_COS = 0.99999
#: qwen3-8b's sparse (Q1) and dense (Q2) decode step near 9k tokens
QWEN_9K_LENS = (9216, 9000, 8800, 8600)


def step_lens(torch, ctx, dev):
    """Ragged lengths near the end of a ``ctx``-token context."""
    return torch.tensor([ctx - 1 - i * (ctx // 16) for i in range(MAX_BATCH)],
                        dtype=torch.int32, device=dev)


def random_cache(torch, model, ctx, dev):
    """A ``MAX_BATCH`` x ``ctx`` cache of random K/V (generator seed 7) with
    the stores rebuilt from it."""
    gen = torch.Generator(device=dev).manual_seed(7)
    cache = model.init_cache(MAX_BATCH, ctx)
    for e in cache["layers"]:
        for name in ("k", "v"):
            e[name].copy_(torch.randn(e[name].shape, generator=gen, device=dev))
    for slot in range(MAX_BATCH):
        model.refresh_slot_store(cache, slot)
    return cache


def written_state(cache):
    """Clones of every cache tensor a decode step writes."""
    from repro_torch.serving.graphs import _PLANTED

    out = {"seq_len": cache["seq_len"].clone()}
    for key in _PLANTED:
        if key in cache:
            out[key] = cache[key].clone()
    for l, e in enumerate(cache["layers"]):
        for name in ("k", "v", "codes"):
            if name in e:
                out[f"{name}[{l}]"] = e[name].clone()
    return out


def state_diff(torch, want, cache) -> dict:
    """-> {tensor: max |diff|} of the written tensors that are not bitwise
    equal to ``want``'s."""
    from repro_torch.serving.graphs import _PLANTED

    got = {"seq_len": cache["seq_len"], **{k: cache.get(k) for k in _PLANTED}}
    for l, e in enumerate(cache["layers"]):
        got.update({f"{n}[{l}]": t for n, t in e.items()})
    return {k: float((w.float() - got[k].float()).abs().max())
            for k, w in want.items() if not torch.equal(w, got[k])}


def step_variants(torch, model, cfgs, dev, qwen: bool):
    """Phase 6's decode steps: name -> (model view, cache dict, lengths).
    fused and staged, each with and without telemetry (one cache, the
    telemetry variants a dict of the same tensors plus ``_telemetry``), at
    ragged lengths near CTX; on qwen3-8b also the ``"dense"`` backend on
    the same cache, the inactive plan (a ``Q3_CTX`` cache, lengths near its
    end), and fused and dense near 9k tokens."""
    def view(cfg):
        return model.with_sparse(**dataclasses.asdict(cfg.sparse))

    cache = random_cache(torch, view(cfgs["fused"]), CTX, dev)
    tel = dict(cache, _telemetry=torch.zeros((model.cfg.n_layers, MAX_BATCH, 4),
                                             dtype=torch.int32, device=dev))
    lens = step_lens(torch, CTX, dev)
    out = {}
    for path in ("fused", "staged"):
        out[path] = (view(cfgs[path]), cache, lens)
        out[f"{path}+telemetry"] = (view(cfgs[path]), tel, lens)
    if qwen:
        lens9k = torch.tensor(QWEN_9K_LENS, dtype=torch.int32, device=dev)
        out["dense"] = (view(cfgs["dense"]), cache, lens)
        out["inactive"] = (view(cfgs["fused"]),
                           random_cache(torch, view(cfgs["fused"]), Q3_CTX, dev),
                           step_lens(torch, Q3_CTX, dev))
        out["fused@9k"] = (view(cfgs["fused"]), dict(cache), lens9k)
        out["dense@9k"] = (view(cfgs["dense"]), dict(cache), lens9k)
    return out


def compiled_step(torch, label, variants, dev):
    """Phase 6 a) and c) for one model: each variant's ``decode_step`` run
    eagerly and through a ``DecodeGraph`` from the same state (first call:
    warm-up, capture, replay; then one more replay), logits and every
    written cache tensor compared (bitwise; else max |diff| per tensor is
    printed and the logits must reach cosine ``GRAPH_COS`` with the same
    argmax); then ``STEP_ROUNDS`` rounds in turns of ``STEP_WARMUP`` +
    ``STEP_ITERS`` steps, eager and graphed (CUDA events, lengths reset
    before every step), the device-busy ms per step of each under
    ``torch.profiler`` (5 steps), and one profiled replay whose launches of
    each decode kernel must equal the bookkeeping's for one step."""
    import statistics

    from repro_torch.serving import DecodeGraph

    tokens = torch.arange(MAX_BATCH, device=dev)
    graphs, out = {}, {}
    for name, (view, cache, lens) in variants.items():
        cache["seq_len"].copy_(lens)
        want_logits = view.decode_step(cache, tokens)[0].clone()
        want = written_state(cache)
        graph = graphs[name] = DecodeGraph(view.decode_step, cache)
        for call in ("first call", "replay"):
            cache["seq_len"].copy_(lens)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = graph(cache, tokens)[0]
            torch.cuda.synchronize()
            out.setdefault(name, {})[f"{call.split()[0]}_ms"] = (
                time.perf_counter() - t0) * 1e3
            diff = state_diff(torch, want, cache)
            if not torch.equal(logits, want_logits):
                diff["logits"] = float((logits.float() - want_logits.float()).abs().max())
            cos = float(torch.nn.functional.cosine_similarity(
                logits.float(), want_logits.float(), dim=-1).min())
            same_argmax = torch.equal(logits.argmax(-1), want_logits.argmax(-1))
            log(f"phase 6 {label} {name}, graphed ({call}) vs eager decode_step: "
                + ("logits and every written cache tensor bitwise equal" if not diff
                   else f"max |diff| {json.dumps(diff)}, logit cosine {cos:.7f}, "
                        f"argmax {'equal' if same_argmax else 'DIFFERENT'}"))
            if diff and not (cos >= GRAPH_COS and same_argmax):
                fail(f"phase 6 {label} {name}: graphed step disagrees with eager")
            out[name][f"bitwise_{call.split()[0]}"] = not diff
        log(f"phase 6 {label} {name}: host ms of the first call (two warm-up steps, "
            f"the capture, a replay) {out[name]['first_ms']:.1f}, of a replay "
            f"{out[name]['replay_ms']:.2f}")
        del want

    def eager(view, cache, lens):
        def fn():
            cache["seq_len"].copy_(lens)
            view.decode_step(cache, tokens)
        return fn

    def replay(graph, cache, lens):
        def fn():
            cache["seq_len"].copy_(lens)
            graph(cache, tokens)
        return fn

    fns = {name: {"eager": eager(*v), "graphed": replay(graphs[name], v[1], v[2])}
           for name, v in variants.items()}
    times = {name: {"eager": [], "graphed": []} for name in variants}
    for _ in range(STEP_ROUNDS):
        for name, pair in fns.items():
            for how, fn in pair.items():
                times[name][how].append(cuda_time_ms(torch, fn, STEP_WARMUP, STEP_ITERS))
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for name, pair in fns.items():
        rec = out[name]
        for how, fn in pair.items():
            v = times[name][how]
            rec[how] = [min(v), statistics.median(v), max(v)]
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            rows = device_time_rows(torch, prof)
            rec[f"busy_{how}"] = sum(r[0] for r in rows) / 5
            rec[f"kernels_{how}"] = sum(r[1] for r in rows) / 5
        with torch.profiler.profile(activities=acts) as prof:
            pair["graphed"]()
            torch.cuda.synchronize()
        seen = {}
        for _, n, key in device_time_rows(torch, prof):
            seen[short(key)] = seen.get(short(key), 0) + n
        book = {k: c["launches"] for k, c in graphs[name].step_counts.items()
                if c["launches"]}
        launches = {k: [seen.get(k, 0), sum(book.get(w, 0) for w in ws)]
                    for k, ws in DECODE_KERNELS.items()}
        log(f"phase 6 {label} {name}: one profiled replay, launches by kernel "
            f"[profiler, bookkeeping] {json.dumps(launches)}; bookkeeping of one step "
            f"{json.dumps(book)}; all kernels of the replay {json.dumps(seen)}")
        if any(a != b for a, b in launches.values()):
            fail(f"phase 6 {label} {name}: the profiler's launches differ from the "
                 f"bookkeeping's")
        log(f"phase 6 {label} {name}: decode_step ms min / median / max over "
            f"{STEP_ROUNDS} rounds, eager {fmt_rounds(rec['eager'])}, graphed "
            f"{fmt_rounds(rec['graphed'])}; device busy per step (profiled) eager "
            f"{rec['busy_eager']:.4f}, graphed {rec['busy_graphed']:.4f}; device "
            f"kernels per step {rec['kernels_eager']:.0f} / {rec['kernels_graphed']:.0f}; "
            f"busy share of the median step eager "
            f"{rec['busy_eager'] / rec['eager'][1]:.3f}, graphed "
            f"{rec['busy_graphed'] / rec['graphed'][1]:.3f}")
    del graphs, fns
    torch.cuda.empty_cache()
    return out


def graphed_vs_eager(torch, what, graphed, eager):
    """Phase 6 b): a served run through the graphed engine and again under
    ``step_graphs_disabled()``, fed its tokens.  At every sampled position
    the eager run's own greedy token must be the graphed run's (identical
    commits); the logits are compared bitwise, their max |diff| printed."""
    lg, le = graphed["logits"], eager["logits"]
    if lg.keys() != le.keys():
        fail(f"{what}: the eager run sampled at other positions than the graphed one")
    same = sum(int(torch.equal(lg[k], le[k])) for k in lg)
    worst = max(float((lg[k] - le[k]).abs().max()) for k in lg)
    other = [k for k in lg if int(le[k].argmax()) != graphed["tokens"][k]]
    log(f"phase 6 {what}: graphed vs eager decode step, fed the graphed run's tokens: "
        f"logits bitwise equal at {same} of {len(lg)} sampled positions (max |diff| "
        f"{worst:.3g}); the eager run's greedy tokens equal the graphed run's at "
        f"{len(lg) - len(other)} of {len(lg)}")
    if other:
        fail(f"{what}: the eager engine would commit other tokens at {other[:4]}")


def serve(torch, dev, cal_cfg, profile: bool = False):
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.serving import step_graphs_disabled

    base = get_config(ARCH)
    pattern = tuple(
        tuple((16, 32, 64)[(l + h) % 3] for h in range(base.n_kv_heads))
        for l in range(base.n_layers)
    )
    fused_cfg = dataclasses.replace(base, sparse=dataclasses.replace(
        base.sparse, backend="cuda", fused_decode=True, sparse_prefill=True,
        quant="int4_asym", block_sizes=pattern, token_budget=BUDGET,
    ))
    cfgs = {"fused": fused_cfg, "staged": dataclasses.replace(
        fused_cfg, sparse=dataclasses.replace(fused_cfg.sparse, fused_decode=False))}
    t0 = time.perf_counter()
    model = Transformer(fused_cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"weights: {sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params "
        f"bf16, init {time.perf_counter() - t0:.1f}s")

    paths = {}
    eng = make_engine(fused_cfg, model, dev, range(len(PROMPT_LENS)), NEW_TOKENS)
    run = run_engine(torch, eng, profile=profile, record=True)
    if profile:
        profile_summary(torch, run["prof"], run["wall"])
    check_served(eng, run["done"], len(PROMPT_LENS), NEW_TOKENS, fused_cfg.vocab_size)
    expect_path("fused serving", run["counts"], {"fused_decode", "sparse_prefill"})
    log_serving("serving (fused)", run, eng.metrics.snapshot())
    paths["fused"] = run
    del eng
    torch.cuda.empty_cache()
    # phase 6 b): the same run with the eager decode step, fed its tokens
    with step_graphs_disabled():
        eng = make_engine(fused_cfg, model, dev, range(len(PROMPT_LENS)), NEW_TOKENS)
    eager = run_engine(torch, eng, forced=run["tokens"], record=True)
    check_served(eng, eager["done"], len(PROMPT_LENS), NEW_TOKENS, fused_cfg.vocab_size)
    expect_path("fused serving, eager step", eager["counts"],
                {"fused_decode", "sparse_prefill"})
    log_serving("serving (fused, eager decode step)", eager, eng.metrics.snapshot())
    graphed_vs_eager(torch, "phase 3 fused run", run, eager)
    del eng, eager
    torch.cuda.empty_cache()

    eng = make_engine(cfgs["staged"], model, dev, STAGED_REQS, NEW_TOKENS,
                      telemetry=True)
    run = run_engine(torch, eng, profile=profile)
    if profile:
        profile_summary(torch, run["prof"], run["wall"])
    check_served(eng, run["done"], len(STAGED_REQS), NEW_TOKENS, fused_cfg.vocab_size)
    expect_path("staged serving", run["counts"],
                {"centroid_scores_quantized", "paged_attention", "sparse_prefill"})
    snap = eng.metrics.snapshot()
    log_serving("serving (staged, telemetry)", run, snap)
    log(f"serving (staged, telemetry): {json.dumps({k: snap[k] for k in SPARSITY_KEYS})}")
    paths["staged"] = run
    del eng
    torch.cuda.empty_cache()

    agree_with_plain(torch, model, cfgs, dev)
    paths["f32"] = {"counts": serve_f32_store(torch, model, cfgs["staged"], dev)}
    serve_calibrated(torch, model, fused_cfg, cal_cfg, dev)
    log(f"phase 3 done at {time.perf_counter() - T_START:.1f}s")
    paths["ladder"] = serve_ladder(torch, model, fused_cfg, dev)
    log(f"phase 5 done at {time.perf_counter() - T_START:.1f}s")
    paths["step"] = compiled_step(torch, ARCH, step_variants(torch, model, cfgs, dev,
                                                             qwen=False), dev)
    log(f"phase 6 ({ARCH}) done at {time.perf_counter() - T_START:.1f}s")
    paths["tiered"] = serve_tiered(torch, model, fused_cfg, dev)
    paths["tiered"]["step"] = compiled_step(
        torch, f"{ARCH} tiered", mask_step_variants(torch, model, fused_cfg, dev), dev)
    log(f"phase 7 done at {time.perf_counter() - T_START:.1f}s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# phase 7: tiered KV memory at full width
# ---------------------------------------------------------------------------

#: the pages requests ``LADDER_REQS`` hold at their end (prompt and new
#: tokens; requests 0 and 1 share the ``PREFIX`` pages): 1548
TIER_LIVE = sum(-(-(PROMPT_LENS[i] + LADDER_NEW) // PS) for i in LADDER_REQS) - PREFIX // PS
#: device and host budgets of runs T and S: 1280 device pages, under the
#: live pages, as the working-set estimate T / 16 + 2 = 258 pages a sequence
#: allows (``max_live_seqs`` 4).  At full depth a decoding sequence's
#: working set (the union of the pages its 28 x 8 (layer, kv head)
#: selections take, each T / 16 = 256 of them) is every page it holds, so
#: the budget holds admissions back until a request retires, and the late
#: request takes a used slot (cleared on install: ``Transformer.clear_slot``)
TIER_HBM, TIER_HOST = 1280, 1024
#: the prefill budget per tick: every prompt at once, so every chunk but a
#: prompt's last is a whole ``CHUNK`` and a request's chunk bounds do not
#: depend on what else prefills with it
TIER_PREFILL_BUDGET = 32768
#: the request whose sink page (pinned into every selection) run T demotes
#: around the shield once it decodes (3 shares no page with another)
TIER_MISS_REQ = 3
#: rounds of the migration timing; the bound's host link: PCIe Gen5 x16,
#: 64 GB/s per direction
MIGRATION_ROUNDS, PCIE_BPS = 20, 64e9
TIER_POOL_KEYS = ("demotions", "promotions", "peak_hbm_pages")


def demote_sink(eng, rid):
    """Demote request ``rid``'s sink page (logical 0, pinned into every
    selection) around the shield, if it decodes, is not stalled and the
    page is on the device -> the page, or None.  A host-I/O fault the
    injector raises on the gather leaves the page where it was (None)."""
    from repro_torch.resilience import HostIOError
    from repro_torch.serving.probe import demote_around_shield

    seq = eng.scheduler.running.get(rid)
    if seq is None or seq.state != "decode" or rid in eng.memory.stalled:
        return None
    try:
        return demote_around_shield(eng, rid)
    except HostIOError:
        return None


def force_miss(torch, state, flat):
    """Run T's forced miss as a ``run_engine`` tick hook: once request
    ``TIER_MISS_REQ`` decodes with two tokens out, demote its sink page;
    after the next tick it must be stalled on that page (and any of its
    own that were host-resident), its token uncommitted, its sampled row
    finite (the poisoned read, kept with its cosine to the flat run's
    logits there), and the other decoding requests must have committed
    unless they stalled on pages of their own.  Each decoding request's
    working set against the pages it holds is kept from that tick."""
    def hook(eng, tick, samples):
        if "page" in state and "checked" not in state:
            reqs, n_out = state.pop("reqs"), state["n_out"]
            pos = n_out[TIER_MISS_REQ]
            row = samples.logits[(TIER_MISS_REQ, pos)]
            state.update(
                checked=True,
                stalled_on=sorted(eng.memory.stalled.get(TIER_MISS_REQ, ())),
                committed=len(reqs[TIER_MISS_REQ].output) != pos,
                row_finite=bool(torch.isfinite(row).all()),
                row_cos=float(torch.nn.functional.cosine_similarity(
                    row, flat["logits"][(TIER_MISS_REQ, pos)], dim=0)),
                others={sid: [len(reqs[sid].output) - n, sid in eng.memory.stalled]
                        for sid, n in n_out.items() if sid != TIER_MISS_REQ})
        seq = eng.scheduler.running.get(TIER_MISS_REQ)
        if "page" in state or seq is None or len(seq.req.output) < 2:
            return
        live = {sid: s.req for sid, s in eng.scheduler.running.items()
                if s.state == "decode" and sid not in eng.memory.stalled}
        n_out = {sid: len(r.output) for sid, r in live.items()}
        working = {sid: [len(eng.memory.working.get(sid, ())),
                         len(eng.pool.table(sid).physical)] for sid in live}
        page = demote_sink(eng, TIER_MISS_REQ)
        if page is not None:
            state.update(page=page, tick=tick, reqs=live, n_out=n_out, working=working)

    return hook


def storm_misses(state):
    """Run S's tick hook: after every tick, demote the sink page of one
    decoding request (the first of ``LADDER_REQS`` rotated by the tick
    that can be), so that page I/O runs on the storm's ticks; counts the
    demotions."""
    def hook(eng, tick, samples):
        n = len(LADDER_REQS)
        for i in range(n):
            if demote_sink(eng, LADDER_REQS[(tick + i) % n]) is not None:
                state["forced"] = state.get("forced", 0) + 1
                return

    return hook


def time_migrations(torch, eng):
    """ms per page demotion (gather to pinned host memory + poison of the
    rows) and per page promotion (restore), by CUDA events over
    ``MIGRATION_ROUNDS`` rounds on the engine's cache (slot 0, page 0,
    restored to its bytes after each round) -> (demote, promote) medians."""
    import statistics

    from repro_torch.memory import CachePageIO

    layers = eng.cache["layers"]
    io = CachePageIO()
    times = {"demote": [], "promote": []}
    for _ in range(MIGRATION_ROUNDS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        kb, vb = io.gather(layers, 0, 0)
        io.poison(layers, 0, 0)
        ev[1].record()
        io.restore(layers, 0, 0, kb, vb)
        ev[2].record()
        torch.cuda.synchronize()
        if not (kb.is_pinned() and vb.is_pinned()):
            fail("phase 7: a demoted page's host copy is not in pinned memory")
        times["demote"].append(ev[0].elapsed_time(ev[1]))
        times["promote"].append(ev[1].elapsed_time(ev[2]))
    return {k: statistics.median(v) for k, v in times.items()}


def serve_tiered(torch, model, cfg, dev):
    """Phase 7: requests ``LADDER_REQS`` x ``LADDER_NEW`` tokens on phase 3's
    weights and fused main path, graphed, one engine a run: F on a flat pool
    of ``TIER_HBM + TIER_HOST`` pages; T on the tiered pool (``TIER_HBM``
    device pages, under the ``TIER_LIVE`` live pages, and ``TIER_HOST``
    pinned host pages) with one forced miss (``force_miss``); S, fed T's
    tokens, on T's pool under ``default_storm()`` seed 7 with a sink page
    demoted every tick (``storm_misses``).  T's tokens must be F's, T must
    move bytes and keep at most ``TIER_HBM`` pages resident, every run
    audit clean and lose nothing; in S the host-tier sites must fire, every non-finite row be one the storm poisoned and
    every committed position's logits be within ``LOGIT_COS`` of T's.
    Then the migration times and the graphed decode step with and without
    the page masks (phase 6's method)."""
    from repro_torch.resilience import FaultInjector, default_storm
    from repro_torch.serving.probe import TIER_COUNTERS

    vocab = cfg.vocab_size
    prompts = traffic(vocab)
    pools = {"flat": dict(pool_pages=TIER_HBM + TIER_HOST),
             "tiered": dict(hbm_pages=TIER_HBM, host_pages=TIER_HOST)}

    def one_run(name, pool, forced=None, storm=False, hook=None):
        eng = make_engine(cfg, model, dev, LADDER_REQS, LADDER_NEW, prompts=prompts,
                          prefill_tokens_per_tick=TIER_PREFILL_BUDGET, **pools[pool])
        reqs = [s.req for s in eng.scheduler.waiting]
        poisoned = []
        if storm:
            inj = FaultInjector(default_storm(), seed=7)
            rows_of = inj.poison_rows

            def poison_rows(*a):
                rows = rows_of(*a)
                poisoned.append(len(rows))
                return rows

            inj.poison_rows = poison_rows
            eng.set_fault_injector(inj)
        run = run_engine(torch, eng, forced=forced, record=True, tick_hook=hook)
        snap = eng.metrics.snapshot()
        run.update(reqs=reqs, snap=snap, fired=dict(eng._fault.fired) if storm else {})
        pins = eng.prefix_cache.pages()
        if eng.pool.assert_consistent(known_pins=pins):
            fail(f"phase 7 run {name}: page pool leaked pages")
        if any(not r.done for r in reqs):
            fail(f"phase 7 run {name}: requests lost")
        if snap["sampler_anomalies"] != sum(poisoned):
            fail(f"phase 7 run {name}: {snap['sampler_anomalies']} non-finite rows, "
                 f"{sum(poisoned)} poisoned")
        log_serving(f"phase 7 run {name}", run, snap)
        first = {}
        for t, st in sorted(run["probe"].steps.items()):
            for _, kind, ids in st:
                for rid in ids if kind == "decode" else ():
                    first.setdefault(rid, t)
        run["first_decode_tick"] = first
        if eng.memory is not None:
            run["pool"] = {k: getattr(eng.pool, k) for k in TIER_POOL_KEYS}
            run["tier"] = {k: snap[k] for k in TIER_COUNTERS + (
                "hbm_resident_pages", "host_resident_pages")}
            log(f"phase 7 run {name}: pool {json.dumps(run['pool'])} (budget "
                f"{eng.pool.hbm_pages} + {eng.pool.host_pages}), max_live_seqs "
                f"{eng.pool.max_live_seqs}; {json.dumps(run['tier'])}; first decode tick "
                f"by request {json.dumps(first)}"
                + (f"; faults fired {json.dumps(run['fired'])}" if storm else ""))
            if run["pool"]["peak_hbm_pages"] > eng.pool.hbm_pages:
                fail(f"phase 7 run {name}: {run['pool']['peak_hbm_pages']} pages "
                     f"resident over a budget of {eng.pool.hbm_pages}")
            if name == "T":
                run["migration_ms"] = time_migrations(torch, eng)
                run["page_nbytes"] = eng.memory.io.page_nbytes(eng.cache["layers"])
        if not storm:
            check_served(eng, run["done"], len(LADDER_REQS), LADDER_NEW, vocab)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return run

    f = one_run("F", "flat")
    expect_path("phase 7 run F", f["counts"], {"fused_decode", "sparse_prefill"})
    miss = {}
    t = one_run("T", "tiered", hook=force_miss(torch, miss, f))
    expect_path("phase 7 run T", t["counts"],
                {"fused_decode", "sparse_prefill", "centroid_scores_quantized"})
    if f["tokens"] != t["tokens"]:
        diff = [k for k in f["tokens"] if f["tokens"][k] != t["tokens"].get(k)]
        fail(f"phase 7: the tiered run's tokens differ from the flat run's at {diff[:6]}")
    same = sum(int(torch.equal(t["logits"][k], f["logits"][k])) for k in f["logits"])
    worst = max(float((t["logits"][k] - f["logits"][k]).abs().max()) for k in f["logits"])
    pool, tier = t["pool"], t["tier"]
    if not (pool["demotions"] > 0 and tier["migration_bytes"] > 0):
        fail(f"phase 7 run T: pool {pool}, migration bytes {tier['migration_bytes']}")
    if (miss.get("page") not in miss.get("stalled_on", ()) or miss.get("committed")
            or not miss.get("row_finite")):
        fail(f"phase 7 run T: the forced miss did not stall request {TIER_MISS_REQ} "
             f"on its sink page with a finite row: {miss}")
    if any(grew != 1 and not stalled for grew, stalled in miss["others"].values()):
        fail(f"phase 7 run T: a request neither committed nor stalled on its own "
             f"pages at the forced miss: {miss['others']}")
    log(f"phase 7: run T's tokens equal run F's at all {len(f['tokens'])} positions; "
        f"logits bitwise equal at {same} of {len(f['logits'])} (max |diff| {worst:.3g})")
    log(f"phase 7: forced miss at tick {miss['tick']} on request {TIER_MISS_REQ}'s sink "
        f"page {miss['page']}: stalled on {miss['stalled_on']}, token not committed, "
        f"the poisoned row finite with cosine {miss['row_cos']:.4f} to run F's logits "
        f"there; the other requests that tick [tokens committed, stalled]: "
        f"{json.dumps(miss['others'])}; working-set pages against pages held, by "
        f"request: {json.dumps(miss['working'])}")
    steps_t = t["steps"]["decode_step"]
    launches = {k: t["counts"][k]["launches"] for k in ("fused_decode",
                                                          "centroid_scores_quantized")}
    log(f"phase 7: run T launches {json.dumps(launches)} over {steps_t} decode steps "
        f"({launches['centroid_scores_quantized'] / max(steps_t, 1):.1f} scoring launches "
        f"a step for the page masks; run F 0 over {f['steps']['decode_step']} steps)")
    mig = t["migration_ms"]
    bound = t["page_nbytes"] / PCIE_BPS * 1e3
    log(f"phase 7: page migration ({t['page_nbytes']} bytes a page) by CUDA events, "
        f"median of {MIGRATION_ROUNDS}: demotion (gather to pinned host + poison) "
        f"{mig['demote']:.4f} ms, promotion (restore) {mig['promote']:.4f} ms; bound "
        f"{bound:.4f} ms a direction at 64 GB/s (PCIe Gen5 x16)")

    log(f"phase 7 run T ({TIER_HBM} device pages, {TIER_LIVE} live): first decode "
        f"tick by request {json.dumps(t['first_decode_tick'])} against F's "
        f"{json.dumps(f['first_decode_tick'])}")
    for name, run in (("F", f), ("T", t)):
        snap = run["snap"]
        log(f"phase 7 run {name}: TTFT p50 {snap['ttft_p50']:.3f}s, TPOT p50 "
            f"{snap['tpot_p50'] * 1e3:.1f}ms, wall {run['wall']:.2f}s")

    forced = {}
    s = one_run("S", "tiered", forced=t["tokens"], storm=True, hook=storm_misses(forced))
    fired = s["fired"]
    if fired.get("host_io", 0) < 1 or fired.get("promote_delay", 0) < 1:
        fail(f"phase 7 run S: the host-tier sites did not fire: {fired}")
    worst_s, n_s = committed_logits(torch, "phase 7 run S", s, t, vocab)
    status = {r.req_id: r.status for r in s["reqs"]}
    log(f"phase 7 run S: {forced.get('forced', 0)} sink pages demoted by the hook; "
        f"statuses {json.dumps(status)}; min logit cosine to T {worst_s:.6f} over "
        f"{n_s} committed positions (>= {LOGIT_COS})")
    return {"F": f, "T": t, "S": s, "migration_ms": mig,
            "migration_bound_ms": bound}


def mask_step_variants(torch, model, cfg, dev):
    """The fused decode step with and without tiered memory's page masks,
    on one cache of random K/V at ragged lengths near CTX (phase 6's)."""
    view = model.with_sparse(**dataclasses.asdict(cfg.sparse))
    cache = random_cache(torch, view, CTX, dev)
    n_pages = CTX // PS
    masks = dict(cache, **{k: torch.zeros((MAX_BATCH, n_pages), dtype=torch.bool,
                                          device=dev)
                           for k in ("_sel_pages", "_pre_pages")})
    lens = step_lens(torch, CTX, dev)
    return {"fused": (view, cache, lens), "fused+masks": (view, masks, lens)}


# ---------------------------------------------------------------------------
# phase 3b: qwen3-8b at full width, the default configuration
# ---------------------------------------------------------------------------


def qwen_runs():
    """Phase 3b's runs: name -> (config, requests, prompts or None, serve
    overrides, kernels the run must launch, prefix-cache hit expected).
    The default configuration is the ``"cuda"`` backend with the fused
    decode and ``sparse_prefill`` off (dense prefill through the flash
    kernel), T = BUDGET, INT4-asym quest store, block sizes
    ``(16, 32, 64)[(layer + head) % 3]``."""
    from repro_torch.configs import get_config

    base = get_config(QWEN)
    pattern = tuple(
        tuple((16, 32, 64)[(l + h) % 3] for h in range(base.n_kv_heads))
        for l in range(base.n_layers)
    )
    default = dataclasses.replace(base, sparse=dataclasses.replace(
        base.sparse, backend="cuda", fused_decode=True, quant="int4_asym",
        block_sizes=pattern, token_budget=BUDGET))
    dense = dataclasses.replace(default, sparse=dataclasses.replace(
        default.sparse, backend="dense"))
    sparse_pf = dataclasses.replace(default, sparse=dataclasses.replace(
        default.sparse, sparse_prefill=True))
    return {
        "Q1": (default, Q_REQS, None, {}, {"flash_attention", "fused_decode"}, True),
        "Q2": (dense, Q_REQS, None, {}, {"flash_attention", "paged_attention"}, True),
        "Q3": (default, range(len(Q3_LENS)), "q3", {"max_context": Q3_CTX},
               {"flash_attention", "paged_attention"}, True),
        "Q4": (default, Q4_REQS, None, {"prefill_chunk": 0},
               {"flash_attention", "fused_decode"}, False),
        "Q5": (sparse_pf, Q5_REQS, None, {}, {"sparse_prefill", "fused_decode"}, False),
    }


#: the runs of phase 3b served again through the plain versions, and the
#: plain backend of each: the "reference" backend for the sparse runs, the
#: dense backend's plain twin for Q2
QWEN_PLAIN = ("Q1", "Q2", "Q5")


def serve_qwen(torch, dev):
    """Phase 3b: qwen3-8b at full width (36 layers, bf16, random weights from
    ``torch.Generator`` seed 0) served through ``Engine`` in runs Q1-Q5
    (``qwen_runs``), NEW_TOKENS new tokens each; each run's counts zeroed
    just before and read just after, its path's kernels launched and no
    other, no plain version called.  Then Q1, Q2 and Q5 are served again
    through the plain versions for ``AGREE_NEW`` tokens, fed the first
    run's tokens: every step's logits finite, of the vocabulary's size, at
    a cosine of at least ``LOGIT_COS`` to the kernel run's."""
    from repro_torch.backends import DenseBackend
    from repro_torch.models import Transformer
    from repro_torch.serving import step_graphs_disabled

    runs_cfg = qwen_runs()
    gc.collect()                # engines of earlier phases
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = Transformer(runs_cfg["Q1"][0], device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    vocab = model.cfg.vocab_size
    log(f"{QWEN} weights: {sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params "
        f"bf16 ({sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} "
        f"GB), untied head, init {time.perf_counter() - t0:.1f}s")
    runs = {}
    for name, (cfg, reqs, prompts, serve_kw, launched, hit) in runs_cfg.items():
        prompts = q3_traffic(vocab) if prompts == "q3" else None
        eng = make_engine(cfg, model, dev, reqs, NEW_TOKENS, prompts=prompts, **serve_kw)
        run = run_engine(torch, eng, record=name in QWEN_PLAIN)
        check_served(eng, run["done"], len(reqs), NEW_TOKENS, vocab, prefix_hit=hit)
        expect_path(f"{QWEN} run {name}", run["counts"], launched)
        active = model.use_sparse(eng.max_context)
        log_serving(f"{QWEN} {name} (backend {cfg.sparse.backend}, sparse_prefill "
                    f"{cfg.sparse.sparse_prefill}, max_context {eng.max_context}, "
                    f"plan {'active' if active else 'inactive'}, prefill_chunk "
                    f"{eng.serve.prefill_chunk})", run, eng.metrics.snapshot())
        runs[name] = run
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for name in QWEN_PLAIN:
        cfg, reqs, _, serve_kw, _, hit = runs_cfg[name]
        backend = DenseBackend(plain=True) if cfg.sparse.backend == "dense" else None
        plain_cfg = cfg if backend else dataclasses.replace(
            cfg, sparse=dataclasses.replace(cfg.sparse, backend="reference"))
        eng = make_engine(plain_cfg, model, dev, reqs, AGREE_NEW, backend=backend,
                          **serve_kw)
        run = run_engine(torch, eng, forced=runs[name]["tokens"], record=True)
        check_served(eng, run["done"], len(reqs), AGREE_NEW, vocab, prefix_hit=hit)
        expect_path(f"{QWEN} run {name}, plain", run["counts"], set())
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        lk, lp = runs[name]["logits"], run["logits"]
        if not set(lp) <= set(lk):
            fail(f"{QWEN} {name}: the plain run sampled at steps the kernel run did not")
        for key, lg in (*((k, lk[k]) for k in lp), *lp.items()):
            if lg.shape != (vocab,) or not bool(torch.isfinite(lg).all()):
                fail(f"{QWEN} {name} logits at {key} of shape {tuple(lg.shape)} are "
                     "not finite")
        worst = min(float(torch.nn.functional.cosine_similarity(lk[k], lp[k], dim=0))
                    for k in lp)
        same = sum(int(lk[k].argmax() == lp[k].argmax()) for k in lp)
        log(f"{QWEN} {name} kernels vs plain: requests {tuple(reqs)} x {AGREE_NEW} new "
            f"tokens, fed the kernel run's tokens: min logit cosine {worst:.6f} (>= "
            f"{LOGIT_COS}) over {len(lp)} steps, greedy tokens equal at {same} of "
            f"{len(lp)}")
        if not worst >= LOGIT_COS:
            fail(f"{QWEN} {name}: kernel and plain logits drift apart: cosine {worst}")
    # phase 6 b): Q1 again with the eager decode step, fed Q1's tokens
    cfg, reqs = runs_cfg["Q1"][:2]
    with step_graphs_disabled():
        eng = make_engine(cfg, model, dev, reqs, NEW_TOKENS)
    eager = run_engine(torch, eng, forced=runs["Q1"]["tokens"], record=True)
    check_served(eng, eager["done"], len(reqs), NEW_TOKENS, vocab)
    expect_path(f"{QWEN} run Q1, eager step", eager["counts"], runs_cfg["Q1"][4])
    log_serving(f"{QWEN} Q1 (eager decode step)", eager, eng.metrics.snapshot())
    graphed_vs_eager(torch, f"{QWEN} run Q1", runs["Q1"], eager)
    del eng, eager
    gc.collect()
    torch.cuda.empty_cache()
    use_config(model, runs_cfg["Q1"][0])
    cfgs = {"fused": runs_cfg["Q1"][0], "dense": runs_cfg["Q2"][0],
            "staged": dataclasses.replace(runs_cfg["Q1"][0], sparse=dataclasses.replace(
                runs_cfg["Q1"][0].sparse, fused_decode=False))}
    runs["step"] = compiled_step(torch, QWEN, step_variants(torch, model, cfgs, dev,
                                                            qwen=True), dev)
    del model
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="run the fused and staged serving runs under torch.profiler "
                         "and print device time by kernel (serving numbers then "
                         "include the profiler's overhead)")
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
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ptxas.log").write_text("".join(
        f"== {name}\n{rep}\n" for name, rep in _build.PTXAS_REPORT.items()))
    for name, rep in _build.PTXAS_REPORT.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                log(f"ptxas {name}: {line.strip()}")

    dec = check_fused_decode(torch, dev)
    pre = check_sparse_prefill(torch, dev)
    # the same two kernels at the shapes phase 3b gives them (qwen3-8b)
    dec_q = check_fused_decode(torch, dev, g=QG, live=QWEN_DECODE_LIVE, seed=11)
    pre_q = check_sparse_prefill(torch, dev, g=QG, off=QWEN_PREFILL_OFF,
                                 valid=QWEN_PREFILL_VALID, seed=12)
    scored = {q: check_centroid_scores(torch, dec, q) for q in ("int4_asym", "none")}
    att = check_paged_attention(torch, dec, scored["int4_asym"])
    pool = check_pool_rank_keys(torch, dev, dec)
    topk = check_topk_threshold(torch, dev, dec, scored["int4_asym"])
    flash = check_flash_attention(torch, dev)
    flash_off = check_flash_offset(torch, dev)
    ident = check_paged_identity(torch, dev)
    log(f"phase 2 done at {time.perf_counter() - T_START:.1f}s")

    cal = calibrate_phase(torch, dev)
    log(f"phase 2b done at {time.perf_counter() - T_START:.1f}s")

    # phase 4 before phase 3: under --profile, a device-time session that
    # follows the profiled serving runs has recorded no kernel at all
    t_dec = time_fused_decode(torch, dec)
    t_pre = time_sparse_prefill(torch, dev)
    t_csq = time_centroid_scores(torch, dec, scored["int4_asym"])
    t_csf = time_centroid_scores(torch, dec, scored["none"])
    t_pa = time_paged_attention(torch, dec, att)
    t_pool = time_pool_rank_keys(torch, pool)
    t_topk = time_topk_threshold(torch, topk)
    t_flash = time_flash_attention(torch, dev)
    sparse_prompt_ms = t_flash.pop("sparse_ms")
    t_chunk = time_flash_chunk(torch, dev)
    t_ident = time_paged_identity(torch, ident)
    log(f"phase 4 done at {time.perf_counter() - T_START:.1f}s")

    mem0 = torch.cuda.memory_allocated()
    paths = serve(torch, dev, cal["cfg"], profile=args.profile)
    gc.collect()
    mem1 = torch.cuda.memory_allocated()
    log(f"device memory allocated before phase 3: {mem0 / 2**30:.3f} GiB, after phase "
        f"6 ({ARCH}'s engines, graphs and weights dropped): {mem1 / 2**30:.3f} GiB")
    if mem1 > mem0 + 2**28:
        blocks = {}
        for seg in torch.cuda.memory_snapshot():
            for b in seg["blocks"]:
                if b["state"] == "active_allocated":
                    key = f"{b['size']} B on stream {seg['stream']}"
                    blocks[key] = blocks.get(key, 0) + 1
        log(f"live blocks by size and stream: {json.dumps(blocks)}")
        fail("an engine, its decode graphs or the weights outlived phase 3")
    qwen = serve_qwen(torch, dev)
    log(f"phase 3b and phase 6 ({QWEN}) done at {time.perf_counter() - T_START:.1f}s")
    log(f"phase 6 summary (ms; busy = device-busy ms per step): "
        f"{json.dumps({ARCH: paths['step'], QWEN: qwen['step']})}")
    tiered = paths["tiered"]
    log(f"phase 7 summary ({card}): " + json.dumps({
        "migration_ms": tiered["migration_ms"],
        "migration_bound_ms": tiered["migration_bound_ms"],
        "pool": tiered["T"]["pool"], "tier": tiered["T"]["tier"],
        "ttft_tpot_p50": {n: [tiered[n]["snap"]["ttft_p50"], tiered[n]["snap"]["tpot_p50"]]
                          for n in ("F", "T")},
        "step": tiered["step"], "storm_fired": tiered["S"]["fired"]}))
    fused, staged = paths["fused"], paths["staged"]
    q1, q2 = qwen["Q1"], qwen["Q2"]
    kernels_line = [
        {"name": "fused_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_decode.cu",
         "replaces": "src/repro/kernels/fused_decode.py:333",
         "launches": fused["counts"]["fused_decode"]["launches"],
         "max_abs_err": max(dec["err"], dec_q["err"]), **t_dec, "library_ms": None},
        {"name": "sparse_prefill", "route": "cuda",
         "source": "src/repro_torch/csrc/sparse_prefill.cu",
         "replaces": "src/repro/kernels/sparse_prefill.py:355",
         "launches": fused["counts"]["sparse_prefill"]["launches"],
         "max_abs_err": max(pre["err"], pre_q["err"]), **t_pre, "library_ms": None},
        {"name": "centroid_scores_quantized", "route": "cuda",
         "source": "src/repro_torch/csrc/centroid_score.cu",
         "replaces": "src/repro/kernels/centroid_score.py:147",
         "launches": staged["counts"]["centroid_scores_quantized"]["launches"],
         "max_abs_err": scored["int4_asym"]["err"], **t_csq},
        {"name": "centroid_scores_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/centroid_score.cu",
         "replaces": "src/repro/kernels/centroid_score.py:181",
         "launches": paths["f32"]["counts"]["centroid_scores_f32"]["launches"],
         "max_abs_err": scored["none"]["err"], **t_csf},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:143",
         "launches": staged["counts"]["paged_attention"]["launches"],
         "max_abs_err": max(att["err"], ident["err"]), **t_pa,
         **{f"identity_{k}": v for k, v in t_ident.items()},
         "identity_launches": q2["counts"]["paged_attention"]["launches"]},
        {"name": "pool_rank_keys", "route": "cuda",
         "source": "src/repro_torch/csrc/pool_rank_keys.cu",
         "replaces": "src/repro/kernels/block_centroid.py:80",
         "launches": cal["launches"], "max_abs_err": pool["err"], **t_pool},
        {"name": "topk_threshold", "route": "cuda",
         "source": "src/repro_torch/csrc/topk_threshold.cu",
         "replaces": "src/repro/kernels/topk_threshold.py:88",
         "launches": 0, "max_abs_err": topk["err"], **t_topk},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:117",
         "launches": q1["counts"]["flash_attention"]["launches"],
         "max_abs_err": max(flash["err"], flash_off["err"]), **t_chunk,
         **{f"sxs_{k}": v for k, v in t_flash.items()}},
    ]
    for k in kernels_line:
        # the launches of phase 5's ladder run (L: all three rungs) and of
        # phase 7's tiered run (T: fused, plus the page masks' scoring)
        k["ladder_launches"] = paths["ladder"]["counts"][k["name"]]["launches"]
        k["tiered_launches"] = paths["tiered"]["T"]["counts"][k["name"]]["launches"]
    for k in kernels_line:
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
        log(f"{k['name']}: {k['ms']:.4f} ms/launch, plain {k['plain_ms']:.3f} ms, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), library {lib}, "
            f"launches while serving {k['launches']}, in phase 5's run L "
            f"{k['ladder_launches']}, in phase 7's run T {k['tiered_launches']}")
    f_steps, s_steps = fused["steps"], staged["steps"]
    log(f"launches per decode step: fused path "
        f"{fused['counts']['fused_decode']['launches'] / f_steps['decode_step']:.1f} "
        f"fused_decode; staged path "
        f"{staged['counts']['centroid_scores_quantized']['launches'] / s_steps['decode_step']:.1f} "
        f"centroid_scores_quantized, "
        f"{staged['counts']['paged_attention']['launches'] / s_steps['decode_step']:.1f} "
        f"paged_attention; per prefill chunk "
        f"{fused['counts']['sparse_prefill']['launches'] / f_steps['prefill_chunk']:.1f}; "
        f"library_ms null for fused_decode / sparse_prefill (no single PyTorch call "
        f"scores, selects and attends) and centroid_scores_quantized (none "
        f"dequantizes split-half INT4)")
    log(f"launches: pool_rank_keys {cal['launches']} in the cuda calibration run "
        f"(one per layer, sample and candidate block size), 0 while serving; "
        f"topk_threshold lies on no serving path (0); dense flash over the whole "
        f"prompt / its sparse_prefill chunks = {t_flash['ms'] / sparse_prompt_ms:.3f}")
    log(f"{QWEN} launches: Q1 flash_attention "
        f"{q1['counts']['flash_attention']['launches']} over "
        f"{q1['steps']['prefill_chunk']} prefill chunks "
        f"({q1['counts']['flash_attention']['launches'] / q1['steps']['prefill_chunk']:.1f} "
        f"per chunk), fused_decode {q1['counts']['fused_decode']['launches']} over "
        f"{q1['steps']['decode_step']} decode steps; Q2 paged_attention (identity table) "
        f"{q2['counts']['paged_attention']['launches']} over {q2['steps']['decode_step']} "
        f"decode steps; flash_attention's kernel-line numbers are the chunk shape's, "
        f"its S x S numbers under sxs_*")
    log(f"total {time.perf_counter() - T_START:.1f}s")
    (out_dir / "chip_smoke.log").write_text("\n".join(LOG) + "\n")
    print(card)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
