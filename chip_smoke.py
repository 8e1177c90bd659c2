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
   Q1's live lengths, the last chunk of its 9000-token prompt) and at
   phase 9's new shapes (``check_family_kernels``: gemma-7b's 16 / 16
   heads of 256 with Dp 512 for the fused decode, the sparse prefill, the
   staged scoring and paged attention, flash S x S and at the chunk
   shape, the identity table; qwen3-32b's group 8, 512 query rows a
   prefill cell, at offsets 0 and 8192, and its fused decode; qwen1.5-4b's
   20 kv heads of group 1 in the fused decode) and at phase 10's and
   11's (``check_late_kernels``: granite-moe-3b-a800m's 24 / 8 heads of
   64 with Dp 128 and musicgen-large's 32 / 32 heads of 64 with Dp 128 at
   group 1 for the fused decode, the sparse prefill and flash at a chunk
   offset; internvl2-2b's 16 / 8 heads of 128 for the fused decode);
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
5. (run after phase 3, on its weights and fused configuration, cut to the
   first ``LADDER_LAYERS`` of its layers) the degradation ladder and a
   fault storm: requests 0, 1, 3 and 5 (24 new
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
3b. serve full-width qwen3-8b (5 of its 36 layers, d_model 4096, 32 / 8
   heads, untied head, bf16, random weights from a seeded generator) through
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
   The extended kernels are timed the same way at gemma-7b's head_dim 256
   and at qwen3-32b's 512-row prefill (``time_family_kernels``; logged, not
   in the ``kernels`` line, whose ``max_abs_err`` covers those checks too).
   Every ``torch.profiler`` session of the script goes through
   ``profiled``: synchronized before it opens and before it closes, its
   rows read once closed; an empty recording is logged and, where the
   work can run again, recorded again; a third empty one fails (a
   served decode step is idempotent for its lengths and tokens: after an
   empty recording the same step is served once more and profiled).  The
   profiler loses a session's leading kernels in about 1% of sessions on
   an H100 (``tools/profiler_window.py``); the final summary lists every
   recording retaken.

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
   8 rounds in turns (CUDA events), its device-busy ms per step printed
   (``torch.profiler``), and one profiled replay's launches of each decode
   kernel must equal the bookkeeping's for one step (a recording short of
   launches is recorded once more).  d) Every served run
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

8. (after phase 7, on phase 3's weights and fused configuration) tracing,
   the serving launcher and its async front-end: 8a runs
   ``repro_torch.launch.serve.main`` at full llama3.2-3b width (its own
   weights, generator seed 0; fused decode, sparse prefill, max_context
   16384, 4 slots, chunks of 512, 16 new tokens, two shared 128-token
   prefixes, SLO classes round robin, traced, metrics every 8 ticks) with
   6 requests of 6000, 3000, 9000, 2000, 7000 and 4000 tokens arriving at
   ticks 0, 0, 2, 5, 9 and 14 through the async front-end: every request
   must finish, the trace validate (``engine.tick``, ``engine.decode``,
   ``prefill.chunk``, the lifecycle spans, the ``pool``, ``queue`` and
   ``sparsity`` counters, ``sched.admit`` and ``prefix.match``), the run
   launch the fused decode, the sparse prefill and (for the telemetry
   that follows the trace) the scoring kernel only, and the streams equal
   ``Engine.run_until_done``'s at every position for the same requests
   submitted at the same ticks (a drain with all of them submitted at once
   is logged beside: its prefix-cache hits, chunk bounds and so its sums
   differ);
   8b serves phase 7's run T again with a trace recorder: tokens equal to
   T's at every position, the trace holding the forced miss's
   ``seq.stall``, ``mem.demote`` / ``mem.promote`` and the ``residency``
   and ``sparsity`` counters; 8c logs (no gate) the graphed fused decode
   step untraced and traced (device time and CUDA events in turns, three
   rounds) and four closed batches on one engine with tracing on, off,
   on, off (the first two capture their variant of the step): wall, TTFT
   and TPOT p50, events recorded and dropped, on the first
   ``COST_LAYERS`` layers.

9. (after phase 3b; ``serve_family``) the JAX package's other dense
   decoders at full width, cut in depth to a quarter of their layers
   (``FAMILY_LAYERS``), one on the card at a time (bf16,
   random weights from ``torch.Generator`` seed 0, INT4-asym quest store,
   T 4096, block sizes ``(16, 32, 64)[(layer + head) % 3]``, chunks of
   512, 16 new tokens, temperature 0): llama3.1-8b, qwen1.5-4b and
   gemma-7b at max_batch 4 on requests 0, 1 and 3 (9000, 6500 and 4000
   tokens, 0 and 1 sharing the 2048-token prefix) in runs D (the default
   configuration: ``flash_attention`` + ``fused_decode``) and S
   (``sparse_prefill`` + ``fused_decode``), gemma-7b also G (the staged
   rung: ``flash_attention``, ``centroid_scores_quantized``,
   ``paged_attention`` at head_dim 256 / Dp 512); qwen3-32b (65.5 GB of
   weights at full depth) at a reduced max_batch of 2 on requests 1 and 2 (6500 and
   12000 tokens).  Each run launches its path's kernels and no other,
   calls no plain version and ends on rung 0; each is served again through
   the plain versions, fed its tokens (qwen3-32b: request 1 alone at
   max_batch 1), at a logit cosine of at least 0.9995.  There every sparse
   prefill call selects on its own inputs and is held against the kernel
   on the same inputs (``prefill_selections``).  Peak device memory is
   logged per model.

10. (after phase 9; ``serve_moe``) granite-moe-3b-a800m at full width
   and depth (32 layers, 24 / 8 heads of 64, 40 experts top-8 of d_ff
   512, vocab 49155, tied, bf16, capacity factor 1.25 as published,
   random weights from ``torch.Generator`` seed 0).  a) granite served
   end to end (``serve_oracle``) in phase 9's runs D and S with step
   graphs off, every ``flash_attention``, ``sparse_prefill`` and
   ``fused_decode`` call held against its plain version on its own inputs
   under ``kernels.parity``'s rules (``call_oracle``), the run going on
   with the kernels' outputs; power checks on layer 16's calls, each
   faulted copy of which must be flagged while every clean call is held:
   one selected page per (sequence, kv head) swapped for the
   lowest-scored live page the plain selection left out (every decode),
   a seeded 1% of the output moved by 4 bf16 steps (D's flash calls).
   (``noise_gate``, the end-to-end gate this replaces, passed a faulty
   pass on the card: ``ROADMAP.md`` §3.)  b) the MoE FFN on the card
   against the same function in f32 on the CPU
   (``repro_torch.models.moe_check.compare_moe_ffn``) on the inputs of one
   layer that granite's entry points give it: a whole chunk, a padded
   chunk, a decode step.  c) granite's decode step graphed vs eager
   (phase 6's method), the MoE FFN's share of the step's device time (the
   expert products apart), peak memory.  d) internvl2-2b at full width
   and depth, requests 0, 1 and 3 each after 256 patch embeddings
   (single-shot prefill through ``flash_attention``, fused decode), then
   through the plain versions fed its tokens: cosine ``LOGIT_COS``.

11. (after phase 10; ``serve_musicgen``) musicgen-large at full width,
   24 of its 48 layers (``FAMILY_LAYERS``; 32 / 32 heads of 64, GELU MLP
   of 8192, vocab 2048,
   untied head, sinusoidal absolute positions on top of RoPE; bf16,
   random weights from ``torch.Generator`` seed 0) in phase 9's runs D
   (cosine ``LOGIT_COS``) and S (``s_gate``, each plain sparse prefill
   call held on its own inputs) on its traffic; run A: request 3 after
   256 bf16 audio-frame embeddings (single-shot prefill, the frames at
   positions 0-255, decode from 4256 on), then the plain versions fed its
   tokens at cosine ``LOGIT_COS``; and the fused decode step graphed vs
   eager, which must be bitwise equal (the positions are an op inside the
   captured graph).

12. (after phase 11; ``serve_recurrent``) the recurrent families at full
   width and depth (bf16, random weights from ``torch.Generator`` seed 0,
   ``SparseConfig(enabled=False)``: no kernel of the port lies on their
   path, since JAX computes RG-LRU, wkv6 and local attention in plain
   jnp): recurrentgemma-9b (38 layers: 12 cycles of rglru, rglru,
   local_attn, then rglru, rglru; d 4096, MQA 16 heads of 256, window
   2048, GeGLU 12288, vocab 256000, tied) and rwkv6-3b (32 layers, d 2560,
   40 heads of 64, ReLU^2 8960, vocab 65536).  a) prompts of 700, 2040,
   3000 and 5000 tokens x 16 served at batch 4, context 8192, each
   prefilled in one shot (``_chunkable`` False, no prefix cache), the
   graphed decode step.  b) a single-shot prefill of each prompt and its
   first 0, 8, 15 served tokens against the engine's logits there
   (cosine ``LOGIT_COS``).  c) the 3000-token prompt prefilled, then fed
   its tokens: every layer's state (ring buffers, ``h``, ``conv``, ``S``,
   ``xprev``) against a single-shot prefill after 1 and 16 fed tokens,
   relative L2 5e-2.  d) power checks (``REC_FAULTS``) that must fail c).
   e) one layer of each kind on its served inputs, card against the CPU
   in f32 (rows within 2e-2).  f) the graphed step bitwise the eager one,
   its ms, kernels and peak memory.  No kernel launches and no plain
   version runs.

13. (after phase 12; ``train_phase``) training (``repro_torch.training``)
   on llama3.2-3b, every earlier model freed.  a) at full width and 2
   layers, bf16, B 1, S 2048, remat "dots": every parameter's gradient
   against an f32 copy's, per leaf cosine and relative L2
   (``TRAIN_GRAD_*``); two power
   checks on layer 1 (queries rotated one position on; each query seeing
   the next key too) must fail that gate on its leaves; the f32 copy's
   ``grad_accum`` 2 against 1 on a batch of 2 within relative L2 1e-5.
   b) ``Trainer`` at full width and depth (28 layers, tied, vocab
   128256), bf16 with an f32 master, m and v: 20 steps of 2 x 2048
   tokens, remat "dots", lr 3e-4, warmup 2, no checkpoint; every loss
   finite and the mean of the last three at least 2 nats below the
   first; step ms (median of steps 5-20), tokens/s and peak memory.  c)
   ``python -m repro_torch.launch.train --smoke --steps 6`` on the card
   with a failure injected at step 5 (one restart, checkpoints under
   ``chiprun_out/``), then a bf16 smoke trainer's state saved and
   restored on the card, bitwise, in its device and dtype.  No kernel
   launches and no plain version runs (JAX trains through no Pallas
   kernel).

14. (after phase 13; ``mesh_phase``) multi-GPU serving
   (``repro_torch.distributed``).  a) phase 2's llama3.2-3b inputs (B 4,
   24 / 8 heads of 128, INT4 store, a chunk at offset 8192) cut by
   ``kernel_partition`` into every shard of the (data, model) meshes
   ``MESH_SHAPES`` (model 2, 4, 8 by data 1, 2, 4, and model 16, where
   8 kv heads replicate): each shard's ``fused_decode``,
   ``sparse_prefill``, staged scoring and selection, ``paged_attention``
   and flash, launched one after another at the whole call's split,
   stitched and held bitwise to the whole call (out, page table, valid,
   n_attended, selected blocks, scores); each shard's own split plan,
   where it differs, logged with whether its outputs then differ.  b)
   llama3.2-3b at ``LADDER_LAYERS`` layers serves requests
   ``MESH_REQS`` x ``NEW_TOKENS`` on one device, then on a one-rank NCCL
   mesh (1, 1): tokens equal, both graphed; then two ranks on this card
   at (1, 2) over gloo (NCCL takes one card a rank; the script started
   again with ``--mesh-rank``): the sharded engine, each rank 4 kv heads,
   eager, tokens equal.  c) with n >= 2 cards only: the same at (1, n)
   over NCCL, one process a card; else logged as alone.

15. (after phase 14; ``abstract_phase``) the wrappers' abstract rules
   (``repro_torch.analysis``).  a) every kernel's entry point called on
   phase 2's real inputs (the fused decode's, the sparse prefill chunk's,
   both staged stores, the staged page table, the serving and calibration
   keys, the masked scores, a flash chunk at ``FLASH_CHUNK_OFF`` with an
   int and a tensor key length), then on fake copies of them under
   ``FakeTensorMode``: output shapes, dtypes and devices equal for all
   eight kernels, each real call one launch, the fake ones none.  b)
   ``repro_torch.analysis.contracts.run_contracts(device="cuda")``: 6
   cells on fake CUDA tensors, 0 failures.  Under 20 s.

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
import contextlib
import dataclasses
import gc
import io
import json
import os
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
#: qwen3-8b at full width (phase 3b) and its GQA group; it runs 5 of its 36
#: layers (cut in depth to keep the whole script well inside its time
#: limit: llama3.1-8b serves the same layer shapes, at 8 layers, in phase 9)
QWEN, QG, QWEN_LAYERS = "qwen3-8b", 4, 5
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

#: phase 9, the dense family: the models it serves, and the new kernel
#: shapes of three of them, (kv heads, head_dim) of gemma-7b and (kv
#: heads, GQA group) of qwen3-32b and qwen1.5-4b
LLAMA31, QWEN15, GEMMA, QWEN32 = "llama3.1-8b", "qwen1.5-4b", "gemma-7b", "qwen3-32b"
#: phase 10, the MoE family and prefix-embedding requests
GRANITE, INTERNVL = "granite-moe-3b-a800m", "internvl2-2b"
#: phase 11, musicgen-large on the sparse kernels
MUSICGEN = "musicgen-large"
FAMILY_SHAPES = {GEMMA: (16, 256), QWEN32: (8, 8), QWEN15: (20, 1)}

#: phase 5, the degradation ladder and a fault storm on phase 3's weights
#: and fused main-path configuration: the requests (0 and 1 share the
#: prefix), their new tokens, the clean decode ticks per re-promotion in
#: run L (24 tokens give about 25 decode ticks, too few for three windows
#: of the default 8), and the request the storm poisons on every tick
LADDER_REQS, LADDER_NEW, LADDER_REPROMOTE, STORM_VICTIM = (0, 1, 3, 5), 24, 4, 5
#: layers of llama3.2-3b that phases 5 and 8c run (the first 8 of its 28:
#: cut in depth for the script's time limit, which phases 10 and 11 share;
#: their gates read rungs, ticks and launches per layer, not the depth;
#: phase 3 serves the same path at full depth)
LADDER_LAYERS = COST_LAYERS = 8
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


#: (phase, seconds since the start) as each phase ends (``phase_done``)
PHASES = []


def phase_done(name: str):
    PHASES.append((name, time.perf_counter() - T_START))
    log(f"phase {name} done at {PHASES[-1][1]:.1f}s")


def phase_seconds() -> dict:
    """Each phase's own seconds, from the end of the one before (the build
    counts to phase 2)."""
    ends = [0.0] + [t for _, t in PHASES]
    return {n: round(t - ends[i], 1) for i, (n, t) in enumerate(PHASES)}


def fail(msg: str):
    log(f"seconds by phase so far: {json.dumps(phase_seconds())}; "
        f"{time.perf_counter() - T_START:.1f}s in all")
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


#: this run's ``torch.profiler`` sessions (``profiled``): opened, recorded
#: again after an empty first recording, and every recording retaken (empty,
#: or in phase 6 short of launches), listed in the final summary
PROFILER = {"sessions": 0, "retried": 0, "retakes": []}


def profiled(torch, run, repeatable: bool = True):
    """The one owner of a ``torch.profiler`` session's lifecycle: ``run()``
    under a session of device activity only, opened after a synchronize (no
    earlier work lands in it) and closed after one (all of ``run``'s work
    does), its rows read once it has closed -> (device ms, launches, kernel
    name) per kernel, largest first.  A session that recorded no device
    time is logged (and listed in ``PROFILER``); a ``repeatable`` run is
    recorded again, up to three recordings, and a third empty recording (or
    a first one of a run that cannot be repeated) fails the script.  On an
    H100 the profiler loses the leading kernels of a session, some or all of
    them, in 0.15-0.9% of sessions whatever the host waits before the work
    or after it, eager or graphed (``tools/profiler_window.py``; all of them
    in 0.05-0.5%), and two empty recordings in a row were seen once; work
    that really ran no kernel comes back empty every time."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    PROFILER["sessions"] += 1
    for attempt in (1, 2, 3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        rows = device_time_rows(torch, prof)
        if rows:
            return rows
        log(f"profiler: session {PROFILER['sessions']} recorded no device time "
            f"(recording {attempt}; {len(prof.events())} events, of them "
            f"{sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())}"
            f" on the device)")
        if not repeatable:
            break
        PROFILER["retried"] += attempt == 1
        PROFILER["retakes"].append({"session": PROFILER["sessions"], "kind": "empty",
                                    "recording": attempt})
    fail("the profiler recorded no device time"
         + (" three times in a row" if repeatable else ""))


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call of ``fn``: the summed times of the kernels it
    launches (``torch.profiler``), without the time the device waits for
    the host between calls."""
    fn()

    def run():
        for _ in range(iters):
            fn()

    return sum(r[0] for r in profiled(torch, run)) / iters


def short(name: str) -> str:
    """A kernel's name as the profiler gives it, without its namespace,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip() or name[:40]


def kernel_breakdown(torch, fn, iters: int) -> str:
    """Device ms per call of ``fn`` by kernel (``torch.profiler``), as text."""
    fn()

    def run():
        for _ in range(iters):
            fn()

    return ", ".join(f"{short(name)} {ms / iters:.4f}"
                     for ms, _, name in profiled(torch, run))


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


def head_blocks(n_kv):
    """Block sizes of ``n_kv`` heads: BLOCKS repeated."""
    return tuple(BLOCKS[h % len(BLOCKS)] for h in range(n_kv))


def layer_inputs(torch, dev, B, seed, n_kv=N_KV, d=D):
    from repro_torch.config import SparseConfig
    from repro_torch.core.ragged import layout_for
    from repro_torch.core.stacked import as_arrays

    sparse = SparseConfig(token_budget=BUDGET, quant="int4_asym",
                          sparse_prefill=True)
    la = as_arrays(layout_for(head_blocks(n_kv), CTX, PS, BUDGET), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (B, n_kv, CTX // PS, PS, d)
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return sparse, la, gen, k, v


def check_fused_decode(torch, dev, g=G, live=None, seed=1, n_kv=N_KV, d=D):
    """The fused kernel against its plain version at ``n_kv * g`` query
    heads of ``d`` channels and live lengths ``live`` (default:
    llama3.2-3b's heads and ragged lengths up to CTX), at its planned and
    forced split counts, with the comparison's power check."""
    from repro_torch.backends.store import build_store_codes
    from repro_torch.core.centroids import rank_query
    from repro_torch.core.sparse_attention import paged_attention_reference
    from repro_torch.kernels import parity

    B = 4
    live = live or (CTX, CTX * 3 // 4 + 1, CTX * 7 // 16 - 3, CTX // 7)
    sparse, la, gen, k, v = layer_inputs(torch, dev, B, seed=seed, n_kv=n_kv, d=d)
    q = torch.randn((B, n_kv * g, d), generator=gen, device=dev)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    seq_len = torch.tensor(live, dtype=torch.int32, device=dev)
    log(f"fused_decode check at {n_kv * g}/{n_kv} heads of {d}, live {live}:")
    store = build_store_codes(k, la, sparse)
    rq = rank_query(q, sparse.centroid_method, d)
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


def check_sparse_prefill(torch, dev, g=G, off=CTX // 2, valid=None, seed=2,
                         n_kv=N_KV, d=D):
    """The sparse prefill kernel against its plain version on a CHUNK-query
    chunk at ``off`` with ``n_kv * g`` query heads of ``d`` channels and
    live lengths ``valid`` (default: llama3.2-3b's heads and ragged lengths
    ending inside the chunk), at its planned and forced split counts."""
    from repro_torch.backends.base import CentroidStore
    from repro_torch.backends.store import build_score_rows
    from repro_torch.core.centroids import rank_query
    from repro_torch.core.quantization import store_bits
    from repro_torch.kernels import parity

    B, SQ, OFF = 4, CHUNK, off
    sparse, la, gen, k, v = layer_inputs(torch, dev, B, seed=seed, n_kv=n_kv, d=d)
    q = torch.randn((B, n_kv * g, SQ, d), generator=gen, device=dev)
    q = (q * parity.QSCALE).to(torch.bfloat16)
    # ragged live lengths: later sequences end inside the chunk, leaving
    # dead trailing query blocks
    valid = valid or (OFF + SQ, OFF + SQ * 3 // 5, OFF + SQ // 8, OFF + 1)
    n_valid = torch.tensor(valid, dtype=torch.int32, device=dev)
    log(f"sparse_prefill check at {n_kv * g}/{n_kv} heads of {d} (g*BQ "
        f"{g * sparse.prefill_block_q}), offset {OFF}, live {valid}:")
    codes, sc, ze = build_score_rows(k, la, sparse)
    ss = CentroidStore(codes, sc, ze, store_bits(sparse.quant), False)
    rq = rank_query(q, sparse.centroid_method, d)
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
    return {"err": err, "args": (q, rq, k, v, ss, la, sparse, n_valid, OFF)}


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


def check_flash_attention(torch, dev, hq=N_KV * G, hkv=N_KV, d=D):
    """The dense flash kernel at B 1, ``hq`` query / ``hkv`` kv heads of
    ``d`` channels (default llama3.2-3b's 24 / 8 of 128), S
    ``FLASH_CHECK_S``, causal and not, against the plain version."""
    from repro_torch.kernels import parity

    gen = torch.Generator(device=dev).manual_seed(11)
    S = FLASH_CHECK_S
    q = (torch.randn((1, hq, S, d), generator=gen, device=dev)
         * parity.QSCALE).to(torch.bfloat16)
    k, v = (torch.randn((1, hkv, S, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    err = 0.0
    for causal in (True, False):
        res = parity.compare_flash_attention(q, k, v, causal)
        err = max(err, res["max_abs_err"])
        if causal:
            plain = res["plain"]
        log(f"flash_attention check ({hq}/{hkv} heads of {d}, "
            f"{'causal' if causal else 'not causal'}, S {S}): "
            f"max_abs_err {res['max_abs_err']:.3e}, max rel L2 {res['max_rel_l2']:.3e} "
            f"(limit {parity.REL_L2}), {res['tol_use']:.2f} of the elementwise limit "
            f"{parity.OUT_ATOL} + 2^-7 |plain|")
    # power: the causal output of query head 0 with one 64-key tile (keys
    # S/2 .. S/2 + 63) left out must fail the comparison
    t0 = S // 2
    keep = torch.ones((S, S), dtype=torch.bool, device=dev).tril_()
    keep[:, t0:t0 + 64] = False
    logits = (q[0, 0].float() @ k[0, 0].float().T) * d ** -0.5
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


def flash_chunk_inputs(torch, dev, seed, hq=N_KV * QG, hkv=N_KV, d=D):
    """A chunk of CHUNK queries at ``hq`` / ``hkv`` heads of ``d`` channels
    (default qwen3-8b's 32 / 8 of 128) and a CTX-row K / V buffer, as
    ``prefill_chunk`` hands the flash kernel a slot's cache row."""
    from repro_torch.kernels import parity

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((1, hq, CHUNK, d), generator=gen, device=dev)
         * parity.QSCALE).to(torch.bfloat16)
    k, v = (torch.randn((1, hkv, CTX, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v


def check_flash_offset(torch, dev, hq=N_KV * QG, hkv=N_KV, d=D):
    """The flash kernel with a query offset and a key length, as chunked
    dense prefill calls it, against its plain version: a CHUNK-query chunk
    at offset ``FLASH_CHUNK_OFF`` over the keys written so far
    (``FLASH_CHUNK_OFF + CHUNK`` of CTX rows), the same at
    ``FLASH_ODD_OFF`` (no multiple of the key tile), one query at offset
    12345 (at CTX 16384).  Power: the chunk's output with one 64-key tile
    of one head left out must fail the comparison."""
    from repro_torch.kernels import parity

    q, k, v = flash_chunk_inputs(torch, dev, seed=12, hq=hq, hkv=hkv, d=d)
    err, plain = 0.0, None
    for off, sq in ((FLASH_CHUNK_OFF, CHUNK), (FLASH_ODD_OFF, CHUNK),
                    (CTX * 3 // 4 + 57, 1)):
        qs = q[:, :, :sq].contiguous()
        res = parity.compare_flash_attention(qs, k, v, True, off, off + sq)
        err = max(err, res["max_abs_err"])
        if off == FLASH_CHUNK_OFF:
            plain = res["plain"]
        log(f"flash_attention offset check ({hq}/{hkv} heads of {d}, {sq} queries at "
            f"offset {off}, "
            f"keys [0, {off + sq}) of {CTX}): max_abs_err {res['max_abs_err']:.3e}, "
            f"max rel L2 {res['max_rel_l2']:.3e} (limit {parity.REL_L2}), "
            f"{res['tol_use']:.2f} of the elementwise limit")
    off, n = FLASH_CHUNK_OFF, FLASH_CHUNK_OFF + CHUNK
    t0 = off // 2
    pos = off + torch.arange(CHUNK, device=dev)
    keep = torch.arange(n, device=dev)[None, :] <= pos[:, None]
    keep[:, t0:t0 + 64] = False
    logits = (q[0, 0].float() @ k[0, 0, :n].float().T) * d ** -0.5
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


def check_paged_identity(torch, dev, hq=N_KV * QG, hkv=N_KV, d=D):
    """The paged-attention kernel over dense decode's identity page table
    (the ``"dense"`` backend, an inactive plan) at ``hq`` / ``hkv`` heads of
    ``d`` channels (default qwen3-8b's shape): B 4, CTX / PS pages, live
    lengths ``IDENTITY_LIVE``."""
    from repro_torch.backends import get_backend
    from repro_torch.kernels import parity

    B = len(IDENTITY_LIVE)
    gen = torch.Generator(device=dev).manual_seed(13)
    kp, vp = (torch.randn((B, hkv, CTX // PS, PS, d), generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    q = (torch.randn((B, hq, d), generator=gen, device=dev)
         * parity.QSCALE).to(torch.bfloat16)
    live = torch.tensor(IDENTITY_LIVE, dtype=torch.int32, device=dev)
    tbl, vld = get_backend("cuda").full_page_table(kp, live)
    res = parity.compare_paged_attention(q, kp, vp, tbl, vld, PS, live)
    log(f"paged_attention identity-table check (B {B}, {hq}/{hkv} heads of {d}, "
        f"{CTX // PS} pages, "
        f"live {list(IDENTITY_LIVE)}): max_abs_err {res['max_abs_err']:.3e}, max rel "
        f"L2 {res['max_rel_l2']:.3e}, {res['tol_use']:.2f} of the elementwise limit")
    return {"err": res["max_abs_err"], "args": (q, kp, vp, tbl, vld, live)}


def check_family_kernels(torch, dev):
    """Phase 2 at the dense family's new shapes (phase 9's models): every
    kernel whose head_dim or row count they extend, against its plain
    version with the same rules and power checks as at llama3.2-3b's.

    - gemma-7b's layer (16 / 16 heads of 256, Dp 512): ``fused_decode``
      (planned and forced split counts), ``sparse_prefill`` (splits 1 and
      5), ``centroid_scores_quantized`` and ``paged_attention`` on the
      staged table, ``flash_attention`` (S x S, the chunk at offsets 8192
      and 5003) and ``paged_attention`` over the identity table;
    - qwen3-32b's group 8 (64 / 8 heads, g * BQ 512): ``sparse_prefill`` at
      offsets 0 and 8192 and ``fused_decode``;
    - qwen1.5-4b's group 1 at 20 kv heads: ``fused_decode``."""
    gh, gd = FAMILY_SHAPES[GEMMA]
    out = {"gemma": {}}
    dec = check_fused_decode(torch, dev, g=1, seed=21, n_kv=gh, d=gd)
    pre = check_sparse_prefill(torch, dev, g=1, seed=22, n_kv=gh, d=gd)
    scored = check_centroid_scores(torch, dec, "int4_asym")
    att = check_paged_attention(torch, dec, scored)
    flash = check_flash_attention(torch, dev, hq=gh, hkv=gh, d=gd)
    flash_off = check_flash_offset(torch, dev, hq=gh, hkv=gh, d=gd)
    ident = check_paged_identity(torch, dev, hq=gh, hkv=gh, d=gd)
    out["gemma"] = {"dec": dec, "scored": scored, "att": att, "ident": ident,
                    "err": {"fused_decode": dec["err"], "sparse_prefill": pre["err"],
                            "centroid_scores_quantized": scored["err"],
                            "paged_attention": max(att["err"], ident["err"]),
                            "flash_attention": max(flash["err"], flash_off["err"])}}
    qh, qg = FAMILY_SHAPES[QWEN32]
    pre32 = [check_sparse_prefill(torch, dev, g=qg, off=off, seed=23 + i, n_kv=qh)
             for i, off in enumerate((0, CTX // 2))]
    dec32 = check_fused_decode(torch, dev, g=qg, seed=25, n_kv=qh)
    out["qwen32"] = {"dec": dec32, "err": {"sparse_prefill": max(r["err"] for r in pre32),
                                           "fused_decode": dec32["err"]}}
    dec15 = check_fused_decode(torch, dev, g=1, seed=26, n_kv=FAMILY_SHAPES[QWEN15][0])
    out["qwen15"] = {"dec": dec15, "err": {"fused_decode": dec15["err"]}}
    return out


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
    n_kv, d = k.shape[1], q.shape[-1]
    g = q.shape[1] // n_kv
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
              + 2 * store.scale.numel() * 4 + 2 * tokens * d * 2
              + q.numel() * 2 + tbl.numel() * 4 + vld.numel())
    f32_ops = 2 * n_rows * g * rq.shape[-1]
    bf16_ops = 4 * tokens * g * d
    b_ms, by = bound(bytes_, f32_ops, bf16_ops)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = pa.split_plan(q.shape[0], n_kv, tbl.shape[-1], n_sm)
    log(f"fused_decode ({n_kv * g}/{n_kv} heads of {d}), device ms per call by kernel: "
        f"{kernel_breakdown(torch, kernel, 20)}")
    log(f"fused_decode ({n_kv * g}/{n_kv} heads of {d}, B {q.shape[0]}, {plan} runs x "
        f"{q.shape[0] * n_kv} cells = {plan * q.shape[0] * n_kv} blocks): device {ms:.4f} ms/launch (rounds "
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

    dev, d = q.device, q.shape[-1]
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
              + 2 * kv_tokens * d * 2 + q.numel() * 2 + sel[..., 0].numel() * 4)
    f32_ops = 2 * Dp * float((cand.sum(-1) * live_rows[:, None, :]).sum())
    bf16_ops = 4 * d * float(extra["pairs"].sum())
    return bound(bytes_, f32_ops, bf16_ops)


def time_sparse_prefill(torch, dev, g=G, n_kv=N_KV, d=D, offsets=PREFILL_OFFSETS):
    """B 1, one prefill chunk of CHUNK tokens as the engine issues it, at
    ``n_kv * g`` query heads of ``d`` channels (default llama3.2-3b's), at
    the chunk offsets ``offsets``: device time of the call's kernels
    (``device_rounds``, three rounds) beside CUDA events around
    back-to-back calls; the bound from each offset's inputs.  The kernel
    line takes the middle offset's numbers (the plain version's time is
    taken there)."""
    from repro_torch.backends.store import build_score_rows
    from repro_torch.backends.base import CentroidStore
    from repro_torch.core.centroids import rank_query
    from repro_torch.core.quantization import store_bits
    from repro_torch.kernels import ops, sparse_prefill as sp

    B, SQ = 1, CHUNK
    sparse, la, gen, k, v = layer_inputs(torch, dev, B, seed=3, n_kv=n_kv, d=d)
    q = torch.randn((B, n_kv * g, SQ, d), generator=gen, device=dev).to(torch.bfloat16)
    codes, sc, ze = build_score_rows(k, la, sparse)
    ss = CentroidStore(codes, sc, ze, store_bits(sparse.quant), False)
    rq = rank_query(q, sparse.centroid_method, d)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    nQB = SQ // sparse.prefill_block_q
    rows = g * sparse.prefill_block_q
    n_split = sp.prefill_split_plan(B * n_kv * nQB, rows, n_sm, d)
    blocks = n_split * sp.attend_blocks(B * n_kv * nQB, rows, d)
    res = {}
    for off in offsets:
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
        log(f"sparse_prefill ({n_kv * g}/{n_kv} heads of {d}, g*BQ {rows}) at offset "
            f"{off}, device ms per call by kernel: {kernel_breakdown(torch, kernel, 20)}")
        log(f"sparse_prefill ({n_kv * g}/{n_kv} heads of {d}, B 1, chunk {SQ} at offset "
            f"{off}, {n_split} runs x {B * n_kv * nQB} cells = {blocks} attention blocks "
            f"of {sp.attend_warpgroups(rows, d)} warpgroups): device {ms:.4f} "
            f"ms/call (rounds {fmt_rounds(rounds)}; CUDA events {event_ms:.4f}), bound "
            f"{b_ms:.4f} ms ({by}), {b_ms / ms:.3f} of the bound; "
            f"ops.sparse_prefill with its layout copies {dev_t['call'][0]:.4f} "
            f"(rounds {fmt_rounds(dev_t['call'][1])})")
    mid = offsets[len(offsets) // 2]
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
    n_kv = k.shape[1]
    g = n_q // n_kv
    rows = st.codes.shape[1]
    if st.bits:
        args = (rq, st.codes, st.scale, st.zero, la.tile_head, la.tile_rows)
        kw = dict(bits=st.bits, symmetric=st.symmetric)
        fns = {"kernel": lambda: cs.centroid_scores_quantized(*args, **kw)}
    else:
        args = (rq, st.codes, None, None, la.tile_head, la.tile_rows)
        kw = dict(bits=0, symmetric=False, n_kv=n_kv)
        rq_t = rq.transpose(1, 2).contiguous()
        fns = {"kernel": lambda: cs.centroid_scores_f32(rq, st.codes, n_kv, la.tile_head,
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
    f32_ops = 2 * B * rows * g * Dp
    b_ms, by = bound(bytes_, f32_ops, 0)
    lib = ("none" if library_ms is None else f"device {library_ms:.4f} "
           f"(rounds {fmt_rounds(dev_t['library'][1])})")
    log(f"centroid_scores ({'INT' + str(st.bits) if st.bits else 'f32'} store, "
        f"{n_q}/{n_kv} heads, B {B}, "
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
    B, n_q, d = q.shape
    n_kv = k.shape[1]
    g = n_q // n_kv
    args = (q, k, v, tbl, vld, seq_len, PS)
    kernel = lambda: pa.paged_attention(*args)
    ms = device_ms(torch, kernel, 50)
    event_ms = cuda_time_ms(torch, kernel, 5, 50)
    plain_ms = cuda_time_ms(torch, lambda: pa.paged_attention_plain(*args), 1, 5)
    P = tbl.shape[-1]
    pos = tbl.long()[..., None] * PS + torch.arange(PS, device=q.device)
    live = ((pos < seq_len.long()[:, None, None, None]) & vld[..., None])
    live = live.reshape(B, n_kv, P * PS)
    idx = tbl.long()[..., None, None].expand(-1, -1, -1, PS, d)
    sel_k = torch.gather(k, 2, idx).reshape(B, n_kv, P * PS, d)
    sel_v = torch.gather(v, 2, idx).reshape(B, n_kv, P * PS, d)
    q4 = q.reshape(B, n_kv, g, d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(q4, sel_k, sel_v, attn_mask=live[:, :, None, :])
    library_ms = device_ms(torch, library, 50)
    library_event_ms = cuda_time_ms(torch, library, 5, 50)
    tokens = int(live.sum())
    bytes_ = (2 * q.numel() * 2 + 2 * tokens * d * 2 + tbl.numel() * 4
              + vld.numel() + seq_len.numel() * 4)
    f32_ops = 4 * tokens * g * d
    b_ms, by = bound(bytes_, f32_ops, 0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"paged_attention ({n_q}/{n_kv} heads of {d}, B {B}, "
        f"{pa.split_plan(B, n_kv, P, n_sm)} "
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


def time_flash_chunk(torch, dev, hq=N_KV * QG, hkv=N_KV, d=D):
    """The flash kernel at the chunk shape of dense prefill (qwen3-8b's 32 /
    8 heads, D 128, CHUNK queries at offset ``FLASH_CHUNK_OFF`` over the
    keys written so far of a CTX-row buffer), by the device time of its
    kernel in three rounds, in turns with its library call:
    ``scaled_dot_product_attention`` on the live keys with the equivalent
    boolean mask (K / V sliced beforehand, not timed)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = flash_chunk_inputs(torch, dev, seed=14, hq=hq, hkv=hkv, d=d)
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
        ke, ve = (x.repeat_interleave(hq // hkv, dim=1) for x in (ks, vs))
        library = lambda: sdpa(q, ke, ve, attn_mask=mask)
    dev_t = device_rounds(torch, {"kernel": kernel, "library": library}, 20)
    ms, library_ms = dev_t["kernel"][0], dev_t["library"][0]
    event_ms = cuda_time_ms(torch, kernel, 3, 20)
    plain_ms = cuda_time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True, off, n),
                            1, 3)
    pairs = hq * sum(off + i + 1 for i in range(CHUNK))
    b_ms, by = bound((2 * q.numel() + 2 * hkv * n * d) * 2, 0, 4 * d * pairs)
    log(f"flash_attention at the chunk shape (B 1, {hq}/{hkv} heads of {d}, {CHUNK} "
        f"queries at offset "
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
    B, hq, d = q.shape
    hkv = kp.shape[1]
    kernel = lambda: pa.paged_attention(q, kp, vp, tbl, vld, live, PS)
    kd, vd = kp.reshape(B, hkv, CTX, d), vp.reshape(B, hkv, CTX, d)
    mask = (torch.arange(CTX, device=q.device)[None, :] < live[:, None])[:, None, None, :]
    q4 = q.reshape(B, hkv, hq // hkv, d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(q4, kd, vd, attn_mask=mask)
    dev_t = device_rounds(torch, {"kernel": kernel, "library": library}, 50)
    ms, library_ms = dev_t["kernel"][0], dev_t["library"][0]
    plain_ms = cuda_time_ms(
        torch, lambda: pa.paged_attention_plain(q, kp, vp, tbl, vld, live, PS), 1, 5)
    tokens = int(live.long().sum()) * hkv
    bytes_ = (2 * q.numel() * 2 + 2 * tokens * d * 2 + tbl.numel() * 4 + vld.numel()
              + live.numel() * 4)
    b_ms, by = bound(bytes_, 4 * tokens * (hq // hkv) * d, 0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"paged_attention over the identity table (B {B}, {hq}/{hkv} heads of {d}, "
        f"{tbl.shape[-1]} pages, live {list(IDENTITY_LIVE)}, "
        f"{pa.split_plan(B, hkv, tbl.shape[-1], n_sm)} splits): device {ms:.4f} "
        f"ms/call (rounds {fmt_rounds(dev_t['kernel'][1])}), SDPA on the dense view "
        f"device {library_ms:.4f} (rounds {fmt_rounds(dev_t['library'][1])}), plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({by}), {b_ms / ms:.3f} of the bound")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms}


def time_family_kernels(torch, dev, fam):
    """Phase 4 at the dense family's new shapes: gemma-7b's layer (16 / 16
    heads of 256, Dp 512; the inputs of ``check_family_kernels``) for
    ``fused_decode``, ``sparse_prefill`` (chunk at offset 8192),
    ``centroid_scores_quantized``, ``paged_attention`` (staged table and
    identity table) and ``flash_attention`` (the chunk shape),
    qwen3-32b's ``sparse_prefill`` at g * BQ 512 (offset 8192) and
    ``fused_decode`` at group 8, and qwen1.5-4b's ``fused_decode`` at 20
    kv heads of group 1, with the same methods, bounds and library calls
    as at llama3.2-3b's shapes -> {"gemma": {kernel: times}, "qwen32":
    {...}, "qwen15": {...}}."""
    gh, gd = FAMILY_SHAPES[GEMMA]
    g = fam["gemma"]
    gemma = {
        "fused_decode": time_fused_decode(torch, g["dec"]),
        "sparse_prefill": time_sparse_prefill(torch, dev, g=1, n_kv=gh, d=gd,
                                              offsets=(CTX // 2,)),
        "centroid_scores_quantized": time_centroid_scores(torch, g["dec"], g["scored"]),
        "paged_attention": time_paged_attention(torch, g["dec"], g["att"]),
        "paged_identity": time_paged_identity(torch, g["ident"]),
        "flash_attention": time_flash_chunk(torch, dev, hq=gh, hkv=gh, d=gd),
    }
    qh, qg = FAMILY_SHAPES[QWEN32]
    qwen32 = {"sparse_prefill": time_sparse_prefill(torch, dev, g=qg, n_kv=qh,
                                                    offsets=(CTX // 2,)),
              "fused_decode": time_fused_decode(torch, fam["qwen32"]["dec"])}
    qwen15 = {"fused_decode": time_fused_decode(torch, fam["qwen15"]["dec"])}
    return {"gemma": gemma, "qwen32": qwen32, "qwen15": qwen15}


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------


def device_time_rows(torch, prof):
    """(device ms, launches, kernel name) per kernel of a closed
    torch.profiler session of device activity only, largest first (empty
    when it recorded no device time; ``profiled`` decides)."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / 1e3, ev.count, ev.key))
    return sorted(rows, reverse=True)


def profile_summary(torch, rows, wall_s: float):
    """Device time by kernel from a profiled run's rows: the top kernels and
    the device busy share of the profiled wall time (one stream, so kernel
    times do not overlap)."""
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


def make_engine(cfg, model, dev, req_ids, new_tokens, telemetry=None,
                prompts=None, backend=None, trace=None, mesh=None, **serve_kw):
    """An ``Engine`` over ``model`` with ``cfg`` (``backend`` in place of
    its registered backend), max_batch ``MAX_BATCH``, context CTX, chunks
    of CHUNK (``serve_kw`` overrides), temperature 0, ``trace`` and
    ``telemetry`` (by default following ``trace``) attached, on ``mesh``
    (None: one device), and requests ``req_ids`` of ``prompts`` (default:
    ``traffic``) submitted."""
    from repro_torch.config import ServeConfig
    from repro_torch.serving import Engine, Request

    use_config(model, cfg, backend)
    serve_cfg = ServeConfig(**{**dict(max_batch=MAX_BATCH, max_context=CTX,
                                      prefill_chunk=CHUNK, temperature=0.0),
                               **serve_kw})
    eng = Engine(cfg, model, serve_cfg, device=dev, telemetry=telemetry, trace=trace,
                 mesh=mesh)
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
        out = {}

        def serve_run():
            out["done"] = eng.run_until_done(max_ticks=2000, tick_callback=callback)

        prof = profiled(torch, serve_run, repeatable=False)
        done = out["done"]
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


def decode_timer(torch, busy=False):
    """-> (a ``decode_hook`` for ``LadderProbe``, the times it records by
    rung).  Each decode step's host time and the CUDA-event time from its
    start to its end on the stream (stream wall time: idle gaps between
    its kernels count); with ``busy``, its device-busy time instead:
    the summed times of the kernels it launched, from a ``torch.profiler``
    session around the step (synchronized on both sides)."""
    times = {}

    def hook(rung, call):
        if busy:
            res = {}
            # the step is idempotent for its (seq_len, tokens): after an
            # empty recording ``profiled`` serves the same step once more
            # and profiles that one (logged; a second empty one fails)
            rows = profiled(torch, lambda: res.update(out=call()))
            times.setdefault(rung, []).append(sum(r[0] for r in rows))
            return res["out"]
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
#: (8 rounds keep the whole script, phase 9 included, well inside its time
#: limit)
STEP_ROUNDS, STEP_WARMUP, STEP_ITERS = 8, 1, 2
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
    """Clones of every cache tensor a decode step writes (KV pages or ring
    buffers, store codes, recurrent states)."""
    from repro_torch.models.transformer import CARRIED
    from repro_torch.serving.graphs import _PLANTED

    out = {"seq_len": cache["seq_len"].clone()}
    for key in _PLANTED:
        if key in cache:
            out[key] = cache[key].clone()
    for l, e in enumerate(cache["layers"]):
        for name in ("k", "v", "codes") + CARRIED:
            if name in e:
                out[f"{name}[{l}]"] = e[name].clone()
    return out


def carried_state(cache):
    """-> a function that puts back the recurrent states a decode step
    advances from their own values (``models.transformer.CARRIED``) as they
    are now."""
    from repro_torch.models.transformer import CARRIED

    kept = [(t, t.clone()) for e in cache["layers"] for n, t in e.items() if n in CARRIED]

    def restore():
        for t, k in kept:
            t.copy_(k)

    return restore


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
    eagerly and through a ``DecodeGraph`` from the same state (the lengths
    and recurrent states put back; first call: warm-up, capture, replay;
    then one more replay), logits and every
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
        restore = carried_state(cache)
        want_logits = view.decode_step(cache, tokens)[0].clone()
        want = written_state(cache)
        graph = graphs[name] = DecodeGraph(view.decode_step, cache)
        for call in ("first call", "replay"):
            cache["seq_len"].copy_(lens)
            restore()
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
    for name, pair in fns.items():
        rec = out[name]
        for how, fn in pair.items():
            v = times[name][how]
            rec[how] = [min(v), statistics.median(v), max(v)]
            fn()
            rows = profiled(torch, lambda: [fn() for _ in range(5)])
            rec[f"busy_{how}"] = sum(r[0] for r in rows) / 5
            rec[f"kernels_{how}"] = sum(r[1] for r in rows) / 5
        book = {k: c["launches"] for k, c in graphs[name].step_counts.items()
                if c["launches"]}
        # a recording short of launches is retaken once: the profiler loses
        # a session's leading kernels in about 1% of sessions
        # (``tools/profiler_window.py``; here the replay's first layer, 4 of 5
        # of each kernel on qwen3-8b, seen twice on an H100), while a launch
        # the replay really misses is missing from every recording
        for attempt in (1, 2):
            seen = {}
            for _, n, key in profiled(torch, pair["graphed"]):
                seen[short(key)] = seen.get(short(key), 0) + n
            launches = {k: [seen.get(k, 0), sum(book.get(w, 0) for w in ws)]
                        for k, ws in DECODE_KERNELS.items()}
            log(f"phase 6 {label} {name}: one profiled replay (recording {attempt}), "
                f"launches by kernel [profiler, bookkeeping] {json.dumps(launches)}; "
                f"bookkeeping of one step {json.dumps(book)}; all kernels of the replay "
                f"{json.dumps(seen)}")
            if attempt == 2 or not (all(a <= b for a, b in launches.values())
                                    and any(a < b for a, b in launches.values())):
                break
            PROFILER["retried"] += 1
            PROFILER["retakes"].append({"session": PROFILER["sessions"], "kind": "short",
                                        "what": f"phase 6 {label} {name}",
                                        "launches": launches})
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


def shallow(model, cfg, n_layers):
    """(a view of ``model`` with its first ``n_layers`` layers, ``cfg`` cut
    to them): the same weight tensors, no copy."""
    from torch import nn

    sp = cfg.sparse
    cut = dataclasses.replace(cfg, n_layers=n_layers, sparse=dataclasses.replace(
        sp, block_sizes=None if sp.block_sizes is None else sp.block_sizes[:n_layers]))
    view = model.with_sparse(**dataclasses.asdict(cut.sparse))
    view._modules = dict(model._modules)
    view._modules["layers"] = nn.ModuleList(list(model.layers)[:n_layers])
    view.cfg = cut
    return view, cut


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
    phase_done("3")
    paths["ladder"] = serve_ladder(torch, *shallow(model, fused_cfg, LADDER_LAYERS), dev)
    phase_done("5")
    paths["step"] = compiled_step(torch, ARCH, step_variants(torch, model, cfgs, dev,
                                                             qwen=False), dev)
    phase_done(f"6 ({ARCH})")
    paths["tiered"] = serve_tiered(torch, model, fused_cfg, dev)
    paths["tiered"]["step"] = compiled_step(
        torch, f"{ARCH} tiered", mask_step_variants(torch, model, fused_cfg, dev), dev)
    phase_done("7")
    paths["traced"] = serve_traced(torch, model, fused_cfg, dev, paths["tiered"])
    phase_done("8")
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


TIER_POOLS = {"flat": dict(pool_pages=TIER_HBM + TIER_HOST),
              "tiered": dict(hbm_pages=TIER_HBM, host_pages=TIER_HOST)}


def tiered_run(torch, model, cfg, dev, name, pool, forced=None, storm=False,
               hook=None, trace=None, phase=7):
    """One run of phase 7 (and of phase 8b): requests ``LADDER_REQS`` x
    ``LADDER_NEW`` tokens on ``pool`` (``TIER_POOLS``), every prompt
    prefilled at once, one engine, ``trace`` attached; under
    ``default_storm()`` seed 7 with ``storm``; ``forced`` and ``hook`` as
    ``run_engine`` takes them.  Checks the audit, that nothing was lost and
    that every non-finite row is one the storm poisoned -> the run."""
    from repro_torch.resilience import FaultInjector, default_storm
    from repro_torch.serving.probe import TIER_COUNTERS

    vocab = cfg.vocab_size
    eng = make_engine(cfg, model, dev, LADDER_REQS, LADDER_NEW, prompts=traffic(vocab),
                      prefill_tokens_per_tick=TIER_PREFILL_BUDGET, trace=trace,
                      **TIER_POOLS[pool])
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
        fail(f"phase {phase} run {name}: page pool leaked pages")
    if any(not r.done for r in reqs):
        fail(f"phase {phase} run {name}: requests lost")
    if snap["sampler_anomalies"] != sum(poisoned):
        fail(f"phase {phase} run {name}: {snap['sampler_anomalies']} non-finite rows, "
             f"{sum(poisoned)} poisoned")
    log_serving(f"phase {phase} run {name}", run, snap)
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
        log(f"phase {phase} run {name}: pool {json.dumps(run['pool'])} (budget "
            f"{eng.pool.hbm_pages} + {eng.pool.host_pages}), max_live_seqs "
            f"{eng.pool.max_live_seqs}; {json.dumps(run['tier'])}; first decode tick "
            f"by request {json.dumps(first)}"
            + (f"; faults fired {json.dumps(run['fired'])}" if storm else ""))
        if run["pool"]["peak_hbm_pages"] > eng.pool.hbm_pages:
            fail(f"phase {phase} run {name}: {run['pool']['peak_hbm_pages']} pages "
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
    vocab = cfg.vocab_size

    def one_run(name, pool, **kw):
        return tiered_run(torch, model, cfg, dev, name, pool, **kw)

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
# phase 8: tracing, the serving launcher and its async front-end
# ---------------------------------------------------------------------------

#: phase 8a's arrival trace: (engine tick, prompt tokens) of each request,
#: and the new tokens of each
LAUNCH_ARRIVALS = ((0, 6000), (0, 3000), (2, 9000), (5, 2000), (9, 7000), (14, 4000))
LAUNCH_NEW = 16
#: what phase 8a's trace must hold: span types, counter tracks, instants
LAUNCH_TRACE = (("engine.tick", "engine.decode", "prefill.chunk", "seq.queued",
                 "seq.prefill", "seq.decode"), ("pool", "queue", "sparsity"),
                ("sched.admit", "prefix.match"))
#: ... and phase 8b's (the traced tiered run)
TIERED_TRACE = (("engine.tick", "engine.decode", "seq.decode", "seq.stall"),
                ("pool", "residency", "sparsity"), ("mem.demote", "mem.promote"))
#: phase 8c: rounds of the traced / untraced decode step in turns, and the
#: closed batches served on one engine with tracing on, off, on, off:
#: prompt lengths (numpy seeds 80-83) and new tokens
COST_ROUNDS, COST_PROMPTS, COST_NEW = 3, (4000, 4000), 16


def validate_trace(path, required, what):
    """``python -m repro_torch.obs.validate`` on ``path`` with ``required``
    (span types, counter tracks, instants), its output logged; fails the
    script unless the trace is valid."""
    from repro_torch.obs import validate

    argv = [str(path)]
    for flag, names in zip(("--require", "--counter", "--instant"), required):
        for n in names:
            argv += [flag, n]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = validate.main(argv)
    for line in buf.getvalue().splitlines():
        log(f"{what}: {line}")
    if rc:
        fail(f"{what}: the trace does not validate")


def serve_launcher(torch, dev, out):
    """Phase 8a: ``repro_torch.launch.serve.main`` at full llama3.2-3b width
    (its own weights, generator seed 0 on the card), the fused decode and
    sparse prefill, traced, requests arriving mid-flight through the async
    front-end (``LAUNCH_ARRIVALS``).  Every request must finish, the trace
    validate with ``LAUNCH_TRACE``, the run launch ``fused_decode``,
    ``sparse_prefill`` and (for the telemetry that follows the trace) the
    scoring kernel and nothing else; then the same requests are served by
    ``Engine.run_until_done`` on the same weights, each submitted once the
    engine has run its arrival tick (as the launcher's arrival loop submits it),
    and the front-end's streams must equal them at every position, with the
    same prefix-cache hits.  A drain with every request submitted at once
    is logged beside: its prefix hits, and so its chunk bounds and sums,
    differ."""
    import asyncio

    from repro_torch import kernels
    from repro_torch.launch import serve as launch
    from repro_torch.serving import Engine, Request, frontend

    arrivals, trace, metrics = (out / n for n in (
        "arrivals.json", "trace.json", "metrics.jsonl"))
    arrivals.write_text(json.dumps([{"tick": t, "prompt_tokens": n}
                                    for t, n in LAUNCH_ARRIVALS]))
    argv = ["--arch", ARCH, "--fused-decode", "--sparse-prefill",
            "--max-context", str(CTX), "--max-batch", str(MAX_BATCH),
            "--prefill-chunk", str(CHUNK), "--new-tokens", str(LAUNCH_NEW),
            "--prefix-groups", "2", "--prefix-len", "128", "--slo-class", "mixed",
            "--trace", str(trace), "--metrics-interval", "8",
            "--metrics-out", str(metrics), "--arrival-trace", str(arrivals)]
    log(f"phase 8a: python -m repro_torch.launch.serve {' '.join(argv)}")
    streams = []
    submit = frontend.AsyncFrontend.submit

    def recording(self, req):
        streams.append(submit(self, req))
        return streams[-1]

    buf = io.StringIO()
    frontend.AsyncFrontend.submit = recording
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            eng = launch.main(argv)
        torch.cuda.synchronize()
    finally:
        frontend.AsyncFrontend.submit = submit
        for line in buf.getvalue().splitlines():
            log(f"phase 8a launcher: {line}")
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    done = sorted(eng.finished, key=lambda r: r.req_id)
    if len(done) != len(LAUNCH_ARRIVALS) or any(
            r.status != "ok" or len(r.output) != LAUNCH_NEW for r in done):
        fail(f"phase 8a: {len(done)} of {len(LAUNCH_ARRIVALS)} requests finished "
             f"with {LAUNCH_NEW} tokens")
    validate_trace(trace, LAUNCH_TRACE, "phase 8a")
    expect_path("phase 8a launcher", counts,
                {"fused_decode", "sparse_prefill", "centroid_scores_quantized"})
    got = {s.req.req_id: asyncio.run(s.collect()) for s in streams}
    snaps = metrics.read_text().splitlines()
    snap = eng.metrics.snapshot()
    res = {"wall_s": wall, "ticks": snap["ticks"], "ttft_p50": snap["ttft_p50"],
           "tpot_p50": snap["tpot_p50"], "prefix_hit_tokens": snap["prefix_hit_tokens"],
           "events": len(eng.trace), "dropped": eng.trace.dropped,
           "metrics_lines": len(snaps),
           "launches": {n: c["launches"] for n, c in counts.items() if c["launches"]}}
    model, cfg, serve_cfg = eng.model, eng.cfg, eng.serve
    hits = {r.req_id: eng.metrics.requests[r.req_id].prefix_hit_tokens for r in done}
    specs = [(r.req_id, r.prompt, r.max_new_tokens, r.slo_class, r.deadline_s)
             for r in done]
    del eng, done
    gc.collect()

    def drain(at_arrival):
        """``run_until_done`` of a fresh engine on the launcher's weights
        over the same requests: each submitted once the engine has run its
        arrival tick's ticks (as the launcher's arrival loop submits it), or all
        up front -> (streams, prefix-hit tokens by request, TPOT p50)."""
        eng = Engine(cfg, model, serve_cfg, device=model.device)
        due = {rid: LAUNCH_ARRIVALS[rid][0] if at_arrival else 0 for rid, *_ in specs}
        pending = sorted((Request(rid, p, max_new_tokens=n, slo_class=c, deadline_s=d)
                          for rid, p, n, c, d in specs), key=lambda r: due[r.req_id])
        reqs = list(pending)

        def submit_due(engine, tick):
            while pending and due[pending[0].req_id] <= engine.metrics.ticks:
                engine.submit(pending.pop(0))

        submit_due(eng, 0)
        while True:
            eng.run_until_done(max_ticks=5000, tick_callback=submit_due)
            if not pending:
                break
            eng.submit(pending.pop(0))     # idle before the next arrival
        out = ({r.req_id: list(r.output) for r in reqs},
               {r.req_id: eng.metrics.requests[r.req_id].prefix_hit_tokens
                for r in reqs}, eng.metrics.snapshot()["tpot_p50"])
        del eng
        gc.collect()
        return out

    def differ(streams):
        return [(rid, i) for rid, toks in streams.items()
                for i in range(max(len(toks), len(got[rid])))
                if toks[i:i + 1] != got[rid][i:i + 1]]

    n_pos = sum(len(t) for t in got.values())
    streams, drain_hits, res["drain_tpot_p50"] = drain(True)
    diff = differ(streams)
    res["streams_equal_drain"] = f"{n_pos - len(diff)} of {n_pos}"
    # the same requests all submitted at once: other prefix-cache hits and
    # chunk bounds, so other floating-point sums (logged, not a gate)
    streams, once_hits, _ = drain(False)
    res["all_at_once_equal"] = f"{n_pos - len(differ(streams))} of {n_pos}"
    res["prefix_hit_tokens_by_request"] = {
        "front_end": hits, "drain": drain_hits, "all_at_once": once_hits}
    log(f"phase 8a: {json.dumps(res)}")
    if diff or drain_hits != hits:
        fail(f"phase 8a: the front-end's streams differ from run_until_done's at "
             f"(request, position) {diff[:6]}, prefix hits {hits} against {drain_hits}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def traced_tiered(torch, model, cfg, dev, tiered, out):
    """Phase 8b: phase 7's run T again with a ``TraceRecorder`` attached
    (telemetry follows it, on its own decode-graph variant): its tokens must
    equal the untraced T's at every position and the trace validate with
    ``TIERED_TRACE`` (the forced miss's ``seq.stall``, the migrations)."""
    from repro_torch.obs import TraceRecorder

    rec, miss = TraceRecorder(), {}
    run = tiered_run(torch, model, cfg, dev, "T traced", "tiered",
                     hook=force_miss(torch, miss, tiered["F"]), trace=rec, phase="8b")
    path = out / "tiered_trace.json"
    rec.dump(str(path))
    events, dropped = len(rec), rec.dropped
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    t = tiered["T"]
    same = sum(int(run["tokens"].get(k) == v) for k, v in t["tokens"].items())
    bitwise = sum(int(torch.equal(run["logits"][k], v)) for k, v in t["logits"].items()
                  if k in run["logits"])
    res = {"tokens_equal": f"{same} of {len(t['tokens'])}",
           "logits_bitwise": f"{bitwise} of {len(t['logits'])}",
           "events": events, "dropped": dropped, "stalls": run["snap"]["stalls"],
           "tier": run["tier"], "wall_s": run["wall"],
           "tpot_p50": run["snap"]["tpot_p50"], "untraced_tpot_p50": t["snap"]["tpot_p50"]}
    log(f"phase 8b: {json.dumps(res)}")
    if run["tokens"] != t["tokens"]:
        fail(f"phase 8b: the traced tiered run's tokens differ from run T's "
             f"({same} of {len(t['tokens'])} equal)")
    expect_path("phase 8b", run["counts"],
                {"fused_decode", "sparse_prefill", "centroid_scores_quantized"})
    validate_trace(path, TIERED_TRACE, "phase 8b")
    return res


def tracing_cost(torch, model, cfg, dev):
    """Phase 8c, numbers only: the graphed fused decode step on phase 6's
    inputs untraced and traced (the telemetry variant), device time and
    CUDA events in turns over ``COST_ROUNDS`` rounds; then closed batches on
    one engine with ``set_tracing`` on, off, on, off (the first two capture
    their variant of the decode step, the last two replay it): wall, TTFT /
    TPOT p50 of the batch, events recorded and dropped, and each
    decode-graph variant's replays."""
    import statistics

    import numpy as np

    from repro_torch.obs import TraceRecorder, validate_chrome_trace
    from repro_torch.serving import DecodeGraph, Request

    view = model.with_sparse(**dataclasses.asdict(cfg.sparse))
    untraced = random_cache(torch, view, CTX, dev)
    caches = {"untraced": untraced, "traced": dict(untraced, _telemetry=torch.zeros(
        (model.cfg.n_layers, MAX_BATCH, 4), dtype=torch.int32, device=dev))}
    lens, tokens = step_lens(torch, CTX, dev), torch.arange(MAX_BATCH, device=dev)
    graphs = {n: DecodeGraph(view.decode_step, c) for n, c in caches.items()}

    def step(name):
        def fn():
            caches[name]["seq_len"].copy_(lens)
            graphs[name](caches[name], tokens)
        return fn

    fns = {n: step(n) for n in graphs}
    for fn in fns.values():
        fn()
    busy = device_rounds(torch, fns, 10, COST_ROUNDS)
    events = {n: [] for n in fns}
    for _ in range(COST_ROUNDS):
        for n, fn in fns.items():
            events[n].append(cuda_time_ms(torch, fn, 1, 5))
    res = {"step_device_ms": {n: v[1] for n, v in busy.items()},
           "step_event_ms": events,
           "step_event_median_ms": {n: statistics.median(v) for n, v in events.items()}}
    del graphs, fns, caches, untraced
    gc.collect()
    torch.cuda.empty_cache()

    eng = make_engine(cfg, model, dev, (), COST_NEW)
    rec = TraceRecorder()
    batches = []
    for i, attach in enumerate((rec, None, rec, None)):
        eng.set_tracing(attach)
        n_variants = len(eng._graph_variants)
        rng = np.random.default_rng(80 + i)
        ids = [100 + 10 * i + j for j in range(len(COST_PROMPTS))]
        for rid, n in zip(ids, COST_PROMPTS):
            eng.submit(Request(rid, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                               max_new_tokens=COST_NEW))
        n0 = len(rec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_until_done(max_ticks=2000)
        torch.cuda.synchronize()
        if sorted(r.req_id for r in done) != ids or any(
                len(r.output) != COST_NEW for r in done):
            fail(f"phase 8c: batch {i} did not finish")
        m = [eng.metrics.requests[r] for r in ids]
        batches.append({"tracing": attach is not None,
                        "captured": len(eng._graph_variants) > n_variants,
                        "wall_s": time.perf_counter() - t0,
                        "ttft_p50": statistics.median(r.ttft for r in m),
                        "tpot_p50_ms": statistics.median(r.tpot for r in m) * 1e3,
                        "events": len(rec) - n0, "dropped": rec.dropped})
    res["batches"] = batches
    res["graph_replays"] = {f"rung {r}, telemetry {'on' if t else 'off'}": g.replays
                            for (r, t), g in eng._graph_variants.items()}
    trace = rec.to_chrome()
    res["exported_events"] = len(trace["traceEvents"])
    errors = validate_chrome_trace(trace, LAUNCH_TRACE[0], ("pool", "queue", "sparsity"))
    del eng, rec, trace
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 8c: {json.dumps(res)}")
    if errors:
        fail(f"phase 8c: the toggled engine's trace does not validate: {errors[:3]}")
    return res


def serve_traced(torch, model, cfg, dev, tiered):
    """Phase 8 (after phase 7, on phase 3's weights and fused main path)."""
    out = ROOT / "chiprun_out" / "phase8"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res = {"launcher": serve_launcher(torch, dev, out)}
    res["tiered"] = traced_tiered(torch, model, cfg, dev, tiered, out)
    res["cost"] = tracing_cost(torch, *shallow(model, cfg, COST_LAYERS), dev)
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 8 took {res['seconds']:.1f}s")
    return res


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

    base = dataclasses.replace(get_config(QWEN), n_layers=QWEN_LAYERS)
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


def agree_logits(torch, what, lk, lp, vocab, reqs, floor=LOGIT_COS, fatal=True,
                 other="plain"):
    """The ``other`` run's logits ``lp`` (by default the plain run's)
    against the kernel run's ``lk`` at the same (request, position) keys:
    all finite, of the vocabulary's size, at a cosine of at least
    ``floor`` (not ``fatal``: logged, the caller decides) -> (the least
    cosine, greedy tokens equal, steps)."""
    if not set(lp) <= set(lk):
        fail(f"{what}: the plain run sampled at steps the kernel run did not")
    for key, lg in (*((k, lk[k]) for k in lp), *lp.items()):
        if lg.shape != (vocab,) or not bool(torch.isfinite(lg).all()):
            fail(f"{what} logits at {key} of shape {tuple(lg.shape)} are not finite")
    worst = min(float(torch.nn.functional.cosine_similarity(lk[k], lp[k], dim=0))
                for k in lp)
    same = sum(int(lk[k].argmax() == lp[k].argmax()) for k in lp)
    log(f"{what} kernels vs {other}: requests {tuple(reqs)}, fed the kernel run's "
        f"tokens: min logit cosine {worst:.6f} (>= {floor}) over {len(lp)} steps, "
        f"greedy tokens equal at {same} of {len(lp)}")
    if fatal and not worst >= floor:
        fail(f"{what}: kernel and plain logits drift apart: cosine {worst}")
    return worst, same, len(lp)


def serve_qwen(torch, dev):
    """Phase 3b: qwen3-8b at full width (``QWEN_LAYERS`` of its 36 layers,
    bf16, random weights from ``torch.Generator`` seed 0) served through
    ``Engine`` in runs Q1-Q5
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
        f"GB), untied head, {model.cfg.n_layers} of its 36 layers (a depth cut: "
        f"phase 9 serves its layer shapes in llama3.1-8b), init "
        f"{time.perf_counter() - t0:.1f}s")
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
        agree_logits(torch, f"{QWEN} {name}", runs[name]["logits"], run["logits"],
                     vocab, reqs)
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
# phase 9: the dense family at full width
# ---------------------------------------------------------------------------

#: phase 9's traffic (``traffic``'s prompts): requests 0, 1 and 3 (9000,
#: 6500 and 4000 tokens, 0 and 1 sharing the 2048-token prefix), 16 new
#: tokens each; qwen3-32b serves requests 1 and 2 (6500 and 12000 tokens)
#: at max_batch 2, a reduced batch on one card, and its plain and control
#: runs request 1 alone at max_batch 1
FAMILY_REQS, FAMILY_NEW = (0, 1, 3), 16
#: phase 9's models and phase 11's musicgen run their first layers only
#: (full width, cut in depth to keep the whole script inside its time
#: limit with phases 10a and 12; every gate as before): llama3.1-8b 8 of
#: 32, qwen1.5-4b 10 of 40, gemma-7b 7 of 28, qwen3-32b 16 of 64,
#: musicgen-large 24 of 48
FAMILY_LAYERS = {"llama3.1-8b": 8, "qwen1.5-4b": 10, "gemma-7b": 7, "qwen3-32b": 16,
                 "musicgen-large": 24}
QWEN32_REQS, QWEN32_PLAIN_REQS, QWEN32_BATCH = (1, 2), (1,), 2
#: the S runs' gate: ``1 - c_plain <= max(S_GATE_FLOOR, S_GATE_RATIO *
#: (1 - c_ctrl))`` with both cosines at least ``S_MIN_COS``, where c_plain
#: is the plain run's least logit cosine to the kernel run and c_ctrl the
#: control run's (the kernel with one split a call)
S_GATE_FLOOR, S_GATE_RATIO, S_MIN_COS = 5e-4, 2.0, 0.999
#: the end-to-end gate phase 10a had before its per-call oracle (kept and
#: tested, called by no phase: it passed a faulty pass on the card):
#: ``1 - c_plain <= max(NOISE_GATE_FLOOR, NOISE_GATE_RATIO * (1 -
#: c_noise))`` with ``c_plain >= NOISE_MIN_PLAIN`` and ``c_noise >=
#: NOISE_MIN_NOISE``, where c_noise is the least logit cosine to the kernel
#: run of a noise control (the kernel run with a seeded 1% of every
#: attention output moved by one bf16 step)
NOISE_GATE_FLOOR, NOISE_GATE_RATIO, NOISE_MIN_PLAIN, NOISE_MIN_NOISE = 5e-4, 2.0, 0.998, 0.995


def family_runs(arch):
    """Phase 9's runs of ``arch`` at full width, at full depth or the depth
    ``FAMILY_LAYERS`` cuts it to: name -> (config, kernels the run must
    launch).  D is the repo's default configuration
    (``"cuda"``, fused decode, dense chunked prefill through
    ``flash_attention``), S the sparse main path (``sparse_prefill`` and
    the fused decode), G (gemma-7b only) the staged rung (scoring kernel,
    top-K, ``paged_attention``).  T = BUDGET, INT4-asym quest store, block
    sizes ``(16, 32, 64)[(layer + head) % 3]``."""
    from repro_torch.configs import get_config

    base = get_config(arch)
    if arch in FAMILY_LAYERS:
        base = dataclasses.replace(base, n_layers=FAMILY_LAYERS[arch])
    pattern = tuple(
        tuple((16, 32, 64)[(l + h) % 3] for h in range(base.n_kv_heads))
        for l in range(base.n_layers))
    d = dataclasses.replace(base, sparse=dataclasses.replace(
        base.sparse, backend="cuda", fused_decode=True, quant="int4_asym",
        block_sizes=pattern, token_budget=BUDGET))
    runs = {"D": (d, {"flash_attention", "fused_decode"}),
            "S": (dataclasses.replace(d, sparse=dataclasses.replace(
                d.sparse, sparse_prefill=True)), {"sparse_prefill", "fused_decode"})}
    if arch == GEMMA:
        runs["G"] = (dataclasses.replace(d, sparse=dataclasses.replace(
            d.sparse, fused_decode=False)),
            {"flash_attention", "centroid_scores_quantized", "paged_attention"})
    return runs


def hold_prefill_call(torch, args, kw, kernel):
    """Hold one sparse prefill call's kernel outputs ``kernel`` = (out,
    n_attended, selected) against the plain version (``sparse_prefill_ref``
    with its extras) on the wrapper's own inputs ``args`` / ``kw``, under
    ``parity``'s rules: ``n_attended`` equal, a block chosen by one version
    only a scored candidate within ``TIE_RTOL`` of its cell's K-th score,
    every output row of the other cells within one bf16 step and 1e-2
    relative L2 -> ({"cells", "tie_cells", "ties", "max_abs_err",
    "max_rel_l2", "tol_use"}, the plain (out, n_attended, selected));
    raises ``AssertionError`` otherwise."""
    from repro_torch.kernels import parity, ref

    q6, rq6, kp, vp, codes, scale, zero, la, k_sel, n_valid, qb0 = args
    out_k, att_k, sel_k = kernel
    rows = ref.dequant_score_rows(codes, scale, zero, kw["bits"], kw["symmetric"])
    out, n_att, extra = ref.sparse_prefill_ref(
        q6, rq6, kp, vp, rows, la, k_sel, n_valid, int(qb0), kw["block_q"],
        kw["sink_pages"], kw["local_pages"], extras=True)
    sel = extra["selected"]
    assert torch.equal(att_k, n_att), "sparse_prefill: n_attended differs"
    ties = parity.check_prefill_ties(sel_k ^ sel, extra, k_sel)
    keep = (~ties)[..., None, None].expand(out.shape[:-1])
    err, rel, use = parity.check_outputs(out_k, out, keep, "sparse_prefill while serving")
    return ({"cells": ties.numel(), "tie_cells": int(ties.sum()), "ties": ties,
             "max_abs_err": err, "max_rel_l2": rel, "tol_use": use}, (out, n_att, sel))


@contextlib.contextmanager
def prefill_selections(mode, record, stats=None):
    """Within, every sparse prefill call made inside
    ``Transformer.prefill_chunk`` is keyed by its chunk (a hash of the
    chunk's tokens, its offset and length) and its place among the chunk's
    calls (the layer), and its selected blocks ``[B, n_kv, nQB, M]`` are
    stored in ``record`` under that key.

    - ``"kernel"``: the kernel call also returns its selection (it writes
      it beside its outputs); nothing else runs, so the run's times are
      serving times.
    - ``"control"``: the same, with the kernel's split count forced to 1
      on every call (the same kernel; only its split-combine order
      differs from the planned count's).
    - ``"plain"``: every plain call scores and selects on its own inputs
      (``sparse_prefill_ref`` with its extras), and the kernel is launched
      on those same inputs (a comparison launch, taken off its count).
      The two are held under ``parity``'s rules: ``n_attended`` equal, a
      block chosen by one version only a scored candidate within
      ``TIE_RTOL`` of its cell's K-th score, every output row of the
      other cells within one bf16 step and 1e-2 relative L2.  The call
      then attends the kernel's blocks in those near-tie cells and its own
      everywhere else.  ``stats`` counts the calls held, their cells and
      their near-tie cells."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.kernels import parity, ref
    from repro_torch.kernels import sparse_prefill as sp
    from repro_torch.models import Transformer

    cur = {"key": None, "layer": 0}
    orig_chunk, orig_kernel, orig_plain = (
        Transformer.prefill_chunk, sp.sparse_prefill, sp.sparse_prefill_plain)

    def keyed(self, cache, slot, tokens, offset, n_valid):
        digest = hashlib.sha1(np.asarray(tokens[:n_valid]).tobytes()).hexdigest()
        cur.update(key=(digest, int(offset), int(n_valid)), layer=0)
        try:
            return orig_chunk(self, cache, slot, tokens, offset, n_valid)
        finally:
            cur["key"] = None

    def next_key():
        if cur["key"] is None:
            fail("a sparse prefill call outside a prefill chunk")
        cur["layer"] += 1
        return cur["key"] + (cur["layer"] - 1,)

    def recording(*args, return_selected=False, **kw):
        if mode == "control":
            kw["n_split"] = 1
        out, n_att, sel = orig_kernel(*args, return_selected=True, **kw)
        record[next_key()] = sel
        return (out, n_att, sel) if return_selected else (out, n_att)

    def held(q6, rq6, kp, vp, codes, scale, zero, la, k_sel, n_valid, qb0, *, bits,
             symmetric, block_q, sink_pages, local_pages, return_selected=False):
        key = next_key()
        sp.plain_calls += 1
        args = (q6, rq6, kp, vp, codes, scale, zero, la, k_sel, n_valid, qb0)
        kw = dict(bits=bits, symmetric=symmetric, block_q=block_q,
                  sink_pages=sink_pages, local_pages=local_pages)
        launched = sp.launches
        out_k, att_k, sel_k = orig_kernel(*args, return_selected=True, **kw)
        sp.launches = launched          # a comparison launch, not the run's path
        try:
            res, (out, n_att, sel) = hold_prefill_call(torch, args, kw,
                                                       (out_k, att_k, sel_k))
        except AssertionError as e:
            fail(f"{key}: {e}")
        stats["calls"] += 1
        stats["cells"] += res["cells"]
        stats["tie_cells"] += res["tie_cells"]
        if res["tie_cells"]:
            ties = res["ties"]
            sel = torch.where(ties[..., None], sel_k, sel)
            out = ref.prefill_attention_ref(q6, kp, vp, sel, la, n_valid, int(qb0),
                                            block_q)[0]
        record[key] = sel
        return (out, n_att, sel) if return_selected else (out, n_att)

    Transformer.prefill_chunk = keyed
    if mode == "plain":
        sp.sparse_prefill_plain = held
    else:
        sp.sparse_prefill = recording
    try:
        yield
    finally:
        Transformer.prefill_chunk = orig_chunk
        sp.sparse_prefill, sp.sparse_prefill_plain = orig_kernel, orig_plain


def selection_drift(what, ref_sel, other):
    """The share of (sequence, kv head, query block) cells, by layer, whose
    selection in ``other`` differs from the kernel run's (``ref_sel``) at
    the same call -> [share of layer 0, 1, ...]."""
    moved, cells = {}, {}
    for key, sel in other.items():
        if key not in ref_sel:
            fail(f"{what}: sparse prefill call {key} is not one of the kernel run's")
        layer = key[-1]
        moved[layer] = moved.get(layer, 0) + int((ref_sel[key] ^ sel).any(-1).sum())
        cells[layer] = cells.get(layer, 0) + sel[..., 0].numel()
    return [moved[l] / cells[l] for l in sorted(cells)]


#: phase 10a's power checks: the layer whose kernel calls are faulted (a
#: copy of each output, held as the clean one is; the run keeps the
#: clean output), the bf16 steps the flash fault moves an element by and
#: the share of elements it moves
ORACLE_FAULT_LAYER, FLASH_FAULT_STEPS, FLASH_FAULT_SHARE = 16, 4, 0.01
#: the kernels phase 10a holds call by call
ORACLE_KERNELS = ("flash_attention", "sparse_prefill", "fused_decode")


def oracle_stats():
    """Per kernel: calls held, calls flagged (clean calls whose kernel
    output broke a rule), near ties, largest element and row errors; per
    fault: calls faulted, those the rules flagged, and each faulted call's
    change and clean difference over its live (sequence, kv head) rows."""
    return {"calls": {k: {"held": 0, "flagged": [], "near_ties": 0, "max_abs_err": 0.0,
                          "max_rel_l2": 0.0, "tol_use": 0.0} for k in ORACLE_KERNELS},
            "faults": {"fused_decode": {"calls": 0, "flagged": 0, "missed": [],
                                        "change": [], "clean": [], "swapped": [],
                                        "unfaultable": []},
                       "flash_attention": {"calls": 0, "flagged": 0, "missed": [],
                                           "change": [], "clean": []}}}


def kv_rows_rel(torch, a, b, n_kv, live=None):
    """Relative L2 distance of ``a`` from ``b`` per (sequence, kv head):
    each kv head's query heads flattened into one row (decode ``[B, Hq,
    D]``, flash ``[B, Hq, S, D]``), sequences where ``live`` holds ->
    list."""
    a, b = a.float(), b.float()
    a, b = a.reshape(a.shape[0], n_kv, -1), b.reshape(b.shape[0], n_kv, -1)
    rel = (a - b).norm(dim=-1) / b.norm(dim=-1).clamp(min=1e-30)
    if live is not None:
        rel = rel[live]
    return rel.flatten().tolist()


def median_max(vals):
    v = sorted(vals)
    return [v[len(v) // 2], v[-1]] if v else [0.0, 0.0]


def decode_fault(torch, args, kw, kernel, plain):
    """Power check 1 on one fused decode call: in a copy of the kernel's
    page table, one selected page per (sequence, kv head) — the first page
    of its lowest-scored selected block, a forced one only when no other
    is selected — is swapped for the first page of the live block with the
    lowest score that the plain selection did not choose (none: the row
    keeps its table); the output is recomputed over the faulted table
    (the plain paged attention) -> ((out, table, valid), rows swapped [B,
    H] bool)."""
    from repro_torch.core.selection import NEG_INF, POS_INF, mask_and_pin_scores
    from repro_torch.kernels import paged_attention, parity

    q, rq, kp, vp, codes, scale, zero, la, seq_len = args
    out_k, tbl_k, vld = kernel
    _, tbl_p, _ = plain
    s = parity.decode_block_scores(rq, codes, scale, zero, la, kw["bits"],
                                   kw["symmetric"])
    m = mask_and_pin_scores(s, la, seq_len, kw["sink_pages"], kw["local_pages"])
    B, H, M = m.shape
    ppb = la.pages_per_block.long()[None, :, None]

    def chosen(tbl):
        blk = torch.where(vld, tbl.long() // ppb, M).clamp(max=M)
        sel = torch.zeros((B, H, M + 1), dtype=torch.bool, device=m.device)
        return sel.scatter(-1, blk, True)[..., :M]

    live = m > NEG_INF / 2
    cand = torch.where(live & (m < POS_INF / 2) & ~chosen(tbl_p), m, float("inf"))
    new_blk = cand.argmin(-1)                                  # [B, H]
    ok = torch.isfinite(cand.min(-1).values)
    # the kernel's lowest-scored selected block (a forced one when no other)
    old_blk = torch.where(live & chosen(tbl_k), m, float("inf")).argmin(-1)
    slot_blk = torch.where(vld, tbl_k.long() // ppb, -1)
    first = (slot_blk == old_blk[..., None]).long().argmax(-1)  # its first slot
    tbl_f = tbl_k.clone()
    new_page = (new_blk * la.pages_per_block.long()[None, :]).to(tbl_f.dtype)
    cur = tbl_f.gather(-1, first[..., None])[..., 0]
    tbl_f.scatter_(-1, first[..., None], torch.where(ok, new_page, cur)[..., None])
    out_f = paged_attention.paged_attention_plain(q, kp, vp, tbl_f, vld, seq_len,
                                                  la.page_size)
    return (out_f, tbl_f, vld), ok


def flash_fault(torch, out, seed):
    """Power check 2 on one flash call: a copy of its output with a seeded
    ``FLASH_FAULT_SHARE`` of the elements moved away from zero by
    ``FLASH_FAULT_STEPS`` bf16 steps (``torch.Generator`` ``seed``, on the
    CPU)."""
    gen = torch.Generator().manual_seed(seed)
    pick = (torch.rand(out.shape, generator=gen) < FLASH_FAULT_SHARE).to(out.device)
    x = out.float()
    step = torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126))) - 7)
    moved = x + torch.sign(x) * FLASH_FAULT_STEPS * step
    return torch.where(pick, moved, x).to(out.dtype)


@contextlib.contextmanager
def call_oracle(stats, fault_layer=None):
    """Phase 10a's per-call oracle.  Within, every ``flash_attention``,
    ``sparse_prefill`` and ``fused_decode`` kernel call of
    ``Transformer.prefill_chunk`` / ``decode_step`` also runs its plain
    version on the same inputs, and the two are held under
    ``kernels.parity``'s rules (``hold_flash_attention``,
    ``hold_prefill_call``, ``hold_fused_decode``); the call returns the
    kernel's outputs, so the run's tokens are the kernels'.  Calls are
    keyed as ``prefill_selections`` keys them: the chunk (its tokens'
    hash, offset, length) or the decode step (its index), then the layer.
    A clean call that breaks a rule is recorded under ``stats["calls"][k]
    ["flagged"]``.  On ``fault_layer``'s calls the comparator runs a
    second time on a faulted copy of the kernel's output
    (``decode_fault``, ``flash_fault``), which must be flagged; its change
    and the clean difference are logged per call over the live (sequence,
    kv head) rows.  The comparison's own work (plain calls, the faulted
    copy's paged attention) is taken off the kernels' counts."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import parity
    from repro_torch.kernels import sparse_prefill as sp
    from repro_torch.models import Transformer

    cur = {"key": None, "layer": 0, "step": 0}
    saved = (Transformer.prefill_chunk, Transformer.decode_step, fd.fused_decode,
             fa.flash_attention, sp.sparse_prefill)
    orig_chunk, orig_step, orig_fd, orig_fa, orig_sp = saved

    def keyed_chunk(self, cache, slot, tokens, offset, n_valid):
        digest = hashlib.sha1(np.asarray(tokens[:n_valid]).tobytes()).hexdigest()
        cur.update(key=("chunk", digest[:12], int(offset), int(n_valid)), layer=0)
        try:
            return orig_chunk(self, cache, slot, tokens, offset, n_valid)
        finally:
            cur["key"] = None

    def keyed_step(self, cache, tokens):
        cur.update(key=("decode", cur["step"]), layer=0)
        cur["step"] += 1
        try:
            return orig_step(self, cache, tokens)
        finally:
            cur["key"] = None

    def next_key():
        if cur["key"] is None:
            fail("a kernel call outside a prefill chunk or a decode step")
        cur["layer"] += 1
        return cur["key"] + (cur["layer"] - 1,)

    def record(name, key, res):
        st = stats["calls"][name]
        st["held"] += 1
        st["near_ties"] += res.get("near_ties", res.get("tie_cells", 0))
        for f in ("max_abs_err", "max_rel_l2", "tol_use"):
            st[f] = max(st[f], res[f])

    def hold(name, key, fn):
        try:
            record(name, key, fn())
            return True
        except AssertionError as e:
            stats["calls"][name]["flagged"].append(f"{key}: {e}")
            return False

    def faulted(name, key, fn, change, clean):
        st = stats["faults"][name]
        st["calls"] += 1
        try:
            fn()
            st["missed"].append(str(key))
        except AssertionError:
            st["flagged"] += 1
        st["change"].append(median_max(change))
        st["clean"].append(median_max(clean))

    def oracle_fd(q, rq, kp, vp, codes, scale, zero, la, seq_len, *, bits, symmetric,
                  sink_pages, local_pages, n_split=None):
        key = next_key()
        args = (q, rq, kp, vp, codes, scale, zero, la, seq_len)
        kw = dict(bits=bits, symmetric=symmetric, sink_pages=sink_pages,
                  local_pages=local_pages)
        kernel = orig_fd(*args, n_split=n_split, **kw)
        counts = kernels.counts()
        plain = fd.fused_decode_plain(*args, **kw)

        def held(out):
            return lambda: parity.hold_fused_decode(
                q, rq, codes, scale, zero, la, bits, symmetric, sink_pages,
                local_pages, seq_len, out, plain)

        hold("fused_decode", key, held(kernel))
        if key[-1] == fault_layer:
            bad, swapped = decode_fault(torch, args, kw, kernel, plain)
            if bool(swapped.any()):
                live = seq_len > 1
                n_kv = kp.shape[1]
                faulted("fused_decode", key, held(bad),
                        kv_rows_rel(torch, bad[0], kernel[0], n_kv, live),
                        kv_rows_rel(torch, kernel[0], plain[0], n_kv, live))
                stats["faults"]["fused_decode"]["swapped"].append(int(swapped.sum()))
            else:
                # every live block of every live row selected: no page to swap
                stats["faults"]["fused_decode"]["unfaultable"].append(str(key))
        kernels.reset_counts()
        kernels.add_counts(counts)
        return kernel

    def oracle_fa(q, k, v, causal=True, q_offset=0, k_len=None):
        key = next_key()
        out = orig_fa(q, k, v, causal, q_offset, k_len)
        counts = kernels.counts()
        plain = fa.flash_attention_plain(q, k, v, causal, q_offset, k_len)
        hold("flash_attention", key, lambda: parity.hold_flash_attention(out, plain))
        if key[-1] == fault_layer:
            bad = flash_fault(torch, out, seed=len(stats["faults"]["flash_attention"]
                                                   ["change"]))
            n_kv = k.shape[1]
            faulted("flash_attention", key, lambda: parity.hold_flash_attention(bad, plain),
                    kv_rows_rel(torch, bad, out, n_kv), kv_rows_rel(torch, out, plain, n_kv))
        kernels.reset_counts()
        kernels.add_counts(counts)
        return out

    def oracle_sp(*args, return_selected=False, n_split=None, **kw):
        key = next_key()
        out_k, att_k, sel_k = orig_sp(*args, return_selected=True, n_split=n_split, **kw)
        counts = kernels.counts()
        hold("sparse_prefill", key,
             lambda: hold_prefill_call(torch, args, kw, (out_k, att_k, sel_k))[0])
        kernels.reset_counts()
        kernels.add_counts(counts)
        return (out_k, att_k, sel_k) if return_selected else (out_k, att_k)

    Transformer.prefill_chunk, Transformer.decode_step = keyed_chunk, keyed_step
    fd.fused_decode, fa.flash_attention, sp.sparse_prefill = oracle_fd, oracle_fa, oracle_sp
    try:
        yield
    finally:
        (Transformer.prefill_chunk, Transformer.decode_step, fd.fused_decode,
         fa.flash_attention, sp.sparse_prefill) = saved


def oracle_misses(what, stats, launched, fault_layer, n_layers):
    """What phase 10a's oracle found wrong in one run -> list: a clean call
    flagged, a faulted call held, a kernel launched more or fewer times
    than its calls were held (``launched``: the run's launches), a
    fault-layer call that was not faulted."""
    out = []
    for name, st in stats["calls"].items():
        if st["flagged"]:
            out.append(f"{what}: {len(st['flagged'])} clean {name} calls flagged, "
                       f"first {st['flagged'][0]}")
        if st["held"] != launched.get(name, 0):
            out.append(f"{what}: {st['held']} {name} calls held of "
                       f"{launched.get(name, 0)} launched")
    for name, f in stats["faults"].items():
        held = stats["calls"][name]["held"]
        if f["missed"]:
            out.append(f"{what}: the {name} fault was held at {f['missed'][:3]}")
        unfaultable = len(f.get("unfaultable", ()))
        if held and (f["calls"] + unfaultable != held // n_layers or not f["calls"]):
            out.append(f"{what}: {f['calls']} {name} calls faulted at layer "
                       f"{fault_layer} (and {unfaultable} with no page to swap) of "
                       f"{held // n_layers}")
    return out


def s_gate(what, c_plain, c_ctrl):
    """Tentpole gate of an S run -> (passed, the limit on 1 - c_plain)."""
    limit = max(S_GATE_FLOOR, S_GATE_RATIO * (1 - c_ctrl))
    ok = (1 - c_plain <= limit and c_plain >= S_MIN_COS and c_ctrl >= S_MIN_COS)
    log(f"{what}: S gate 1 - c_plain = {1 - c_plain:.3e} against max({S_GATE_FLOOR}, "
        f"{S_GATE_RATIO} x (1 - c_ctrl) = {S_GATE_RATIO * (1 - c_ctrl):.3e}) = "
        f"{limit:.3e}; c_plain {c_plain:.6f}, c_ctrl {c_ctrl:.6f} (each >= {S_MIN_COS}): "
        f"{'passed' if ok else 'FAILED'}")
    return ok, limit


def noise_gate(what, c_plain, c_noise):
    """Phase 10a's gate of a run, D and S alike -> (passed, the limit on
    1 - c_plain): ``1 - c_plain <= max(NOISE_GATE_FLOOR, NOISE_GATE_RATIO
    * (1 - c_noise))`` with ``c_plain >= NOISE_MIN_PLAIN`` and ``c_noise
    >= NOISE_MIN_NOISE`` (a control that moves the logits further is a
    broken control).  No phase calls it now: on the card this gate passed
    granite's runs and also a pass with a page left out in one layer's
    decode (``ROADMAP.md`` §3), so phase 10a runs under the per-call
    oracle (``call_oracle``) instead."""
    limit = max(NOISE_GATE_FLOOR, NOISE_GATE_RATIO * (1 - c_noise))
    ok = (1 - c_plain <= limit and c_plain >= NOISE_MIN_PLAIN
          and c_noise >= NOISE_MIN_NOISE)
    log(f"{what}: noise gate 1 - c_plain = {1 - c_plain:.3e} against max("
        f"{NOISE_GATE_FLOOR}, {NOISE_GATE_RATIO} x (1 - c_noise) = "
        f"{NOISE_GATE_RATIO * (1 - c_noise):.3e}) = {limit:.3e}; c_plain {c_plain:.6f} "
        f"(>= {NOISE_MIN_PLAIN}), c_noise {c_noise:.6f} (>= {NOISE_MIN_NOISE}): "
        f"{'passed' if ok else 'FAILED'}")
    return ok, limit


def serve_pass(torch, dev, what, model, cfg, launched, reqs, new_tokens, hit,
               forced=None, selecting=None, **serve_kw):
    """Requests ``reqs`` of ``traffic`` served through ``Engine`` on
    ``model`` with ``cfg``, fed ``forced`` tokens when given, inside
    ``selecting`` (a context), every row's logits recorded; the run's
    counts zeroed just before and read just after: ``launched``'s kernels
    launched and no other (the plain versions only when empty), no plain
    version called, rung 0 kept.  -> ``run_engine``'s record, with the
    engine's ``snap``shot and ``max_batch``."""
    eng = make_engine(cfg, model, dev, reqs, new_tokens, **serve_kw)
    with selecting or contextlib.nullcontext():
        run = run_engine(torch, eng, forced=forced, record=True)
    check_served(eng, run["done"], len(reqs), new_tokens, cfg.vocab_size, prefix_hit=hit)
    expect_path(what, run["counts"], launched)
    run.update(snap=eng.metrics.snapshot(), max_batch=eng.serve.max_batch)
    del run["probe"], eng       # the probe holds the engine and its cache
    gc.collect()
    torch.cuda.empty_cache()
    return run


def family_model(torch, dev, arch, cfg):
    """``arch`` on the card at ``cfg``'s width and depth: bf16,
    random weights from ``torch.Generator`` seed 0 (peak memory counted
    from here)."""
    from repro_torch.models import Transformer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()        # the init's f32 staging, still cached
    cfg = model.cfg
    n_par = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    ffn = (f"{cfg.moe.n_experts} experts top-{cfg.moe.experts_per_token} of d_ff "
           f"{cfg.d_ff}, capacity factor {cfg.moe.capacity_factor} (router f32)"
           if cfg.moe else f"d_ff {cfg.d_ff}")
    log(f"{arch} weights: {n_par / 1e9:.3f}B params bf16 ({w_bytes / 1e9:.2f} GB), "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, {cfg.activation}, {ffn}, "
        f"qkv_bias {cfg.qkv_bias}, tied {cfg.tie_embeddings}, vocab {cfg.vocab_size}, "
        f"init {time.perf_counter() - t0:.1f}s")
    return model


def serve_arch(torch, dev, arch, missed, extra=None):
    """The runs of ``family_runs(arch)`` on one model at full width and
    depth (``family_model``), each served through ``Engine`` at
    temperature 0 (``serve_pass``: its path's kernels only, rung 0), then
    through the plain versions (the ``"reference"`` backend) for
    ``AGREE_NEW`` tokens, fed the kernel run's tokens, every step's logits
    finite; in an S run every plain sparse prefill call selects on its own
    inputs and is held against the kernel on the same inputs
    (``prefill_selections``).  D and G are gated at a least logit cosine
    of ``LOGIT_COS``; S by ``s_gate``, whose control run is the kernel with
    one split a call, fed the same tokens.

    qwen3-32b (65.5 GB of weights) runs at max_batch 2, a reduced batch
    (the script fails if the free memory after the weights cannot hold two
    16384-token KV rows), its plain and control runs on its shorter
    request at max_batch 1.  A run that misses its gate is added to
    ``missed``.  ``extra(model, summary)`` runs on the model before it is
    dropped.  -> {run: summary, "peak_gib": ...}."""
    t_arch = time.perf_counter()
    runs_cfg = family_runs(arch)
    model = family_model(torch, dev, arch, runs_cfg["D"][0])
    cfg = model.cfg
    reqs, plain_reqs, serve_kw, plain_kw, hit = FAMILY_REQS, FAMILY_REQS, {}, {}, True
    if arch == QWEN32:
        kv_row = (2 * cfg.n_layers * cfg.n_kv_heads * CTX * cfg.resolved_head_dim * 2)
        free = torch.cuda.mem_get_info(dev)[0]
        if free < QWEN32_BATCH * kv_row:
            fail(f"{arch}: {free / 2**30:.2f} GiB free after the weights cannot "
                 f"hold {QWEN32_BATCH} KV rows of {CTX} tokens")
        reqs, plain_reqs, hit = QWEN32_REQS, QWEN32_PLAIN_REQS, False
        serve_kw, plain_kw = {"max_batch": QWEN32_BATCH}, {"max_batch": 1}
        log(f"{arch}: {free / 2**30:.2f} GiB free after the weights, a KV row of "
            f"{CTX} tokens takes {kv_row / 2**30:.2f} GiB: max_batch {QWEN32_BATCH} "
            f"(a reduced batch on one card, not the full serving configuration)")
    vocab = cfg.vocab_size
    summary = {}
    for name, (rcfg, launched) in runs_cfg.items():
        sparse = rcfg.sparse.sparse_prefill
        sel = {"kernel": {}, "plain": {}, "control": {}}
        held = {"calls": 0, "cells": 0, "tie_cells": 0}

        def selecting(mode):
            return prefill_selections(mode, sel[mode], held) if sparse else None

        t_run = time.perf_counter()
        what = f"{arch} run {name}"
        run = serve_pass(torch, dev, what, model, rcfg, launched, reqs, FAMILY_NEW, hit,
                         selecting=selecting("kernel"), **serve_kw)
        snap = run["snap"]
        log_serving(f"{arch} {name} (sparse_prefill {sparse}, fused_decode "
                    f"{rcfg.sparse.fused_decode}, max_batch {run['max_batch']})",
                    run, snap)
        plain_cfg = dataclasses.replace(rcfg, sparse=dataclasses.replace(
            rcfg.sparse, backend="reference"))

        plain = serve_pass(torch, dev, f"{what}, plain", model, plain_cfg, set(),
                           plain_reqs, AGREE_NEW, hit, forced=run["tokens"],
                           selecting=selecting("plain"), **plain_kw)
        floor = S_MIN_COS if sparse else LOGIT_COS
        c_plain, same, n_steps = agree_logits(
            torch, f"{arch} {name}", run["logits"], plain["logits"], vocab,
            plain_reqs, floor=floor, fatal=False)
        ok = c_plain >= floor
        row = {"launches": {k: c["launches"] for k, c in run["counts"].items()
                            if c["launches"]},
               "decode_steps": run["steps"]["decode_step"],
               "prefill_chunks": run["steps"]["prefill_chunk"],
               "wall_s": run["wall"], "ttft_p50": snap["ttft_p50"],
               "tpot_p50": snap["tpot_p50"], "c_plain": c_plain,
               "greedy_equal": [same, n_steps]}
        if sparse:
            # the control: the kernel with one split a call, same tokens
            ctrl = serve_pass(torch, dev, f"{what}, control", model, rcfg, launched,
                              plain_reqs, AGREE_NEW, hit, forced=run["tokens"],
                              selecting=selecting("control"), **plain_kw)
            c_ctrl, same_c, _ = agree_logits(
                torch, f"{arch} {name}", run["logits"], ctrl["logits"], vocab,
                plain_reqs, floor=S_MIN_COS, fatal=False,
                other="the control (the kernel at n_split 1)")
            ok, limit = s_gate(f"{arch} {name}", c_plain, c_ctrl)
            row.update(c_ctrl=c_ctrl, greedy_equal_ctrl=same_c, gate_limit=limit)
        if sparse:
            log(f"{arch} {name}: every sparse prefill call of the plain run "
                f"({held['calls']} calls, {held['cells']} cells) selected on its own "
                f"inputs and was held against the kernel on the same inputs: "
                f"selections equal up to {held['tie_cells']} near-tie cells (the "
                f"plain run attends the kernel's blocks there), outputs within the "
                f"bf16 rule")
            drift = {m: selection_drift(f"{arch} {name} {m}", sel["kernel"], sel[m])
                     for m in ("plain", "control") if sel[m]}
            for m, shares in drift.items():
                log(f"{arch} {name}: share of cells the {m} run selects otherwise "
                    f"than the kernel run, by layer: "
                    + " ".join(f"{s:.3f}" for s in shares))
            row.update(prefill_calls_held=held["calls"], prefill_cells=held["cells"],
                       prefill_tie_cells=held["tie_cells"],
                       **{f"drift_{m}_max": max(s) for m, s in drift.items()})
        if not ok:
            missed.append(f"{arch} {name}: c_plain {c_plain}"
                          + (f", c_ctrl {row['c_ctrl']}" if sparse else ""))
        del sel
        row["run_s"] = time.perf_counter() - t_run
        log(f"{arch} {name} took {row['run_s']:.1f}s")
        summary[name] = row
    if extra is not None:
        use_config(model, runs_cfg["D"][0])
        extra(model, summary)
    peak = torch.cuda.max_memory_allocated()
    log(f"{arch}: peak device memory allocated {peak / 2**30:.2f} GiB; {arch} took "
        f"{time.perf_counter() - t_arch:.1f}s")
    summary["peak_gib"] = peak / 2**30
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def serve_family(torch, dev):
    """Phase 9: llama3.1-8b, qwen1.5-4b, gemma-7b and qwen3-32b, one model
    on the card at a time, through ``serve_arch`` with its ``"control"``
    oracle.  A run that misses its gate fails the phase after every run
    has been served.  -> {arch: {run: summary}}."""
    out, missed = {}, []
    for arch in (LLAMA31, QWEN15, GEMMA, QWEN32):
        out[arch] = serve_arch(torch, dev, arch, missed)
    if missed:
        log(f"phase 9 summary: {json.dumps(out)}")
        fail("phase 9: " + "; ".join(missed))
    return out

# ---------------------------------------------------------------------------
# phase 10: the MoE family (granite-moe-3b-a800m) and prefix-embedding
# requests (internvl2-2b) at full width and depth
# ---------------------------------------------------------------------------

#: granite's attention (24 / 8 heads of 64, Dp 128), internvl's (16 / 8
#: heads of 128, group 2) and musicgen's (32 / 32 heads of 64, Dp 128,
#: group 1), as phases 2 and 4 check and time them: (kv heads, group,
#: head_dim)
GRANITE_SHAPE, INTERNVL_SHAPE, MUSICGEN_SHAPE = (8, 3, 64), (8, 2, 128), (32, 1, 64)
#: the layer whose MoE FFN inputs phase 10b takes, and the valid rows of
#: its padded chunk (a 512-token buffer)
MOE_PROBE_LAYER, MOE_PADDED_VALID = 16, 296


def check_late_kernels(torch, dev):
    """Phase 2 at phase 10's and 11's shapes: granite's ``fused_decode``
    (planned and forced splits, the page-left-out power check),
    ``sparse_prefill`` (planned and forced splits) and ``flash_attention``
    at a chunk offset (the tile-left-out power check), all at head_dim 64
    / Dp 128; internvl's ``fused_decode`` at group 2; musicgen's three at
    32 kv heads of group 1 (64 query rows a prefill cell)."""
    out = {}
    for name, (n_kv, g, d), seed in (("granite", GRANITE_SHAPE, 31),
                                     ("musicgen", MUSICGEN_SHAPE, 34)):
        dec = check_fused_decode(torch, dev, g=g, seed=seed, n_kv=n_kv, d=d)
        pre = check_sparse_prefill(torch, dev, g=g, seed=seed + 1, n_kv=n_kv, d=d)
        flash_off = check_flash_offset(torch, dev, hq=n_kv * g, hkv=n_kv, d=d)
        out[name] = {"dec": dec, "err": {"fused_decode": dec["err"],
                                         "sparse_prefill": pre["err"],
                                         "flash_attention": flash_off["err"]}}
    n_kv, g, d = INTERNVL_SHAPE
    dec_v = check_fused_decode(torch, dev, g=g, seed=33, n_kv=n_kv, d=d)
    out["internvl"] = {"dec": dec_v, "err": {"fused_decode": dec_v["err"]}}
    return out


def time_late_kernels(torch, dev, late):
    """Phase 4 at phase 10's and 11's shapes: granite's and musicgen's
    ``fused_decode``, ``sparse_prefill`` (the chunk at offset 8192) and
    ``flash_attention`` (the chunk shape), internvl's ``fused_decode``, by
    device time with their bounds -> {"granite" | "musicgen" | "internvl":
    {kernel: times}}."""
    out = {}
    for name, (n_kv, g, d) in (("granite", GRANITE_SHAPE), ("musicgen", MUSICGEN_SHAPE)):
        out[name] = {
            "fused_decode": time_fused_decode(torch, late[name]["dec"]),
            "sparse_prefill": time_sparse_prefill(torch, dev, g=g, n_kv=n_kv, d=d,
                                                  offsets=(CTX // 2,)),
            "flash_attention": time_flash_chunk(torch, dev, hq=n_kv * g, hkv=n_kv, d=d),
        }
    out["internvl"] = {"fused_decode": time_fused_decode(torch, late["internvl"]["dec"])}
    return out


@contextlib.contextmanager
def ffn_input(layer, probe, name):
    """Within, the first input of ``layer``'s MoE FFN and its keyword
    arguments are kept as ``probe[name] = (x, kwargs)``."""
    from repro_torch.models import layers as tlayers

    orig = tlayers.moe_ffn

    def keep(p, x, cfg, **kw):
        if p is layer and name not in probe:
            probe[name] = (x.clone(), kw)
        return orig(p, x, cfg, **kw)

    tlayers.moe_ffn = keep
    try:
        yield
    finally:
        tlayers.moe_ffn = orig


def moe_inputs(torch, view, dev):
    """Phase 10b's inputs, layer ``MOE_PROBE_LAYER``'s MoE FFN inputs as
    granite's entry points give them: ``prefill_chunk`` of request 0's
    first 512 tokens (a whole chunk) and of its next ``MOE_PADDED_VALID``
    in a 512-token buffer (a padded chunk; its groups and capacity come
    from the buffer), and one eager ``decode_step`` of ``MAX_BATCH`` slots
    (group ``MAX_BATCH``) on phase 6's random cache -> {"chunk" |
    "padded" | "decode": (x, kwargs)}."""
    layer, probe = view.layers[MOE_PROBE_LAYER], {}
    prompt = traffic(view.cfg.vocab_size)[0]
    cache = view.init_cache(1, CTX)
    with ffn_input(layer, probe, "chunk"):
        view.prefill_chunk(cache, 0, prompt[:CHUNK], 0, CHUNK)
    with ffn_input(layer, probe, "padded"):
        view.prefill_chunk(cache, 0, prompt[CHUNK:2 * CHUNK], CHUNK, MOE_PADDED_VALID)
    del cache
    cache = random_cache(torch, view, CTX, dev)
    cache["seq_len"].copy_(step_lens(torch, CTX, dev))
    with ffn_input(layer, probe, "decode"):
        view.decode_step(cache, torch.arange(MAX_BATCH, device=dev))
    del cache
    for name in ("chunk", "padded", "decode"):
        if name not in probe:
            fail(f"phase 10b: no {name} input of layer {MOE_PROBE_LAYER} reached the MoE FFN")
    return probe


def prefix_embeddings(torch, cfg, req_ids, n):
    """Per request a ``[n, d_model]`` bf16 block of patch or frame
    embeddings (``torch.Generator`` seed 100 + request, on the CPU), at
    the scale of the token embeddings' rows."""
    out = {}
    for i in req_ids:
        gen = torch.Generator().manual_seed(100 + i)
        out[i] = (torch.randn((n, cfg.d_model), generator=gen) * 0.02).to(torch.bfloat16)
    return out


def make_prefix_engine(torch, cfg, model, dev, req_ids, new_tokens, prefix):
    """``make_engine`` with requests ``req_ids`` of ``traffic`` each after
    its ``prefix`` embeddings."""
    from repro_torch.serving import Request

    eng = make_engine(cfg, model, dev, (), new_tokens)
    prompts = traffic(cfg.vocab_size)
    for i in req_ids:
        eng.submit(Request(req_id=i, prompt=prompts[i], max_new_tokens=new_tokens,
                           prefix_emb=prefix[i]))
    return eng


def moe_step(torch, view, dev, x, kw):
    """Phase 10c: granite's fused decode step eager and graphed from the
    same state (``compiled_step``: bitwise, times, device-busy share), and
    the MoE FFN's device time at the step's shape (B 4 slots, group 4, on
    phase 10b's decode input ``x``): the whole FFN and its expert products
    alone (``moe._experts`` on the ``[E, C = 4, d]`` dispatch), times the
    layers, against the step."""
    from repro_torch.models import moe as tmoe

    cfg = view.cfg
    cache = random_cache(torch, view, CTX, dev)
    res = compiled_step(torch, GRANITE, {"fused": (view, cache, step_lens(torch, CTX, dev))},
                        dev)["fused"]
    del cache
    layer = view.layers[MOE_PROBE_LAYER]
    E = cfg.moe.n_experts
    C = tmoe.capacity(x.shape[0], E, cfg.moe.experts_per_token, cfg.moe.capacity_factor)
    xe = torch.randn((E, C, cfg.d_model), device=dev).to(torch.bfloat16)
    ffn_ms = device_ms(torch, lambda: tmoe.moe_ffn(layer, x, cfg, **kw), 20)
    experts_ms = device_ms(torch, lambda: tmoe._experts(layer, xe, cfg.activation), 20)
    L, busy = cfg.n_layers, max(res["busy_graphed"], 1e-9)
    res["moe"] = {"ffn_ms_per_layer": ffn_ms, "experts_ms_per_layer": experts_ms,
                  "route_dispatch_combine_ms_per_layer": ffn_ms - experts_ms,
                  "share_of_step": L * ffn_ms / busy,
                  "experts_share_of_step": L * experts_ms / busy,
                  "route_dispatch_combine_share_of_step": L * (ffn_ms - experts_ms) / busy}
    log(f"phase 10c {GRANITE}: the MoE FFN at the step's shape (B {x.shape[0]}, C {C}): "
        f"{ffn_ms:.4f} ms a layer (device), its expert products {experts_ms:.4f}, routing, "
        f"dispatch and combine {ffn_ms - experts_ms:.4f}; x {L} layers against the "
        f"graphed step's {busy:.4f} device-busy ms: {json.dumps(res['moe'])}")
    return res


def prefix_run(torch, dev, arch, model, rcfg, launched, reqs, n_prefix):
    """Requests ``reqs`` of ``traffic``, each after ``n_prefix`` embeddings
    (``prefix_embeddings``), served on ``model`` with ``rcfg`` (each in
    one single-shot prefill, outside the prefix cache), then through the
    plain versions fed its tokens -> (summary, least logit cosine)."""
    cfg = model.cfg
    prefix = prefix_embeddings(torch, cfg, reqs, n_prefix)
    eng = make_prefix_engine(torch, rcfg, model, dev, reqs, FAMILY_NEW, prefix)
    monolithic = []
    orig = eng._prefill_monolithic
    eng._prefill_monolithic = lambda seq: (monolithic.append(seq.req.req_id), orig(seq))
    run = run_engine(torch, eng, record=True)
    check_served(eng, run["done"], len(reqs), FAMILY_NEW, cfg.vocab_size, prefix_hit=False)
    expect_path(f"{arch} prefix run", run["counts"], launched)
    snap = eng.metrics.snapshot()
    del run["probe"]            # it holds the engine and its cache
    log_serving(f"{arch} ({n_prefix} prefix embeddings a request, single-shot prefill)",
                run, snap)
    if sorted(monolithic) != sorted(reqs) or run["steps"]["prefill_chunk"] or snap[
            "prefix_hit_tokens"]:
        fail(f"{arch}: prefix requests must prefill in one shot each, outside the "
             f"prefix cache (single-shot {monolithic}, prefill steps "
             f"{run['steps']['prefill_chunk']}, prefix hits {snap['prefix_hit_tokens']})")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    pcfg = dataclasses.replace(rcfg, sparse=dataclasses.replace(rcfg.sparse,
                                                                backend="reference"))
    eng = make_prefix_engine(torch, pcfg, model, dev, reqs, AGREE_NEW, prefix)
    plain = run_engine(torch, eng, forced=run["tokens"], record=True)
    check_served(eng, plain["done"], len(reqs), AGREE_NEW, cfg.vocab_size,
                 prefix_hit=False)
    expect_path(f"{arch} prefix run, plain", plain["counts"], set())
    del plain["probe"], eng
    gc.collect()
    torch.cuda.empty_cache()
    c_plain, same, n_steps = agree_logits(
        torch, f"{arch} prefix run", run["logits"], plain["logits"], cfg.vocab_size,
        reqs, fatal=False)
    return {"launches": {k: c["launches"] for k, c in run["counts"].items()
                         if c["launches"]},
            "decode_steps": run["steps"]["decode_step"],
            "single_shot_prefills": len(monolithic), "prefix_rows": n_prefix,
            "wall_s": run["wall"], "ttft_p50": snap["ttft_p50"],
            "tpot_p50": snap["tpot_p50"], "c_plain": c_plain,
            "greedy_equal": [same, n_steps]}, c_plain


def serve_oracle(torch, dev, arch, model, missed):
    """Phase 10a: ``arch`` served end to end in phase 9's runs D and S
    (``family_runs``: requests ``FAMILY_REQS`` x ``FAMILY_NEW``, batch 4,
    context 16384, chunks of 512) with step graphs off, every kernel call
    held against its plain version on its own inputs (``call_oracle``),
    the power checks on layer ``ORACLE_FAULT_LAYER``'s calls.  No
    plain-fed pass and no end-to-end cosine: the per-call oracle replaces
    both.  What it finds wrong goes to ``missed`` -> {run: summary}."""
    from repro_torch.serving.graphs import step_graphs_disabled

    out = {}
    n_layers = model.cfg.n_layers
    runs = family_runs(arch)
    for name, (rcfg, launched) in runs.items():
        stats = oracle_stats()
        t0 = time.perf_counter()
        what = f"phase 10a {arch} run {name}"
        with step_graphs_disabled():
            run = serve_pass(torch, dev, what, model, rcfg, launched, FAMILY_REQS,
                             FAMILY_NEW, True,
                             selecting=call_oracle(stats, ORACLE_FAULT_LAYER))
        launches = {k: c["launches"] for k, c in run["counts"].items() if c["launches"]}
        miss = oracle_misses(what, stats, launches, ORACLE_FAULT_LAYER, n_layers)
        missed.extend(miss)
        calls = {k: dict(v, flagged=len(v["flagged"])) for k, v in stats["calls"].items()
                 if v["held"] or v["flagged"]}
        faults = {}
        for k, f in stats["faults"].items():
            if not f["calls"] and not f.get("unfaultable"):
                continue
            faults[k] = {"calls": f["calls"], "flagged": f["flagged"],
                         "held": len(f["missed"]),
                         "unfaultable": len(f.get("unfaultable", ())),
                         "rows_swapped": f.get("swapped"),
                         "change_median_max_per_call": f["change"],
                         "clean_median_max_per_call": f["clean"],
                         "change_median_of_medians": median_max(
                             [c[0] for c in f["change"]])[0],
                         "clean_max": max((c[1] for c in f["clean"]), default=0.0)}
        tokens = {r: [run["tokens"][k] for k in sorted(run["tokens"]) if k[0] == r]
                  for r in FAMILY_REQS}
        row = {"launches": launches, "decode_steps": run["steps"]["decode_step"],
               "prefill_chunks": run["steps"]["prefill_chunk"], "wall_s": run["wall"],
               "calls": calls, "faults": faults, "greedy_tokens": tokens,
               "missed": miss, "run_s": time.perf_counter() - t0}
        log(f"{what} (step graphs off, sparse_prefill {rcfg.sparse.sparse_prefill}): "
            f"every kernel call held against its plain version on its own inputs: "
            f"{json.dumps(calls)}")
        log(f"{what}: power checks on layer {ORACLE_FAULT_LAYER}'s calls (the run kept "
            f"the clean outputs): {json.dumps(faults)}")
        log(f"{what}: greedy tokens {json.dumps({str(r): t for r, t in tokens.items()})}; "
            f"{'passed' if not miss else 'FAILED: ' + '; '.join(miss)}; "
            f"took {row['run_s']:.1f}s")
        out[name] = row
    use_config(model, runs["D"][0])
    return out


def serve_moe(torch, dev):
    """Phase 10 on granite-moe-3b-a800m at full width and depth (bf16,
    random weights from ``torch.Generator`` seed 0, capacity factor 1.25
    as published).  a) granite served end to end in runs D and S under the
    per-call oracle (``serve_oracle``).  b) the MoE FFN on the card against the same function in f32 on
    the CPU (``moe_check.compare_moe_ffn``) on the inputs of one layer that
    its entry points give it (``moe_inputs``): a whole chunk, a padded
    chunk, a decode step.  c) the decode step graphed vs eager and the MoE FFN's
    share of it (``moe_step``), peak memory.  d) internvl2-2b at full
    width and depth, requests 0, 1 and 3 each after 256 patch embeddings
    (single-shot prefill through ``flash_attention``, fused decode), then
    through the plain versions fed its tokens: cosine ``LOGIT_COS``
    (``prefix_run``).  -> summary, with the gates it missed under
    ``"missed"`` (the script fails on them after its summary lines)."""
    from repro_torch.models.moe_check import compare_moe_ffn

    if family_runs(GRANITE)["D"][0].moe.capacity_factor != 1.25:
        fail(f"{GRANITE}: capacity factor not the published 1.25")
    out, missed = {}, []

    def moe_checks(model, summary):
        cfg = model.cfg
        view = model.with_sparse(**dataclasses.asdict(cfg.sparse))
        # b) the MoE FFN on the card against the CPU's f32 run
        probe = moe_inputs(torch, view, dev)
        for what in ("chunk", "padded", "decode"):
            x, kw = probe[what]
            try:
                res = compare_moe_ffn(model.layers[MOE_PROBE_LAYER], x, cfg, **kw)
            except AssertionError as e:
                fail(f"phase 10b {what}: {e}")
            log(f"phase 10b {GRANITE} layer {MOE_PROBE_LAYER}, {what} (x "
                f"{tuple(x.shape)}, {json.dumps(kw)}): card vs the CPU's f32 run: "
                f"{json.dumps(res)}")
            summary[f"ffn_{what}"] = res
        # c) the decode step as a CUDA graph
        summary["step"] = moe_step(torch, view, dev, *probe["decode"])

    model = family_model(torch, dev, GRANITE, family_runs(GRANITE)["D"][0])
    out[GRANITE] = serve_oracle(torch, dev, GRANITE, model, missed)
    phase_done("10a")
    moe_checks(model, out[GRANITE])
    peak = torch.cuda.max_memory_allocated()
    out[GRANITE]["peak_gib"] = peak / 2**30
    log(f"{GRANITE}: peak device memory allocated {peak / 2**30:.2f} GiB")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # d) internvl2-2b with prefix embeddings
    rcfg, launched = family_runs(INTERNVL)["D"]
    model = family_model(torch, dev, INTERNVL, rcfg)
    row, c_plain = prefix_run(torch, dev, INTERNVL, model, rcfg, launched, FAMILY_REQS,
                              model.cfg.n_prefix_embeddings)
    peak = torch.cuda.max_memory_allocated()
    out[INTERNVL] = {"D": row, "peak_gib": peak / 2**30}
    log(f"{INTERNVL}: peak device memory allocated {peak / 2**30:.2f} GiB")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if c_plain < LOGIT_COS:
        missed.append(f"{INTERNVL} D: c_plain {c_plain}")
    out["missed"] = missed
    return out


# ---------------------------------------------------------------------------
# phase 11: musicgen-large on the sparse kernels, with its sinusoidal
# positions and audio frames
# ---------------------------------------------------------------------------

#: run A: the request served after ``AUDIO_FRAMES`` bf16 audio-frame
#: embeddings (single-shot prefill; the frames take positions 0 .. 255)
AUDIO_REQS, AUDIO_FRAMES = (3,), 256


def serve_musicgen(torch, dev):
    """Phase 11: musicgen-large at full width, 24 of its 48 layers
    (``FAMILY_LAYERS``; 32 / 32 heads of 64, GELU MLP, vocab 2048, untied
    head, sinusoidal positions
    on top of RoPE; bf16, random weights from ``torch.Generator`` seed 0)
    in runs D and S through ``serve_arch`` with phase 9's oracle; then on
    the same model run A (``AUDIO_REQS`` after ``AUDIO_FRAMES`` audio-frame
    embeddings, D's path, ``prefix_run``) at cosine ``LOGIT_COS``, and its
    fused decode step graphed vs eager (``compiled_step``), which must be
    bitwise equal (the positions are an op inside the captured graph).
    -> summary, with the gates it missed under ``"missed"`` (the script
    fails on them after its summary lines)."""
    missed = []

    def audio_and_graph(model, summary):
        rcfg, launched = family_runs(MUSICGEN)["D"]
        summary["A"], c_plain = prefix_run(torch, dev, MUSICGEN, model, rcfg, launched,
                                           AUDIO_REQS, AUDIO_FRAMES)
        if c_plain < LOGIT_COS:
            missed.append(f"{MUSICGEN} A: c_plain {c_plain}")
        view = model.with_sparse(**dataclasses.asdict(rcfg.sparse))
        gc.collect()
        torch.cuda.empty_cache()
        cache = random_cache(torch, view, CTX, dev)
        res = compiled_step(torch, MUSICGEN, {"fused": (view, cache,
                                                        step_lens(torch, CTX, dev))},
                            dev)["fused"]
        del cache
        if not (res["bitwise_first"] and res["bitwise_replay"]):
            missed.append(f"{MUSICGEN}: the graphed decode step is not bitwise the eager one")
        summary["step"] = res

    out = serve_arch(torch, dev, MUSICGEN, missed, extra=audio_and_graph)
    out["missed"] = missed
    return out


# ---------------------------------------------------------------------------
# phase 12: the recurrent families (recurrentgemma-9b, rwkv6-3b)
# ---------------------------------------------------------------------------

RGEMMA, RWKV = "recurrentgemma-9b", "rwkv6-3b"
#: phase 12's serving: context, batch, new tokens, and the prompts (numpy
#: seed 12): 2040 tokens decode across recurrentgemma's 2048-token window
REC_CTX, REC_BATCH, REC_NEW = 8192, 4, 16
REC_PROMPTS = (700, 2040, 3000, 5000)
#: b) the served steps whose logits a single-shot prefill of the prompt and
#: the tokens before them must reproduce (cosine ``LOGIT_COS``)
REC_JS = (0, 8, 15)
#: c) the request whose prompt is prefilled and then decoded with its served
#: tokens, the fed tokens after which every layer's state is compared with
#: a single-shot prefill (1: the state a prefill hands over, before it
#: decays; 16: after the issue's 16 tokens), and the relative L2 limit
REC_STATE_REQ, REC_STATE_AT, REC_STATE_RTOL = 2, (1, 16), 5e-2
#: d) the power checks: (layer, cache entries the prefill leaves zeroed,
#: whether the check is gated); each gated fault must move its layer's
#: state past ``REC_FAULT_MIN`` and fail c).  recurrentgemma's final
#: ``h`` alone is logged, not gated: its decay exp(-8 softplus(lam) r) is
#: about e^-8.5 or less a token at r near 0.5, so the recurrence forgets
#: it within one token and no continuation can see it; its gated fault
#: zeroes ``h`` and the conv tail, which the next decode steps read
REC_FAULTS = {RGEMMA: ((19, ("h",), False), (19, ("h", "conv"), True),
                       (20, ("k", "v"), True)),
              RWKV: ((16, ("S",), True),)}
REC_FAULT_MIN = 0.5
#: e) the layers whose mixing runs on the card and in f32 on the CPU on
#: their served inputs (request ``REC_STATE_REQ``'s prompt; rwkv's first
#: 512 tokens), rows within relative L2 ``REC_CPU_RTOL``
REC_CPU_LAYERS = {RGEMMA: (19, 20), RWKV: (16,)}
REC_CPU_RWKV_TOKENS, REC_CPU_RTOL = 512, 2e-2
#: calls of the prefill mixing timed on those layers' inputs
MIX_WARMUP, MIX_ITERS = 1, 3


def rec_traffic(vocab: int):
    """Phase 12's prompts, ``REC_PROMPTS`` tokens (numpy seed 12)."""
    import numpy as np

    rng = np.random.default_rng(12)
    return [rng.integers(0, vocab, n).astype(np.int64) for n in REC_PROMPTS]


@contextlib.contextmanager
def mixing_hook(layers_at, fn):
    """Within, ``fn(l, entry, h)`` runs after layer ``l``'s prefill mixing
    for ``l`` in ``layers_at`` (``h``: its input after the first norm)."""
    from repro_torch.models import Transformer

    orig = Transformer._mix_prefill

    def hooked(self, l, layer, h, e, positions):
        out = orig(self, l, layer, h, e, positions)
        if l in layers_at:
            fn(l, e, h)
        return out

    Transformer._mix_prefill = hooked
    try:
        yield
    finally:
        Transformer._mix_prefill = orig


def rec_states(torch, model, cache):
    """Every local-attention / recurrent layer's state, by layer and entry:
    clones of the ring buffers (all slots: c) compares past the window,
    where every slot is live) and states."""
    return {(l, name): t.clone() for l, e in enumerate(cache["layers"])
            for name, t in e.items()}


def rel_l2(torch, a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def rec_continuation(torch, model, prompt, fed, dev, fault=None, refs=None):
    """c) / d): ``prompt`` prefilled single-shot (under ``fault``: (layer,
    entries zeroed after its prefill mixing)), then decoded with the
    ``fed`` tokens; after each of ``REC_STATE_AT`` fed tokens every
    layer's state against a single-shot prefill of the prompt and the
    tokens fed so far (``refs``: {j: (logits, states)} of those prefills,
    filled on first use) -> ({j: {(layer, entry): relative L2}}, the last
    step's logits' cosine to the reference prefill's)."""
    refs = {} if refs is None else refs
    tok = torch.as_tensor(prompt, device=dev)[None]
    fed_t = torch.as_tensor(fed, device=dev)
    hook = contextlib.nullcontext()
    if fault is not None:
        layer, names = fault
        hook = mixing_hook({layer}, lambda l, e, h: [e[n].zero_() for n in names])
    with hook:
        logits, cache = model.prefill(tok, max_context=REC_CTX)
    out, cos = {}, None
    for j in range(1, max(REC_STATE_AT) + 1):
        logits, cache = model.decode_step(cache, fed_t[j - 1:j])
        if j in REC_STATE_AT:
            if j not in refs:
                want, ref = model.prefill(torch.cat([tok, fed_t[None, :j]], 1),
                                          max_context=REC_CTX)
                refs[j] = (want, rec_states(torch, model, ref))
                del ref
            want, ref_states = refs[j]
            got = rec_states(torch, model, cache)
            out[j] = {key: rel_l2(torch, t, got[key]) for key, t in ref_states.items()}
            cos = rec_cos(torch, logits, want)
    return out, cos


def rec_cpu_check(torch, model, inputs, dev):
    """e) each captured layer's mixing (``models.transformer.mix_prefill``:
    its served bf16 input after the first norm -> output) on the card and
    in f32 on the CPU (the layer's weights upcast, a fresh cache entry) ->
    {layer: worst and median row's relative L2}."""
    from repro_torch.models.layers import DecoderLayer
    from repro_torch.models.transformer import mix_prefill, state_entry

    cpu_cfg = dataclasses.replace(model.cfg, dtype="float32")
    out = {}
    for l, h in inputs.items():
        layer = model.layers[l]
        if layer.kind == "rwkv":
            h = h[:, :REC_CPU_RWKV_TOKENS]
        S = h.shape[1]
        e = state_entry(model.cfg, layer.kind, 1, REC_CTX, model.dtype, dev)
        got = mix_prefill(model.cfg, layer, h, e,
                          torch.arange(S, device=dev)[None]).float().cpu()
        cpu_layer = DecoderLayer(cpu_cfg, torch.float32, "cpu", layer.kind)
        with torch.no_grad():
            for name, p in cpu_layer.named_parameters():
                p.copy_(getattr(layer, name).float().cpu())
        e = state_entry(cpu_cfg, layer.kind, 1, REC_CTX, torch.float32, "cpu")
        want = mix_prefill(cpu_cfg, cpu_layer, h.float().cpu(), e, torch.arange(S)[None])
        rows = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp(min=1e-30)
        out[l] = {"kind": layer.kind, "tokens": S, "max_row_rel_l2": float(rows.max()),
                  "median_row_rel_l2": float(rows.median())}
    return out


def rec_mixing_times(torch, model, inputs):
    """The plain PyTorch mixing of each captured layer over its served
    3000-token input by CUDA events (``MIX_WARMUP`` + ``MIX_ITERS`` calls,
    a fresh state entry each), and for an RWKV layer its recurrence alone
    (``rwkv6.wkv_chunked`` on the layer's own r, k, v, decays) in chunks
    of ``rwkv6.CHUNK`` tokens and in chunks of one, the plain loop over
    time -> {layer: {"kind", "tokens", "mix_ms", ...}}."""
    from repro_torch.models import rwkv6
    from repro_torch.models.transformer import mix_prefill, state_entry

    out = {}
    for l, h in inputs.items():
        layer = model.layers[l]
        S = h.shape[1]
        pos = torch.arange(S, device=h.device)[None]
        e = state_entry(model.cfg, layer.kind, 1, REC_CTX, model.dtype, h.device)
        row = {"kind": layer.kind, "tokens": S, "mix_ms": cuda_time_ms(
            torch, lambda: mix_prefill(model.cfg, layer, h, e, pos), MIX_WARMUP, MIX_ITERS)}
        if layer.kind == "rwkv":
            prev = torch.nn.functional.pad(h, (0, 0, 1, 0))[:, :-1]
            r, k, v, _, logw = rwkv6._projections(layer, h, prev, model.cfg.rwkv_head_dim)
            r, k, v = r.float(), k.float(), v.float()
            S0 = torch.zeros(e["S"].shape, dtype=torch.float32, device=h.device)
            for name, chunk in (("wkv_chunked_ms", rwkv6.CHUNK), ("wkv_loop_ms", 1)):
                row[name] = cuda_time_ms(
                    torch, lambda c=chunk: rwkv6.wkv_chunked(r, k, v, logw, layer.u, S0, c),
                    1 if chunk == 1 else MIX_WARMUP, 1 if chunk == 1 else MIX_ITERS)
        out[l] = row
    return out


def rec_graph_step(torch, model, dev):
    """f) phase 6's ``compiled_step`` on a ``REC_BATCH`` x ``REC_CTX`` cache
    of random ring buffers and recurrent states (generator seed 7) at
    lengths near the end of the context: bitwise, times, kernels a step."""
    gen = torch.Generator(device=dev).manual_seed(7)
    cache = model.init_cache(REC_BATCH, REC_CTX)
    for e in cache["layers"]:
        for t in e.values():
            t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.5)
    res = compiled_step(torch, model.cfg.name, {"fused": (
        model, cache, step_lens(torch, REC_CTX, dev))}, dev)["fused"]
    del cache
    torch.cuda.empty_cache()
    return res


def rec_cos(torch, a, b):
    """Cosine of two logit rows in f64 (an f32 cosine over 256000 entries
    is off by up to 3e-5)."""
    return float(torch.nn.functional.cosine_similarity(
        a.double().reshape(1, -1), b.double().reshape(1, -1))[0])


def rec_serve(torch, dev, arch, model, what, keep=None):
    """a) ``REC_PROMPTS`` x ``REC_NEW`` tokens through ``Engine`` at batch
    ``REC_BATCH``, context ``REC_CTX``, the graphed decode step, each
    prompt prefilled in one shot, nothing launched; ``keep`` (as
    ``mixing_hook``'s ``fn``) sees the prefill's mixing inputs -> (summary,
    the served tokens and logits by (request, step))."""
    cfg = model.cfg
    eng = make_engine(cfg, model, dev, range(len(REC_PROMPTS)), REC_NEW,
                      prompts=rec_traffic(cfg.vocab_size), max_context=REC_CTX,
                      max_batch=REC_BATCH)
    if eng._chunkable or eng.prefix_cache is not None or eng.serve.prefill_chunk <= 0:
        fail(f"{what}: the engine would chunk prompts or cache prefixes")
    with mixing_hook(set(REC_CPU_LAYERS[arch]), keep or (lambda l, e, h: None)):
        run = run_engine(torch, eng, record=True)
    check_served(eng, run["done"], len(REC_PROMPTS), REC_NEW, cfg.vocab_size,
                 prefix_hit=False)
    snap = eng.metrics.snapshot()
    log_serving(f"{what} (single-shot prefill, graphed decode)", run, snap)
    used = {k: c for k, c in run["counts"].items() if c["launches"] or c["plain_calls"]}
    if used:
        fail(f"{what}: kernels or plain versions ran: {used}")
    row = {"wall_s": run["wall"], "ttft_p50": snap["ttft_p50"], "tpot_p50": snap["tpot_p50"],
           "graph_steps": run["graph_steps"], "decode_steps": run["steps"]["decode_step"]}
    del run["probe"], eng
    gc.collect()
    torch.cuda.empty_cache()
    served = {r: [run["tokens"][(r, j)] for j in range(REC_NEW)]
              for r in range(len(REC_PROMPTS))}
    return row, served, run["logits"]


def rec_oracles(torch, dev, arch, model, what, gated, missed):
    """a) ``rec_serve``, b) the continuation oracle on the logits (not
    ``gated``: at the last j only), c) on every layer's state, and with
    ``gated`` d) the power checks; a missed gate goes to ``missed`` when
    ``gated`` (else it is only logged) -> (summary, e)'s captured
    inputs)."""
    inputs = {}
    want_len = REC_PROMPTS[REC_STATE_REQ]

    def keep(l, e, h):
        if h.shape[1] == want_len and l not in inputs:
            inputs[l] = h.clone()

    row, served, logits = rec_serve(torch, dev, arch, model, what, keep)
    prompts = rec_traffic(model.cfg.vocab_size)
    miss = []
    # b) continuation oracle, logits
    cos = {}
    for r, prompt in enumerate(prompts):
        for j in REC_JS if gated else REC_JS[-1:]:
            toks = torch.as_tensor(list(prompt) + served[r][:j], device=dev)[None]
            lg = model.prefill(toks, max_context=REC_CTX)[0][0].cpu()
            cos[f"{r}@{j}"] = rec_cos(torch, lg, logits[(r, j)])
    worst = min(cos.values())
    row["continuation_cos"] = cos
    log(f"{what} b): single-shot prefill of the prompt and the first j served tokens "
        f"vs the engine's logits at step j (cosine in f64): {json.dumps(cos)}; min "
        f"{worst:.7f} (>= {LOGIT_COS}{'' if gated else ', logged, not gated'})")
    if not worst >= LOGIT_COS:
        miss.append(f"{what} b): cosine {worst}")
    # c) continuation oracle, every layer's state
    prompt, fed = prompts[REC_STATE_REQ], served[REC_STATE_REQ]
    refs = {}
    states, c_cos = rec_continuation(torch, model, prompt, fed, dev, refs=refs)
    worst_c = {j: max(v.values()) for j, v in states.items()}
    row["state_rel_l2"] = {j: {f"{l}.{n}": x for (l, n), x in v.items()}
                           for j, v in states.items()}
    row["state_worst"] = worst_c
    log(f"{what} c): prefill of {len(prompt)} tokens, then fed tokens, vs a "
        f"single-shot prefill: every layer's state relative L2 at {REC_STATE_AT} fed "
        f"tokens {json.dumps(row['state_rel_l2'])}; worst {json.dumps(worst_c)} (<= "
        f"{REC_STATE_RTOL}{'' if gated else ', logged, not gated'}); logit cosine "
        f"{c_cos:.7f}")
    if max(worst_c.values()) > REC_STATE_RTOL:
        miss.append(f"{what} c): state relative L2 {worst_c}")
    if gated:
        # d) power checks
        row["faults"] = []
        for layer, names, gate in REC_FAULTS[arch]:
            f_states, f_cos = rec_continuation(torch, model, prompt, fed, dev,
                                               fault=(layer, names), refs=refs)
            own = {j: max(x for (l, n), x in v.items() if l == layer)
                   for j, v in f_states.items()}
            fails_c = max(max(v.values()) for v in f_states.values()) > REC_STATE_RTOL
            seen = max(own.values()) > REC_FAULT_MIN and fails_c
            row["faults"].append({"layer": layer, "zeroed": list(names), "gated": gate,
                                  "layer_state_rel_l2": own, "fails_c": fails_c,
                                  "logit_cos": f_cos})
            log(f"{what} d): layer {layer} ({model.layers[layer].kind}) with "
                f"{'/'.join(names)} zeroed after its prefill: its state's relative L2 by "
                f"fed tokens {json.dumps(own)} (> {REC_FAULT_MIN}), c) "
                f"{'fails' if fails_c else 'passes'}, logit cosine {f_cos:.7f}"
                + ("" if gate else " (logged, not gated)"))
            if gate and not seen:
                miss.append(f"{what} d): the layer {layer} fault {names} passed its "
                            f"gate ({own})")
    del refs
    if gated:
        missed.extend(miss)
    return row, inputs


def upcast(torch, model, dev):
    """A float32 copy of ``model`` (every weight upcast; the bf16 values
    exactly)."""
    from repro_torch.models import Transformer

    cfg = dataclasses.replace(model.cfg, dtype="float32")
    out = Transformer(cfg, device=dev)
    out.backend = model.backend
    with torch.no_grad():
        for (name, p), (_, q) in zip(out.named_parameters(), model.named_parameters()):
            p.copy_(q)
    return out


def serve_recurrent(torch, dev):
    """Phase 12: recurrentgemma-9b and rwkv6-3b at full width and depth
    (random weights from ``torch.Generator`` seed 0), one on the card at a
    time, no hand-written kernel launched and no plain version run (JAX
    computes these layers in plain jnp: no Pallas kernel exists for them).

    On the served bf16 model: a) ``rec_serve``; b) and c) as below, logged
    only: cuBLAS rounds a one-row product otherwise than the same rows of
    a prompt's, and the bf16 residual stream carries those steps through
    every layer, so decode and prefill part by more than the gates allow
    with no fault in either; e) ``rec_cpu_check`` on ``REC_CPU_LAYERS``;
    f) ``rec_graph_step``.  Then on a float32 copy of the same weights
    (JAX's own continuation invariant is an f32 one, ``tests/
    test_models.py``), gated: a) again; b) for each request and each j of
    ``REC_JS``, a single-shot prefill of the prompt and the first j served
    tokens against the engine's logits at step j, cosine ``LOGIT_COS``; c)
    request ``REC_STATE_REQ``'s prompt prefilled, then decoded with its
    served tokens: every layer's state against a single-shot prefill at
    each of ``REC_STATE_AT`` fed tokens, relative L2 ``REC_STATE_RTOL``;
    d) ``REC_FAULTS``: each gated fault must move its layer's state past
    ``REC_FAULT_MIN`` and fail c) -> summary with the gates it missed
    under ``"missed"``."""
    from repro_torch import kernels
    from repro_torch.configs import get_config

    out, missed = {}, []
    kernels.reset_counts()
    for arch in (RGEMMA, RWKV):
        t_arch = time.perf_counter()
        base = get_config(arch)
        cfg = dataclasses.replace(base, sparse=dataclasses.replace(
            base.sparse, backend="cuda", fused_decode=True))
        model = family_model(torch, dev, arch, cfg)
        row = {}
        row["bf16"], inputs = rec_oracles(torch, dev, arch, model, f"phase 12 {arch} bf16",
                                          False, missed)
        # e) card against CPU
        cpu = rec_cpu_check(torch, model, inputs, dev)
        row["card_vs_cpu"] = cpu
        log(f"phase 12 {arch} e): mixing on the served bf16 inputs, card vs the CPU "
            f"in f32: {json.dumps(cpu)} (rows <= {REC_CPU_RTOL})")
        row["mixing_ms"] = rec_mixing_times(torch, model, inputs)
        log(f"phase 12 {arch}: the plain prefill mixing of one layer of each kind over "
            f"{REC_PROMPTS[REC_STATE_REQ]} tokens, ms by CUDA events: "
            f"{json.dumps(row['mixing_ms'])}")
        if set(cpu) != set(REC_CPU_LAYERS[arch]) or any(
                v["max_row_rel_l2"] > REC_CPU_RTOL for v in cpu.values()):
            missed.append(f"{arch} e): {json.dumps(cpu)}")
        del inputs
        # f) the graphed step
        step = rec_graph_step(torch, model, dev)
        row["step"] = step
        log(f"phase 12 {arch} f): graphed vs eager decode step: bitwise first call "
            f"{step['bitwise_first']}, replay {step['bitwise_replay']}; ms min / median "
            f"/ max eager {fmt_rounds(step['eager'])}, graphed "
            f"{fmt_rounds(step['graphed'])}; device busy per step eager "
            f"{step['busy_eager']:.4f}, graphed {step['busy_graphed']:.4f}; device "
            f"kernels per step {step['kernels_eager']:.0f} / {step['kernels_graphed']:.0f}")
        if not (step["bitwise_first"] and step["bitwise_replay"]):
            missed.append(f"{arch} f): graphed step not bitwise: "
                          f"{json.dumps({k: v for k, v in step.items() if 'diff' in k})}")
        peak = torch.cuda.max_memory_allocated()
        row["peak_gib_bf16"] = peak / 2**30
        # a) - d) on a float32 copy of the weights, gated
        model32 = upcast(torch, model, dev)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        row["f32"], _ = rec_oracles(torch, dev, arch, model32, f"phase 12 {arch} f32",
                                    True, missed)
        peak = torch.cuda.max_memory_allocated()
        row["peak_gib"] = peak / 2**30
        row["seconds"] = time.perf_counter() - t_arch
        log(f"{arch}: peak device memory allocated {peak / 2**30:.2f} GiB (bf16 model "
            f"{row['peak_gib_bf16']:.2f}); {arch} took {row['seconds']:.1f}s")
        out[arch] = row
        del model32
        gc.collect()
        torch.cuda.empty_cache()
    used = {k: c for k, c in kernels.counts().items() if c["launches"] or c["plain_calls"]}
    if used:
        fail(f"phase 12 launched hand-written kernels or their plain versions: {used}")
    out["missed"] = missed
    return out


# ---------------------------------------------------------------------------
# phase 13: training (repro_torch.training) on llama3.2-3b
# ---------------------------------------------------------------------------

#: a) gradients: depth, batch and sequence of the bf16 model held against
#: its f32 copy, and the gate every parameter's gradient must pass, set
#: from ``tools/train_grad_control.py`` on an H100 (four sequences: clean
#: leaves at cosine >= 0.999935 and relative L2 <= 0.0119, the tied
#: embedding the worst; layer 1's rope and mask faults moved its wq / wk
#: to 0.0266-0.0394, cosine <= 0.999657)
TRAIN_GRAD_LAYERS, TRAIN_GRAD_B, TRAIN_S = 2, 1, 2048
TRAIN_GRAD_COS, TRAIN_GRAD_RTOL = 0.99985, 0.018
#: a) the layer the power checks fault, and grad_accum 2 against 1 (f32)
TRAIN_FAULT_LAYER, TRAIN_ACCUM_RTOL = 1, 1e-5
#: b) the full run: steps, global batch, learning rate, warmup, and the
#: least fall of the loss (first step against the mean of the last three)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR, TRAIN_WARMUP, TRAIN_MIN_DROP = 20, 2, 3e-4, 2, 2.0
#: b) the steps whose median is the step time (steps 5-20)
TRAIN_TIMED = slice(4, TRAIN_STEPS)
#: c) the launcher's run: steps and the step its injected failure hits
TRAIN_LAUNCH_STEPS, TRAIN_LAUNCH_FAIL = 6, 5


def grad_diff(torch, got, ref):
    """Per leaf (cosine, relative L2) of gradients ``got`` against ``ref``
    (f64)."""
    out = {}
    for n, r in ref.items():
        a, b = got[n].double().flatten(), r.double().flatten()
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        out[n] = (cos, float((a - b).norm() / b.norm()))
    return out


def grad_misses(diff):
    """The leaves of ``grad_diff``'s result outside a)'s gate."""
    return {n: v for n, v in diff.items()
            if not (v[0] >= TRAIN_GRAD_COS and v[1] <= TRAIN_GRAD_RTOL)}


@contextlib.contextmanager
def train_fault(target, kind):
    """A power check on ``target``'s attention in ``forward_train``:
    "rope" rotates its queries at position + 1 (shifting q and k alike
    would be invisible: RoPE's scores depend on the offset only); "mask"
    lets each query see the next key too (a plain masked attention)."""
    import math

    from repro_torch.models import layers

    qkv, attend = layers.qkv_project, layers.chunked_causal_attention
    on = {}

    def qkv_fault(p, x, cfg, positions):
        q, k, v = qkv(p, x, cfg, positions)
        on["target"] = p is target
        if on["target"] and kind == "rope":
            q = qkv(p, x, cfg, positions + 1)[0]
        return q, k, v

    def attend_fault(q, k, v, chunk=512, causal_pairs=True, window=None):
        if not (on.get("target") and kind == "mask"):
            return attend(q, k, v, chunk=chunk, causal_pairs=causal_pairs, window=window)
        import torch

        S, D, g = q.shape[2], q.shape[3], q.shape[1] // k.shape[1]
        kf, vf = (t.repeat_interleave(g, 1).float() for t in (k, v))
        logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) / math.sqrt(D)
        i = torch.arange(S, device=q.device)
        logits = torch.where(i[None] <= i[:, None] + 1, logits, -1e30)
        return torch.einsum("bhst,bhtd->bhsd", logits.softmax(-1), vf).to(q.dtype)

    layers.qkv_project, layers.chunked_causal_attention = qkv_fault, attend_fault
    try:
        yield
    finally:
        layers.qkv_project, layers.chunked_causal_attention = qkv, attend


def train_grads(torch, dev, cfg, missed):
    """a) llama3.2-3b at full width, ``TRAIN_GRAD_LAYERS`` layers, bf16:
    every parameter's gradient (remat "dots") against its f32 copy's on one
    batch, gated by ``TRAIN_GRAD_COS`` / ``TRAIN_GRAD_RTOL``; both power
    checks must fail the gate on layer ``TRAIN_FAULT_LAYER``'s leaves; the
    f32 copy's ``grad_accum`` 2 against 1 on a batch of 2 within
    ``TRAIN_ACCUM_RTOL``."""
    from repro_torch.config import MeshPlan
    from repro_torch.training.data import DataConfig, batch_for_step
    from repro_torch.training.train_loop import loss_and_grads, trainable

    cfg2 = dataclasses.replace(cfg, n_layers=TRAIN_GRAD_LAYERS)
    model = family_model(torch, dev, ARCH, cfg2)
    model32 = upcast(torch, model, dev)
    p16, p32 = trainable(model), trainable(model32)
    toks = batch_for_step(DataConfig(cfg.vocab_size, TRAIN_S, 2, seed=1), 0, device=dev)
    plan = MeshPlan(remat="dots")
    t0 = time.perf_counter()
    _, ref = loss_and_grads(model32, p32, toks[:TRAIN_GRAD_B], plan)
    loss, got = loss_and_grads(model, p16, toks[:TRAIN_GRAD_B], plan)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    clean = grad_diff(torch, got, ref)
    del got
    row = {"loss_bf16": float(loss), "seconds_f32_and_bf16": grad_s,
           "clean_min_cos": min(v[0] for v in clean.values()),
           "clean_max_rel_l2": max(v[1] for v in clean.values()),
           "clean": clean}
    log(f"phase 13 a) {ARCH} ({TRAIN_GRAD_LAYERS} layers, B {TRAIN_GRAD_B}, S {TRAIN_S}, "
        f"remat dots): bf16 gradients vs the f32 copy's, worst leaf cosine "
        f"{row['clean_min_cos']:.6f} (>= {TRAIN_GRAD_COS}), relative L2 "
        f"{row['clean_max_rel_l2']:.5f} (<= {TRAIN_GRAD_RTOL}); {grad_s:.1f}s; by leaf "
        f"{json.dumps({n: [round(c, 6), round(r, 5)] for n, (c, r) in clean.items()})}")
    if grad_misses(clean):
        missed.append(f"13 a) clean bf16 gradients fail the gate: {grad_misses(clean)}")
    target = model.layers[TRAIN_FAULT_LAYER]
    prefix = f"layers.{TRAIN_FAULT_LAYER}."
    row["faults"] = {}
    for kind in ("rope", "mask"):
        with train_fault(target, kind):
            _, got = loss_and_grads(model, p16, toks[:TRAIN_GRAD_B], plan)
        diff = grad_diff(torch, got, ref)
        del got
        own = {n: v for n, v in diff.items() if n.startswith(prefix)}
        flagged = sorted(grad_misses(own))
        row["faults"][kind] = {"flagged": flagged, "own": own}
        log(f"phase 13 a) power check {kind} on layer {TRAIN_FAULT_LAYER}: its leaves "
            f"{json.dumps({n: [round(c, 6), round(r, 5)] for n, (c, r) in own.items()})}; "
            f"failing the gate: {flagged}")
        if not flagged:
            missed.append(f"13 a) the {kind} fault passed the gradient gate")
    del model, p16, ref
    gc.collect()
    torch.cuda.empty_cache()
    # grad_accum 2 against 1 on the f32 copy
    l1, g1 = loss_and_grads(model32, p32, toks, MeshPlan(remat="dots", grad_accum=1))
    l2, g2 = loss_and_grads(model32, p32, toks, MeshPlan(remat="dots", grad_accum=2))
    acc = max(v[1] for v in grad_diff(torch, g2, g1).values())
    row["accum_max_rel_l2"], row["accum_loss"] = acc, [float(l1), float(l2)]
    log(f"phase 13 a) f32 copy, batch 2: grad_accum 2 vs 1, worst leaf relative L2 "
        f"{acc:.3e} (<= {TRAIN_ACCUM_RTOL}), losses {float(l1):.6f} / {float(l2):.6f}")
    if not acc <= TRAIN_ACCUM_RTOL:
        missed.append(f"13 a) grad_accum 2 vs 1: relative L2 {acc}")
    del model32, p32, g1, g2
    gc.collect()
    torch.cuda.empty_cache()
    return row


def train_full(torch, dev, cfg, card, missed):
    """b) ``Trainer`` on llama3.2-3b at full width and depth, bf16:
    ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_S`` tokens (remat
    "dots", ``grad_accum`` 1, no checkpoint: the state is 45 GB), every
    loss finite and the mean of the last three at least ``TRAIN_MIN_DROP``
    nats below the first."""
    import math

    from repro_torch.config import MeshPlan, TrainConfig
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=TRAIN_STEPS, checkpoint_dir=None)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S, global_batch=TRAIN_BATCH)
    trainer = Trainer(cfg, tc, dc, MeshPlan(grad_accum=1, remat="dots"), device=dev)
    out = trainer.run(TRAIN_STEPS, resume=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = out["losses"]
    n_par = sum(p.numel() for p in trainer.params.values())
    timed = sorted(trainer.durations[TRAIN_TIMED])
    step_ms = 1e3 * timed[len(timed) // 2]
    row = {"params": n_par, "losses": losses, "step_ms_median": step_ms,
           "step_ms_min": 1e3 * timed[0], "step_ms_max": 1e3 * timed[-1],
           "first_step_ms": 1e3 * trainer.durations[0],
           "tokens_per_s": TRAIN_BATCH * TRAIN_S / (step_ms / 1e3),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "stragglers": len(out["fault_log"].stragglers), "wall_s": wall}
    drop = losses[0] - sum(losses[-3:]) / 3
    row["drop"] = drop
    log(f"phase 13 b) {ARCH} trained at full width and depth ({n_par / 1e9:.3f}B params, "
        f"bf16, f32 master / m / v), {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_S} "
        f"tokens, remat dots ({card}): losses {json.dumps([round(x, 4) for x in losses])}; "
        f"fall {drop:.3f} nats (>= {TRAIN_MIN_DROP}); step ms median "
        f"{step_ms:.1f} (min {row['step_ms_min']:.1f}, max {row['step_ms_max']:.1f}, "
        f"first {row['first_step_ms']:.1f}), {row['tokens_per_s']:.0f} tokens/s, peak "
        f"allocated {row['peak_gib']:.2f} GiB, {wall:.1f}s with init")
    if not all(math.isfinite(x) for x in losses) or not drop >= TRAIN_MIN_DROP:
        missed.append(f"13 b) losses {losses}: fall {drop}")
    row["breakdown"] = train_breakdown(torch, trainer, out["state"]["opt"])
    log(f"phase 13 b) one step after the run, apart ({card}): "
        f"{json.dumps(row['breakdown'])}")
    del trainer, out
    gc.collect()
    torch.cuda.empty_cache()
    return row


def train_breakdown(torch, trainer, opt):
    """Where a step of ``trainer`` goes, on the batch after its run:
    forward and backward, then AdamW, by CUDA events (the second of two
    steps), then one whole step under ``profiled``: its host ms, device
    busy ms, device kernels and the three kernels that take longest."""
    from repro_torch.training.data import batch_for_step
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_loop import loss_and_grads

    toks = batch_for_step(trainer.data_cfg, TRAIN_STEPS, device=trainer.model.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(2):
        ev[0].record()
        _, grads = loss_and_grads(trainer.model, trainer.params, toks, trainer.plan)
        ev[1].record()
        opt, _ = adamw_update(trainer.train_cfg, trainer.params, grads, opt)
        ev[2].record()
        del grads
        torch.cuda.synchronize()
    row = {"fwd_bwd_ms": ev[0].elapsed_time(ev[1]), "adamw_ms": ev[1].elapsed_time(ev[2])}
    t0 = time.perf_counter()
    rows = profiled(torch, lambda: float(trainer._step_fn(opt, toks)[1]["loss"]))
    row["profiled_step_ms"] = (time.perf_counter() - t0) * 1e3
    row["busy_ms"] = sum(r[0] for r in rows)
    row["kernels"] = sum(r[1] for r in rows)
    row["top"] = [[short(r[2]), round(r[0], 2), r[1]] for r in rows[:3]]
    return row


def train_launcher(torch, dev, out_dir, missed):
    """c) ``python -m repro_torch.launch.train --smoke`` on the card for
    ``TRAIN_LAUNCH_STEPS`` steps, its checkpoints under ``out_dir``, one
    failure injected at step ``TRAIN_LAUNCH_FAIL`` (one restart); then a
    bf16 smoke trainer's state after two steps saved and restored into
    another state on the card: bitwise, on the card, in its dtype."""
    import re
    import shutil

    from repro_torch.config import MeshPlan, TrainConfig
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import Trainer

    root = out_dir / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--steps",
         str(TRAIN_LAUNCH_STEPS), "--ckpt-dir", str(root / "launcher"),
         "--inject-failure-at", str(TRAIN_LAUNCH_FAIL)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    launch_s = time.perf_counter() - t0
    tail = res.stdout.strip().splitlines()[-1:] or [""]
    m = re.match(r"final loss (\S+) \(start (\S+)\); restarts=(\d+)", tail[0])
    kept = sorted(os.listdir(root / "launcher")) if (root / "launcher").is_dir() else []
    row = {"rc": res.returncode, "line": tail[0], "checkpoints": kept, "seconds": launch_s}
    log(f"phase 13 c) launcher --smoke --steps {TRAIN_LAUNCH_STEPS} on the card, failure at "
        f"step {TRAIN_LAUNCH_FAIL}: exit {res.returncode}, {tail[0]!r}, checkpoints {kept}, "
        f"{launch_s:.1f}s")
    if res.returncode != 0 or m is None or int(m.group(3)) != 1 \
            or f"step_{TRAIN_LAUNCH_STEPS:08d}" not in kept or any(k.endswith(".tmp") for k in kept):
        missed.append(f"13 c) launcher: {row} {res.stderr[-2000:]}")
    # a checkpoint saved and restored on the card
    cfg = dataclasses.replace(smoke_variant(get_config(ARCH)), dtype="bfloat16")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=4)
    tc = TrainConfig(checkpoint_dir=None, warmup_steps=1, total_steps=2)
    a, b = (Trainer(cfg, tc, dc, MeshPlan(), device=dev) for _ in range(2))
    state = a.run(2, resume=False)["state"]
    ckpt.save_checkpoint(str(root / "state"), 2, state)
    step, got = ckpt.restore_checkpoint(str(root / "state"), b.init_state(seed=1))
    want, have = dict(flatten(state)), dict(flatten(got))

    def same(v, h):
        if not isinstance(v, torch.Tensor):
            return v == h
        return h.device == v.device and h.dtype == v.dtype and torch.equal(h, v)

    bad = [k for k, v in want.items() if not same(v, have[k])]
    row["restore"] = {"step": step, "leaves": len(want), "mismatched": bad}
    log(f"phase 13 c) checkpoint of a bf16 smoke trainer after 2 steps on {dev}: "
        f"{len(want)} leaves restored into another state, step {step}, mismatched "
        f"(value, device or dtype): {bad}")
    if step != 2 or bad:
        missed.append(f"13 c) restore: {row['restore']}")
    shutil.rmtree(root, ignore_errors=True)
    return row


def train_phase(torch, dev, card, out_dir):
    """Phase 13: a) ``train_grads``, b) ``train_full``, c)
    ``train_launcher``; no hand-written kernel launched and no plain
    version run (JAX trains through no Pallas kernel) -> summary with the
    gates it missed under ``"missed"``."""
    from repro_torch import kernels
    from repro_torch.configs import get_config

    missed = []
    kernels.reset_counts()
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    out = {"grads": train_grads(torch, dev, cfg, missed)}
    out["full"] = train_full(torch, dev, cfg, card, missed)
    out["launcher"] = train_launcher(torch, dev, out_dir, missed)
    used = {k: c for k, c in kernels.counts().items() if c["launches"] or c["plain_calls"]}
    if used:
        missed.append(f"13: kernels or plain versions ran: {used}")
    out["seconds"] = time.perf_counter() - t0
    out["missed"] = missed
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 14: multi-GPU serving, its kernel shards on one card
# ---------------------------------------------------------------------------

#: the (data, model) meshes whose every shard phase 14 a) launches: model 2,
#: 4 and 8 by data 1, 2 and 4, and model 16, where 8 kv heads degrade to
#: replicated heads (GQA)
MESH_SHAPES = tuple((d, m) for m in (2, 4, 8) for d in (1, 2, 4)) + ((1, 16),)
#: phase 14 b) / c): the requests served (0 and 1 share the prefix)
MESH_REQS = (0, 1, 3)
#: the kernels of a sharded call, and the dim of each output's kv-head axis
#: with its group (q heads ride their kv head)
MESH_KERNELS = ("fused_decode", "sparse_prefill", "centroid_scores_quantized",
                "paged_attention", "flash_attention")


def shard_calls(torch, dec, pre):
    """Phase 2's inputs (the fused decode's and the sparse prefill's) ->
    (the whole calls' outputs, a function running one shard's calls).
    Every output is a tuple of (tensor, GQA group of its head axis)."""
    from repro_torch.core.selection import select_page_table
    from repro_torch.core.sparse_attention import as_dense
    from repro_torch.distributed import kernel_partition as kp
    from repro_torch.kernels import ops

    q, rq, k, v, store, la, sink, local, seq_len = dec["args"]
    pq, prq, pk, pv, ss, pla, sparse, n_valid, off = pre["args"]
    g = q.shape[1] // k.shape[1]
    pre_kw = dict(sink_pages=sparse.sink_pages, local_pages=sparse.local_pages,
                  block_q=sparse.prefill_block_q, topk_scale=sparse.prefill_topk_scale,
                  return_selected=True)

    def calls(shard, own_split=False):
        """One shard's calls (the whole call's for a trivial shard), on the
        slices and at the splits the backends give a mesh rank ->
        {kernel: ((output, group), ...)}; ``own_split``: only the three
        kernels that split a cell's work, each at the split its own shapes
        would choose."""
        t = lambda x, grp=1: shard.take(x, 1, grp).contiguous()
        sla, spla = kp.shard_layout(la, shard.heads), kp.shard_layout(pla, shard.heads)
        st = kp.shard_store(store, la, shard, head_aligned_params=True)
        sst = kp.shard_store(ss, pla, shard, head_aligned_params=False)
        ql, rql, kl, vl = t(q, g), t(rq, g), t(k), t(v)
        sl, nv = shard.take_rows(seq_len).contiguous(), shard.take_rows(n_valid).contiguous()
        pql, prql, pkl, pvl = t(pq, g), t(prq, g), t(pk), t(pv)
        split = (lambda fn, *a: None) if own_split else (lambda fn, *a: fn(shard, *a))
        out, table, valid = ops.fused_decode(
            ql, rql, kl, vl, st, sla, sink, local, sl,
            n_split=split(kp.decode_split, sla.selected_pages, q.device))
        pout, n_att, sel = ops.sparse_prefill(
            pql, prql, pkl, pvl, sst, spla, n_valid=nv, chunk_offset=off, **pre_kw,
            n_split=split(kp.prefill_split, pql, sparse.prefill_block_q))
        scores = ops.centroid_scores(rql, st, sla, shard.n_heads)
        stable, svalid = select_page_table(scores, sla, sl, sink, local)
        att = ops.paged_attention(ql, kl, vl, stable, svalid, PS, sl, n_split=split(
            kp.decode_split, stable.shape[-1], q.device))
        if own_split:
            return {"fused_decode": ((out, g),), "sparse_prefill": ((pout, g),),
                    "paged_attention": ((att, g),)}
        flash = ops.flash_attention(pql, as_dense(pkl), as_dense(pvl), True, off, nv)
        return {"fused_decode": ((out, g), (table, 1), (valid, 1)),
                "sparse_prefill": ((pout, g), (n_att, 1), (sel, 1)),
                "centroid_scores_quantized": ((scores, 1),),
                "paged_attention": ((att, g), (stable, 1), (svalid, 1)),
                "flash_attention": ((flash, g),)}

    whole = kp.Shard(q.shape[0], k.shape[1], (0, q.shape[0]), (0, k.shape[1]))
    return calls(whole), calls


def own_splits(torch, dec, pre, shard):
    """{kernel: (the whole call's split, this shard's own)} of the three
    kernels that split a cell's work."""
    from repro_torch.distributed import kernel_partition as kp

    q, k = dec["args"][0], dec["args"][2]
    pq, sparse = pre["args"][0], pre["args"][6]
    own = kp.Shard(shard.n_rows, shard.n_heads, (0, shard.n_rows), (0, shard.n_heads))
    p_sel = dec["args"][5].selected_pages
    g = q.shape[1] // k.shape[1]
    pql = shard.take(pq, 1, g)
    out = {}
    for name, split in (("fused_decode", lambda s: kp.decode_split(s, p_sel, q.device)),
                        ("paged_attention", lambda s: kp.decode_split(s, p_sel, q.device)),
                        ("sparse_prefill", lambda s: kp.prefill_split(
                            s, pql, sparse.prefill_block_q))):
        out[name] = (split(shard), split(own))
    return out


def mesh_kernels(torch, dec, pre):
    """Phase 14 a): for every mesh of ``MESH_SHAPES`` launch every shard of
    the five kernels of a sharded call, one after another on this card, on
    the slices and at the splits ``kernel_partition`` gives the rank (no
    process group), stitch the outputs and hold them bitwise to the whole
    call: out, page table, valid, the sparse prefill's n_attended and
    selected map, the staged scores.  The launch counts are set to 0 just
    before a mesh's shards and read just after: each kernel must have
    launched once a shard.  Then, outside that window, log per kernel the
    shards whose own split plan differs from the whole call's, and whether
    their outputs then differ."""
    from repro_torch import kernels
    from repro_torch.distributed import kernel_partition as kp

    whole, calls = shard_calls(torch, dec, pre)
    B, n_kv = dec["args"][0].shape[0], dec["args"][2].shape[1]
    launches = {n: 0 for n in MESH_KERNELS}
    own = {n: {"shards": 0, "split_differs": 0, "out_differs": 0}
           for n in ("fused_decode", "sparse_prefill", "paged_attention")}
    for shape in MESH_SHAPES:
        shards = [s for _, s in kp.every_shard(shape, B, n_kv)]
        stitched = {n: [torch.full_like(t, -1) if t.dtype != torch.bool
                        else torch.zeros_like(t) for t, _ in outs]
                    for n, outs in whole.items()}
        kernels.reset_counts()
        for shard in shards:
            for name, outs in calls(shard).items():
                for dst, (part, grp) in zip(stitched[name], outs):
                    shard.take(dst, 1, grp).copy_(part)
        counted = kernels.counts()
        for name in MESH_KERNELS:
            n = counted[name]["launches"]
            if n != len(shards) or counted[name]["plain_calls"]:
                fail(f"mesh {shape}: {name} launched {n} times (plain calls "
                     f"{counted[name]['plain_calls']}) over {len(shards)} shards")
            launches[name] += n
        for name, outs in whole.items():
            for i, ((want, _), have) in enumerate(zip(outs, stitched[name])):
                if not torch.equal(want, have):
                    bad = (want != have).sum().item()
                    fail(f"mesh {shape}: {name} output {i} stitched from its shards "
                         f"differs from the whole call in {bad} elements")
        for shard in shards:
            splits = own_splits(torch, dec, pre, shard)
            diff = {n: s for n, s in splits.items() if s[0] != s[1]}
            mine = calls(shard, own_split=True) if diff else {}
            for name, (w, o) in splits.items():
                own[name]["shards"] += 1
                if w != o:
                    own[name]["split_differs"] += 1
                    part = shard.take(whole[name][0][0], 1, whole[name][0][1])
                    own[name]["out_differs"] += int(not torch.equal(mine[name][0][0], part))
        log(f"phase 14 a) mesh {shape}: {len(shards)} shards, each kernel launched "
            f"once a shard, every stitched output bitwise the whole call's")
    log(f"phase 14 a) launches counted over the meshes' shards: {json.dumps(launches)}")
    log(f"phase 14 a) own split plans (shards held / own plan differs / output "
        f"then differs): {json.dumps(own)}")
    return {"launches": launches, "own_split": own}


def mesh_model(torch, dev):
    """llama3.2-3b at full width, ``LADDER_LAYERS`` deep, on phase 3's
    fused configuration, random weights from seed 0 on ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer

    base = get_config(ARCH)
    pattern = tuple(tuple((16, 32, 64)[(l + h) % 3] for h in range(base.n_kv_heads))
                    for l in range(LADDER_LAYERS))
    cfg = dataclasses.replace(base, n_layers=LADDER_LAYERS, sparse=dataclasses.replace(
        base.sparse, backend="cuda", fused_decode=True, sparse_prefill=True,
        quant="int4_asym", block_sizes=pattern, token_budget=BUDGET))
    return cfg, Transformer(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))


def mesh_serve(torch, cfg, model, dev, mesh, what):
    """Serve ``MESH_REQS`` x ``NEW_TOKENS`` on ``mesh`` (None: one device)
    with the launch counts zeroed before and read after -> the run."""
    eng = make_engine(cfg, model, dev, MESH_REQS, NEW_TOKENS, mesh=mesh)
    run = run_engine(torch, eng)
    check_served(eng, run["done"], len(MESH_REQS), NEW_TOKENS, cfg.vocab_size)
    expect_path(what, run["counts"], {"fused_decode", "sparse_prefill"})
    log_serving(what, run, eng.metrics.snapshot())
    run["streams"] = {r.req_id: list(r.output) for r in run["done"]}
    run["graphed"] = eng._graphed
    run["heads"] = None if eng._shard is None else list(eng._shard.heads)
    del eng
    torch.cuda.empty_cache()
    return run


def mesh_ranks(torch, n, one_card, out_dir, what, want):
    """Serve ``MESH_REQS`` at mesh (1, ``n``) with ``n`` processes of this
    script (``--mesh-rank``): one a card over NCCL, or with ``one_card``
    all on card 0 over gloo (NCCL takes one card a rank).  Rank 0's
    streams must be ``want`` (one device's) and its engine the sharded
    one: this rank's kv heads, the step eager -> rank 0's record."""
    from repro_torch.configs import get_config

    port, path = _mesh_port(), out_dir / "mesh_streams.json"
    path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--mesh-rank", str(r), "--mesh-world", str(n),
                               "--mesh-port", str(port), "--mesh-out", str(path)]
                              + (["--mesh-one-card"] if one_card else []))
             for r in range(n)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if rcs != [0] * n:
        fail(f"{what}: ranks exited {rcs}")
    got = json.loads(path.read_text())
    streams = {int(k): v for k, v in got["streams"].items()}
    if streams != want:
        fail(f"{what}: the tokens differ from one device's")
    n_kv = get_config(ARCH).n_kv_heads
    if got["heads"] != [0, n_kv // n] or got["graphed"]:
        fail(f"{what}: rank 0 served kv heads {got['heads']} (graphed "
             f"{got['graphed']}), not the sharded engine's [0, {n_kv // n}] eager")
    log(f"{what}: tokens equal one device's; rank 0 held kv heads "
        f"{got['heads']}, launches {json.dumps(got['launches'])}, wall "
        f"{got['wall']:.1f}s, {time.perf_counter() - t0:.1f}s with the start-up")
    return {"n": n, "tokens_equal": True, "launches": got["launches"],
            "wall_s": got["wall"]}


def _mesh_port() -> int:
    from repro_torch.launch.mesh import _free_port

    return _free_port()


def mesh_serving(torch, dev, out_dir):
    """Phase 14 b) and c): requests ``MESH_REQS`` served without a mesh,
    then on a one-rank NCCL group at mesh (1, 1), whose tokens must be the
    same (and its decode step graphed, as one device's), then by two ranks
    on this card at (1, 2) over gloo: the sharded engine (a rank's kv
    heads, the backends' shard splits, the head gather), tokens equal; c)
    only with 2 or more cards: the same at (1, n) over NCCL, one process a
    card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serving_mesh

    cfg, model = mesh_model(torch, dev)
    one = mesh_serve(torch, cfg, model, dev, None, "phase 14 b) one device")
    mesh = make_serving_mesh((1, 1), device=dev)
    try:
        m11 = mesh_serve(torch, cfg, model, dev, mesh, "phase 14 b) mesh (1, 1), NCCL")
    finally:
        dist.destroy_process_group()
    if m11["streams"] != one["streams"]:
        fail("phase 14 b): the (1, 1) mesh's tokens differ from one device's")
    if not (m11["graphed"] and one["graphed"]):
        fail("phase 14 b): the (1, 1) mesh must take the graphed single-device step")
    res = {"b": {"tokens_equal": True, "wall_s": [one["wall"], m11["wall"]],
                 "graph_steps": m11["graph_steps"]}}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    res["b"]["one_card_1x2"] = mesh_ranks(
        torch, 2, True, out_dir, "phase 14 b) mesh (1, 2), two ranks on this card "
        "over gloo", one["streams"])
    n_cards = torch.cuda.device_count()
    n = max((c for c in (2, 4, 8) if c <= n_cards), default=0)
    if not n:
        log(f"phase 14 c): {n_cards} card: the card is alone, no (1, n) mesh")
        res["c"] = None
        return res
    res["c"] = mesh_ranks(torch, n, False, out_dir,
                          f"phase 14 c) mesh (1, {n}) over NCCL on {n} cards",
                          one["streams"])
    return res


def mesh_rank(args) -> int:
    """One rank of phase 14 b)'s gloo pair or of c): serve ``MESH_REQS``
    at mesh (1, world), over NCCL on card ``rank`` or, with
    ``--mesh-one-card``, over gloo on card 0; rank 0 writes its streams,
    launches and kv heads to ``--mesh-out``."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.mesh import ServingMesh
    from repro_torch.launch.mesh import make_serving_mesh

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    init = f"tcp://localhost:{args.mesh_port}"
    shape = (1, args.mesh_world)
    if args.mesh_one_card:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=init, rank=args.mesh_rank,
                                world_size=args.mesh_world)
        mesh = ServingMesh.join(shape, dev)
    else:
        os.environ["LOCAL_RANK"] = str(args.mesh_rank)
        mesh = make_serving_mesh(shape, device="cuda", init_method=init,
                                 rank=args.mesh_rank, world_size=args.mesh_world)
    try:
        cfg, model = mesh_model(torch, mesh.device)
        run = mesh_serve(torch, cfg, model, mesh.device, mesh,
                         f"phase 14 rank {args.mesh_rank} of {args.mesh_world}")
    finally:
        dist.destroy_process_group()
    if args.mesh_rank == 0:
        launched = {n: c["launches"] for n, c in run["counts"].items() if c["launches"]}
        Path(args.mesh_out).write_text(json.dumps(
            {"streams": run["streams"], "launches": launched, "wall": run["wall"],
             "heads": run["heads"], "graphed": run["graphed"]}))
    return 0


def mesh_phase(torch, dev, dec, pre, out_dir):
    """Phase 14: a) the kernel shards, b) and c) serving on a mesh."""
    t0 = time.perf_counter()
    res = {"a": mesh_kernels(torch, dec, pre)}
    res["a"]["seconds"] = time.perf_counter() - t0
    res.update(mesh_serving(torch, dev, out_dir))
    return res


def abstract_calls(torch, dev, dec, pre, scored, att, pool, topk):
    """Phase 15 a)'s calls: (kernel, entry point, args, kwargs) on phase 2's
    real inputs, every TPU kernel at least once."""
    from repro_torch.kernels import block_centroid, ops

    q, rq, k, v, store, la, sink, local, seq_len = dec["args"]
    pq, prq, pk, pv, ss, pla, sparse, n_valid, off = pre["args"]
    fq, fk, fv = flash_chunk_inputs(torch, dev, seed=12)
    k_len = torch.full((1,), FLASH_CHUNK_OFF + CHUNK, dtype=torch.int32, device=dev)
    return [
        ("fused_decode", ops.fused_decode, dec["args"], {}),
        ("sparse_prefill", ops.sparse_prefill,
         (pq, prq, pk, pv, ss, pla, sparse.sink_pages, sparse.local_pages,
          sparse.prefill_block_q, sparse.prefill_topk_scale, n_valid, off),
         {"return_selected": True}),
        ("centroid_scores_quantized", ops.centroid_scores,
         (rq, scored["int4_asym"]["store"], la, N_KV), {}),
        ("centroid_scores_f32", ops.centroid_scores,
         (rq, scored["none"]["store"], la, N_KV), {}),
        ("paged_attention", ops.paged_attention,
         (q, k, v, att["table"], att["valid"], PS, seq_len), {}),
        ("pool_rank_keys", block_centroid.pool_rank_keys, (pool["k_serve"], 32, "quest"),
         {}),
        ("pool_rank_keys", block_centroid.pool_rank_keys, (pool["k_cal"], 16, "arkvale"),
         {}),
        ("topk_threshold", ops.topk_threshold, (topk["scores"], la), {}),
        ("flash_attention", ops.flash_attention,
         (fq, fk, fv, True, FLASH_CHUNK_OFF, FLASH_CHUNK_OFF + CHUNK), {}),
        ("flash_attention", ops.flash_attention,
         (fq, fk, fv, True, FLASH_CHUNK_OFF, k_len), {}),
    ]


def abstract_phase(torch, dev, calls):
    """Phase 15: a) each call of ``calls`` (:func:`abstract_calls`) real,
    then on fake copies: equal output specs, one launch against none; b)
    the contract grid on fake CUDA tensors."""
    from repro_torch import kernels
    from repro_torch.analysis import contracts

    t0 = time.perf_counter()
    rows, bad = {}, []
    for name, fn, args, kw in calls:
        kernels.reset_counts()
        real = contracts.output_specs(fn(*args, **kw))
        torch.cuda.synchronize()
        after_real = kernels.counts()
        fake = contracts.abstract_call(fn, *args, **kw)
        moved = kernels.counts() != after_real
        launched = after_real[name]["launches"]
        others = sum(c["launches"] + c["plain_calls"] for c in after_real.values())
        if not (real == fake and launched == 1 and others == 1 and not moved):
            bad.append(f"{name}: abstract specs equal to the kernel's {real == fake}, "
                       f"the real call's launches {launched} of {others} counted "
                       f"(want 1 of 1), the fake copy moved the counters {moved}")
        rows.setdefault(name, []).append({"specs": real, "equal": real == fake,
                                          "launches": launched,
                                          "abstract_moved_counts": moved})
    for name, calls_of in rows.items():
        log(f"phase 15 a) {name}: {len(calls_of)} call(s), output specs (shape, "
            f"dtype, device) {[c['specs'] for c in calls_of]}, abstract equal "
            f"{[c['equal'] for c in calls_of]}, real launches "
            f"{[c['launches'] for c in calls_of]}, abstract moved the counters "
            f"{[c['abstract_moved_counts'] for c in calls_of]}")
    if bad:
        fail("phase 15 a): " + "; ".join(bad))
    t1 = time.perf_counter()
    report = contracts.run_contracts(device="cuda")
    for f in report["failures"]:
        log(f"phase 15 b) FAIL {f}")
    log(f"phase 15 b) contracts: {report['cells']} cells on fake "
        f"{report['fake_device']} tensors, {report['n_failures']} failure(s), "
        f"{time.perf_counter() - t1:.1f}s")
    if report["n_failures"] or report["cells"] != 6 or report["fake_device"] != "cuda":
        fail("phase 15 b): the contract grid failed on fake CUDA tensors")
    return {"a": rows, "a_seconds": t1 - t0, "b_cells": report["cells"],
            "b_failures": report["n_failures"], "b_seconds": time.perf_counter() - t1}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="run the fused and staged serving runs under torch.profiler "
                         "and print device time by kernel (serving numbers then "
                         "include the profiler's overhead)")
    for flag in ("--mesh-rank", "--mesh-world", "--mesh-port"):
        ap.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-one-card", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank is not None:
        # one rank of phase 14 b)'s pair or of c), started by the script itself
        return mesh_rank(args)

    # keep CUPTI set up between profiler sessions: torn down after each
    # one (Kineto's default), about one session in a hundred of phase 4
    # re-initialized it and recorded no event at all
    # (``tools/profiler_loop.py``)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
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
    # the same kernels at phase 9's new shapes (head_dim 256, g * BQ 512,
    # 20 kv heads of group 1)
    fam = check_family_kernels(torch, dev)
    # ... and at phase 10's and 11's (granite's head_dim 64, internvl's
    # group 2, musicgen's 32 kv heads of 64 at group 1)
    late = check_late_kernels(torch, dev)
    phase_done("2")

    cal = calibrate_phase(torch, dev)
    phase_done("2b")

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
    t_fam = time_family_kernels(torch, dev, fam)
    t_late = time_late_kernels(torch, dev, late)
    fam = {k: {"err": f["err"]} for k, f in fam.items()}   # free their inputs
    fam.update({k: {"err": f["err"]} for k, f in late.items()})
    del late
    phase_done("4")
    # phase 4's numbers now, so that a later phase's failure keeps them
    log(f"phase 4 ({card}): " + json.dumps({
        "fused_decode": t_dec, "sparse_prefill": t_pre,
        "centroid_scores_quantized": t_csq, "centroid_scores_f32": t_csf,
        "paged_attention": t_pa, "pool_rank_keys": t_pool, "topk_threshold": t_topk,
        "flash_attention": t_chunk, "flash_attention_sxs": t_flash,
        "paged_identity": t_ident, "phase9_shapes": t_fam, "phase10_11_shapes": t_late}))

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
    phase_done(f"3b and phase 6 ({QWEN})")
    family = serve_family(torch, dev)
    phase_done("9")
    moe_run = serve_moe(torch, dev)
    phase_done("10")
    music = serve_musicgen(torch, dev)
    phase_done("11")
    rec = serve_recurrent(torch, dev)
    phase_done("12")
    train = train_phase(torch, dev, card, out_dir)
    phase_done("13")
    mesh = mesh_phase(torch, dev, dec, pre, out_dir)
    phase_done("14")
    abstract = abstract_phase(torch, dev, abstract_calls(torch, dev, dec, pre, scored,
                                                         att, pool, topk))
    phase_done("15")
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
    log(f"phase 8 summary ({card}): {json.dumps(paths['traced'])}")
    log(f"profiler sessions {PROFILER['sessions']}, recorded again after an empty "
        f"(or, in phase 6, short) first recording {PROFILER['retried']}; every "
        f"recording retaken: {json.dumps(PROFILER['retakes'])}")
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
        # phase 14 a): shard launches, each held bitwise to the whole call
        k["mesh_shard_launches"] = mesh["a"]["launches"].get(k["name"], 0)
        # max_abs_err over the checks at phase 9's, 10's and 11's shapes too
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            f["err"][k["name"]] for f in fam.values() if k["name"] in f["err"]])
        # the served runs of phases 10 and 11: launches, and the times at
        # granite's, internvl's and musicgen's shapes
        k["served_launches"] = {f"{arch} {run}": row["launches"].get(k["name"], 0)
                                for arch, rows in ((GRANITE, moe_run[GRANITE]),
                                                   (INTERNVL, moe_run[INTERNVL]),
                                                   (MUSICGEN, music))
                                for run, row in rows.items()
                                if isinstance(row, dict) and "launches" in row}
        for model_name, times in t_late.items():
            if k["name"] in times:
                t = times[k["name"]]
                k.update({f"{model_name}_{key}": t.get(key) for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    log(f"phase 9 summary ({card}): " + json.dumps(family))
    log(f"phase 10 summary ({card}): " + json.dumps(moe_run))
    log(f"phase 11 summary ({card}): " + json.dumps(music))
    log(f"phase 12 summary ({card}): " + json.dumps(rec))
    log(f"phase 13 summary ({card}): " + json.dumps(train))
    log(f"phase 14 summary ({card}): " + json.dumps(mesh))
    log(f"phase 15 summary ({card}): " + json.dumps(abstract))
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
    log(f"seconds by phase: {json.dumps(phase_seconds())}")
    log(f"total {time.perf_counter() - T_START:.1f}s")
    missed = [f"phase {n}: {m}" for n, run in (("10", moe_run), ("11", music),
                                                 ("12", rec), ("13", train))
              for m in run["missed"]]
    if missed:
        log(f"FAILED gates: {json.dumps(missed)}")
    (out_dir / "chip_smoke.log").write_text("\n".join(LOG) + "\n")
    print(card)
    print(json.dumps({"kernels": kernels_line}))
    if missed:
        fail("; ".join(missed))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
