"""Serving launcher (counterpart of ``repro.launch.serve``): the
scheduler-driven continuous-batching engine over the AB-Sparse decode path
with synthetic request traffic, on one CUDA device (``--device cpu`` runs
the kernels' plain versions on the CPU).

Requests are drawn from ``--prefix-groups`` system-prompt groups: every
request in a group shares a ``--prefix-len``-token prompt prefix, so the
radix prefix cache (page-granular KV reuse) and chunked prefill both get
exercised.  The run ends with the engine's lifecycle-metrics snapshot
(TTFT/TPOT, prefix-hit rate, preemptions) and a page-leak audit.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --smoke --requests 8 --max-batch 4 --device cpu

Observability: ``--trace out.json`` records the full run timeline —
per-sequence lifecycle spans, engine tick spans, memory-tier migrations,
pool/residency/sparsity counter tracks — as Chrome trace-event JSON,
loadable at https://ui.perfetto.dev and checked by
``python -m repro_torch.obs.validate``.  ``--metrics-interval N`` appends a
structured metrics-snapshot JSONL line every N ticks to ``--metrics-out``
(default stdout).  ``--arrival-trace`` serves through the async front-end
with requests arriving mid-flight.

Weights are random (``Transformer.init`` from a generator seeded 0 on the
device).  ``--streams`` prints each request's tokens.

Multi-device serving: ``--mesh DATA,MODEL`` (or ``--mesh auto``, the
model axis capped by the arch's kv heads) under ``torchrun``, one process
per card, batch rows over ``data`` and kv heads over ``model``
(:mod:`repro_torch.distributed`); rank 0 prints and traces:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 1,2 ...

With ``--device cpu`` the processes form a gloo group on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch.config import ServeConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import Transformer
from repro_torch.obs import TraceRecorder
from repro_torch.serving import Engine, Request


def _serve_async(eng, arrivals, tick_cb=None):
    """Drive the continuous-batching front-end with (tick, request)
    arrivals: each request is submitted mid-flight once the engine reaches
    its tick (immediately when the engine idles early — nothing else would
    advance the clock).  -> the retired requests."""
    import asyncio

    from repro_torch.serving import AsyncFrontend

    pending = {}
    for tick, req in arrivals:
        pending.setdefault(tick, []).append(req)

    async def run():
        fe = AsyncFrontend(eng)
        if tick_cb is not None:
            fe.on_tick = lambda f, t: tick_cb(eng, t - 1)
        task = asyncio.create_task(fe.run())
        while pending:
            t = min(pending)
            if fe.ticks >= t or not eng.scheduler.has_work:
                for req in pending.pop(t):
                    fe.submit(req)
            await asyncio.sleep(0)
        await fe.drain()
        fe.shutdown()
        return await task

    return asyncio.run(run())


def main(argv=None):
    """Parse ``argv`` (default: ``sys.argv[1:]``), serve, print the
    summary, audit the page pool -> the engine (for callers in process)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on; 'cpu' runs the plain "
                         "versions of the kernels")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-context", type=int, default=1024)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--prefix-groups", type=int, default=2,
                    help="distinct shared system prompts (0 disables)")
    ap.add_argument("--prefix-len", type=int, default=128,
                    help="shared prefix length in tokens (page-aligned)")
    ap.add_argument("--prefill-chunk", type=int, default=256)
    ap.add_argument("--prefill-budget", type=int, default=512,
                    help="prefill token budget per engine tick")
    ap.add_argument("--sparse-prefill", action="store_true",
                    help="query-block sparse prefill (cuda backend)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve on a (data, model) mesh of torchrun's "
                         "processes: an explicit shape like '2,2', or "
                         "'auto' to derive it from the world size (model "
                         "axis capped by the arch's kv-head count).  "
                         "Default: no mesh (one device)")
    ap.add_argument("--streams", action="store_true",
                    help="print every request's tokens ('stream ID: ...')")
    ap.add_argument("--fused-decode", action="store_true",
                    help="single-launch fused decode (cuda backend)")
    ap.add_argument("--hbm-pages", type=int, default=None,
                    help="hierarchical KV memory: device-resident page "
                         "budget (cold pages spill to the host tier; "
                         "requires the sparse decode path)")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host (offload) tier page budget; only with "
                         "--hbm-pages")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="flat KV pool page budget (undersizing forces "
                         "preemption; mutually exclusive with --hbm-pages)")
    ap.add_argument("--trace", default=None, metavar="OUT.JSON",
                    help="record a Chrome trace-event timeline of the run "
                         "(open in Perfetto); also enables device-side "
                         "sparsity telemetry")
    ap.add_argument("--metrics-interval", type=int, default=0, metavar="N",
                    help="emit a metrics-snapshot JSONL line every N ticks")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="JSONL destination for --metrics-interval "
                         "(default: stdout)")
    ap.add_argument("--chaos-seed", type=int, default=None, metavar="SEED",
                    help="install a seeded FaultInjector running the "
                         "default fault storm (host-I/O failures, NaN "
                         "logits, pool exhaustion, device errors, stuck "
                         "ticks)")
    ap.add_argument("--chaos-plan", default=None, metavar="PLAN.JSON",
                    help="JSON fault plan (list of FaultSpec dicts) to "
                         "inject instead of the default storm; implies "
                         "--chaos-seed 0 unless given")
    ap.add_argument("--slo-class", default="interactive",
                    choices=["interactive", "batch", "deadline", "mixed"],
                    help="SLO class for the generated traffic; 'mixed' "
                         "round-robins all three (EDF admission + "
                         "deadline-aware preemption act on it)")
    ap.add_argument("--deadline-s", type=float, default=30.0,
                    help="completion deadline (seconds) for "
                         "deadline-class requests")
    ap.add_argument("--arrival-trace", default=None, metavar="TRACE.JSON",
                    help="serve through the async continuous-batching "
                         "front-end with arrivals from a JSON trace: a "
                         "list of {tick, prompt_tokens, new_tokens, "
                         "slo_class, deadline_s} objects (missing fields "
                         "fall back to the CLI flags); requests are "
                         "submitted mid-flight at their engine tick")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.sparse_prefill or args.fused_decode:
        cfg = dataclasses.replace(
            cfg,
            sparse=dataclasses.replace(
                cfg.sparse, backend="cuda",
                sparse_prefill=args.sparse_prefill or cfg.sparse.sparse_prefill,
                fused_decode=args.fused_decode or cfg.sparse.fused_decode,
            ),
        )
    device, mesh = torch.device(args.device), None
    if args.mesh is not None:
        from repro_torch.launch.mesh import make_serving_mesh, parse_mesh_arg

        try:
            shape = None if args.mesh == "auto" else parse_mesh_arg(args.mesh)
            mesh = make_serving_mesh(shape, n_kv_heads=cfg.n_kv_heads,
                                     device=device)
        except ValueError as e:
            ap.error(f"--mesh: {e}")
        device = mesh.device
    try:
        return _serve(args, cfg, device, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(args, cfg, device, mesh):
    """Serve ``args``' traffic on ``device`` (this rank's, on ``mesh``)."""
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    if mesh is not None:
        say(f"serving mesh: data={mesh.shape[0]}, model={mesh.shape[1]} "
          f"({mesh.size} processes on {device.type})")
    model = Transformer(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    trace = TraceRecorder() if args.trace and lead else None
    eng = Engine(cfg, model, ServeConfig(
        max_batch=args.max_batch,
        max_context=args.max_context,
        prefill_chunk=args.prefill_chunk,
        prefill_tokens_per_tick=args.prefill_budget,
        pool_pages=args.pool_pages,
        hbm_pages=args.hbm_pages,
        host_pages=args.host_pages,
    ), device=device, mesh=mesh, trace=trace)
    injector = None
    if args.chaos_seed is not None or args.chaos_plan is not None:
        from repro_torch.resilience import FaultInjector, default_storm, load_plan

        specs = (
            load_plan(args.chaos_plan) if args.chaos_plan else default_storm()
        )
        injector = FaultInjector(specs, seed=args.chaos_seed or 0)
        eng.set_fault_injector(injector)
        say(f"chaos: {len(specs)} fault specs armed "
          f"(seed={args.chaos_seed or 0})")
    rng = np.random.default_rng(0)
    prefixes = [
        rng.integers(0, cfg.vocab_size, args.prefix_len).astype(np.int32)
        for _ in range(args.prefix_groups)
    ]

    def _slo_for(rid):
        if args.slo_class == "mixed":
            cls = ["interactive", "batch", "deadline"][rid % 3]
        else:
            cls = args.slo_class
        return cls, (args.deadline_s if cls == "deadline" else None)

    def _mkreq(rid, plen, new_tokens, slo_class=None, deadline_s=None):
        body = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        if prefixes:
            body = np.concatenate([prefixes[rid % len(prefixes)], body])
        if slo_class is None:
            slo_class, deadline_s = _slo_for(rid)
        return Request(rid, body, max_new_tokens=new_tokens,
                       slo_class=slo_class, deadline_s=deadline_s)

    arrivals = None
    if args.arrival_trace is not None:
        with open(args.arrival_trace) as f:
            entries = json.load(f)
        arrivals = []
        for rid, e in enumerate(entries):
            cls = e.get("slo_class")
            arrivals.append((int(e.get("tick", 0)), _mkreq(
                rid,
                int(e.get("prompt_tokens", max(64, args.max_context // 4))),
                int(e.get("new_tokens", args.new_tokens)),
                slo_class=cls,
                deadline_s=e.get(
                    "deadline_s",
                    args.deadline_s if cls == "deadline" else None,
                ),
            )))
        arrivals.sort(key=lambda te: te[0])
    else:
        for rid in range(args.requests):
            plen = int(rng.integers(64, args.max_context // 2))
            eng.submit(_mkreq(rid, plen, args.new_tokens))
    metrics_f = None
    tick_cb = None
    if args.metrics_interval > 0 and lead:
        metrics_f = (
            open(args.metrics_out, "w") if args.metrics_out else sys.stdout
        )

        def tick_cb(engine, tick):
            if (tick + 1) % args.metrics_interval:
                return
            snap = engine.metrics.snapshot()
            snap["tick"] = tick + 1
            metrics_f.write(json.dumps(snap) + "\n")
            metrics_f.flush()

    t0 = time.monotonic()
    try:
        if arrivals is not None:
            done = _serve_async(eng, arrivals, tick_cb)
        else:
            done = eng.run_until_done(tick_callback=tick_cb)
    finally:
        if metrics_f is not None and metrics_f is not sys.stdout:
            metrics_f.close()
    dt = time.monotonic() - t0
    if trace is not None:
        trace.dump(args.trace)
        say(f"trace: {len(trace)} events -> {args.trace} "
            f"(open at https://ui.perfetto.dev)")
    if args.streams:
        for r in sorted(done, key=lambda r: r.req_id):
            say(f"stream {r.req_id}: {' '.join(str(t) for t in r.output)}")
    total = sum(len(r.output) for r in done)
    plan = model.attention_plan(args.max_context)
    say(f"served {len(done)} requests / {total} tokens in {dt:.1f}s "
        f"({total / dt:.1f} tok/s); sparse path: {plan.active} "
        f"(backend={plan.backend}, "
        f"sparse_prefill={plan.active and cfg.sparse.sparse_prefill})")
    say(f"metrics: {eng.metrics.format_snapshot()}")
    snap = eng.metrics.snapshot()
    for cls, m in snap["per_class"].items():
        say(f"  slo[{cls}]: finished={m['finished']} "
            f"ttft p50/p99={m['ttft_p50'] * 1e3:.0f}/"
            f"{m['ttft_p99'] * 1e3:.0f}ms "
            f"tpot p99={m['tpot_p99'] * 1e3:.1f}ms "
            f"deadline_miss={m['deadline_misses']} "
            f"({100 * m['deadline_miss_rate']:.0f}%)")
    if injector is not None:
        snap = eng.metrics.snapshot()
        failed = [r for r in done if r.status == "failed"]
        say(f"chaos: injected={injector.snapshot()} "
            f"retries={snap['retries']:.0f} "
            f"restores={snap['checkpoints_restored']:.0f} "
            f"degradations={snap['degradations']:.0f} "
            f"watchdog={snap['watchdog_fires']:.0f}")
        for r in failed:
            say(f"chaos: request {r.req_id} FAILED: {r.failure}")
        lost = args.requests - len(done)
        assert lost == 0, f"chaos: {lost} requests lost (never retired)"
    known = eng.prefix_cache.pages() if eng.prefix_cache else set()
    leaks = eng.pool.assert_consistent(known_pins=known)
    assert not leaks, f"leaked pages at drain: {leaks}"
    cached = eng.prefix_cache.n_pages if eng.prefix_cache else 0
    assert eng.pool.used_pages == cached, "page leak at drain"
    say(f"pool: {eng.pool.used_pages}/{eng.pool.total_pages} pages held "
        f"({cached} prefix-cache pins), accounting clean")
    return eng


if __name__ == "__main__":
    main()
