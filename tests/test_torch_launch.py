"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU.

- ``main([...])`` serves the smoke model through the async front-end from
  an arrival trace with tracing and periodic metrics on: it finishes,
  passes its own page-pool audit, writes a trace that
  ``repro_torch.obs.validate.main`` accepts and metrics JSONL, and prints
  JAX's summary lines.
- The requests it builds from a set of flags (ids, prompts, new tokens,
  SLO class, deadline, arrival tick) and the ``ServeConfig`` it serves
  with equal those of JAX's launcher (``repro.launch.serve``) for the same
  flags: both launchers run with their engine and ``_serve_async``
  replaced by recorders (``monkeypatch``; nothing in ``src/repro``
  changes).
- ``--arch qwen1.5-4b --smoke`` serves to the end, and ``--arch`` takes
  every ``("attn",)`` decoder of the JAX package (dense, MoE, vision and
  audio);
- under ``torchrun`` (``python -m torch.distributed.run``) with 2 CPU
  processes, ``--mesh 1,2`` prints the single-process launcher's token
  streams; ``--mesh 2,2`` over 2 processes, or in one, exits with an error
  naming the world size.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro.launch import serve as jserve

from repro_torch.launch import serve as tserve
from repro_torch.obs import validate

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU ops on one thread: the suite runs in parallel
    workers, and torch's default pool (a thread per core in every worker)
    oversubscribes the cores and slows these small ops several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrivals(path, entries):
    path.write_text(json.dumps(entries))
    return str(path)


def test_launcher_serves_arrivals_traced(tmp_path, capsys):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.jsonl"
    arrivals = _arrivals(tmp_path / "arrivals.json", [
        {"tick": 0, "prompt_tokens": 200}, {"tick": 0, "prompt_tokens": 100},
        {"tick": 2, "prompt_tokens": 300, "new_tokens": 3},
        {"tick": 5, "prompt_tokens": 64, "slo_class": "deadline", "deadline_s": 5.0}])
    eng = tserve.main([
        "--smoke", "--device", "cpu", "--fused-decode", "--sparse-prefill",
        "--max-context", "512", "--max-batch", "2", "--prefill-chunk", "128",
        "--new-tokens", "5", "--prefix-len", "64", "--slo-class", "mixed",
        "--trace", str(trace), "--metrics-interval", "2",
        "--metrics-out", str(metrics), "--arrival-trace", arrivals])
    out = capsys.readouterr().out
    assert [len(r.output) for r in sorted(eng.finished, key=lambda r: r.req_id)] == [
        5, 5, 3, 5]
    assert all(r.status == "ok" for r in eng.finished)
    assert "served 4 requests / 18 tokens" in out
    assert "sparse path: True (backend=cuda, sparse_prefill=True)" in out
    assert "accounting clean" in out and "slo[deadline]: finished=2" in out
    argv = [str(trace)]
    for flag, names in (("--require", ("engine.tick", "engine.decode", "prefill.chunk",
                                       "seq.queued", "seq.prefill", "seq.decode")),
                        ("--counter", ("pool", "queue", "sparsity")),
                        ("--instant", ("sched.admit", "prefix.match", "prefix.hit"))):
        for n in names:
            argv += [flag, n]
    assert validate.main(argv) == 0
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert lines and [x["tick"] for x in lines] == list(
        range(2, 2 * len(lines) + 1, 2))
    assert lines[-1]["ticks"] == lines[-1]["tick"]


class _Captured(Exception):
    pass


def _capture(monkeypatch, mod, argv):
    """Run ``mod.main`` with its engine and async server replaced by
    recorders -> (ServeConfig fields, [(arrival tick or None, request)])."""
    got = {"reqs": []}

    class Engine:
        def __init__(self, cfg, weights, serve_cfg, **kw):
            got["serve"] = dataclasses.asdict(serve_cfg)
            got["cfg"] = cfg
            self.scheduler = SimpleNamespace(has_work=False)

        def set_fault_injector(self, injector):
            got["faults"] = len(injector.specs)

        def submit(self, req):
            got["reqs"].append((None, req))

        def run_until_done(self, **kw):
            raise _Captured

    def serve_async(eng, arrivals, tick_cb=None):
        got["reqs"].extend(arrivals)
        raise _Captured

    class Model:
        def __init__(self, *a, **k):
            pass

        def init(self, *a):
            return self

    monkeypatch.setattr(mod, "Engine", Engine)
    monkeypatch.setattr(mod, "_serve_async", serve_async)
    monkeypatch.setattr(mod, "Transformer", Model)
    with pytest.raises(_Captured):
        if mod is jserve:
            monkeypatch.setattr(sys, "argv", ["serve"] + argv)
            mod.main()
        else:
            mod.main(argv + ["--device", "cpu"])
    reqs = [(t, r.req_id, r.prompt.tolist(), r.prompt.dtype.name, r.max_new_tokens,
             r.slo_class, r.deadline_s) for t, r in got["reqs"]]
    return got["serve"], reqs, got.get("faults"), got["cfg"].sparse


@pytest.mark.parametrize("flags", [
    ["--smoke", "--requests", "5", "--max-context", "512", "--slo-class", "mixed",
     "--prefix-groups", "3", "--prefix-len", "32", "--new-tokens", "7",
     "--pool-pages", "40", "--prefill-budget", "256", "--chaos-seed", "3"],
    ["--smoke", "--prefix-groups", "0", "--slo-class", "deadline",
     "--deadline-s", "4.5", "--hbm-pages", "30", "--host-pages", "20",
     "--fused-decode", "--sparse-prefill", "ARRIVALS"],
    ["--requests", "3", "--max-batch", "2", "--prefill-chunk", "128",
     "--slo-class", "batch", "--sparse-prefill", "ARRIVALS"],
], ids=["synthetic", "arrivals", "full-width-arrivals"])
def test_requests_equal_jax_launchers(flags, tmp_path, monkeypatch):
    """Same flags, same requests (arrival ticks included), same serving
    configuration, same fault plan size and sparse settings (the port's
    ``"cuda"`` backend where JAX's is ``"pallas"``)."""
    if "ARRIVALS" in flags:
        path = _arrivals(tmp_path / "a.json", [
            {"tick": 4, "prompt_tokens": 90, "new_tokens": 2},
            {"tick": 0},
            {"tick": 4, "slo_class": "interactive", "prompt_tokens": 33},
            {"prompt_tokens": 70, "slo_class": "deadline"},
            {"tick": 1, "slo_class": "batch", "deadline_s": 9.0}])
        i = flags.index("ARRIVALS")
        flags = flags[:i] + ["--arrival-trace", path] + flags[i + 1:]
    t_serve, t_reqs, t_faults, t_sparse = _capture(monkeypatch, tserve, flags)
    j_serve, j_reqs, j_faults, j_sparse = _capture(monkeypatch, jserve, flags)
    assert t_reqs == j_reqs and len(t_reqs) >= 3
    assert t_faults == j_faults
    assert {k: v for k, v in t_serve.items() if k != "resilience"} == {
        k: j_serve[k] for k in t_serve if k != "resilience"}
    assert t_serve["resilience"] == j_serve["resilience"]
    t_sp, j_sp = dataclasses.asdict(t_sparse), dataclasses.asdict(j_sparse)
    assert t_sp.pop("backend") == ("cuda" if j_sp.pop("backend") == "pallas"
                                   else "reference")
    assert t_sp == {k: j_sp[k] for k in t_sp}


def test_launcher_serves_another_arch(capsys):
    """``--arch qwen1.5-4b --smoke`` (QKV bias, MHA: 4 / 4 heads) serves to
    the end on the CPU, and every config of the JAX package (dense, MoE,
    vision, audio and the recurrent families) is one ``--arch`` takes."""
    from repro.configs import list_archs as j_list_archs
    from repro_torch.configs import list_archs

    assert set(list_archs()) == set(j_list_archs())
    eng = tserve.main([
        "--arch", "qwen1.5-4b", "--smoke", "--device", "cpu", "--fused-decode",
        "--requests", "3", "--max-context", "512", "--max-batch", "2",
        "--prefill-chunk", "128", "--new-tokens", "4", "--prefix-len", "64"])
    out = capsys.readouterr().out
    assert eng.model.cfg.name == "qwen1.5-4b-smoke" and eng.model.cfg.qkv_bias
    assert eng.model.cfg.n_kv_heads == eng.model.cfg.n_heads == 4
    assert [len(r.output) for r in eng.finished] == [4, 4, 4]
    assert all(r.status == "ok" for r in eng.finished)
    assert "served 3 requests / 12 tokens" in out and "accounting clean" in out


def test_mesh_is_not_ported(capsys):
    """``--mesh`` with a shape that is not the world's (one process here)
    exits with an error naming the world size."""
    with pytest.raises(SystemExit) as ei:
        tserve.main(["--smoke", "--device", "cpu", "--mesh", "2,2"])
    assert ei.value.code != 0
    assert "needs 4 processes; the world size is 1" in capsys.readouterr().err


LAUNCH = ["-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
          "--requests", "3", "--max-context", "256", "--max-batch", "2",
          "--prefill-chunk", "64", "--new-tokens", "4", "--prefix-len", "32",
          "--fused-decode", "--sparse-prefill", "--streams"]


def _launch(args, nproc=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = ([] if nproc is None else
           ["-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={nproc}"])
    if nproc is not None:
        args = args[1:]       # torchrun takes the module after -m
        run += ["-m"]
    return subprocess.run([sys.executable] + run + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_torchrun_mesh_streams_equal_one_process():
    """Two gloo processes at ``--mesh 1,2`` print the streams of one
    process without a mesh, once (rank 0); ``--mesh 2,2`` over two
    processes names the world size."""
    one = _launch(LAUNCH)
    two = _launch(LAUNCH + ["--mesh", "1,2"], nproc=2)
    assert one.returncode == 0, one.stderr[-2000:]
    assert two.returncode == 0, two.stderr[-3000:]
    streams = lambda out: [l for l in out.splitlines() if l.startswith("stream ")]
    assert len(streams(one.stdout)) == 3
    assert streams(two.stdout) == streams(one.stdout)
    assert "serving mesh: data=1, model=2 (2 processes on cpu)" in two.stdout
    assert two.stdout.count("accounting clean") == 1
    bad = _launch(LAUNCH + ["--mesh", "2,2"], nproc=2)
    assert bad.returncode != 0
    assert "mesh 2,2 needs 4 processes; the world size is 2" in bad.stderr


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b"])
def test_launcher_serves_the_recurrent_families(arch, capsys):
    """``--arch`` takes both recurrent families: their smoke variants serve
    to the end on the CPU, each prompt prefilled in one shot (no chunks,
    no prefix cache)."""
    eng = tserve.main([
        "--arch", arch, "--smoke", "--device", "cpu", "--fused-decode",
        "--requests", "3", "--max-context", "256", "--max-batch", "2",
        "--prefill-chunk", "64", "--new-tokens", "4", "--prefix-len", "32"])
    out = capsys.readouterr().out
    assert eng.model.cfg.name == f"{arch}-smoke"
    assert not eng._chunkable and eng.prefix_cache is None
    assert [len(r.output) for r in eng.finished] == [4, 4, 4]
    assert all(r.status == "ok" for r in eng.finished)
    assert "served 3 requests / 12 tokens" in out and "accounting clean" in out
