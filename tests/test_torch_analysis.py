"""The port's linter (``repro_torch.analysis``: the RPT rules, pragmas,
engine and CLI), held against JAX's (``repro.analysis``) where the two
share a meaning.

RPT004, RPT005, RPT006 and RPT008 run beside JAX's engine on the same
sources and must report the same lines.  RPT001, RPT003 and RPT007 run on
``tests/fixtures/torch_analysis``, a translation of JAX's seeded fixture
with ``jnp`` made ``torch`` at the same lines, and fire at JAX's lines.
Every rule has a firing and a clean case.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint_paths as jax_lint
from repro_torch.analysis import ALL_RULES, LintEngine, lint_paths
from repro_torch.analysis.lint import main as lint_main
from repro_torch.analysis.pragmas import collect_pragmas, suppressed

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"


def lint_source(tmp_path, source, name="mod.py", select=None):
    f = tmp_path / name
    f.write_text(textwrap.dedent(source))
    return lint_paths([str(f)], select=select)


def codes(findings):
    return sorted({f.code for f in findings})


def both(tmp_path, source, n):
    """(JAX's RPR00n lines, the port's RPT00n lines) on one source."""
    f = tmp_path / "shared.py"
    f.write_text(textwrap.dedent(source))
    j = [(x.line, x.code[3:]) for x in jax_lint([str(f)], select=[f"RPR00{n}"])]
    t = [(x.line, x.code[3:]) for x in lint_paths([str(f)], select=[f"RPT00{n}"])]
    return j, t


# ---------------------------------------------------------------------------
# against JAX's engine on shared sources
# ---------------------------------------------------------------------------

SHARED = {
    4: ["""
        import asyncio
        import time

        def run_sync(engine):
            engine.step()

        async def run(engine, worker):
            engine.step()
            time.sleep(1)
            worker.join()
            open("f")
            def deferred():
                time.sleep(1)
            await asyncio.sleep(0)
            engine.run_until_done()
            return deferred
        """],
    5: ["""
        class Engine:
            def tick(self, tokens):
                out = self._rung_step_fns(0)[0](tokens)
                self._fault.check_raise("decode", tick=0)
                return out

            def good(self, tokens):
                self._fault.check_raise("decode", tick=0)
                return self.decode_step_fn(tokens)

            def late(self, tokens):
                out = self.prefill_step_fn(tokens)
                self._fault.check_raise("prefill", tick=0)
                return out
        """],
}


@pytest.mark.parametrize("n", sorted(SHARED))
def test_shared_rules_report_jaxs_lines(tmp_path, n):
    for src in SHARED[n]:
        j, t = both(tmp_path, src, n)
        assert j and j == t


def test_rpt006_reports_jaxs_lines(tmp_path):
    (tmp_path / "config.py").write_text(textwrap.dedent("""
        from dataclasses import dataclass

        @dataclass
        class SparseConfig:
            token_budget: int = 4096
            ghost_knob: int = 0

            def budget_for(self, n):
                return self.token_budget

        @dataclass
        class ServeConfig:
            max_batch: int = 4
            spare: int = 0
        """))
    (tmp_path / "user.py").write_text("def b(cfg):\n    return cfg.max_batch\n")
    j = [(f.line, f.message) for f in jax_lint([str(tmp_path)], select=["RPR006"])]
    t = [(f.line, f.message) for f in lint_paths([str(tmp_path)], select=["RPT006"])]
    assert [x[0] for x in t] == [x[0] for x in j] == [7, 15]
    assert "ghost_knob" in t[0][1] and "spare" in t[1][1]
    assert lint_paths([str(tmp_path / "user.py")], select=["RPT006"]) == []


def test_rpt008_and_shared_pragma_in_both_engines(tmp_path):
    src = """
        async def run(engine):
            engine.step()  # noqa: RPR004, RPT004
            engine.step()  # noqa: RPR004
            engine.step()  # noqa: RPT004
            x = 1  # noqa: RPR004, RPT004
        """
    f = tmp_path / "p.py"
    f.write_text(textwrap.dedent(src))
    j = sorted((x.line, x.code) for x in jax_lint([str(f)]))
    t = sorted((x.line, x.code) for x in lint_paths([str(f)]))
    # the shared pragma suppresses in both; each engine sees only its code
    assert j == [(5, "RPR004"), (6, "RPR008")]
    assert t == [(4, "RPT004"), (6, "RPT008")]
    assert [x[0] for x in j if x[1].endswith("8")] == [x[0] for x in t if x[1].endswith("8")]


# ---------------------------------------------------------------------------
# the translated fixture: RPT001, RPT003, RPT007 at JAX's lines
# ---------------------------------------------------------------------------


def test_translated_fixture_fires_at_jaxs_lines():
    j = {(f.code[3:], f.line) for f in jax_lint([str(FIXTURES / "analysis")])}
    t = {(f.code[3:], f.line) for f in LintEngine().run([str(FIXTURES / "torch_analysis")])}
    for n in ("001", "003", "007"):
        assert {ln for c, ln in t if c == n} == {ln for c, ln in j if c == n}, n
    assert {c for c, _ in t} == {f"00{i}" for i in range(1, 9)}


def test_seeded_fixture_fires_every_rule():
    found = LintEngine().run([str(FIXTURES / "torch_analysis")])
    assert codes(found) == [f"RPT00{i}" for i in range(1, 9)]
    assert [r.code for r in ALL_RULES] == [f"RPT00{i}" for i in range(1, 8)]


# ---------------------------------------------------------------------------
# each rule: firing and clean
# ---------------------------------------------------------------------------


def test_rpt001_cached_tensor_fires_and_host_values_are_clean(tmp_path):
    found = lint_source(tmp_path, """
        import functools
        import torch as th
        from repro_torch.core.stacked import as_arrays

        @functools.lru_cache(maxsize=16)
        def layout_arrays(layout, device):
            return as_arrays(layout, device)

        @functools.cache
        def table(n):
            return th.zeros((n,))

        class Plan:
            @functools.cached_property
            def on_card(self):
                return self.host.to("cuda")
        """, select=["RPT001"])
    assert [f.line for f in found] == [8, 12, 17]
    clean = lint_source(tmp_path, """
        import functools
        import numpy as np
        import torch

        @functools.lru_cache(maxsize=None)
        def sm_count(dev: torch.device) -> int:
            return torch.cuda.get_device_properties(dev).multi_processor_count

        @functools.lru_cache
        def offsets(n):
            return np.arange(n)

        def uncached(n):
            return torch.zeros((n,))
        """, name="clean.py", select=["RPT001"])
    assert clean == []


def test_rpt002_read_after_replay_fires(tmp_path):
    found = lint_source(tmp_path, """
        import torch
        from repro_torch.serving.graphs import DecodeGraph

        def twice(model, cache, a, b):
            g = DecodeGraph(model, cache)
            first, cache = g(cache, a)
            second, cache = g(cache, b)
            return first - second

        def raw(static_out):
            graph = torch.cuda.CUDAGraph()
            out = graph.replay()
            graph.replay()
            return out
        """, select=["RPT002"])
    assert [(f.line, "first" in f.message) for f in found] == [(9, True), (15, False)]


def test_rpt002_clone_or_rebind_is_clean(tmp_path):
    assert lint_source(tmp_path, """
        from repro_torch.serving.graphs import DecodeGraph

        def twice(model, cache, a, b):
            g = DecodeGraph(model, cache)
            first, cache = g(cache, a)
            first = first.clone()
            second, cache = g(cache, b)
            return first - second, cache

        def step_graph_loop(step_graph, cache, toks):
            logits, cache = step_graph(cache, toks)
            kept = logits.argmax(-1)
            logits, cache = step_graph(cache, kept)
            return logits, cache
        """, select=["RPT002"]) == []


def test_rpt003_fires_in_zones_and_stacked_is_sanctioned(tmp_path):
    found = lint_source(tmp_path, """
        import torch
        import numpy as np

        class RaggedLayout:
            def offsets(self):
                return torch.cumsum(torch.tensor(self.sizes), 0)

        class AttentionPlan:
            def stacked(self, device):
                return torch.as_tensor(self.rows, device=device)

        def layout_for(sizes):
            return np.asarray(sizes), torch.zeros(3)
        """, select=["RPT003"])
    assert [f.line for f in found] == [7, 7, 14]
    assert lint_source(tmp_path, """
        import torch

        def as_arrays(layout, device):
            return torch.as_tensor(layout.rows, device=device)
        """, name="clean.py", select=["RPT003"]) == []


def test_rpt004_device_waits_fire_and_offloop_is_clean(tmp_path):
    found = lint_source(tmp_path, """
        import torch

        async def drain(self, ev):
            torch.cuda.synchronize()
            ev.synchronize()
            n = self.counts.item()
            rows = self.cache["_ptel"].cpu().numpy()
            return self.buf.tolist(), n, rows
        """, select=["RPT004"])
    assert [f.line for f in found] == [5, 6, 7, 8, 9]
    assert lint_source(tmp_path, """
        import asyncio
        import torch

        async def drain(self):
            await asyncio.to_thread(torch.cuda.synchronize)
            def later():
                return self.counts.item()
            return later
        """, name="clean.py", select=["RPT004"]) == []


def test_rpt005_graph_replay_before_injection_fires(tmp_path):
    found = lint_source(tmp_path, """
        class Engine:
            def tick(self, cache, tokens):
                logits, cache = self.decode_graph(cache, tokens)
                self._fault.check_raise("decode", tick=0)
                return logits

            def ok(self, cache, tokens):
                self._fault.check_raise("decode", tick=0)
                self._graph.replay()
                return cache
        """, select=["RPT005"])
    assert [f.line for f in found] == [4]


def test_rpt007_device_tensors_at_import_fire_host_ones_are_clean(tmp_path):
    found = lint_source(tmp_path, """
        import torch

        DEV = torch.device("cuda")
        N_SM = torch.cuda.get_device_properties(0).multi_processor_count
        SINK = torch.zeros((4,), device="cuda:0")
        TABLE = torch.arange(4).cuda()
        ANY = torch.ones(2, device=DEV)
        """, select=["RPT007"])
    assert [f.line for f in found] == [5, 6, 7, 8]
    assert lint_source(tmp_path, """
        import torch

        DEV = torch.device("cuda")
        HOST = torch.zeros((4,))
        META = torch.empty((4,), device="meta")
        CPU = torch.ones(2, device=torch.device("cpu"))
        DT = torch.bfloat16

        def make():
            return torch.zeros((4,), device="cuda")
        """, name="clean.py", select=["RPT007"]) == []


# ---------------------------------------------------------------------------
# pragmas, RPT008, RPT000
# ---------------------------------------------------------------------------


def test_pragma_suppresses_and_unused_pragma_reports_rpt008(tmp_path):
    assert lint_source(tmp_path, """
        import torch

        def build_plan(cfg, n):
            return torch.arange(n)  # noqa: RPT003
        """) == []
    found = lint_source(tmp_path, """
        import numpy as np

        def build_plan(cfg, n):
            return np.arange(n)  # noqa: RPT003
        """, name="stale.py")
    assert codes(found) == ["RPT008"]
    found = lint_source(tmp_path, """
        import torch

        def build_plan(cfg, n):
            return torch.arange(n)  # noqa: RPT001
        """, name="wrong.py")
    assert codes(found) == ["RPT003", "RPT008"]


def test_bare_foreign_and_jax_noqa_pass_through(tmp_path):
    found = lint_source(tmp_path, """
        import torch

        def build_plan(cfg, n):
            a = torch.arange(n)  # noqa
            b = torch.arange(n)  # noqa: F401
            c = torch.arange(n)  # noqa: RPR003
            return a, b, c
        """)
    assert [f.code for f in found] == ["RPT003"] * 3


def test_pragma_in_string_literal_is_not_a_pragma():
    pragmas = collect_pragmas('x = "# noqa: RPT001"\ny = 1  # noqa: RPR002, RPT002\n')
    assert list(pragmas) == [2]
    assert pragmas[2].codes == frozenset({"RPT002"})
    assert suppressed(pragmas, 2, "RPT002") and pragmas[2].unused_codes == []
    assert not suppressed(pragmas, 1, "RPT001")


def test_syntax_error_is_reported_not_crashed(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    assert [f.code for f in lint_paths([str(bad)])] == ["RPT000"]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_json_report_and_exit_codes(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = lint_main([str(FIXTURES / "torch_analysis"), "--format", "json",
                    "--output", str(out)])
    printed = json.loads(capsys.readouterr().out)
    assert rc == 1
    report = json.loads(out.read_text())
    assert report == printed
    assert report["tool"] == "repro_torch.analysis.lint"
    assert report["n_files"] == 1
    assert report["n_findings"] == len(report["findings"]) == 14
    assert lint_main([str(FIXTURES / "torch_analysis"), "--select", "RPT007"]) == 1
    assert "RPT007" in capsys.readouterr().out
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert lint_main([str(clean)]) == 0
    assert "clean: 0 findings in 1 file(s)" in capsys.readouterr().out


def test_cli_module_entrypoint_on_port_tree_is_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(ROOT / "src" / "repro_torch")],
        capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean: 0 findings" in proc.stdout
