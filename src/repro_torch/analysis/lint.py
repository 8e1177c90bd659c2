"""Lint engine and CLI: ``python -m repro_torch.analysis.lint PATHS``.

Walks the given paths, parses every ``.py`` file once, runs each
:class:`~repro_torch.analysis.rules.Rule` (per-file hooks, then
project-wide hooks), applies ``# noqa: RPT0xx`` suppression, and reports
RPT008 for every pragma that suppressed nothing.  Exits 1 on any finding
and prints ``clean: 0 findings`` otherwise, as ``repro.analysis.lint``
does.
"""
from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.analysis.pragmas import Pragma, collect_pragmas, suppressed
from repro_torch.analysis.rules import (
    ALL_RULES,
    FileContext,
    Finding,
    Rule,
    UNUSED_PRAGMA_CODE,
)


def _iter_py_files(paths: Sequence[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            out.append(path)
    seen, uniq = set(), []
    for f in out:  # a file listed and inside a listed directory
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            uniq.append(f)
    return uniq


class LintEngine:
    """Runs a rule set over a file tree with pragma suppression."""

    def __init__(self, rules: Optional[Sequence[Rule]] = None):
        self.rules: Sequence[Rule] = tuple(rules) if rules else ALL_RULES

    def run(self, paths: Sequence[str]) -> List[Finding]:
        contexts: List[FileContext] = []
        pragma_maps: Dict[str, Dict[int, Pragma]] = {}
        findings: List[Finding] = []
        for path in _iter_py_files(paths):
            try:
                source = path.read_text()
            except (OSError, UnicodeDecodeError) as e:
                findings.append(Finding("RPT000", f"unreadable: {e}", str(path), 1))
                continue
            try:
                tree = ast.parse(source, filename=str(path))
            except SyntaxError as e:
                findings.append(Finding("RPT000", f"syntax error: {e.msg}",
                                        str(path), e.lineno or 1))
                continue
            contexts.append(FileContext(str(path), source, tree))
            pragma_maps[str(path)] = collect_pragmas(source)

        raw: List[Finding] = []
        for ctx in contexts:
            for rule in self.rules:
                raw.extend(rule.check_file(ctx))
        for rule in self.rules:
            raw.extend(rule.check_project(contexts))
        for f in raw:
            if not suppressed(pragma_maps.get(f.path, {}), f.line, f.code):
                findings.append(f)

        # RPT008: a pragma that suppressed nothing is stale
        for path, pragmas in pragma_maps.items():
            for pragma in pragmas.values():
                for code in pragma.unused_codes:
                    findings.append(Finding(
                        UNUSED_PRAGMA_CODE,
                        f"unused suppression: no {code} finding on this line "
                        "— remove the stale pragma",
                        path, pragma.line,
                    ))
        findings.sort(key=lambda f: (f.path, f.line, f.code))
        return findings


def lint_paths(paths: Sequence[str],
               select: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint ``paths``, with only the given RPT codes' rules when ``select``
    is given (RPT008's pragma accounting always runs)."""
    rules: Optional[List[Rule]] = None
    if select is not None:
        wanted = set(select)
        rules = [r for r in ALL_RULES if r.code in wanted]
    return LintEngine(rules).run(paths)


def _report(findings: List[Finding], fmt: str, n_files: int) -> str:
    if fmt == "json":
        return json.dumps({
            "tool": "repro_torch.analysis.lint",
            "n_files": n_files,
            "n_findings": len(findings),
            "findings": [f.as_dict() for f in findings],
        }, indent=2)
    lines = [f.format() for f in findings]
    lines.append(f"{len(findings)} finding(s) in {n_files} file(s)" if findings
                 else f"clean: 0 findings in {n_files} file(s)")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="The port's PyTorch/CUDA hazard linter (RPT0xx rules).",
    )
    parser.add_argument("paths", nargs="+", help="files or directories")
    parser.add_argument("--format", choices=("text", "json"), default="text",
                        dest="fmt")
    parser.add_argument("--output", default=None,
                        help="also write the JSON report to this path")
    parser.add_argument("--select", default=None,
                        help="comma-separated RPT codes to run (default: all)")
    args = parser.parse_args(argv)
    select = ([c.strip() for c in args.select.split(",") if c.strip()]
              if args.select else None)
    n_files = len(_iter_py_files(args.paths))
    findings = lint_paths(args.paths, select=select)
    print(_report(findings, args.fmt, n_files))
    if args.output:
        Path(args.output).write_text(_report(findings, "json", n_files) + "\n")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
