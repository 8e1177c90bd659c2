"""Chrome trace-event schema validation (counterpart of
``repro.obs.validate``; the tests and ``chip_smoke.py`` use it).

``validate_chrome_trace`` checks the structural invariants a
Perfetto-loadable export must satisfy; the CLI form::

    python -m repro_torch.obs.validate trace.json \
        --require seq.prefill --require seq.decode --counter pool

additionally asserts that named span types / counter tracks / instants are
present: a traced serving run is checked with it for the timeline it
claims to have produced.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Sequence, Tuple

_PHASES = {"X", "B", "E", "i", "C", "M"}


def validate_chrome_trace(
    trace: dict,
    require_spans: Sequence[str] = (),
    require_counters: Sequence[str] = (),
    require_instants: Sequence[str] = (),
) -> List[str]:
    """-> list of violation strings (empty == valid).

    Checks: top-level shape, per-event required keys and phase codes,
    non-negative "X" durations, B/E stack discipline per (pid, tid) track
    (only when the ring reports zero evictions — a truncated ring may
    legitimately retain an "E" whose "B" was evicted), and presence of any
    required span / counter / instant names.
    """
    errors: List[str] = []
    if not isinstance(trace, dict) or not isinstance(
        trace.get("traceEvents"), list
    ):
        return ["top level must be an object with a 'traceEvents' list"]
    events = trace["traceEvents"]
    dropped = (trace.get("otherData") or {}).get("dropped_events", 0)

    spans, counters, instants = set(), set(), set()
    stacks: Dict[Tuple[int, int], List[str]] = {}
    unmatched_ends = 0
    for n, ev in enumerate(events):
        where = f"event[{n}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        missing = {"name", "ph", "ts", "pid", "tid"} - ev.keys()
        # metadata events carry no timestamp requirement
        if ev.get("ph") == "M":
            missing -= {"ts"}
        if missing:
            errors.append(f"{where}: missing keys {sorted(missing)}")
            continue
        ph = ev["ph"]
        if ph not in _PHASES:
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        if ph != "M" and not isinstance(ev["ts"], (int, float)):
            errors.append(f"{where}: non-numeric ts")
            continue
        key = (ev["pid"], ev["tid"])
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                errors.append(f"{where}: 'X' needs a non-negative dur")
            spans.add(ev["name"])
        elif ph == "B":
            spans.add(ev["name"])
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if stack:
                top = stack.pop()
                if top != ev["name"]:
                    errors.append(
                        f"{where}: 'E' {ev['name']!r} closes open span "
                        f"{top!r} on track {key} (stack discipline)"
                    )
            else:
                unmatched_ends += 1
        elif ph == "C":
            counters.add(ev["name"])
            if not isinstance(ev.get("args"), dict) or not ev["args"]:
                errors.append(f"{where}: counter needs non-empty args")
        elif ph == "i":
            instants.add(ev["name"])
    if unmatched_ends and not dropped:
        errors.append(
            f"{unmatched_ends} 'E' events without a matching 'B' "
            "(and the ring reports no evictions)"
        )
    for name in require_spans:
        if name not in spans:
            errors.append(f"required span type {name!r} absent")
    for name in require_counters:
        if name not in counters:
            errors.append(f"required counter track {name!r} absent")
    for name in require_instants:
        if name not in instants:
            errors.append(f"required instant {name!r} absent")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate a Chrome trace-event JSON export"
    )
    ap.add_argument("path")
    ap.add_argument("--require", action="append", default=[],
                    help="span type that must be present (repeatable)")
    ap.add_argument("--counter", action="append", default=[],
                    help="counter track that must be present (repeatable)")
    ap.add_argument("--instant", action="append", default=[],
                    help="instant marker that must be present (repeatable)")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        trace = json.load(f)
    errors = validate_chrome_trace(
        trace, args.require, args.counter, args.instant
    )
    n = len(trace["traceEvents"]) if isinstance(trace, dict) else 0
    if errors:
        for e in errors:
            print(f"INVALID {e}")
        return 1
    print(f"ok: {args.path} valid ({n} events, "
          f"{len(args.require)} required spans present)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
