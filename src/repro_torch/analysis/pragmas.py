"""``# noqa: RPT0xx`` pragma parsing and suppression accounting (the port's
copy of ``repro.analysis.pragmas``, with the port's code prefix).

Only RPT codes are handled here: a bare ``# noqa``, foreign codes
(``F401`` ...) and the JAX linter's ``RPR`` codes pass through untouched,
so ``# noqa: RPR004, RPT004`` serves both linters on one line.  A pragma
that suppresses nothing is itself a finding (RPT008, reported by the
engine): a stale suppression is how a real violation sneaks back in.
"""
from __future__ import annotations

import re
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from typing import Dict, FrozenSet, List

#: a pragma comment: "# noqa: RPT001" or "# noqa: RPR004, RPT004", possibly
#: mixed with foreign codes, of which only the RPT codes are taken.
#: Anchored at the comment's start, so prose that merely mentions the
#: syntax never registers as a suppression.
_NOQA_RE = re.compile(
    r"\A#\s*noqa\s*:\s*(?P<codes>[A-Z0-9,\s]+)", re.IGNORECASE
)
_RPT_RE = re.compile(r"\bRPT\d{3}\b")


@dataclass
class Pragma:
    line: int
    codes: FrozenSet[str]
    used: set = field(default_factory=set)

    @property
    def unused_codes(self) -> List[str]:
        return sorted(self.codes - self.used)


def collect_pragmas(source: str) -> Dict[int, Pragma]:
    """-> {line: Pragma} for every ``# noqa: RPT...`` comment in ``source``.

    Read from the tokens, not from raw lines, so a string literal holding
    the pragma's text never registers as a suppression."""
    pragmas: Dict[int, Pragma] = {}
    try:
        for tok in tokenize.generate_tokens(StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _NOQA_RE.search(tok.string)
            if not m:
                continue
            codes = frozenset(_RPT_RE.findall(m.group("codes").upper()))
            if codes:
                pragmas[tok.start[0]] = Pragma(tok.start[0], codes)
    except tokenize.TokenError:
        pass  # the AST parse reports the syntax error
    return pragmas


def suppressed(pragmas: Dict[int, Pragma], line: int, code: str) -> bool:
    """True (and the pragma marked used) when ``code`` at ``line`` is
    covered by a pragma on the same line."""
    p = pragmas.get(line)
    if p is not None and code in p.codes:
        p.used.add(code)
        return True
    return False
