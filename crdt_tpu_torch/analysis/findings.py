"""Finding model, suppression comments, report rendering (crdtlint).

Copied from ``crdt_tpu/analysis/findings.py``.

A :class:`Finding` is one analyzer verdict pinned to a location: a
source line for the host linter, a pseudo-path like ``<audit:target>``
or ``<law:target>`` for the device-side auditors. Findings are data —
the CLI decides rendering and exit codes, tests assert on them
directly.

Suppression syntax (host-linter findings only — op-audit/law findings
name no source line to hang a comment on)::

    x = risky_call()  # crdtlint: disable=rule-id -- why this is safe
    # crdtlint: disable=rule-a,rule-b -- reason covering the next line
    y = other_call()

A suppression comment applies to its own line and the line directly
below it, so both trailing and line-above placements work. The
``-- reason`` is required: an unexplained suppression is itself a
finding (``suppression-without-reason``) — the whole point of the
comment is to record the uniqueness/safety argument next to the code
that depends on it.
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional

_SUPPRESS_RE = re.compile(
    r"#\s*crdtlint:\s*disable=([a-z0-9_\-]+(?:\s*,\s*[a-z0-9_\-]+)*)"
    r"(\s*--\s*\S.*)?$")


@dataclass(frozen=True)
class Finding:
    """One analyzer verdict. ``line`` is 1-based; 0 for findings that
    are not pinned to source (law counterexamples, op-audit hazards)."""

    rule: str
    path: str
    line: int
    message: str
    detail: str = ""

    def format(self) -> str:
        head = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if not self.detail:
            return head
        body = "\n".join("    " + ln for ln in self.detail.splitlines())
        return head + "\n" + body


@dataclass
class Suppressions:
    """Per-file suppression map: line -> rule ids suppressed there."""

    by_line: Dict[int, FrozenSet[str]] = field(default_factory=dict)
    #: suppression comments missing the mandatory ``-- reason``
    unexplained: List[int] = field(default_factory=list)

    def covers(self, rule: str, line: int) -> bool:
        return rule in self.by_line.get(line, frozenset())


def parse_suppressions(text: str) -> Suppressions:
    """Scan source text for ``# crdtlint: disable=...`` comments.

    A comment at line L suppresses the named rules at L (trailing
    comment) and L+1 (comment-above placement)."""
    supp = Suppressions()
    for lineno, raw in enumerate(text.splitlines(), start=1):
        m = _SUPPRESS_RE.search(raw)
        if m is None:
            continue
        if m.group(2) is None:
            supp.unexplained.append(lineno)
            continue
        rules = frozenset(r.strip() for r in m.group(1).split(",")
                          if r.strip())
        for at in (lineno, lineno + 1):
            supp.by_line[at] = supp.by_line.get(at, frozenset()) | rules
    return supp


def apply_suppressions(findings: Iterable[Finding], supp: Suppressions,
                       path: str) -> List[Finding]:
    """Drop findings covered by suppression comments; surface any
    suppression comment that carries no reason as its own finding."""
    kept = [f for f in findings if not supp.covers(f.rule, f.line)]
    for lineno in supp.unexplained:
        kept.append(Finding(
            rule="suppression-without-reason", path=path, line=lineno,
            message="crdtlint suppression without a '-- reason'; "
                    "record why the rule is safe to silence here"))
    return kept


def render_human(findings: List[Finding],
                 summary: Optional[str] = None) -> str:
    lines = [f.format() for f in findings]
    if summary:
        lines.append(summary)
    if findings:
        lines.append(f"{len(findings)} finding"
                     f"{'s' if len(findings) != 1 else ''}")
    return "\n".join(lines)


def render_json(findings: List[Finding], **extra) -> str:
    payload = {"findings": [asdict(f) for f in findings],
               "ok": not findings}
    payload.update(extra)
    return json.dumps(payload, indent=2, sort_keys=True)
