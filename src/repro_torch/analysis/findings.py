"""Findings, severities, and the suppression protocol shared by every
analyzer in ``repro_torch.analysis``: the port's own copy of
``repro/analysis/findings.py`` (same syntax, same CHK-NOQA rule).

A finding is anchored to a (file, line) so it can be SUPPRESSED in
source with a justified noqa comment on the flagged line or in the
contiguous comment block immediately above it:

    # repro: noqa[CHK-STATIC] call sites only ever pass module-level
    #   functions here, so the per-closure retrace cannot trigger.

The justification is REQUIRED: a bare ``# repro: noqa[CHK-X]`` does not
suppress — it is itself reported as a CHK-NOQA error.  Several IDs may
be suppressed at once (``noqa[CHK-A,CHK-B] why``).  Suppressions are
per-line, never per-file, so a new instance of an old problem is always
a new finding.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Tuple

ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES = (ERROR, WARNING, INFO)

NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa\[([A-Z0-9\-,\s]+)\]\s*(.*)")


@dataclasses.dataclass
class Finding:
    """One analyzer result: ``check`` is the stable ID (catalogued in
    ``repro_torch.analysis.CHECKS``), ``path``/``line`` anchor it for
    suppression."""

    check: str
    severity: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    justification: str = ""

    def format(self) -> str:
        tag = "suppressed: " if self.suppressed else ""
        return (f"{self.path}:{self.line}: {tag}{self.severity} "
                f"[{self.check}] {self.message}")


def _noqa_at(lines: List[str], lineno: int
             ) -> Optional[Tuple[Tuple[str, ...], str]]:
    """The noqa directive governing ``lineno`` (1-based): on the line
    itself, or in the contiguous run of comment-only lines immediately
    above it.  Returns (check_ids, justification) or None.  The
    justification is the text after the bracket plus any continuation
    comment lines below the marker within the same comment block."""
    if not 1 <= lineno <= len(lines):
        return None

    def parse(i: int) -> Optional[Tuple[Tuple[str, ...], str]]:
        m = NOQA_RE.search(lines[i - 1])
        if not m:
            return None
        ids = tuple(s.strip() for s in m.group(1).split(",") if s.strip())
        just = m.group(2).strip()
        # continuation comment lines extend the justification
        j = i + 1
        while j <= len(lines) and j != lineno:
            stripped = lines[j - 1].strip()
            if not stripped.startswith("#") or NOQA_RE.search(stripped):
                break
            just = (just + " " + stripped.lstrip("# ")).strip()
            j += 1
        return ids, just

    hit = parse(lineno)
    if hit:
        return hit
    i = lineno - 1
    while i >= 1 and lines[i - 1].strip().startswith("#"):
        hit = parse(i)
        if hit:
            return hit
        i -= 1
    return None


def apply_suppressions(findings: Iterable[Finding],
                       sources: Optional[Dict[str, List[str]]] = None
                       ) -> List[Finding]:
    """Resolve noqa directives against each finding's source location.

    Suppressed findings are kept (marked, with their justification) so
    reports can show what was waived and why; a matching directive with
    an EMPTY justification converts the finding into a CHK-NOQA error
    at the directive's location.  ``sources`` maps path -> lines for
    testing; by default files are read from disk (unreadable files
    leave their findings unsuppressed).
    """
    cache: Dict[str, Optional[List[str]]] = dict(sources or {})
    out: List[Finding] = []
    for f in findings:
        if f.path not in cache:
            try:
                with open(f.path, encoding="utf-8") as fh:
                    cache[f.path] = fh.read().splitlines()
            except OSError:
                cache[f.path] = None
        lines = cache[f.path]
        hit = _noqa_at(lines, f.line) if lines else None
        if hit and f.check in hit[0]:
            ids, just = hit
            if not just:
                out.append(Finding(
                    "CHK-NOQA", ERROR, f.path, f.line,
                    f"suppression of {f.check} carries no justification "
                    f"— '# repro: noqa[{f.check}] <why>' is required"))
            else:
                out.append(dataclasses.replace(
                    f, suppressed=True, justification=just))
        else:
            out.append(f)
    return out


def render_report(findings: List[Finding]) -> str:
    """Human-readable report: active findings by severity, then the
    suppressed ones with their justifications, then a summary line."""
    active = [f for f in findings if not f.suppressed]
    supp = [f for f in findings if f.suppressed]
    rank = {s: i for i, s in enumerate(SEVERITIES)}
    active.sort(key=lambda f: (rank.get(f.severity, 99), f.path, f.line))
    lines = [f.format() for f in active]
    if supp:
        lines.append("")
        lines.append(f"-- {len(supp)} suppressed --")
        for f in sorted(supp, key=lambda f: (f.path, f.line)):
            lines.append(f"{f.format()}  ({f.justification})")
    counts = {s: sum(1 for f in active if f.severity == s)
              for s in SEVERITIES}
    lines.append("")
    lines.append(f"{len(active)} finding(s): "
                 f"{counts[ERROR]} error, {counts[WARNING]} warning, "
                 f"{counts[INFO]} info; {len(supp)} suppressed")
    return "\n".join(lines)
