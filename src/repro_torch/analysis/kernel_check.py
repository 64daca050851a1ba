"""The kernel sanitizer: the counterpart of ``repro/analysis/pallas_check.py``
for the port's hand-written CUDA kernels.

It reads the launches ``registry.capture`` records and the sources of
``csrc/``:

* CHK-RACE (error) / CHK-HOLE (error): the plan a wrapper computes in
  Python (``kernels.kmv.kmv_plan`` / ``kmv_f64_plan`` for the KMV family,
  the streamed pipes' per-chunk plans included; ``kernels.gram.
  gram_splits``) is laid out as the C++ runs it: every block covers a
  run of the contraction axis (the m rows of A, or the n features of the
  gram) against a tile of the output, and writes one slot of the split
  workspace, which the reduce sums over every split.  A (contraction,
  output) cell that two blocks cover, a workspace slot two blocks write,
  or a slot past the workspace's slices (the symmetric plan's mirrors
  of a plan with fewer splits than column tiles) is a race; a cell no
  block covers is a hole (the split-n partials of a plan with one split
  too few).  The JAX check walks the
  BlockSpec index maps; the port's tiles are planned in Python and
  launched in C++, so the plan is where they can be checked.  The flash
  and RMSNorm tiles are fixed in C++ and have no plan to check.
* CHK-ALIGN (warning): the operands the tensor-core flash kernels read
  through TMA tensor maps must start on a 16-byte boundary
  (``kernels.flash_attention._check_tma``): the TPU check's tile
  alignment becomes the TMA base alignment.
* CHK-SMEM (warning): the dynamic shared memory of a kernel launch,
  as the C++ launch itself noted it (``csrc/launch_log.cuh``), over the
  card's opt-in limit per block
  (``torch.cuda.get_device_properties(...).shared_memory_per_block_optin``
  on the card, else sm_90's 227 KiB): the counterpart of CHK-VMEM and of
  ``perf_model.pallas_working_set_bytes`` / ``vmem_fits``.  Only a card
  run holds these numbers; without one the check has nothing to read.
* CHK-SITE (warning): a C entry point of ``csrc/`` that no registered
  entry point reaches.
* CHK-DMA (error): the streamed pipe's copy discipline, read from the
  CUDA sources: in each function every event recorded
  (``cudaEventRecord``, the counterpart of an async copy's ``.start()``)
  is waited on (``cudaStreamWaitEvent``, the ``.wait()``) and every wait
  has a record; and a record and a wait never name the same non-constant
  slot expression of an event array (a prefetch must target the other
  slot of the double buffer).

Findings anchor to the C entry point's line (CHK-DMA: to the event
call's), so suppressions sit next to the launch they waive.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .findings import ERROR, WARNING, Finding
from .registry import (CSRC_DIR, CapturedCall, capture_entry_points,
                       discover_sites)

# sm_90's opt-in dynamic shared memory per block (227 KiB), the limit
# without a card
SM90_SMEM_OPTIN = 227 * 1024
TMA_ALIGN = 16            # kernels/flash_attention.TMA_ALIGN
GRAM_BK = 32              # kernels/gram.BK: features a chunk
F64_TILE = 32             # kernels/kmv.F64_TILE
PLAN_ENUM_CAP = 1 << 16   # blocks a plan may have and still be enumerated

# the operands each tensor-core entry point reads through TMA
TMA_OPERANDS = {"flash_fwd_wgmma_launch": ("q", "k", "v"),
                "flash_bwd_dq_wgmma_launch": ("q", "k", "v", "dout"),
                "flash_bwd_dkv_wgmma_launch": ("q", "k", "v", "dout")}

# the KMV-family entry points: (contraction extent, output extent) by
# parameter name, and whether the plan carries a regime (else the f64
# route's 32 x 32 tiles)
KMV_PLANS = {"kmv_launch": ("m", "r", True),
             "kmv_f64_launch": ("m", "r", False),
             "kmv_stream_launch": ("cr", "r", True),
             "kmv_stream_f64_launch": ("cr", "r", False),
             "kmv_stream_apply_launch": ("sb", "cr", True),
             "kmv_stream_apply_f64_launch": ("sb", "cr", False)}
REGIMES = {0: "rows", 1: "narrow", 2: "wide", 3: "symmetric"}


def smem_limit() -> int:
    """The card's opt-in shared memory per block, or sm_90's without a
    card."""
    import torch
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(
            torch.cuda.current_device()).shared_memory_per_block_optin)
    return SM90_SMEM_OPTIN


# ------------------------------------------------------- the plans' cover --

def _runs(extent: int, splits: int, per: int) -> List[Tuple[int, int]]:
    """The contraction runs of a split plan: split s takes [s per,
    min((s + 1) per, extent))."""
    return [(s * per, min((s + 1) * per, extent)) for s in range(splits)]


def plan_blocks(call: CapturedCall) -> Optional[List[tuple]]:
    """The blocks of a call's plan as ``(contraction (lo, hi), output
    (lo, hi), slot)``, as the C++ runs them; None where the call has no
    Python plan (or too many blocks to enumerate)."""
    a = call.args
    if call.symbol in KMV_PLANS:
        mk, rk, regime_known = KMV_PLANS[call.symbol]
        M, R = int(a[mk]), int(a[rk])
        splits, per = int(a["splits"]), int(a["rows_per_split"])
        regime = REGIMES.get(int(a["regime"])) if regime_known else "f64"
        br = int(a["br"]) if regime_known else F64_TILE
        if regime == "rows":
            tiles = [(0, R)]
        else:
            tiles = [(t * br, min((t + 1) * br, R))
                     for t in range(-(-R // br))]
        if len(tiles) * splits > PLAN_ENUM_CAP:
            return None
        runs = _runs(M, splits, per)
        if regime == "symmetric":
            # kmv_tile_kernel with sym: block (x, y) of the (column tile,
            # split) grid runs where y <= x, and off the diagonal also
            # writes its mirror: rows of run x against column tile y,
            # into slot (x, y)
            out = []
            for x, tile in enumerate(tiles):
                for y in range(min(x + 1, splits)):
                    out.append((runs[y], tile, (y, x)))
                    if y != x:
                        mrows = runs[x] if x < splits else (M, M)
                        out.append((mrows, tiles[y], (x, y)))
            return out
        return [(run, tile, (s, t)) for s, run in enumerate(runs)
                for t, tile in enumerate(tiles)]
    if call.symbol == "gram_launch":
        m, r, n = int(a["m"]), int(a["r"]), int(a["n"])
        bm, br = int(a["bm"]), int(a["br"])
        splits, per = int(a["splits"]), int(a["per"])
        tiles = [(i, j) for i in range(-(-m // bm))
                 for j in range(-(-r // br))]
        if len(tiles) * splits > PLAN_ENUM_CAP:
            return None
        runs = _runs(n, splits, per * GRAM_BK)
        # one output "column" per output tile: the contraction is covered
        # for each tile separately
        return [(run, (k, k + 1), (s, k)) for s, run in enumerate(runs)
                for k in range(len(tiles))]
    return None


def _extent(call: CapturedCall) -> Tuple[int, int]:
    a = call.args
    if call.symbol in KMV_PLANS:
        mk, rk, _ = KMV_PLANS[call.symbol]
        return int(a[mk]), int(a[rk])
    m, r = int(a["m"]), int(a["r"])
    tiles = -(-m // int(a["bm"])) * -(-r // int(a["br"]))
    return int(a["n"]), tiles


def _check_plan(call: CapturedCall) -> List[Finding]:
    blocks = plan_blocks(call)
    if blocks is None:
        return []
    M, R = _extent(call)
    where = f"{call.entry} {call.symbol}"
    out: List[Finding] = []
    slots: Dict[tuple, int] = {}
    for _, _, slot in blocks:
        slots[slot] = slots.get(slot, 0) + 1
    twice = sorted(s for s, k in slots.items() if k > 1)
    # a slot's first index is its workspace slice: past the plan's
    # splits it lands on whatever follows the workspace (the KMV's |b|^2)
    past = sorted(s for s in slots if s[0] >= int(call.args["splits"]))
    # the cells between every run and tile boundary, each counted
    rows = sorted({0, M} | {x for b in blocks for x in b[0]
                            if 0 <= x <= M})
    cols = sorted({0, R} | {x for b in blocks for x in b[1]
                            if 0 <= x <= R})
    over, holes = [], []
    for r0, r1 in zip(rows, rows[1:]):
        for c0, c1 in zip(cols, cols[1:]):
            k = sum(1 for (a0, a1), (b0, b1), _ in blocks
                    if a0 <= r0 and r1 <= a1 and b0 <= c0 and c1 <= b1)
            if k > 1:
                over.append((r0, c0))
            elif k == 0:
                holes.append((r0, c0))
    if twice or over or past:
        if past:
            what = (f"{len(past)} blocks write workspace slices past its "
                    f"{call.args['splits']} (first {past[0]})")
        elif twice:
            what = (f"workspace slot {twice[0]} written by "
                    f"{slots[twice[0]]} blocks")
        else:
            what = (f"{len(over)} (contraction, output) cells covered by "
                    f"more than one block (first {over[0]})")
        out.append(Finding(
            "CHK-RACE", ERROR, call.path, call.line,
            f"{where}: {what} — the split partials race or are counted "
            f"twice"))
    if holes:
        out.append(Finding(
            "CHK-HOLE", ERROR, call.path, call.line,
            f"{where}: {len(holes)} (contraction, output) cells no block "
            f"covers (first at {holes[0]} of {M} x {R}) — the reduce sums "
            f"partials that leave them out"))
    return out


# --------------------------------------------------- alignment and smem --

def _check_alignment(call: CapturedCall) -> List[Finding]:
    bad = [(name, int(call.args[name]) % TMA_ALIGN)
           for name in TMA_OPERANDS.get(call.symbol, ())
           if name in call.args and int(call.args[name]) % TMA_ALIGN]
    if not bad:
        return []
    return [Finding(
        "CHK-ALIGN", WARNING, call.path, call.line,
        f"{call.entry} {call.symbol}: TMA operand(s) "
        + ", ".join(f"{n} (+{off} B)" for n, off in bad)
        + f" not on a {TMA_ALIGN}-byte boundary — the tensor map cannot "
        f"be made")]


def _check_smem(call: CapturedCall, limit: int) -> List[Finding]:
    out = []
    for k, rec in enumerate(call.launches or ()):
        if rec["smem"] > limit:
            out.append(Finding(
                "CHK-SMEM", WARNING, call.path, call.line,
                f"{call.entry} {call.symbol} launch #{k}: "
                f"{rec['smem']} B of dynamic shared memory a block "
                f"(grid {rec['grid']}, block {rec['block']}) exceeds the "
                f"card's opt-in {limit} B — the launch fails"))
    return out


def analyze_calls(calls: Sequence[CapturedCall],
                  limit: Optional[int] = None) -> List[Finding]:
    """All per-launch checks over captured calls (the fixtures enter
    here; ``run`` adds the capture, the sites and CHK-DMA)."""
    limit = smem_limit() if limit is None else limit
    findings: List[Finding] = []
    seen = set()
    for call in calls:
        for f in (_check_plan(call) + _check_alignment(call)
                  + _check_smem(call, limit)):
            key = (f.check, f.path, f.line, f.message)
            if key not in seen:
                seen.add(key)
                findings.append(f)
    return findings


# ------------------------------------------------------------- CHK-DMA --

_RECORD_RE = re.compile(r"cudaEventRecord\(\s*([^,()]+(?:\[[^\]]*\])?)\s*,")
_WAIT_RE = re.compile(
    r"cudaStreamWaitEvent\(\s*[^,]+,\s*([^,()]+(?:\[[^\]]*\])?)\s*,")


def _functions(text: str, line0: int = 1) -> Iterable[Tuple[int, str]]:
    """``(first line, body)`` of every top-level brace block of C++
    ``text`` (whose first line is ``line0``), the blocks of a
    ``namespace`` walked into; comments and strings blanked first."""
    clean = re.sub(r"//[^\n]*|/\*.*?\*/|\"(?:\\.|[^\"\\])*\"",
                   lambda m: re.sub(r"[^\n]", " ", m.group(0)), text,
                   flags=re.S)
    depth, start = 0, None
    for i, ch in enumerate(clean):
        if ch == "{":
            if depth == 0:
                start = i
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0 and start is not None:
                line = line0 + clean.count("\n", 0, start)
                head = clean[:start].rsplit("\n", 1)[-1]
                if "namespace" in head:
                    yield from _functions(clean[start + 1:i], line)
                else:
                    yield line, clean[start:i + 1]


def _event(expr: str) -> Tuple[str, Optional[str], bool]:
    """``(event array or name, slot expression, slot is a constant)``."""
    expr = expr.strip()
    m = re.match(r"(.+?)\[(.*)\]$", expr)
    if not m:
        return expr, None, False
    slot = m.group(2).strip()
    return m.group(1).strip(), slot, slot.isdigit()


def check_dma_source(path: str, text: str) -> List[Finding]:
    """CHK-DMA over one CUDA source's text (module docstring)."""
    out: List[Finding] = []
    for line0, body in _functions(text):
        ops = []
        for kind, rx in (("record", _RECORD_RE), ("wait", _WAIT_RE)):
            for m in rx.finditer(body):
                base, slot, const = _event(m.group(1))
                ops.append({"kind": kind, "event": base, "slot": slot,
                            "const": const,
                            "line": line0 + body.count("\n", 0, m.start())})
        for event in sorted({o["event"] for o in ops}):
            mine = [o for o in ops if o["event"] == event]
            recs = [o for o in mine if o["kind"] == "record"]
            waits = [o for o in mine if o["kind"] == "wait"]
            if recs and not waits:
                out.append(Finding(
                    "CHK-DMA", ERROR, path, recs[0]["line"],
                    f"event {event!r} recorded but never waited on — the "
                    f"stream that reads the copy does not wait for it"))
            if waits and not recs:
                out.append(Finding(
                    "CHK-DMA", ERROR, path, waits[0]["line"],
                    f"event {event!r} waited on but never recorded — the "
                    f"wait orders nothing"))
            shared = ({o["slot"] for o in recs if o["slot"] and
                       not o["const"]}
                      & {o["slot"] for o in waits if o["slot"] and
                         not o["const"]})
            for slot in sorted(shared):
                out.append(Finding(
                    "CHK-DMA", ERROR, path, waits[0]["line"],
                    f"event {event!r}: a record and a wait both index slot "
                    f"[{slot}] — the double buffer's slots must alternate, "
                    f"or the next copy lands on the chunk in use"))
    return out


def check_dma(root: str = CSRC_DIR) -> List[Finding]:
    out: List[Finding] = []
    for fname in sorted(os.listdir(root)):
        if fname.endswith((".cu", ".cuh")):
            path = os.path.abspath(os.path.join(root, fname))
            with open(path, encoding="utf-8") as fh:
                out.extend(check_dma_source(path, fh.read()))
    return out


def run(calls: Optional[Sequence[CapturedCall]] = None) -> List[Finding]:
    """Capture every registered entry point (launching on the card where
    there is one), check the launches, the sites and the pipe."""
    calls = capture_entry_points() if calls is None else calls
    findings = analyze_calls(calls)
    findings.extend(check_dma())
    covered = {c.site for c in calls}
    for site in discover_sites():
        if (site.path, site.line) not in covered:
            findings.append(Finding(
                "CHK-SITE", WARNING, site.path, site.line,
                f"{site.symbol} not reached by any registered entry point "
                f"— register it in repro_torch.analysis.registry."
                f"ENTRY_POINTS"))
    return findings
