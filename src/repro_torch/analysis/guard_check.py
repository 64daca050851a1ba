"""The guarded-carry coverage auditor (the counterpart of
``repro/analysis/guard_check.py``).

The divergence guard is only as good as its health predicate: a carry
leaf the predicate does not read is a blind spot, where a NaN can live
for the rest of the solve while the guard reports healthy rounds.  For
every guarded round family of ``core`` (DCD / BDCD x classical / s-step)
this analyzer

1. builds the family's guarded round (``make_*_round_fn(guard=True)``)
   on a small problem drawn from a seed, on the CPU,
2. runs one real round to get the post-round carry,
3. poisons each floating leaf of the carry with NaN, one leaf at a
   time, and
4. asks ``resilience.guard.finite_health`` to flag every poisoned copy
   and accept the clean one.

* CHK-CARRY (error): a carry leaf the predicate misses, or a healthy
  carry it rejects.  Anchors to the family's factory ``def`` line in
  ``core/``.

The audit runs the real factories and predicate, so a leaf added to a
guarded carry is audited with no change here.
"""
from __future__ import annotations

import inspect
from typing import Callable, List, Tuple

import torch

from repro_torch.core.bdcd import KRRConfig, make_bdcd_round_fn
from repro_torch.core.dcd import SVMConfig, make_dcd_round_fn
from repro_torch.core.kernels import ExactGramOperator, KernelConfig
from repro_torch.core.sstep_bdcd import make_sstep_bdcd_round_fn
from repro_torch.core.sstep_dcd import make_sstep_dcd_round_fn
from repro_torch.resilience.guard import finite_health
from repro_torch.tree import leaves, unflatten

from .findings import ERROR, Finding

M, N, B, S = 16, 4, 2, 4                   # the audited problem


def _problem():
    gen = torch.Generator().manual_seed(0)
    A = torch.randn((M, N), generator=gen)
    y = torch.sign(torch.randn((M,), generator=gen))
    return A, y


def _families() -> List[Tuple[str, Callable, Callable, object]]:
    """``(name, factory, round function, xs)`` of each guarded family;
    the round function runs one real round."""
    A, y = _problem()
    svm = SVMConfig(C=1.0, loss="l1", kernel=KernelConfig("linear"))
    krr = KRRConfig(lam=0.5, kernel=KernelConfig("linear"))
    i = torch.tensor(3)
    idx_s = torch.arange(S)
    valid = torch.ones((S,), dtype=torch.bool)
    blk = torch.arange(B)
    blk_s = torch.arange(S * B).reshape(S, B)

    def fam(name, factory, cfg, x, **kw):
        op = ExactGramOperator(A, cfg.kernel)
        if "dcd" in name and "bdcd" not in name:
            op = op.scale_rows(y)
        return name, factory, factory(A, y, cfg, op=op, guard=True, **kw), x

    return [
        fam("dcd", make_dcd_round_fn, svm, i),
        fam("sstep_dcd", make_sstep_dcd_round_fn, svm, (idx_s, valid), s=S),
        fam("bdcd", make_bdcd_round_fn, krr, blk),
        fam("sstep_bdcd", make_sstep_bdcd_round_fn, krr, (blk_s, valid),
            s=S),
    ]


def _anchor(factory) -> Tuple[str, int]:
    return inspect.getsourcefile(factory), inspect.getsourcelines(factory)[1]


def run() -> List[Finding]:
    findings: List[Finding] = []
    for name, factory, rf, x in _families():
        path, line = _anchor(factory)
        carry = (torch.zeros(M), torch.zeros(M))
        carry = rf(carry, x)                   # one real round
        flat = leaves(carry)
        if not bool(finite_health(carry)):
            findings.append(Finding(
                "CHK-CARRY", ERROR, path, line,
                f"{name}: the health predicate rejects a finite post-round "
                f"carry — guarded solves would stop at round 0"))
            continue
        for k, leaf in enumerate(flat):
            if not leaf.is_floating_point():
                continue
            poisoned = list(flat)
            poisoned[k] = leaf.clone()
            poisoned[k].view(-1)[0] = float("nan")
            if bool(finite_health(unflatten(carry, poisoned))):
                findings.append(Finding(
                    "CHK-CARRY", ERROR, path, line,
                    f"{name}: carry leaf #{k} (shape {tuple(leaf.shape)}) "
                    f"is not read by the health predicate — a NaN there "
                    f"survives every guarded round"))
    return findings
