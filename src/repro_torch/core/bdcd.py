"""Block Dual Coordinate Descent (paper Algorithm 3) for kernel ridge
regression — the counterpart of ``repro/core/bdcd.py``.

The optimality system is ``((1/lambda) K + m I) alpha = y``.  Each
iteration samples ``b`` coordinates and solves the b x b sub-system
exactly:

    G_k = (1/lambda) K(A_k, A_k) + m I
    dalpha = G_k^{-1}(V_k^T y - m V_k^T alpha - (1/lambda) U_k^T alpha)

``U_k`` enters only through ``U_k^T alpha`` and its sampled block, so the
default path is slab-free through a ``GramOperator``; ``gram_fn`` forces
the materialized-slab path (the parity oracle).  ``lam=`` given as an
(F,) tensor makes the round a fleet's: F problems of a lambda grid
advance an (F, m) alpha in lockstep (``tune.fleet``; the fleets
themselves run the s-step rounds).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from .dcd import _fleet_update
from .kernels import ExactGramOperator, KernelConfig
from .loop import as_schedule, run_rounds


@dataclasses.dataclass(frozen=True)
class KRRConfig:
    lam: float = 1.0          # ridge parameter lambda
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)


def block_schedule(gen: torch.Generator, H: int, m: int, b: int,
                   device: Optional[torch.device] = None,
                   chunk: int = 256) -> torch.Tensor:
    """(H, b) coordinate blocks, each sampled uniformly WITHOUT replacement
    (paper Alg. 3 line 4): the indices of the b largest of m uniform keys,
    drawn ``chunk`` blocks at a time so memory stays O(chunk * m)."""
    if not 1 <= b <= m:
        raise ValueError(f"block size b must be in [1, m={m}], got {b}")
    parts = []
    for lo in range(0, H, chunk):
        keys = torch.rand((min(chunk, H - lo), m), generator=gen,
                          device=gen.device)
        parts.append(torch.topk(keys, b, dim=1).indices)
    sched = (torch.cat(parts) if parts
             else torch.zeros((0, b), dtype=torch.long, device=gen.device))
    return sched.to(device if device is not None else gen.device)


def solve_small(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``G^{-1} rhs`` for one small dense system.  ``solve_ex`` does not
    check for singularity, so it never synchronises with the host (a
    singular block gives non-finite values, as ``jnp.linalg.solve``
    does)."""
    return torch.linalg.solve_ex(G, rhs)[0]


def fleet_inv_lam(lam: torch.Tensor) -> torch.Tensor:
    """1/lam for a fleet's (F,) lambda grid, taken in f64 and rounded
    once, as the single round's Python float is when it meets an f32
    tensor."""
    return (1.0 / lam.double()).to(lam.dtype)


def make_bdcd_round_fn(A: torch.Tensor, y: torch.Tensor, cfg: KRRConfig,
                       gram_fn: Optional[Callable] = None,
                       op=None, lam=None, guard: bool = False) -> Callable:
    """``round_fn(alpha, idx) -> alpha`` for ``loop.run_rounds``: one
    Algorithm-3 exact b x b block solve.  ``op`` injects a prebuilt
    operator over the training representation.  ``lam`` overrides
    ``cfg.lam``: a number replaces it, an (F,) tensor makes the round a
    fleet's over an (F, m) alpha (slab-free only).

    ``guard=True`` is the guarded-carry round, ``round_fn((alpha, f),
    idx) -> (alpha, f)`` with ``f = K alpha`` kept by ``f += K[:, idx]
    dalpha`` (``op.apply_at``): ``U^T alpha`` becomes the free gather
    ``f[idx]``.  Operator path only."""
    if gram_fn is not None and op is not None:
        raise ValueError("pass at most one of gram_fn (materialized "
                         "slab) or op (prebuilt operator)")
    if guard and gram_fn is not None:
        raise ValueError("guard=True requires the GramOperator path "
                         "(gram_fn= is the legacy materialized oracle)")
    m = A.shape[0]
    if op is None and gram_fn is None:
        op = ExactGramOperator(A, cfg.kernel)
    if isinstance(lam, torch.Tensor):
        if gram_fn is not None:
            raise ValueError("a fleet round is slab-free (one shared "
                             "operator); gram_fn= is the single-solve "
                             "oracle")
        return _fleet_bdcd_round_fn(y, m, op, fleet_inv_lam(lam))
    inv_lam = 1.0 / (cfg.lam if lam is None else float(lam))
    if guard:
        return _guarded_bdcd_round_fn(y, m, op, inv_lam)

    def round_fn(alpha, idx):                 # idx: (b,)
        if gram_fn is not None:               # materialized m x b slab
            U = gram_fn(A, A[idx], cfg.kernel)
            Gblk = U[idx, :]
            uTa = U.T @ alpha
        else:                                 # slab-free operator path
            Gblk, uTa = op.round_data(idx, alpha)
        G = inv_lam * Gblk
        G.diagonal().add_(m)                  # + m I
        rhs = y[idx] - m * alpha[idx] - inv_lam * uTa
        return alpha.index_add(0, idx, solve_small(G, rhs))

    return round_fn


def _guarded_bdcd_round_fn(y, m, op, inv_lam):
    """The guarded round of ``make_bdcd_round_fn(guard=True)``."""

    def round_fn(carry, idx):                 # idx: (b,)
        alpha, f = carry                      # f = K @ alpha, (m,)
        G = inv_lam * op.cross_block(idx)
        G.diagonal().add_(m)                  # + m I
        rhs = y[idx] - m * alpha[idx] - inv_lam * f[idx]
        dalpha = solve_small(G, rhs)
        return (alpha.index_add(0, idx, dalpha),
                f + op.apply_at(idx, dalpha))

    return round_fn


def _fleet_bdcd_round_fn(y, m, op, inv_lam):
    """The fleet round of ``make_bdcd_round_fn(lam=tensor)``."""

    def round_fn(alpha, idx):                 # alpha (F, m), idx (b,)
        Gblk, uTa = op.round_data(idx, alpha.T)        # (b, b), (b, F)
        G = inv_lam[:, None, None] * Gblk
        G.diagonal(dim1=-2, dim2=-1).add_(m)
        rhs = y[idx] - m * alpha[:, idx] - inv_lam[:, None] * uTa.T
        return _fleet_update(alpha, idx, solve_small(G, rhs))

    return round_fn


def bdcd_krr(A: torch.Tensor, y: torch.Tensor, alpha0: torch.Tensor,
             schedule, cfg: KRRConfig, record_every: int = 0,
             gram_fn: Optional[Callable] = None, op=None,
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run Algorithm 3 for H = schedule.shape[0] iterations."""
    round_fn = make_bdcd_round_fn(A, y, cfg, gram_fn=gram_fn, op=op)
    res = run_rounds(round_fn, alpha0, as_schedule(schedule, A.device),
                     record_state=bool(record_every),
                     capture=op is None or op.capturable)
    if record_every:
        return res.state, res.state_hist[record_every - 1::record_every]
    return res.state, None
