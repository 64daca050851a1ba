"""s-Step Dual Coordinate Descent (paper Algorithm 2) for kernel SVM —
the counterpart of ``repro/core/sstep_dcd.py``.

Computes the kernel data of ``s`` future coordinates at once — the
(s x s) cross block and ``U^T alpha`` (one gram launch and one KMV
launch on the card) — then runs the ``s`` scalar solves in sequence with
gradient corrections (paper lines 14-23).  Same iterates as classical
DCD in exact arithmetic.  Ragged schedules (``H % s != 0``) run a masked
final short round.

``C=`` given as an (F,) tensor makes the round a fleet's (``tune.fleet``):
F problems of a C grid advance an (F, m) alpha in lockstep on one
schedule, with one gram launch and one KMV launch of F columns a round
for the whole fleet, and the local phase batched over F
(``sstep_dcd_inner_fleet``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .dcd import (SVMConfig, _clip, _fleet_update, _nu_omega,
                  fleet_nu_omega)
from .kernels import ExactGramOperator
from .loop import as_schedule, pad_rounds, run_rounds


def sstep_dcd_inner(G0, u_dot_alpha, alpha_at, idx_s, nu, omega, s,
                    valid=None):
    """The local phase: ``s`` sequential scalar solves with gradient
    corrections (paper Alg. 2 lines 14-23).

    G0: (s, s) sampled cross block, u_dot_alpha: (s,), alpha_at: (s,),
    idx_s: (s,) the round's coordinates, valid: (s,) 1/0 mask for the
    ragged final round (padded slots get theta = 0).  Returns thetas (s,).

    This is ~13 small launches per solve, s solves per round: eager on
    the card it is bound by launch overhead, which the captured driver
    (``core.loop.RoundGraphs``) takes off by replaying them as a graph.
    """
    dtype = alpha_at.dtype
    ones = (torch.ones(s, dtype=dtype, device=alpha_at.device)
            if valid is None else valid.to(dtype))
    # same[t, j] = 1 iff i_{sk+t} == i_{sk+j} (for the omega & rho terms)
    same = (idx_s[:, None] == idx_s[None, :]).to(dtype)
    eta = torch.diagonal(G0) + omega
    thetas = torch.zeros(s, dtype=dtype, device=alpha_at.device)
    for j in range(s):
        # thetas[t] is still 0 for t >= j, so thetas is the t < j prefix
        rep = thetas @ same[:, j]
        rho = alpha_at[j] + rep
        g = (u_dot_alpha[j] - 1.0 + omega * alpha_at[j]
             + thetas @ G0[:, j] + omega * rep)
        cand = torch.clamp(rho - g, 0.0, nu) - rho
        theta = torch.where(cand.abs() != 0.0,
                            torch.clamp(rho - g / eta[j], 0.0, nu) - rho,
                            0.0)
        thetas[j] = theta * ones[j]
    return thetas


def _member_dots(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M @ v`` for the F rows of M, through the single round's vector
    dot when F = 1: on the card cuBLAS's dot and its matrix-vector
    product sum in different orders, so a one-member fleet repeats the
    single fit bit for bit only through the same call."""
    if M.shape[0] == 1:
        return (M[0] @ v).reshape(1)
    return M @ v


def sstep_dcd_inner_fleet(G0, u_dot_alpha, alpha_at, idx_s, nu, omega, s,
                          valid=None):
    """``sstep_dcd_inner`` for F members that share the round's
    coordinates and cross block: u_dot_alpha and alpha_at (F, s), nu and
    omega (F,).  Returns thetas (F, s).  Each member's arithmetic is the
    single local phase's, elementwise over F; the sums over t < j are
    (F, s) x (s,) products (``_member_dots``)."""
    dtype = alpha_at.dtype
    F = alpha_at.shape[0]
    ones = (torch.ones(s, dtype=dtype, device=alpha_at.device)
            if valid is None else valid.to(dtype))
    same = (idx_s[:, None] == idx_s[None, :]).to(dtype)
    eta = torch.diagonal(G0)[None, :] + omega[:, None]          # (F, s)
    thetas = torch.zeros((F, s), dtype=dtype, device=alpha_at.device)
    for j in range(s):
        rep = _member_dots(thetas, same[:, j])
        rho = alpha_at[:, j] + rep
        g = (u_dot_alpha[:, j] - 1.0 + omega * alpha_at[:, j]
             + _member_dots(thetas, G0[:, j]) + omega * rep)
        cand = _clip(rho - g, nu) - rho
        theta = torch.where(cand.abs() != 0.0,
                            _clip(rho - g / eta[:, j], nu) - rho, 0.0)
        thetas[:, j] = theta * ones[j]
    return thetas


def make_sstep_dcd_round_fn(A: torch.Tensor, y: torch.Tensor,
                            cfg: SVMConfig, s: int,
                            gram_fn: Optional[Callable] = None,
                            op=None, C=None, guard: bool = False
                            ) -> Callable:
    """``round_fn(alpha, (idx_s, valid)) -> alpha`` for
    ``loop.run_rounds``: one Algorithm-2 outer round.  ``op`` injects a
    prebuilt, already ``diag(y)``-scaled training operator.

    ``C`` overrides ``cfg.C``: a number replaces it, an (F,) tensor makes
    the round a fleet's, ``round_fn(alpha (F, m), xs) -> alpha (F, m)``
    (module docstring; slab-free only).

    ``guard=True`` is the guarded-carry round, ``round_fn((alpha, f), xs)
    -> (alpha, f)`` with ``f = Ktil alpha`` kept by the recurrence ``f +=
    Ktil[:, idx_s] thetas`` (``op.apply_at``: one gram launch and one KMV
    launch a round, as unguarded): ``U^T alpha`` becomes the free gather
    ``f[idx_s]``.  Operator path only."""
    if gram_fn is not None and op is not None:
        raise ValueError("pass at most one of gram_fn (materialized "
                         "slab) or op (prebuilt operator)")
    if guard and gram_fn is not None:
        raise ValueError("guard=True requires the GramOperator path "
                         "(gram_fn= is the legacy materialized oracle)")
    if isinstance(C, torch.Tensor):
        return _fleet_round_fn(A, y, cfg, s, gram_fn, op, C)
    nu, omega = _nu_omega(cfg, C)
    Atil = None
    if gram_fn is not None:
        Atil = y[:, None] * A
    elif op is None:
        op = ExactGramOperator(A, cfg.kernel).scale_rows(y)
    if guard:
        return _guarded_round_fn(op, nu, omega, s)

    def round_fn(alpha, xs):
        idx_s, valid = xs
        # --- kernel phase: one cross block and one fused KMV -----------
        if gram_fn is not None:                  # materialized m x s slab
            U = gram_fn(Atil, Atil[idx_s], cfg.kernel)
            G0 = U[idx_s, :]
            u_dot_alpha = U.T @ alpha
        else:
            G0, u_dot_alpha = op.round_data(idx_s, alpha)
        # --- local phase: s sequential scalar solves --------------------
        thetas = sstep_dcd_inner(G0, u_dot_alpha, alpha[idx_s], idx_s,
                                 nu, omega, s, valid)
        # the accumulating index_put sums repeated coordinates, as JAX's
        # .at[].add does, and on the card in a fixed order (index_add's
        # atomics would not repeat bit for bit)
        return alpha.index_put((idx_s,), thetas, accumulate=True)

    return round_fn


def _guarded_round_fn(op, nu, omega, s):
    """The guarded round of ``make_sstep_dcd_round_fn(guard=True)``."""

    def round_fn(carry, xs):
        alpha, f = carry                         # f = Ktil @ alpha, (m,)
        idx_s, valid = xs
        thetas = sstep_dcd_inner(op.cross_block(idx_s), f[idx_s],
                                 alpha[idx_s], idx_s, nu, omega, s, valid)
        return (alpha.index_put((idx_s,), thetas, accumulate=True),
                f + op.apply_at(idx_s, thetas))

    return round_fn


def _fleet_round_fn(A, y, cfg, s, gram_fn, op, C):
    """The fleet round of ``make_sstep_dcd_round_fn(C=tensor)``."""
    if gram_fn is not None:
        raise ValueError("a fleet round is slab-free (one shared "
                         "operator); gram_fn= is the single-solve oracle")
    nu, omega = fleet_nu_omega(cfg, C)
    if op is None:
        op = ExactGramOperator(A, cfg.kernel).scale_rows(y)

    def round_fn(alpha, xs):
        idx_s, valid = xs
        # one cross block and one KMV of F columns for the whole fleet
        G0, u_dot_alpha = op.round_data(idx_s, alpha.T)
        thetas = sstep_dcd_inner_fleet(G0, u_dot_alpha.T, alpha[:, idx_s],
                                       idx_s, nu, omega, s, valid)
        return _fleet_update(alpha, idx_s, thetas)

    return round_fn


def sstep_dcd_ksvm(A: torch.Tensor, y: torch.Tensor, alpha0: torch.Tensor,
                   schedule, cfg: SVMConfig, s: int,
                   record_rounds: bool = False,
                   gram_fn: Optional[Callable] = None, op=None,
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run Algorithm 2 over ``ceil(H/s)`` rounds (ragged tails allowed)."""
    round_fn = make_sstep_dcd_round_fn(A, y, cfg, s, gram_fn=gram_fn,
                                       op=op)
    xs = pad_rounds(as_schedule(schedule, A.device), s)
    res = run_rounds(round_fn, alpha0, xs, record_state=record_rounds,
                     capture=op is None or op.capturable)
    return res.state, (res.state_hist if record_rounds else None)
