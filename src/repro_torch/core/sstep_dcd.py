"""s-Step Dual Coordinate Descent (paper Algorithm 2) for kernel SVM —
the counterpart of ``repro/core/sstep_dcd.py``.

Computes the kernel data of ``s`` future coordinates at once — the
(s x s) cross block and ``U^T alpha`` (one gram launch and one KMV
launch on the card) — then runs the ``s`` scalar solves in sequence with
gradient corrections (paper lines 14-23).  Same iterates as classical
DCD in exact arithmetic.  Ragged schedules (``H % s != 0``) run a masked
final short round.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .dcd import SVMConfig, _nu_omega
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


def make_sstep_dcd_round_fn(A: torch.Tensor, y: torch.Tensor,
                            cfg: SVMConfig, s: int,
                            gram_fn: Optional[Callable] = None,
                            op=None) -> Callable:
    """``round_fn(alpha, (idx_s, valid)) -> alpha`` for
    ``loop.run_rounds``: one Algorithm-2 outer round.  ``op`` injects a
    prebuilt, already ``diag(y)``-scaled training operator."""
    if gram_fn is not None and op is not None:
        raise ValueError("pass at most one of gram_fn (materialized "
                         "slab) or op (prebuilt operator)")
    nu, omega = _nu_omega(cfg)
    Atil = None
    if gram_fn is not None:
        Atil = y[:, None] * A
    elif op is None:
        op = ExactGramOperator(A, cfg.kernel).scale_rows(y)

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
