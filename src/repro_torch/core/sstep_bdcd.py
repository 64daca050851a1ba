"""s-Step Block Dual Coordinate Descent (paper Algorithm 4) for K-RR —
the counterpart of ``repro/core/sstep_bdcd.py``.

One outer round gathers everything ``s`` exact b x b block solves need —
the (sb x sb) cross block and ``Q^T alpha`` (one gram launch and one KMV
launch on the card) — then repairs the deferred alpha update with the
correction sums of paper eq. (3):

    dalpha_{sk+j} = G^{-1}( V_j^T y - m V_j^T alpha_sk
                            - m     sum_{t<j} V_j^T V_t dalpha_t
                            - 1/lam U_j^T alpha_sk
                            - 1/lam sum_{t<j} U_j^T V_t dalpha_t )

Ragged schedules (``H % s != 0``) run a masked final short round.

``lam=`` given as an (F,) tensor makes the round a fleet's
(``tune.fleet``): F problems of a lambda grid advance an (F, m) alpha in
lockstep on one schedule, with one gram launch and one KMV launch of F
columns a round for the whole fleet, and the local phase batched over F
(``sstep_bdcd_inner_fleet``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .bdcd import KRRConfig, fleet_inv_lam, solve_small
from .dcd import _fleet_update
from .kernels import ExactGramOperator
from .loop import as_schedule, pad_rounds, run_rounds


def sstep_bdcd_inner(Gblk, QTalpha, alpha_at, y_at, flat, m, inv_lam,
                     s, b, valid=None):
    """The local phase: ``s`` sequential b x b solves with eq. (3)
    corrections.

    Gblk: (sb, sb), QTalpha: (sb,), alpha_at/y_at: (s, b), flat: (sb,),
    valid: (s,) 1/0 mask for the ragged final round (padded blocks get
    dalpha = 0).  Returns dalpha: (s, b).  On the card these are s small
    solves of a few launches each: bound by launch overhead unless the
    rounds are replayed as a graph (``core.loop``).
    """
    dtype = alpha_at.dtype
    dev = alpha_at.device
    ones = (torch.ones(s, dtype=dtype, device=dev) if valid is None
            else valid.to(dtype))
    # collide[t, q, j, p] = 1 iff flat[t*b+q] == flat[j*b+p]
    collide4 = (flat[:, None] == flat[None, :]).to(dtype).reshape(s, b, s, b)
    Gblk4 = Gblk.reshape(s, b, s, b)                  # [t, q, j, p]
    dalpha = torch.zeros((s, b), dtype=dtype, device=dev)
    for j in range(s):
        # dalpha rows t >= j are still 0, so dalpha is the t < j prefix
        vv = torch.einsum("tq,tqp->p", dalpha, collide4[:, :, j, :])
        uv = torch.einsum("tq,tqp->p", dalpha, Gblk4[:, :, j, :])
        G = inv_lam * Gblk4[j, :, j, :]
        G.diagonal().add_(m)                      # + m I
        rhs = (y_at[j] - m * alpha_at[j] - m * vv
               - inv_lam * QTalpha[j * b:(j + 1) * b] - inv_lam * uv)
        dalpha[j] = solve_small(G, rhs) * ones[j]
    return dalpha


def sstep_bdcd_inner_fleet(Gblk, QTalpha, alpha_at, y_at, flat, m,
                           inv_lam, s, b, valid=None):
    """``sstep_bdcd_inner`` for F members that share the round's blocks
    and cross block: QTalpha (F, sb), alpha_at (F, s, b), inv_lam (F,).
    Returns dalpha (F, s, b).  Each member's arithmetic is the single
    local phase's, elementwise over F; the correction sums are one
    (F, sb) x (sb, b) product each, the b x b solves one batched
    solve."""
    dtype = alpha_at.dtype
    dev = alpha_at.device
    F = alpha_at.shape[0]
    ones = (torch.ones(s, dtype=dtype, device=dev) if valid is None
            else valid.to(dtype))
    collide4 = (flat[:, None] == flat[None, :]).to(dtype).reshape(s, b, s, b)
    Gblk4 = Gblk.reshape(s, b, s, b)                  # [t, q, j, p]
    il = inv_lam[:, None]
    dalpha = torch.zeros((F, s, b), dtype=dtype, device=dev)
    for j in range(s):
        vv = torch.einsum("ftq,tqp->fp", dalpha, collide4[:, :, j, :])
        uv = torch.einsum("ftq,tqp->fp", dalpha, Gblk4[:, :, j, :])
        G = inv_lam[:, None, None] * Gblk4[j, :, j, :]
        G.diagonal(dim1=-2, dim2=-1).add_(m)           # + m I
        rhs = (y_at[j] - m * alpha_at[:, j] - m * vv
               - il * QTalpha[:, j * b:(j + 1) * b] - il * uv)
        dalpha[:, j] = solve_small(G, rhs) * ones[j]
    return dalpha


def make_sstep_bdcd_round_fn(A: torch.Tensor, y: torch.Tensor,
                             cfg: KRRConfig, s: int,
                             gram_fn: Optional[Callable] = None,
                             op=None, lam=None) -> Callable:
    """``round_fn(alpha, (idx, valid)) -> alpha`` for ``loop.run_rounds``:
    one Algorithm-4 outer round; idx: (s, b), valid: (s,).  ``lam``
    overrides ``cfg.lam``: a number replaces it, an (F,) tensor makes the
    round a fleet's over an (F, m) alpha (module docstring; slab-free
    only)."""
    if gram_fn is not None and op is not None:
        raise ValueError("pass at most one of gram_fn (materialized "
                         "slab) or op (prebuilt operator)")
    m = A.shape[0]
    if op is None and gram_fn is None:
        op = ExactGramOperator(A, cfg.kernel)
    if isinstance(lam, torch.Tensor):
        if gram_fn is not None:
            raise ValueError("a fleet round is slab-free (one shared "
                             "operator); gram_fn= is the single-solve "
                             "oracle")
        return _fleet_round_fn(y, m, s, op, fleet_inv_lam(lam))
    inv_lam = 1.0 / (cfg.lam if lam is None else float(lam))

    def round_fn(alpha, xs):
        idx, valid = xs                        # idx: (s, b)
        b = idx.shape[1]
        flat = idx.reshape(s * b)
        # --- kernel phase ------------------------------------------------
        if gram_fn is not None:                # materialized m x sb slab
            Q = gram_fn(A, A[flat], cfg.kernel)
            Gblk = Q[flat, :]
            QTalpha = Q.T @ alpha
        else:
            Gblk, QTalpha = op.round_data(flat, alpha)
        # --- local phase: s block solves ---------------------------------
        dalpha = sstep_bdcd_inner(Gblk, QTalpha, alpha[idx], y[idx], flat,
                                  m, inv_lam, s, b, valid)
        # blocks may overlap inside a round: the accumulating index_put
        # sums every duplicate, as JAX's .at[].add does, and on the card in
        # a fixed order (index_add's atomics would not repeat bit for bit)
        return alpha.index_put((flat,), dalpha.reshape(s * b),
                               accumulate=True)

    return round_fn


def _fleet_round_fn(y, m, s, op, inv_lam):
    """The fleet round of ``make_sstep_bdcd_round_fn(lam=tensor)``."""

    def round_fn(alpha, xs):                   # alpha (F, m)
        idx, valid = xs
        b = idx.shape[1]
        flat = idx.reshape(s * b)
        # one cross block and one KMV of F columns for the whole fleet
        Gblk, QTalpha = op.round_data(flat, alpha.T)
        dalpha = sstep_bdcd_inner_fleet(Gblk, QTalpha.T, alpha[:, idx],
                                        y[idx], flat, m, inv_lam, s, b,
                                        valid)
        return _fleet_update(alpha, flat, dalpha.reshape(-1, s * b))

    return round_fn


def sstep_bdcd_krr(A: torch.Tensor, y: torch.Tensor, alpha0: torch.Tensor,
                   schedule, cfg: KRRConfig, s: int,
                   record_rounds: bool = False,
                   gram_fn: Optional[Callable] = None, op=None,
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run Algorithm 4 over the (H, b) block schedule; ragged H runs a
    masked final short round."""
    round_fn = make_sstep_bdcd_round_fn(A, y, cfg, s, gram_fn=gram_fn,
                                        op=op)
    xs = pad_rounds(as_schedule(schedule, A.device), s)
    res = run_rounds(round_fn, alpha0, xs, record_state=record_rounds,
                     capture=op is None or op.capturable)
    return res.state, (res.state_hist if record_rounds else None)
