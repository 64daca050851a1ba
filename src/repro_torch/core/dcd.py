"""Classical Dual Coordinate Descent (paper Algorithm 1) for kernel SVM —
the counterpart of ``repro/core/dcd.py``.

Solves the dual K-SVM problem one coordinate at a time.  Each iteration
reads one column ``u = K(Atil, a_i)`` only through ``u^T alpha`` and
``u[i]``, so the default path reads both through a slab-free
``GramOperator`` (one KMV launch and one 1 x 1 gram launch per iteration
on the card); ``gram_fn`` forces the materialized-column path, kept as
the parity oracle.  ``C=`` given as an (F,) tensor makes the round a
fleet's: F problems of a C grid advance an (F, m) alpha in lockstep
(``tune.fleet``; the fleets themselves run the s-step rounds).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from .kernels import ExactGramOperator, KernelConfig
from .loop import as_schedule, run_rounds

L1 = "l1"
L2 = "l2"


@dataclasses.dataclass(frozen=True)
class SVMConfig:
    C: float = 1.0
    loss: str = L1            # "l1" (hinge) or "l2" (squared hinge)
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)

    def __post_init__(self):
        if self.loss not in (L1, L2):
            raise ValueError(f"loss must be 'l1' or 'l2', got {self.loss!r}")

    @property
    def nu(self) -> float:
        """Upper clip bound on alpha (paper line 2)."""
        return self.C if self.loss == L1 else float("inf")

    @property
    def omega(self) -> float:
        """Diagonal shift (paper line 2)."""
        return 0.0 if self.loss == L1 else 1.0 / (2.0 * self.C)


def _nu_omega(cfg: SVMConfig, C=None):
    """(nu, omega) from the config, with ``C`` (a number) in place of
    ``cfg.C`` when given."""
    if C is not None:
        cfg = dataclasses.replace(cfg, C=float(C))
    return cfg.nu, cfg.omega


def fleet_nu_omega(cfg: SVMConfig, C: torch.Tensor):
    """(nu, omega) as (F,) tensors for a fleet's C grid (C: (F,) in the
    state's dtype).  omega is 1/(2C) taken in f64 and rounded once, as
    the single round's Python float is when it meets an f32 tensor."""
    if cfg.loss == L1:
        return C, torch.zeros_like(C)
    return (torch.full_like(C, float("inf")),
            (1.0 / (2.0 * C.double())).to(C.dtype))


def _clip(x, nu):
    """``clamp(x, 0, nu)`` with a per-member (F,) upper bound."""
    return torch.minimum(torch.clamp(x, min=0.0), nu)


def _fleet_update(alpha: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``alpha[f, idx] += vals[f]`` for an (F, m) alpha and (F, k) vals:
    the accumulating ``index_put`` of the single rounds on the flattened
    state, so repeated coordinates sum in a fixed order (and one member's
    update is the single round's own call)."""
    F, m = alpha.shape
    flat = (torch.arange(F, device=alpha.device)[:, None] * m
            + idx[None, :]).reshape(-1)
    return alpha.reshape(-1).index_put(
        (flat,), vals.reshape(-1), accumulate=True).reshape(F, m)


def coordinate_schedule(gen: torch.Generator, H: int, m: int,
                        device: Optional[torch.device] = None
                        ) -> torch.Tensor:
    """i_k ~ Uniform[m], k = 1..H, drawn from ``gen`` (on its device) and
    returned on ``device``.  DCD and s-step DCD share one schedule so
    that their iterates are comparable."""
    sched = torch.randint(0, m, (H,), generator=gen, device=gen.device)
    return sched.to(device if device is not None else gen.device)


def _dcd_theta(alpha_i, g, eta, nu):
    """One DCD coordinate update (paper lines 8-16). Returns theta."""
    cand = torch.clamp(alpha_i - g, 0.0, nu) - alpha_i
    return torch.where(cand.abs() != 0.0,
                       torch.clamp(alpha_i - g / eta, 0.0, nu) - alpha_i,
                       0.0)


def make_dcd_round_fn(A: torch.Tensor, y: torch.Tensor, cfg: SVMConfig,
                      gram_fn: Optional[Callable] = None,
                      op=None, C=None, guard: bool = False) -> Callable:
    """``round_fn(alpha, i) -> alpha`` for ``loop.run_rounds``: one
    Algorithm-1 coordinate step.

    ``op`` injects a prebuilt operator over the training representation,
    already row-scaled by ``diag(y)`` (``operator.scale_rows(y)``);
    ``gram_fn(Atil, rows, kernel)`` selects the materialized path.  ``C``
    overrides ``cfg.C``: a number replaces it, an (F,) tensor makes the
    round a fleet's over an (F, m) alpha (slab-free only).

    ``guard=True`` is the guarded-carry round, ``round_fn((alpha, f), i)
    -> (alpha, f)`` with ``f = Ktil alpha`` kept by the recurrence ``f +=
    Ktil[:, i] theta`` (``op.apply_at``): ``u^T alpha`` becomes the free
    gather ``f[i]``.  Operator path only."""
    if gram_fn is not None and op is not None:
        raise ValueError("pass at most one of gram_fn (materialized "
                         "slab) or op (prebuilt operator)")
    if guard and gram_fn is not None:
        raise ValueError("guard=True requires the GramOperator path "
                         "(gram_fn= is the legacy materialized oracle)")
    if isinstance(C, torch.Tensor):
        if gram_fn is not None:
            raise ValueError("a fleet round is slab-free (one shared "
                             "operator); gram_fn= is the single-solve "
                             "oracle")
        return _fleet_dcd_round_fn(A, y, cfg, op, C)
    nu, omega = _nu_omega(cfg, C)
    Atil = None
    if gram_fn is not None:
        Atil = y[:, None] * A                   # diag(y) @ A
    elif op is None:
        op = ExactGramOperator(A, cfg.kernel).scale_rows(y)
    if guard:
        return _guarded_dcd_round_fn(op, nu, omega)

    def round_fn(alpha, i):
        # gather through the (1,) index: indexing with the 0-dim i itself
        # would read it on the host, which a captured round cannot do
        idx = i.reshape(1)
        a_i = alpha[idx][0]
        if gram_fn is not None:                 # materialized m x 1 column
            u = gram_fn(Atil, Atil[idx], cfg.kernel)[:, 0]
            eta = u[idx][0] + omega
            g = u @ alpha - 1.0 + omega * a_i
        else:                                   # slab-free operator path
            G, uTa = op.round_data(idx, alpha)  # (1, 1), (1,)
            eta = G[0, 0] + omega
            g = uTa[0] - 1.0 + omega * a_i
        theta = _dcd_theta(a_i, g, eta, nu)
        return alpha.index_add(0, idx, theta.reshape(1))

    return round_fn


def _guarded_dcd_round_fn(op, nu, omega):
    """The guarded round of ``make_dcd_round_fn(guard=True)``."""

    def round_fn(carry, i):
        alpha, f = carry                        # f = Ktil @ alpha, (m,)
        idx = i.reshape(1)
        a_i = alpha[idx][0]
        eta = op.cross_block(idx)[0, 0] + omega
        g = f[idx][0] - 1.0 + omega * a_i       # u^T alpha = f[i], free
        theta = _dcd_theta(a_i, g, eta, nu).reshape(1)
        return (alpha.index_add(0, idx, theta), f + op.apply_at(idx, theta))

    return round_fn


def _fleet_dcd_round_fn(A, y, cfg, op, C):
    """The fleet round of ``make_dcd_round_fn(C=tensor)``."""
    nu, omega = fleet_nu_omega(cfg, C)
    if op is None:
        op = ExactGramOperator(A, cfg.kernel).scale_rows(y)

    def round_fn(alpha, i):
        idx = i.reshape(1)
        a_i = alpha[:, idx][:, 0]                     # (F,)
        G, uTa = op.round_data(idx, alpha.T)          # (1, 1), (1, F)
        eta = G[0, 0] + omega
        g = uTa[0] - 1.0 + omega * a_i
        cand = _clip(a_i - g, nu) - a_i
        theta = torch.where(cand.abs() != 0.0,
                            _clip(a_i - g / eta, nu) - a_i, 0.0)
        return _fleet_update(alpha, idx, theta[:, None])

    return round_fn


def dcd_ksvm(A: torch.Tensor, y: torch.Tensor, alpha0: torch.Tensor,
             schedule, cfg: SVMConfig, record_every: int = 0,
             gram_fn: Optional[Callable] = None, op=None,
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run Algorithm 1 for ``H = len(schedule)`` iterations.

    Returns ``(alpha_H, history)``; ``history`` stacks alpha every
    ``record_every`` iterations (None when 0)."""
    round_fn = make_dcd_round_fn(A, y, cfg, gram_fn=gram_fn, op=op)
    res = run_rounds(round_fn, alpha0, as_schedule(schedule, A.device),
                     record_state=bool(record_every),
                     capture=op is None or op.capturable)
    if record_every:
        return res.state, res.state_hist[record_every - 1::record_every]
    return res.state, None
