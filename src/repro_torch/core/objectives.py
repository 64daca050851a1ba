"""Objectives, duality gap, and closed-form oracles — the counterpart of
``repro/core/objectives.py``.

K-SVM duality gap: ``gap(alpha) = P(alpha) + D(alpha)`` with D the dual
minimization objective and P the primal at the primal point alpha
induces.  Every K-SVM quantity here needs only ``Qa = (y y^T o K)
alpha = y * K(A, A) (y * alpha)``, which is one full KMV — so unlike the
JAX package (which forms the m x m gram in ``_Qbar``) nothing here builds
the m x m slab.

K-RR: the closed form ``alpha* = ((1/lam) K + m I)^{-1} y`` (a dense
oracle), the relative solution error, and the relative residual of the
optimality system (one full KMV).

The facade's tolerance metrics (``ksvm_duality_gap_op``,
``krr_rel_residual_op``, and ``krr_rel_residual`` for a Nystrom fit)
launch on the current stream and never synchronise: on the card each
check is captured at the end of its run's CUDA graph
(``core.loop.RoundGraphs``), and the host reads only its value.
"""
from __future__ import annotations

import torch

from .bdcd import KRRConfig
from .dcd import L1, SVMConfig
from .kernels import KernelConfig, gram_full, gram_slab


def _kmv(A, B, X, cfg: KernelConfig):
    from repro_torch.kernels import ops   # ops imports core.kernels
    return ops.kmv(A, B, X, cfg).to(X.dtype)


def ksvm_Qa(A, y, alpha, cfg: SVMConfig) -> torch.Tensor:
    """``(y y^T o K) alpha`` through one full slab-free KMV."""
    return y * _kmv(A, A, y * alpha, cfg.kernel)


def ksvm_gap_from_Qa(Qa, alpha, C, loss):
    """Primal + dual gap given ``Qa = (yy^T o K) alpha`` — the one place
    the gap formula (L1/L2 hinge, omega shift) lives."""
    if loss == L1:
        Qbar_a = Qa
        hinge = C * torch.sum(torch.clamp(1.0 - Qa, min=0.0))
    else:
        Qbar_a = Qa + (1.0 / (2.0 * C)) * alpha      # omega = 1/(2C)
        hinge = C * torch.sum(torch.clamp(1.0 - Qa, min=0.0) ** 2)
    dual = 0.5 * alpha @ Qbar_a - torch.sum(alpha)
    primal = 0.5 * alpha @ Qa + hinge
    return primal + dual


def ksvm_dual_objective(A, y, alpha, cfg: SVMConfig):
    """D(alpha) = 1/2 alpha^T Qbar alpha - sum(alpha) (minimization form;
    Qbar carries the L2 shift omega I)."""
    Qbar_a = ksvm_Qa(A, y, alpha, cfg) + cfg.omega * alpha
    return 0.5 * alpha @ Qbar_a - torch.sum(alpha)


def ksvm_primal_objective(A, y, alpha, cfg: SVMConfig):
    """Primal objective at the KKT primal point: 1/2 alpha^T Q alpha plus
    the (squared) hinge on the margins ``(Q alpha)_i``."""
    Qa = ksvm_Qa(A, y, alpha, cfg)
    margins = torch.clamp(1.0 - Qa, min=0.0)
    loss = (torch.sum(margins) if cfg.loss == L1
            else torch.sum(margins ** 2))
    return 0.5 * alpha @ Qa + cfg.C * loss


def ksvm_duality_gap(A, y, alpha, cfg: SVMConfig):
    """Duality gap from one full KMV (no m x m slab)."""
    return ksvm_gap_from_Qa(ksvm_Qa(A, y, alpha, cfg), alpha, cfg.C,
                            cfg.loss)


def ksvm_duality_gap_lowrank(Phi, y, alpha, cfg: SVMConfig):
    """Duality gap under the factored kernel ``K~ = Phi Phi^T``: the
    shared ``Qa`` is the O(m l) product ``y * (Phi (Phi^T (y alpha)))``
    — the low-rank facade's tolerance metric."""
    Qa = y * (Phi @ (Phi.T @ (y * alpha)))
    return ksvm_gap_from_Qa(Qa, alpha, cfg.C, cfg.loss)


def ksvm_duality_gap_op(op, y, alpha, cfg: SVMConfig):
    """The duality gap with ``Qa = y * (K @ (y * alpha))`` read through an
    operator's ``full_matvec`` (over the unscaled data): for a streamed
    operator one streamed full KMV, where ``ksvm_duality_gap`` reads a
    device-resident A."""
    Qa = y * op.full_matvec(y * alpha)
    return ksvm_gap_from_Qa(Qa, alpha, cfg.C, cfg.loss)


def krr_rel_residual_op(op, y, alpha, cfg: KRRConfig):
    """``krr_rel_residual`` with ``K @ alpha`` read through an operator's
    ``full_matvec`` (the streamed fit's metric)."""
    m = op.n_samples
    r = y - (op.full_matvec(alpha) / cfg.lam + m * alpha)
    return torch.linalg.norm(r) / torch.linalg.norm(y)


def krr_dual_objective(A, y, alpha, cfg: KRRConfig):
    """Paper eq. (2): 1/2 alpha^T ((1/lam) K + m I) alpha - alpha^T y."""
    m = A.shape[0]
    Ma = _kmv(A, A, alpha, cfg.kernel) / cfg.lam + m * alpha
    return 0.5 * alpha @ Ma - alpha @ y


def krr_closed_form(A, y, cfg: KRRConfig):
    """alpha* via a dense factorization of the full kernel matrix (the
    paper's reference; an m x m oracle)."""
    m = A.shape[0]
    M = gram_full(A, cfg.kernel) / cfg.lam + m * torch.eye(
        m, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(M, y)


def relative_solution_error(alpha, alpha_star):
    return torch.linalg.norm(alpha - alpha_star) / torch.linalg.norm(
        alpha_star)


def krr_rel_residual_value(A, y, alpha, lam, kernel: KernelConfig):
    """``||y - ((1/lam) K + m I) alpha|| / ||y||`` through one full KMV."""
    m = A.shape[0]
    r = y - (_kmv(A, A, alpha, kernel) / lam + m * alpha)
    return torch.linalg.norm(r) / torch.linalg.norm(y)


def krr_rel_residual(A, y, alpha, cfg: KRRConfig):
    """Relative residual of the K-RR optimality system — the
    closed-form-free convergence metric of the facade's stopper."""
    return krr_rel_residual_value(A, y, alpha, cfg.lam, cfg.kernel)


def ksvm_predict(A_train, y_train, alpha, A_test, cfg: SVMConfig):
    """Dense oracle: f(x) = sum_i alpha_i y_i K(a_i, x), materializing the
    (q x m) test-kernel slab.  Serving goes through ``core.predict``."""
    return gram_slab(A_test, A_train, cfg.kernel) @ (alpha * y_train)


def krr_predict(A_train, alpha, A_test, cfg: KRRConfig):
    """Dense oracle: f(x) = (1/lam) K(x, A) alpha."""
    return (gram_slab(A_test, A_train, cfg.kernel) @ alpha) / cfg.lam
