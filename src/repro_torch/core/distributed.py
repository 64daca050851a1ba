"""Distributed DCD/BDCD solvers on ``torch.distributed`` — the counterpart
of ``repro/core/distributed.py`` (the paper's MPI implementation, Section
5.2), run SPMD: every rank calls the same solver on the same global
``A``, ``y``, ``alpha0`` and schedule, takes its own block of A, and
meets the others only in ``Mesh.all_reduce`` (``launch.mesh``; the
process model is described there).

Layouts
-------
1D (paper):   A is partitioned in 1D-column (feature) layout over the
              ``model`` axis — each rank holds ``A[:, n/P]``.  The
              per-round kernel-slab reduction ``sum_p A_p B_p^T`` is one
              all-reduce; alpha, y and all solver state are replicated,
              as each MPI rank "redundantly stores y and alpha" (Thm 1
              proof).

2D (beyond paper): additionally shards samples over the ``data`` axis.
              The model-axis reduction then carries only ``m/P_data x
              sb`` words a rank, at the cost of two more small
              collectives a round (the sampled-row gather and the fused
              cross-term reduction).  alpha is sharded over ``data``: the
              solvers return this rank's rows, and ``assemble_2d`` puts
              the whole alpha on every rank with one more reduction.

Classical vs s-step: the classical solvers reduce every iteration (H
collectives); the s-step solvers once an outer round (H/s), which is the
paper's entire contribution.

Kernels: every rank's partials go through the port's hand-written
kernels (``kernels.ops``, the plain versions for CPU tensors).  The 1d
linear round is ``gram(B_loc, B_loc)`` and ``kmv(A_loc, B_loc, x)`` (one
launch each), packed into one ``(sb, sb+1)`` reduction; the 1d
nonlinear round reduces the pre-epilogue block ``A_loc B_loc^T`` (one
gram launch with the linear config), slices the sampled cross-dots out
of the same reduction, and runs the epilogue and ``U^T x`` as plain
products, as the reference's ``jnp`` does; the 2d round reduces
``A_loc B_loc^T`` and ``B_loc B_loc^T`` (two gram launches) in one
``model`` reduction.  The rounds run eagerly (``run_rounds(capture=
False)``): a gloo reduction cannot be captured in a CUDA graph.

Slab-free: the solvers read the kernel through an operator, so the
psum-before-epilogue ordering of nonlinear kernels (Thm 1/2 proofs)
holds while the post-epilogue slab never leaves the round; for the
linear kernel the m x sb reduction disappears (only the contracted
``(sb, sb+1)`` words are reduced).  ``slab_free=False`` keeps the
materialized-slab reduction as the parity oracle (1d only).
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import Mesh
from .bdcd import KRRConfig
from .dcd import SVMConfig
from .kernels import LINEAR, RBF, KernelConfig, apply_epilogue
from .loop import as_schedule, pad_rounds, run_rounds
from .sstep_bdcd import make_sstep_bdcd_round_fn, sstep_bdcd_inner
from .sstep_dcd import make_sstep_dcd_round_fn, sstep_dcd_inner

_LINEAR = KernelConfig(LINEAR)


def _ops():
    from repro_torch.kernels import ops   # ops imports core.kernels
    return ops


def _dots(A_loc: torch.Tensor, B_loc: torch.Tensor) -> torch.Tensor:
    """This rank's partial ``A_loc B_loc^T``: the gram kernel with the
    linear config (its plain version on the CPU), in A_loc's dtype."""
    return _ops().gram(A_loc, B_loc, _LINEAR).to(A_loc.dtype)


def make_allreduce_gram(mesh: Mesh, axis_name: str, row_sqnorms=None):
    """Feature-partitioned MATERIALIZED gram slab (the ``slab_free=False``
    parity oracle): partial dots on local columns, one all-reduce, then
    the nonlinear epilogue applied redundantly on every rank.

    For RBF, ``row_sqnorms`` (the reduced ||a_i||^2, loop-invariant)
    removes the per-round (m,) norm reduction, and the (sb,) B-norm
    vector rides the slab's reduction as one extra row, so every round
    issues exactly one collective."""

    def gram(A_loc, B_loc, cfg: KernelConfig):
        dots_part = _dots(A_loc, B_loc)                 # (m, sb) partial
        if cfg.name != RBF:
            return apply_epilogue(mesh.all_reduce(dots_part, axis_name), cfg)
        cs_part = torch.sum(B_loc * B_loc, dim=1)[None, :]
        if row_sqnorms is not None:
            packed = mesh.all_reduce(torch.cat([dots_part, cs_part], dim=0),
                                     axis_name)
            return apply_epilogue(packed[:-1], cfg, row_sqnorms, packed[-1])
        rs = mesh.all_reduce(torch.sum(A_loc * A_loc, dim=1), axis_name)
        cs = mesh.all_reduce(cs_part[0], axis_name)
        return apply_epilogue(mesh.all_reduce(dots_part, axis_name), cfg,
                              rs, cs)

    return gram


class AllreduceGramOperator:
    """Slab-free operator for the paper's 1D-column layout: ``round_data``
    issues exactly ONE all-reduce a round (module docstring).

      linear:    ``B (A^T x)`` and ``B B^T`` — (sb, sb+F) words — are
                 reduced; the m x sb slab is never formed.
      poly/rbf:  the pre-epilogue m x sb dot block is reduced first
                 (Thm 1/2 ordering); the sampled cross-dots are sliced
                 out of that reduction (``dots[idx]``), the epilogue runs
                 redundantly on every rank, and ``U^T x`` is contracted
                 at once.

    ``row_sqnorms`` (the reduced ||a_i||^2) must be given for RBF.  Only
    ``round_data`` exists, the solvers' whole per-round contract, as in
    the reference.  ``x`` may be (m,) or (m, F) (a fleet's alphas)."""

    capturable = False

    def __init__(self, mesh: Mesh, axis_name: str, A_loc: torch.Tensor,
                 cfg: KernelConfig, row_sqnorms=None):
        if cfg.name == RBF and row_sqnorms is None:
            raise ValueError("RBF AllreduceGramOperator needs the reduced "
                             "row_sqnorms (loop-invariant, compute once)")
        self.mesh = mesh
        self.axis_name = axis_name
        self.A_loc = A_loc
        self.cfg = cfg
        self.rs = row_sqnorms

    def round_data(self, idx, x):
        ops, cfg, A_loc = _ops(), self.cfg, self.A_loc
        B_loc = A_loc[idx]
        r = idx.shape[0]
        if cfg.name == LINEAR:
            cross_part = ops.gram(B_loc, B_loc, cfg).to(A_loc.dtype)
            mv_part = ops.kmv(A_loc, B_loc, x, cfg).to(x.dtype)
            packed = self.mesh.all_reduce(
                torch.cat([cross_part, mv_part.reshape(r, -1)], dim=1),
                self.axis_name)
            mv = packed[:, r:]
            return packed[:, :r], (mv[:, 0] if x.ndim == 1 else mv)
        dots = self.mesh.all_reduce(_dots(A_loc, B_loc), self.axis_name)
        cross = dots[idx]                          # == the reduced B B^T
        if cfg.name == RBF:
            cs = self.rs[idx]
            U = apply_epilogue(dots, cfg, self.rs, cs)      # transient
            G = apply_epilogue(cross, cfg, cs, cs)
        else:
            U = apply_epilogue(dots, cfg)
            G = apply_epilogue(cross, cfg)
        return G, U.T @ x


def _reduced_row_sqnorms(mesh: Mesh, A_loc, cfg: KernelConfig,
                         axis_name: str):
    """Loop-invariant reduced ||a_i||^2 (RBF only; None otherwise): the
    one setup collective of a solve."""
    if cfg.name != RBF:
        return None
    return mesh.all_reduce(torch.sum(A_loc * A_loc, dim=1), axis_name,
                           "setup")


def shard_dataset_1d(mesh: Mesh, A: torch.Tensor,
                     axis_name: str = "model") -> torch.Tensor:
    """This rank's block of A's columns in the paper's 1D-column layout
    (``torch.tensor_split``: the first ``n % P`` blocks one column
    wider), contiguous."""
    return torch.tensor_split(A, mesh.shape[axis_name], dim=1)[
        mesh.index(axis_name)].contiguous()


# --------------------------------------------------------------------------
# 1D (paper) layout solvers.  The serial solver bodies are reused verbatim:
# only the gram operator changes, which is precisely the paper's claim that
# the s-step schedule is independent of the partitioning.
# --------------------------------------------------------------------------

def dist_sstep_dcd_ksvm(mesh: Mesh, A, y, alpha0, schedule,
                        cfg: SVMConfig, s: int, axis_name: str = "model",
                        slab_free: bool = True, op_factory=None
                        ) -> torch.Tensor:
    """s-step DCD for K-SVM with A in 1D-column layout over ``axis_name``.

    A is the global matrix (every rank's copy); this rank's column block
    is taken here.  Returns the replicated final alpha.
    ``slab_free=False`` selects the materialized-slab all-reduce path
    (parity oracle).  ``op_factory(Atil_loc, kernel_cfg)`` injects a
    custom per-rank operator built from the LOCAL, already
    ``diag(y)``-scaled column block (a closure carries the mesh, as
    ``resilience.poisoned_1d_factory``'s does).  For the low-rank
    representation pass ``A = Phi`` with a linear kernel config: Phi's l
    columns are sharded and only the contracted (sb, sb+1) words are
    reduced."""
    return LayoutSolver(mesh, "1d", A, y, cfg, slab_free=slab_free,
                        model_axis=axis_name).run(alpha0, schedule, s,
                                                  op_factory=op_factory)


def dist_dcd_ksvm(mesh: Mesh, A, y, alpha0, schedule, cfg: SVMConfig,
                  axis_name: str = "model", slab_free: bool = True
                  ) -> torch.Tensor:
    """Classical DCD baseline (communicates every iteration): the s-step
    solver at s = 1, which is Algorithm 1's schedule — one m-word
    reduction an iteration."""
    return dist_sstep_dcd_ksvm(mesh, A, y, alpha0, schedule, cfg, s=1,
                               axis_name=axis_name, slab_free=slab_free)


def dist_sstep_bdcd_krr(mesh: Mesh, A, y, alpha0, schedule,
                        cfg: KRRConfig, s: int, axis_name: str = "model",
                        slab_free: bool = True, op_factory=None
                        ) -> torch.Tensor:
    """s-step BDCD for K-RR, 1D-column layout (see
    ``dist_sstep_dcd_ksvm``; ``op_factory(A_loc, kernel_cfg)``)."""
    return LayoutSolver(mesh, "1d", A, y, cfg, slab_free=slab_free,
                        model_axis=axis_name).run(alpha0, schedule, s,
                                                  op_factory=op_factory)


def dist_bdcd_krr(mesh: Mesh, A, y, alpha0, schedule, cfg: KRRConfig,
                  axis_name: str = "model", slab_free: bool = True
                  ) -> torch.Tensor:
    """Classical BDCD baseline — one (m x b)-word reduction an
    iteration."""
    return dist_sstep_bdcd_krr(mesh, A, y, alpha0, schedule, cfg, s=1,
                               axis_name=axis_name, slab_free=slab_free)


# --------------------------------------------------------------------------
# 2D (samples x features) s-step solvers — beyond-paper optimization.
# Both drive the shared round protocol (core/loop.py); the redundant inner
# phases are the SAME functions the serial solvers use.
# --------------------------------------------------------------------------

class RowSelector:
    """The sampled rows of one round that this data-rank owns: ``mine``
    (sb,) bool and ``local`` (sb,) their local row indices (clamped into
    range where not owned).  The counterpart of the reference's one-hot
    selector: a reduction over ``data`` of ``gather(X_loc)`` IS the
    gather of the global rows, and ``scatter_add`` the placement of an
    update — the same values as the one-hot products (every row adds
    zeros from the ranks that do not own it)."""

    def __init__(self, flat: torch.Tensor, row0: int, m_loc: int):
        local = flat - row0
        self.mine = (local >= 0) & (local < m_loc)
        self.local = local.clamp(0, m_loc - 1)

    def gather(self, X_loc: torch.Tensor) -> torch.Tensor:
        """``X_loc[flat]`` where this rank owns the row, zeros
        elsewhere: (sb, ...)."""
        rows = X_loc[self.local]
        mask = self.mine.reshape((-1,) + (1,) * (rows.ndim - 1))
        return torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                                   device=rows.device))

    def scatter_add(self, x_loc: torch.Tensor, d: torch.Tensor
                    ) -> torch.Tensor:
        """``x_loc`` plus ``d`` at the owned rows; the rows of other
        ranks add zero (to row 0), so the shapes stay fixed and
        duplicates sum as the serial round's accumulating index_put."""
        return x_loc.index_put((self.local,), torch.where(
            self.mine, d, torch.zeros((), dtype=d.dtype, device=d.device)),
            accumulate=True)


class Sharded2dGramOperator:
    """Per-rank slab-free gram operator for the 2D (samples x features)
    layout — the 2D twin of ``AllreduceGramOperator``.  Both 2D solver
    bodies consume only ``round_parts``, so another representation (a
    row-sharded low-rank factor: ``A = Phi`` with a linear config) drops
    in without touching the solver math.

    ``round_parts(flat)`` runs collectives (1) and (2) of the 2D round:
    gather the sampled rows over ``data``, then one ``model`` reduction
    of the row-local dot block with the sb x sb cross-dots riding the
    same collective.  Returns (selector, Q_loc, Gblk): the
    ``RowSelector``, the epilogued row-local slab tile, and the
    replicated sampled cross block."""

    def __init__(self, mesh: Mesh, A_loc, kernel: KernelConfig, *,
                 data_axis: str, model_axis: str, row0: int, m_loc: int,
                 row_sqnorms=None):
        self.mesh = mesh
        self.A_loc = A_loc
        self.kernel = kernel
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.row0 = row0
        self.m_loc = m_loc
        self.rs_loc = row_sqnorms

    def round_parts(self, flat):
        A_loc, kernel, m_loc = self.A_loc, self.kernel, self.m_loc
        sel = RowSelector(flat, self.row0, m_loc)
        B_loc = self.mesh.all_reduce(sel.gather(A_loc),
                                     self.data_axis)        # (sb, n_loc)
        packed = self.mesh.all_reduce(torch.cat(
            [_dots(A_loc, B_loc),                            # (m_loc, sb)
             _dots(B_loc, B_loc)], dim=0), self.model_axis)
        dots, cross = packed[:m_loc], packed[m_loc:]
        if kernel.name == RBF:
            cs = torch.diagonal(cross)                   # ||b_j||^2 free
            Q_loc = apply_epilogue(dots, kernel, self.rs_loc, cs)
            Gblk = apply_epilogue(cross, kernel, cs, cs)
        else:
            Q_loc = apply_epilogue(dots, kernel)
            Gblk = apply_epilogue(cross, kernel)
        return sel, Q_loc, Gblk


def _2d_block(mesh: Mesh, A, m: int, data_axis: str, model_axis: str):
    """(row0, m_loc, A_loc): this rank's row range and its block of A."""
    pd = mesh.shape[data_axis]
    if m % pd != 0:
        raise ValueError(f"m={m} must divide data axis {pd}")
    m_loc = m // pd
    row0 = mesh.index(data_axis) * m_loc
    A_loc = torch.tensor_split(A[row0:row0 + m_loc],
                               mesh.shape[model_axis], dim=1)[
        mesh.index(model_axis)].contiguous()
    return row0, m_loc, A_loc


def dist_sstep_bdcd_krr_2d(mesh: Mesh, A, y, alpha0, schedule,
                           cfg: KRRConfig, s: int,
                           data_axis: str = "data",
                           model_axis: str = "model",
                           op_factory=None) -> torch.Tensor:
    """2D-partitioned s-step BDCD: A[m/Pd, n/Pm] per rank, alpha sharded
    over ``data``; returns this rank's (m/Pd,) rows of alpha
    (``assemble_2d`` gathers them).

    Per outer round the collective schedule is:
      1. data  : gather the s*b sampled rows (s*b x n/Pm words)
      2. model : reduce the row-local dot block PLUS the s*b x s*b
                 cross-dots riding the same collective
                 ((m/Pd + s*b) x s*b words)
      3. data  : fuse {Q^T alpha, alpha at idx, y at idx} into ONE
                 collective (s*b x 3 words)
    vs. the 1D layout's single reduction of (m x s*b).  RBF row norms
    are loop-invariant and reduced once.  Ragged H (H % s != 0) runs a
    masked final short round (``loop.pad_rounds``).  ``op_factory``
    overrides the per-rank ``Sharded2dGramOperator`` (same constructor
    signature)."""
    return LayoutSolver(mesh, "2d", A, y, cfg, data_axis=data_axis,
                        model_axis=model_axis).run(alpha0, schedule, s,
                                                   op_factory=op_factory)


def dist_sstep_dcd_ksvm_2d(mesh: Mesh, A, y, alpha0, schedule,
                           cfg: SVMConfig, s: int,
                           data_axis: str = "data",
                           model_axis: str = "model",
                           op_factory=None) -> torch.Tensor:
    """2D-partitioned s-step DCD for K-SVM: Atil[m/Pd, n/Pm] per rank,
    alpha and y sharded over ``data``; returns this rank's rows of
    alpha.  Same collective schedule as the 2D BDCD solver ({U^T alpha,
    alpha at idx} in the third collective), with the scalar-coordinate
    inner recurrence of the serial solver (``sstep_dcd_inner``)."""
    return LayoutSolver(mesh, "2d", A, y, cfg, data_axis=data_axis,
                        model_axis=model_axis).run(alpha0, schedule, s,
                                                   op_factory=op_factory)


def assemble_2d(mesh: Mesh, alpha_loc: torch.Tensor, m: int,
                data_axis: str = "data") -> torch.Tensor:
    """The whole (m,) alpha on every rank from the 2d solvers' row
    shards: each data-rank places its rows in zeros and one ``data``
    reduction sums them (a setup collective of the solve)."""
    m_loc = alpha_loc.shape[0]
    row0 = mesh.index(data_axis) * m_loc
    placed = alpha_loc.new_zeros(m)
    placed[row0:row0 + m_loc] = alpha_loc
    return mesh.all_reduce(placed, data_axis, "setup")


class LayoutSolver:
    """One rank's side of a 1d or 2d solve, set up once and run over any
    number of schedule pieces (the facade's and the fleet's chunks, a
    guard's re-runs at another s).  Setting up takes this rank's block of
    A (``diag(y)``-scaled for K-SVM, which ``cfg``, an ``SVMConfig`` or
    ``KRRConfig``, names) and reduces the RBF row norms over ``model``:
    the solve's one setup collective, however many pieces follow (in 1d
    at the first run that needs them: an ``op_factory`` run does not).
    Every rank builds it with the same arguments (SPMD).  ``slab_free``
    picks the 1d round's route (the 2d layout is slab-free only)."""

    def __init__(self, mesh: Mesh, layout: str, A: torch.Tensor,
                 y: torch.Tensor, cfg, *, slab_free: bool = True,
                 data_axis: str = "data", model_axis: str = "model"):
        if layout not in ("1d", "2d"):
            raise ValueError(f"layout must be '1d' or '2d', got {layout!r}")
        self.mesh, self.layout, self.cfg = mesh, layout, cfg
        self.ksvm = isinstance(cfg, SVMConfig)
        self.data_axis, self.model_axis = data_axis, model_axis
        self.m = A.shape[0]
        kernel = cfg.kernel
        if layout == "1d":
            self.A_loc = shard_dataset_1d(mesh, A, model_axis)
            self.y = y
            self.data_loc = (y[:, None] * self.A_loc if self.ksvm
                             else self.A_loc)
            self.slab_free = slab_free
            self._route = None
            return
        self.row0, self.m_loc, A_loc = _2d_block(mesh, A, self.m, data_axis,
                                                 model_axis)
        self.y_loc = y[self.row0:self.row0 + self.m_loc]
        self.data_loc = (self.y_loc[:, None] * A_loc if self.ksvm
                         else A_loc)
        self.op_kw = dict(data_axis=data_axis, model_axis=model_axis,
                          row0=self.row0, m_loc=self.m_loc,
                          row_sqnorms=_reduced_row_sqnorms(
                              mesh, self.data_loc, kernel, model_axis))
        self.op = Sharded2dGramOperator(mesh, self.data_loc, kernel,
                                        **self.op_kw)

    def _route_1d(self) -> dict:
        """The 1d round's default kernel route (the solver-body keyword:
        the slab-free operator, or the materialized-slab ``gram_fn``),
        built once."""
        if self._route is None:
            mesh, axis, kernel = self.mesh, self.model_axis, self.cfg.kernel
            rs = _reduced_row_sqnorms(mesh, self.data_loc, kernel, axis)
            self._route = (
                {"op": AllreduceGramOperator(mesh, axis, self.data_loc,
                                             kernel, rs)}
                if self.slab_free else
                {"gram_fn": make_allreduce_gram(mesh, axis, row_sqnorms=rs)})
        return self._route

    def run(self, alpha0: torch.Tensor, schedule, s: int, *,
            op_factory=None, **params) -> torch.Tensor:
        """The rounds of ``schedule`` at ``s`` from ``alpha0`` (the whole
        alpha; (F, m) for a 1d fleet, with its (F,) ``C=`` or ``lam=``),
        eagerly: a reduction inside a round cannot be captured as a CUDA
        graph.  Returns this rank's state: the whole alpha in 1d, this
        rank's rows in 2d.  ``op_factory`` replaces the operator for this
        run (1d: ``op_factory(data_loc, kernel_cfg)``; 2d: the
        ``Sharded2dGramOperator`` signature)."""
        sched = as_schedule(schedule, self.data_loc.device)
        xs = pad_rounds(sched, s)
        if self.layout == "1d":
            kw = (self._route_1d() if op_factory is None
                  else {"op": op_factory(self.data_loc, self.cfg.kernel)})
            make = (make_sstep_dcd_round_fn if self.ksvm
                    else make_sstep_bdcd_round_fn)
            # the gram_fn body re-applies diag(y), the op path reads A
            # only for its shape
            rf = make(self.A_loc, self.y, self.cfg, s, **kw, **params)
            return run_rounds(rf, alpha0, xs, capture=False).state
        if params:
            raise ValueError("the 2d layout solves one problem at a time "
                             "(a fleet runs on the 1d layout)")
        op = (self.op if op_factory is None
              else op_factory(self.mesh, self.data_loc, self.cfg.kernel,
                              **self.op_kw))
        rf = (self._dcd_round_2d(op, s) if self.ksvm
              else self._bdcd_round_2d(op, s, sched.shape[1]))
        a0_loc = alpha0[self.row0:self.row0 + self.m_loc]
        return run_rounds(rf, a0_loc, xs, capture=False).state

    def solve(self, alpha0: torch.Tensor, schedule, s: int,
              **kw) -> torch.Tensor:
        """``run``, then the whole alpha on every rank (a 2d run assembles
        its rows with one more reduction, ``assemble_2d``)."""
        out = self.run(alpha0, schedule, s, **kw)
        if self.layout == "1d":
            return out
        return assemble_2d(self.mesh, out, self.m, self.data_axis)

    def _bdcd_round_2d(self, op, s: int, b: int):
        """The 2d BDCD round (``dist_sstep_bdcd_krr_2d``'s collective
        schedule) around the serial solver's inner phase."""
        mesh, data_axis, m, y_loc = self.mesh, self.data_axis, self.m, \
            self.y_loc
        inv_lam = 1.0 / self.cfg.lam

        def round_fn(alpha_loc, xs):                  # idx: (s, b) global
            idx, valid = xs
            flat = idx.reshape(s * b)
            sel, Q_loc, Gblk = op.round_parts(flat)
            # (3) contract the slab tile at once and fuse every data-axis
            #     cross term into ONE reduction
            packed = mesh.all_reduce(torch.stack([
                Q_loc.T @ alpha_loc, sel.gather(alpha_loc),
                sel.gather(y_loc)], dim=1), data_axis)
            QTalpha = packed[:, 0]
            alpha_at = packed[:, 1].reshape(s, b)
            y_at = packed[:, 2].reshape(s, b)
            # redundant inner loop — shared with the serial solver
            dalpha = sstep_bdcd_inner(Gblk, QTalpha, alpha_at, y_at, flat,
                                      m, inv_lam, s, b, valid)
            return sel.scatter_add(alpha_loc, dalpha.reshape(s * b))

        return round_fn

    def _dcd_round_2d(self, op, s: int):
        """The 2d DCD round: the same schedule, the scalar-coordinate
        inner recurrence."""
        mesh, data_axis = self.mesh, self.data_axis
        nu, omega = self.cfg.nu, self.cfg.omega

        def round_fn(alpha_loc, xs):                  # idx: (s,) global
            idx, valid = xs
            sel, U_loc, G0 = op.round_parts(idx)
            packed = mesh.all_reduce(torch.stack([
                U_loc.T @ alpha_loc, sel.gather(alpha_loc)], dim=1),
                data_axis)
            thetas = sstep_dcd_inner(G0, packed[:, 0], packed[:, 1], idx,
                                     nu, omega, s, valid)
            return sel.scatter_add(alpha_loc, thetas)

        return round_fn
