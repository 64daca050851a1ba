"""The port's four solvers and round driver against the JAX package's,
replaying the JAX schedule from the same a0 on the same numpy data.

f32 iterates are held to 1e-5 (tests/test_slabfree_parity.py); s-step
against classical inside the port to the repo's own equivalence bound
(rtol 2e-4, atol 2e-5, tests/test_core_equivalence.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KernelConfig as JKernelConfig
from repro.core import KRRConfig as JKRRConfig
from repro.core import SVMConfig as JSVMConfig
from repro.core import bdcd_krr as j_bdcd_krr
from repro.core import block_schedule as j_block_schedule
from repro.core import coordinate_schedule as j_coordinate_schedule
from repro.core import dcd_ksvm as j_dcd_ksvm
from repro.core import gram_slab as j_gram_slab
from repro.core import krr_rel_residual as j_krr_rel_residual
from repro.core import make_sstep_bdcd_round_fn as j_make_sstep_bdcd
from repro.core import pad_rounds as j_pad_rounds
from repro.core import run_rounds as j_run_rounds
from repro.core import sstep_bdcd_krr as j_sstep_bdcd_krr
from repro.core import sstep_dcd_ksvm as j_sstep_dcd_ksvm
from repro_torch.core import (NO_TOL, KernelConfig, KRRConfig, SVMConfig,
                              bdcd_krr, block_schedule, coordinate_schedule,
                              dcd_ksvm, krr_rel_residual,
                              make_sstep_bdcd_round_fn, pad_rounds,
                              run_rounds, sstep_bdcd_krr, sstep_dcd_ksvm)
from repro_torch.kernels.ops import make_solver_gram_fn

KERNELS = {"linear": dict(name="linear"),
           "polynomial": dict(name="polynomial", degree=3, coef0=1.0),
           "rbf": dict(name="rbf", sigma=1.0)}
TOL = dict(rtol=1e-5, atol=1e-5)
EQUIV = dict(rtol=2e-4, atol=2e-5)


def _svm_data(m=64, n=16, seed=0):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    w = rng.standard_normal(n)
    A = ((rng.standard_normal((m, n)) + 0.5 * y[:, None] * w / np.linalg.norm(
        w)) / np.sqrt(n)).astype(np.float32)
    return A, y


def _krr_data(m=56, n=10, seed=1):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    y = np.sin(A @ rng.standard_normal(n)).astype(np.float32)
    return A, y


def _t(x):
    return torch.tensor(np.asarray(x))


def _svm_cfgs(kernel, loss):
    return (JSVMConfig(C=1.0, loss=loss, kernel=JKernelConfig(**kernel)),
            SVMConfig(C=1.0, loss=loss, kernel=KernelConfig(**kernel)))


def _krr_cfgs(kernel):
    return (JKRRConfig(lam=0.5, kernel=JKernelConfig(**kernel)),
            KRRConfig(lam=0.5, kernel=KernelConfig(**kernel)))


@pytest.mark.parametrize("kernel,loss,s", [
    ("linear", "l1", 4), ("polynomial", "l1", 4), ("rbf", "l1", 4),
    ("rbf", "l2", 8), ("rbf", "l1", 1)])
def test_sstep_dcd_replays_jax(kernel, loss, s):
    A, y = _svm_data()
    H = 30                                    # ragged for s = 4 and 8
    sched = j_coordinate_schedule(jax.random.key(1), H, A.shape[0])
    a0 = np.zeros(A.shape[0], np.float32)
    jcfg, cfg = _svm_cfgs(KERNELS[kernel], loss)
    want, _ = j_sstep_dcd_ksvm(jnp.asarray(A), jnp.asarray(y),
                               jnp.asarray(a0), sched, jcfg, s=s)
    got, _ = sstep_dcd_ksvm(_t(A), _t(y), _t(a0), np.asarray(sched), cfg,
                            s=s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kernel,loss", [("polynomial", "l1"),
                                         ("rbf", "l2")])
def test_dcd_replays_jax(kernel, loss):
    A, y = _svm_data(seed=2)
    sched = j_coordinate_schedule(jax.random.key(3), 40, A.shape[0])
    a0 = np.full(A.shape[0], 0.05, np.float32)    # warm start
    jcfg, cfg = _svm_cfgs(KERNELS[kernel], loss)
    want, _ = j_dcd_ksvm(jnp.asarray(A), jnp.asarray(y), jnp.asarray(a0),
                         sched, jcfg)
    got, _ = dcd_ksvm(_t(A), _t(y), _t(a0), np.asarray(sched), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kernel,s", [("linear", 4), ("polynomial", 4),
                                      ("rbf", 4), ("rbf", 8), ("rbf", 1)])
def test_sstep_bdcd_replays_jax(kernel, s):
    A, y = _krr_data()
    H, b = 13, 4                               # ragged for s = 4 and 8
    sched = j_block_schedule(jax.random.key(4), H, A.shape[0], b)
    a0 = np.zeros(A.shape[0], np.float32)
    jcfg, cfg = _krr_cfgs(KERNELS[kernel])
    want, _ = j_sstep_bdcd_krr(jnp.asarray(A), jnp.asarray(y),
                               jnp.asarray(a0), sched, jcfg, s=s)
    got, _ = sstep_bdcd_krr(_t(A), _t(y), _t(a0), np.asarray(sched), cfg,
                            s=s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bdcd_replays_jax():
    A, y = _krr_data(seed=5)
    sched = j_block_schedule(jax.random.key(6), 20, A.shape[0], 3)
    a0 = np.zeros(A.shape[0], np.float32)
    jcfg, cfg = _krr_cfgs(KERNELS["rbf"])
    want, _ = j_bdcd_krr(jnp.asarray(A), jnp.asarray(y), jnp.asarray(a0),
                         sched, jcfg)
    got, _ = bdcd_krr(_t(A), _t(y), _t(a0), np.asarray(sched), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_materialized_slab_paths_replay_jax():
    """slab_free=False: the gram_fn path of both s-step solvers."""
    A, y = _svm_data(seed=7)
    sched = j_coordinate_schedule(jax.random.key(8), 24, A.shape[0])
    a0 = np.zeros(A.shape[0], np.float32)
    jcfg, cfg = _svm_cfgs(KERNELS["rbf"], "l1")
    want, _ = j_sstep_dcd_ksvm(jnp.asarray(A), jnp.asarray(y),
                               jnp.asarray(a0), sched, jcfg, s=8,
                               gram_fn=j_gram_slab)
    got, _ = sstep_dcd_ksvm(_t(A), _t(y), _t(a0), np.asarray(sched), cfg,
                            s=8, gram_fn=make_solver_gram_fn())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    A, y = _krr_data(seed=9)
    sched = j_block_schedule(jax.random.key(10), 12, A.shape[0], 4)
    a0 = np.zeros(A.shape[0], np.float32)
    jcfg, cfg = _krr_cfgs(KERNELS["polynomial"])
    want, _ = j_sstep_bdcd_krr(jnp.asarray(A), jnp.asarray(y),
                               jnp.asarray(a0), sched, jcfg, s=4,
                               gram_fn=j_gram_slab)
    got, _ = sstep_bdcd_krr(_t(A), _t(y), _t(a0), np.asarray(sched), cfg,
                            s=4, gram_fn=make_solver_gram_fn())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("s", [4, 16])
def test_sstep_equals_classical_in_the_port(kernel, s):
    A, y = _svm_data(seed=11)
    gen = torch.Generator().manual_seed(12)
    sched = coordinate_schedule(gen, 50, A.shape[0])
    _, cfg = _svm_cfgs(KERNELS[kernel], "l1")
    a0 = torch.zeros(A.shape[0])
    a_dcd, _ = dcd_ksvm(_t(A), _t(y), a0, sched, cfg)
    a_ss, _ = sstep_dcd_ksvm(_t(A), _t(y), a0, sched, cfg, s=s)
    np.testing.assert_allclose(a_ss.numpy(), a_dcd.numpy(), **EQUIV)

    A, y = _krr_data(seed=13)
    sched = block_schedule(gen, 24, A.shape[0], 4)
    _, kcfg = _krr_cfgs(KERNELS[kernel])
    a0 = torch.zeros(A.shape[0])
    a_bd, _ = bdcd_krr(_t(A), _t(y), a0, sched, kcfg)
    a_ss, _ = sstep_bdcd_krr(_t(A), _t(y), a0, sched, kcfg, s=s)
    np.testing.assert_allclose(a_ss.numpy(), a_bd.numpy(), **EQUIV)


def test_overlapping_blocks_accumulate_every_duplicate():
    """Blocks that share coordinates inside one s-step round: every
    duplicate update lands (index_add), as with JAX's .at[].add."""
    A, y = _krr_data(m=12, seed=14)
    sched = np.array([[0, 1, 2], [2, 3, 0], [0, 4, 5], [6, 0, 2]],
                     np.int32)
    a0 = np.zeros(12, np.float32)
    jcfg, cfg = _krr_cfgs(KERNELS["rbf"])
    want, _ = j_sstep_bdcd_krr(jnp.asarray(A), jnp.asarray(y),
                               jnp.asarray(a0), jnp.asarray(sched), jcfg,
                               s=4)
    got, _ = sstep_bdcd_krr(_t(A), _t(y), _t(a0), sched, cfg, s=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    classical, _ = bdcd_krr(_t(A), _t(y), _t(a0), sched, cfg)
    np.testing.assert_allclose(got.numpy(), classical.numpy(), **EQUIV)


def test_pad_rounds_matches_jax():
    sched = np.arange(22, dtype=np.int64).reshape(11, 2)
    j_idx, j_valid = j_pad_rounds(jnp.asarray(sched, jnp.int32), 4)
    idx, valid = pad_rounds(_t(sched), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    assert idx.dtype == torch.int64


def test_schedules_are_in_range_and_blocks_without_replacement():
    gen = torch.Generator().manual_seed(0)
    c = coordinate_schedule(gen, 500, 37)
    assert c.dtype == torch.int64 and c.shape == (500,)
    assert int(c.min()) >= 0 and int(c.max()) < 37
    blocks = block_schedule(gen, 300, 20, 7, chunk=64)
    assert blocks.shape == (300, 7)
    assert all(len(set(row.tolist())) == 7 for row in blocks)
    assert int(blocks.min()) >= 0 and int(blocks.max()) < 20


def test_tolerance_path_history_and_stop_round_match_jax():
    """run_rounds' checked loop: same history, same checks, same stop."""
    A, y = _krr_data(m=64, seed=15)
    s, b, check_every = 2, 4, 2
    sched = j_block_schedule(jax.random.key(16), 40, A.shape[0], b)
    jcfg, cfg = _krr_cfgs(KERNELS["rbf"])
    jA, jy = jnp.asarray(A), jnp.asarray(y)
    j_rf = j_make_sstep_bdcd(jA, jy, jcfg, s)
    j_xs = j_pad_rounds(sched, s)

    def j_run(tol):
        return jax.jit(lambda a0: j_run_rounds(
            j_rf, a0, j_xs, tol=tol, check_every=check_every,
            metric_fn=lambda a: j_krr_rel_residual(jA, jy, a, jcfg)))(
                jnp.zeros(A.shape[0]))

    full = np.asarray(j_run(NO_TOL).metric_history())
    tol = float(np.sqrt(full[3] * full[4]))    # between checks 3 and 4
    want = j_run(tol)

    rf = make_sstep_bdcd_round_fn(_t(A), _t(y), cfg, s)
    xs = pad_rounds(_t(np.asarray(sched)).long(), s)
    got = run_rounds(rf, torch.zeros(A.shape[0]), xs, tol=tol,
                     check_every=check_every,
                     metric_fn=lambda a: krr_rel_residual(_t(A), _t(y), a,
                                                          cfg))
    assert got.checks_run == int(want.checks_run) == 5
    assert got.rounds_run == int(want.rounds_run)
    assert got.converged and bool(want.converged)
    np.testing.assert_allclose(got.metric_history().numpy(),
                               np.asarray(want.metric_history()),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state),
                               **TOL)
    # an unreachable tol records every check, forced final one included
    rec = run_rounds(rf, torch.zeros(A.shape[0]), xs, tol=NO_TOL,
                     check_every=3, metric_fn=lambda a: a.abs().sum())
    assert rec.checks_run == -(-xs[0].shape[0] // 3) and not rec.converged
