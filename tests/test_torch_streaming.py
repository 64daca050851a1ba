"""The port's streamed representation against the JAX package's, on the
same numpy inputs.

The JAX reference is ``StreamingGramOperator`` with ``matvec_impl=None``
(its ``lax.scan`` path) and ``kernels/ref.kmv_ref`` on the flattened
chunks: the Pallas ``kmv_stream_pallas`` does not run on the installed
JAX (ROADMAP C1).  The port runs its plain versions on the CPU.

Tolerances, and why:
  * KMV-based reductions (matvec, full_matvec, serve_block, the plain
    streamed KMV): 2e-4, the KMV bound of tests/test_kmv.py — f32 sums
    over the chunks in another order.
  * cross block 1e-4 (tests/test_pallas_gram.py), diag 1e-5, rows and
    the re-chunked data exact (copies).
  * bf16 data: rtol 5e-2, atol 5e-1, the bound tests/test_streaming.py
    sets for the JAX operator (JAX contracts in bf16, the port in f32).
  * Polynomial: absolute tolerance times max(1, max |output|) — f32
    rounding at outputs of 1e3-1e6 exceeds a fixed bound (ROADMAP C2).
  * Fits on replayed schedules: iterates and predictions 1e-5, the f32
    bound of tests/test_streaming.py and tests/test_slabfree_parity.py;
    metric histories 1e-5 relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import KernelRidge as JKernelRidge
from repro.api import KernelSVM as JKernelSVM
from repro.api import SolverOptions as JSolverOptions
from repro.core.kernels import ExactGramOperator as JExact
from repro.core.kernels import KernelConfig as JKernelConfig
from repro.core.kernels import StreamingGramOperator as JStream
from repro.core.objectives import krr_rel_residual as j_krr_rel_residual
from repro.core.objectives import ksvm_duality_gap as j_ksvm_duality_gap
from repro.core.bdcd import KRRConfig as JKRRConfig
from repro.core.dcd import SVMConfig as JSVMConfig
from repro.core.predict import BatchedPredictor as JBatchedPredictor
from repro.kernels.ref import kmv_ref as j_kmv_ref
from repro_torch import api, convert
from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
from repro_torch.core import (KernelConfig, KRRConfig, StreamingGramOperator,
                              SVMConfig, krr_rel_residual_op,
                              ksvm_duality_gap_op)
from repro_torch.core.kernels import _chunk
from repro_torch.core.predict import BatchedPredictor
from repro_torch.kernels import ops
from repro_torch.kernels.kmv_stream import (gather_rows_plain,
                                            kmv_stream_full_plain,
                                            kmv_stream_plain)

KERNELS = [dict(name="linear"),
           dict(name="polynomial", degree=3, coef0=1.0),
           dict(name="rbf", sigma=0.9)]
IDS = [k["name"] for k in KERNELS]
M, N, CR = 56, 9, 16                # 56 % 16 != 0: ragged last chunk
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, kernel, tol, atol=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = tol if atol is None else atol
    if kernel["name"] == "polynomial":
        atol *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _data(m=M, n=N, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)


def _pair(A, kernel, chunk_rows=CR, dtype=torch.float32):
    jA = jnp.asarray(A).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    return (JStream.from_dense(jA, JKernelConfig(**kernel),
                               chunk_rows=chunk_rows),
            StreamingGramOperator.from_dense(
                torch.from_numpy(A).to(dtype), KernelConfig(**kernel),
                chunk_rows))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_operator_methods_match_jax(kernel, dtype):
    A = _data()
    jop, op = _pair(A, kernel, dtype=dtype)
    assert (op.n_chunks, op.chunk_rows) == (jop.n_chunks, jop.chunk_rows)
    assert (op.n_samples, op.feature_dim) == (jop.n_samples,
                                              jop.feature_dim)
    bf16 = dtype == torch.bfloat16
    tol_k, tol_g, atol = (5e-2, 5e-2, 5e-1) if bf16 else (2e-4, 1e-4, None)
    rng = np.random.default_rng(9)
    idx = np.array([0, 7, 19, 55, 7], np.int64)   # ragged tail, a repeat
    X = rng.standard_normal((M, 3)).astype(np.float32)
    w = rng.standard_normal(M).astype(np.float32)
    Q = A[[2, 30, 50]]
    jidx, tidx = jnp.asarray(idx, jnp.int32), torch.from_numpy(idx)
    t = torch.from_numpy
    np.testing.assert_array_equal(op.rows(tidx).float().numpy(),
                                  np.asarray(jop.rows(jidx), np.float32))
    _close(op.diag(tidx).float(), jop.diag(jidx), kernel, 1e-5, atol)
    _close(op.matvec(tidx, t(X)), jop.matvec(jidx, jnp.asarray(X)), kernel,
           tol_k, atol)
    _close(op.matvec(tidx, t(w)), jop.matvec(jidx, jnp.asarray(w)), kernel,
           tol_k, atol)
    _close(op.cross_block(tidx).float(), jop.cross_block(jidx), kernel,
           tol_g, atol)
    G, u = op.round_data(tidx, t(w))
    jG, ju = jop.round_data(jidx, jnp.asarray(w))
    _close(G.float(), jG, kernel, tol_g, atol)
    _close(u, ju, kernel, tol_k, atol)
    _close(op.full_matvec(t(w)), jop.full_matvec(jnp.asarray(w)), kernel,
           tol_k, atol)
    _close(op.full_matvec(t(X)), jop.full_matvec(jnp.asarray(X)), kernel,
           tol_k, atol)
    jQ = jnp.asarray(Q).astype(jop.dtype)
    _close(op.serve_block(t(Q).to(dtype), t(w)),
           jop.serve_block(jQ, jnp.asarray(w)), kernel, tol_k, atol)


@pytest.mark.parametrize("c", [1, 5], ids=["vec", "mat"])
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_kmv_stream_plain_matches_kmv_ref_on_flattened_chunks(kernel, c):
    rng = np.random.default_rng(7)
    nc, cr, n, r = 4, 14, 9, 11            # nothing aligned
    Xc = rng.standard_normal((nc, cr, n)).astype(np.float32)
    B = rng.standard_normal((r, n)).astype(np.float32)
    Xvc = rng.standard_normal((nc, cr, c)).astype(np.float32)
    got = kmv_stream_plain(torch.from_numpy(Xc), torch.from_numpy(B),
                           torch.from_numpy(Xvc), KernelConfig(**kernel))
    want = j_kmv_ref(jnp.asarray(Xc.reshape(nc * cr, n)), jnp.asarray(B),
                     jnp.asarray(Xvc.reshape(nc * cr, c)),
                     JKernelConfig(**kernel))
    assert got.shape == (r, c)
    _close(got, want, kernel, 2e-4)
    # through the dispatch: everything on the CPU runs the plain version
    via_ops = ops.kmv_stream(torch.from_numpy(Xc), torch.from_numpy(B),
                             torch.from_numpy(Xvc), KernelConfig(**kernel))
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_ragged_tail_rows_contribute_nothing(kernel):
    """m = 50 in chunks of 16: the tail chunk has 2 live rows and 14 zero
    rows, whose kernel values K(0, b) are not zero for rbf/polynomial;
    the streamed results match the exact operator and the plain streamed
    KMV gives the same result whether the padding is masked (m given) or
    only multiplied by zero right-hand-side rows (m omitted)."""
    A = _data(m=50)
    jex = JExact(jnp.asarray(A), JKernelConfig(**kernel))
    _, op = _pair(A, kernel)
    assert op.n_chunks == 4 and op.m == 50
    assert float(op.Xc[3, 2:].abs().max()) == 0.0
    v = np.random.default_rng(1).standard_normal(50).astype(np.float32)
    _close(op.full_matvec(torch.from_numpy(v)),
           jex.full_matvec(jnp.asarray(v)), kernel, 2e-4)
    B = torch.from_numpy(A[:5])
    Xvc = _chunk(torch.from_numpy(v)[:, None], 16)
    masked = kmv_stream_plain(op.Xc, B, Xvc, op.cfg, m=50)
    unmasked = kmv_stream_plain(op.Xc, B, Xvc, op.cfg)
    _close(masked, unmasked, kernel, 1e-6)


# chunk rows giving nc = 1, 2 and 4 chunks of m = 50 rows (partial tails
# of 18 and 2 rows at nc = 2 and 4)
FULL_CHUNKS = {1: 64, 2: 32, 4: 16}


@pytest.mark.parametrize("c", [1, 5], ids=["vec", "mat"])
@pytest.mark.parametrize("nc", sorted(FULL_CHUNKS), ids=lambda v: f"nc{v}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_symmetric_full_matvec_matches_jax(kernel, dtype, nc, c):
    """The port's full_matvec (one symmetric pass over the chunk pairs
    i <= j, the plain version on the CPU) against the JAX streamed
    operator's (nc pieces K(A, chunk_j)^T X) and the JAX exact
    operator's, also for the K-SVM operator scale_rows(y), within the
    KMV bound 2e-4.  bf16 data: the JAX operators get the same bf16
    values widened to f32, since the port computes in f32 from bf16."""
    m = 50
    A = _data(m=m, seed=11)
    if dtype == torch.bfloat16:
        A = torch.from_numpy(A).bfloat16().float().numpy()
    rng = np.random.default_rng(12)
    X = rng.standard_normal((m, c)).astype(np.float32)
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    if c == 1:
        X = X[:, 0]
    jcfg = JKernelConfig(**kernel)
    jex = JExact(jnp.asarray(A), jcfg)
    jst = JStream.from_dense(jnp.asarray(A), jcfg,
                             chunk_rows=FULL_CHUNKS[nc])
    op = StreamingGramOperator.from_dense(
        torch.from_numpy(A).to(dtype), KernelConfig(**kernel),
        FULL_CHUNKS[nc])
    assert op.n_chunks == jst.n_chunks == nc
    for got_op, refs in ((op, (jst, jex)),
                         (op.scale_rows(torch.from_numpy(y)),
                          (jst.scale_rows(jnp.asarray(y)),
                           jex.scale_rows(jnp.asarray(y))))):
        got = got_op.full_matvec(torch.from_numpy(X))
        assert got.shape == X.shape and got.dtype == torch.float32
        for ref in refs:
            _close(got, ref.full_matvec(jnp.asarray(X)), kernel, 2e-4)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_symmetric_full_matvec_equals_the_piece_loop(kernel):
    """kmv_stream_full_plain (each chunk pair once, with its mirror)
    against the piece loop it replaces (one kmv_stream_plain a chunk of
    output rows) to 1e-5 relative: 4 chunks of 16 rows, a 2-row tail."""
    m, cr = 50, 16
    A = torch.from_numpy(_data(m=m, seed=13))
    X = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (m, 3)).astype(np.float32))
    cfg = KernelConfig(**kernel)
    Xc, Xvc = _chunk(A, cr), _chunk(X, cr)
    got = kmv_stream_full_plain(Xc, Xvc, cfg, m=m)
    want = torch.cat([kmv_stream_plain(Xc, Xc[j], Xvc, cfg, m=m)
                      for j in range(Xc.shape[0])])[:m]
    assert got.shape == (m, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    via_ops = ops.kmv_stream_full(Xc, Xvc, cfg, m=m)
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


def test_full_matvec_dispatch_raises_off_the_two_routes():
    Xc = _chunk(torch.from_numpy(_data()), CR)
    Xvc = torch.zeros((Xc.shape[0], CR, 1))
    cfg = KernelConfig("rbf")
    with pytest.raises(ValueError, match="host"):
        ops.kmv_stream_full(Xc.to("meta"), Xvc, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        ops.kmv_stream_full(Xc, Xvc.to("meta"), cfg)
    with pytest.raises(ValueError, match="true rows"):
        kmv_stream_full_plain(Xc, Xvc, cfg, m=3)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_scale_rows_and_take_rechunk(kernel):
    A = _data()
    jop, op = _pair(A, kernel)
    rng = np.random.default_rng(4)
    y = rng.standard_normal(M).astype(np.float32)
    keep = np.array([3, 17, 20, 41, 55], np.int64)
    js = jop.scale_rows(jnp.asarray(y)).take(jnp.asarray(keep))
    ts = op.scale_rows(torch.from_numpy(y)).take(torch.from_numpy(keep))
    assert isinstance(ts, StreamingGramOperator)
    assert (ts.n_samples, ts.chunk_rows, ts.n_chunks) == (
        js.n_samples, js.chunk_rows, js.n_chunks)
    np.testing.assert_array_equal(ts.Xc.numpy(), np.asarray(js.Xc))
    sc = op.scale_rows(torch.from_numpy(y))
    np.testing.assert_array_equal(
        sc.Xc.numpy(), np.asarray(jop.scale_rows(jnp.asarray(y)).Xc))
    idx = np.arange(keep.size)
    _close(ts.cross_block(torch.from_numpy(idx)),
           js.cross_block(jnp.asarray(idx)), kernel, 1e-4)


def test_chunk_rows_validated_and_clipped():
    A = torch.zeros((8, 3))
    cfg = KernelConfig("linear")
    for bad in (0, -1, 2.5, "16", True):
        with pytest.raises(ValueError):
            StreamingGramOperator.from_dense(A, cfg, chunk_rows=bad)
    op = StreamingGramOperator.from_dense(A, cfg, chunk_rows=64)
    assert op.n_chunks == 1 and op.chunk_rows == 8
    assert op.device == torch.device("cpu")


def test_gather_rows_plain_is_row_indexing():
    A = torch.from_numpy(_data())
    Xc = _chunk(A, CR)
    idx = torch.tensor([55, 0, 16, 15, 15])
    np.testing.assert_array_equal(gather_rows_plain(Xc, idx).numpy(),
                                  A[idx].numpy())
    np.testing.assert_array_equal(ops.gather_rows(Xc, idx).numpy(),
                                  A[idx].numpy())


def test_dispatch_raises_off_the_two_routes():
    """Chunks off the host, or a device operand on a device that has no
    kernel, raise instead of running somewhere unintended."""
    Xc = _chunk(torch.from_numpy(_data()), CR)
    B = torch.zeros((2, N))
    Xvc = torch.zeros((Xc.shape[0], CR, 1))
    cfg = KernelConfig("rbf")
    with pytest.raises(ValueError, match="host"):
        ops.kmv_stream(Xc.to("meta"), B, Xvc, cfg)
    with pytest.raises(ValueError, match="no kernel"):
        ops.kmv_stream(Xc, B.to("meta"), Xvc, cfg)
    with pytest.raises(ValueError, match="Xvc"):
        ops.kmv_stream(Xc, B, Xvc.to("meta"), cfg)
    with pytest.raises(ValueError, match="no kernel"):
        ops.gather_rows(Xc, torch.zeros(2, dtype=torch.long,
                                        device="meta"))
    with pytest.raises(ValueError, match="true rows"):
        kmv_stream_plain(Xc, B, Xvc, cfg, m=3)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_streamed_metrics_match_jax_resident_metrics(kernel):
    """ROADMAP C: the port's streamed fit reads its gap and residual
    through the operator's streamed full_matvec, the JAX facade through
    the resident A — the same values."""
    A = _data()
    rng = np.random.default_rng(6)
    y = np.where(rng.random(M) < 0.5, 1.0, -1.0).astype(np.float32)
    t = rng.standard_normal(M).astype(np.float32)
    alpha = rng.random(M).astype(np.float32)
    _, op = _pair(A, kernel)
    jcfg = JKernelConfig(**kernel)
    gap = ksvm_duality_gap_op(op, torch.from_numpy(y),
                              torch.from_numpy(alpha),
                              SVMConfig(C=1.0, kernel=KernelConfig(**kernel)))
    jgap = j_ksvm_duality_gap(jnp.asarray(A), jnp.asarray(y),
                              jnp.asarray(alpha), JSVMConfig(C=1.0,
                                                             kernel=jcfg))
    _close(gap, jgap, kernel, 2e-4)
    res = krr_rel_residual_op(op, torch.from_numpy(t),
                              torch.from_numpy(alpha),
                              KRRConfig(lam=0.5,
                                        kernel=KernelConfig(**kernel)))
    jres = j_krr_rel_residual(jnp.asarray(A), jnp.asarray(t),
                              jnp.asarray(alpha), JKRRConfig(lam=0.5,
                                                             kernel=jcfg))
    _close(res, jres, kernel, 2e-4)


def _svm_data(m=64, n=8, seed=0):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    A = ((rng.standard_normal((m, n)) + 0.8 * y[:, None])
         / np.sqrt(n)).astype(np.float32)
    return A, y


def _krr_data(m=64, n=8, seed=2):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    return A, np.sin(A @ rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("problem", ["ksvm", "krr"])
@pytest.mark.parametrize("method", ["classical", "sstep"])
def test_streamed_fit_matches_resident_fit_on_replayed_jax_schedule(
        problem, method):
    """The JAX resident fit and the JAX streamed fit against the port's
    streamed fit replaying their schedule: iterates and metric histories
    to 1e-5, predictions to 1e-5."""
    A, y = _svm_data() if problem == "ksvm" else _krr_data()
    kw = dict(method=method, s=4, max_iters=24, record=True,
              check_every=2)
    if problem == "ksvm":
        make_j = lambda **o: JKernelSVM(  # noqa: E731
            C=1.0, kernel="rbf", options=JSolverOptions(**kw, **o))
        est = KernelSVM(C=1.0, kernel="rbf", device="cpu",
                        options=SolverOptions(stream=16, **kw))
    else:
        make_j = lambda **o: JKernelRidge(  # noqa: E731
            lam=0.5, kernel="rbf", options=JSolverOptions(b=4, **kw, **o))
        est = KernelRidge(lam=0.5, kernel="rbf", device="cpu",
                          options=SolverOptions(stream=16, b=4, **kw))
    jres_est, jstr_est = make_j(), make_j(stream=16)
    jres, jstr = jres_est.fit(A, y), jstr_est.fit(A, y)
    res = est.fit(A, y, schedule=np.asarray(jres.schedule))
    assert isinstance(est.op_, StreamingGramOperator)
    assert est.A_.device.type == "cpu"
    for ref in (jres, jstr):
        np.testing.assert_allclose(res.alpha.numpy(), np.asarray(ref.alpha),
                                   **TOL)
        np.testing.assert_allclose(res.history, np.asarray(ref.history),
                                   rtol=1e-5, atol=1e-7)
    Q = _data(m=13, n=A.shape[1], seed=8)
    if problem == "ksvm":
        got, want = est.decision_function(Q), jstr_est.decision_function(Q)
    else:
        got, want = est.predict(Q), jstr_est.predict(Q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_options_validation():
    with pytest.raises(ValueError):
        SolverOptions(stream=0)
    with pytest.raises(ValueError):
        SolverOptions(stream=2.5)
    with pytest.raises(ValueError, match="slab_free"):
        SolverOptions(stream=16, slab_free=False)
    with pytest.raises(ValueError, match="A11"):
        SolverOptions(stream=16, layout="1d")
    with pytest.raises(ValueError, match="exact"):
        SolverOptions(stream=16, approx="nystrom")
    assert SolverOptions(stream=False).stream is None
    assert SolverOptions(stream=16).stream == 16


@pytest.mark.parametrize("knob", [dict(stream=True), dict(stream="auto"),
                                  dict(approx="auto")],
                         ids=["stream-true", "stream-auto", "approx-auto"])
def test_unported_auto_knobs_raise_naming_their_roadmap_items(knob):
    """These knobs raised naming A5 and A8 until the performance model
    and the autotuner were ported: they are now accepted, marked for the
    autotuner (``stream=True`` means "auto", as in the JAX package), and
    an unresolved one still refuses to build a representation."""
    opts = SolverOptions(**knob)
    assert opts.needs_autotune
    assert opts.stream == "auto" or opts.approx == "auto"
    with pytest.raises(ValueError, match="unresolved"):
        api._build_representation(torch.zeros((4, 2)), KRRConfig(), opts,
                                  torch.device("cpu"))


def test_batched_predictor_query_stream_matches_jax():
    """Host queries k at a time through the streamed operator against
    the JAX predictor over the resident operator; the JAX predictor's
    own query stream agrees too."""
    cfg = dict(name="rbf", sigma=0.9)
    A = _data()
    jex = JExact(jnp.asarray(A), JKernelConfig(**cfg))
    _, op = _pair(A, cfg)
    rng = np.random.default_rng(6)
    w = rng.standard_normal(M).astype(np.float32)
    Xq = rng.standard_normal((301, N)).astype(np.float32)
    want = JBatchedPredictor(jex, jnp.asarray(w), batch=64)(
        jnp.asarray(Xq))
    pred = BatchedPredictor(op, torch.from_numpy(w), batch=64, stream=48)
    got = pred(Xq)                                  # a numpy host array
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got_t = pred(torch.from_numpy(Xq))
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())
    jstream = JBatchedPredictor(jex, jnp.asarray(w), batch=64, stream=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(jstream(Xq)), **TOL)
    for bad in (0, -3, 2.5, True):
        with pytest.raises(ValueError):
            BatchedPredictor(op, torch.from_numpy(w), stream=bad)


def test_convert_carries_a_streamed_jax_fit_across():
    A, y = _svm_data(seed=5)
    kw = dict(s=4, max_iters=40, stream=16)
    jest = JKernelSVM(C=0.8, kernel="polynomial",
                      options=JSolverOptions(**kw))
    jest.fit(A, y)
    est = convert.fitted_estimator(
        "ksvm", dataclasses.asdict(jest.cfg), np.asarray(jest.A_),
        np.asarray(jest.y_), np.asarray(jest.alpha_), options=kw,
        device="cpu")
    assert isinstance(est.op_, StreamingGramOperator)
    assert est.op_.chunk_rows == 16
    Q = _data(m=11, n=A.shape[1], seed=12)
    want = np.asarray(jest.decision_function(Q))
    np.testing.assert_allclose(est.decision_function(Q).numpy(), want,
                               rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("problem", ["ksvm", "krr"])
@pytest.mark.parametrize("rep", [["--stream", "16"], ["--landmarks", "12"]],
                         ids=["stream", "nystrom"])
def test_solve_cli_runs_streamed_and_nystrom_fits_on_the_host(
        capsys, problem, rep):
    from repro_torch.launch import solve
    if problem == "ksvm":
        solve.main(["--device", "cpu", "--H", "64", "--s", "8", *rep])
        assert "max|a_s - a_dcd|" in capsys.readouterr().out
    else:
        solve.main(["--device", "cpu", "--problem", "krr", "--dataset",
                    "bodyfat", "--b", "4", "--s", "4", "--H", "32", *rep])
        out = capsys.readouterr().out
        assert "rel err vs closed form" in out and rep[0][2:] in out
