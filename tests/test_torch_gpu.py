"""The port on the card: each CUDA kernel against its plain PyTorch
version on the same inputs, and a facade fit through the kernels against
the same fit through the plain versions on the host.

Every test here carries the ``gpu`` marker and skips itself (inside the
fixture) when no CUDA device is present.  The file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: KMV and the streamed KMV (the symmetric full matvec too)
2e-4 (tests/test_kmv.py), gram
1e-4 (tests/test_pallas_gram.py), bf16 inputs 2e-2; polynomial absolute
tolerance relative to the largest output value (ROADMAP C2).  The row
gather copies bits and is held to exact equality.  RMSNorm 1e-5 f32
and 2e-2 bf16 (tests/test_pallas_rmsnorm.py); flash attention 2e-4 /
2e-5 f32 (tests/test_flash_attention.py), and for bf16 inputs through
the FP32-FMA kernels 1e-2 / 1e-3 on o (one bf16 ulp: kernel and plain
version both compute in f32 and differ only in the final rounding) with
lse at the f32 limits.  The flash backward (dq, dk, dv): f32 2e-4 / 2e-5
(tighter than the JAX gradient test's 2e-3 / 2e-4: kernel and plain
version sum the same f32 products in another order, with no bf16
rounding of p), bf16 through the FP32-FMA kernels (dq always) one ulp,
1e-2 / 1e-3.  The tensor-core kernels (bf16, hd = hdv in {64, 128},
``flash_route``) round p, and in dkv ds, to bf16 for their products, so
their o, dk and dv are held to a derived elementwise bound instead:
u = 2^-8 (bf16's unit roundoff) times the sum of the products'
magnitudes, plus the f32 sums and both sides' final rounding, capped at
the JAX package's bf16 bound 3e-2 (``ref.flash_fwd_bf16_tolerance``,
``ref.flash_dkv_bf16_tolerance``); lse stays at the f32 limits.  The
tensor-core dq kernel rounds ds to bf16 and is held to the same kind of
bound (``ref.flash_dq_bf16_tolerance``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
from repro_torch.configs import get_config
from repro_torch.core.kernels import (KernelConfig, StreamingGramOperator,
                                      _chunk)
from repro_torch.core import (KRRConfig, NO_TOL, SVMConfig,
                              krr_rel_residual, loop, make_bdcd_round_fn,
                              make_dcd_round_fn, make_sstep_bdcd_round_fn,
                              make_sstep_dcd_round_fn, pad_rounds)
from repro_torch.core.predict import BatchedPredictor
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_bwd_cuda,
                                                 flash_bwd_plain,
                                                 flash_delta,
                                                 flash_fwd_cuda,
                                                 flash_fwd_plain,
                                                 flash_route)
from repro_torch.kernels import gram as gram_module
from repro_torch.kernels.gram import gram_cuda, gram_plain
from repro_torch.kernels import kmv as kmv_module
from repro_torch.kernels.kmv import kmv_cuda, kmv_plain
from repro_torch.kernels import kmv_stream as kmv_stream_module
from repro_torch.kernels.kmv_stream import (gather_rows_cuda,
                                            gather_rows_plain,
                                            kmv_stream_cuda,
                                            kmv_stream_full_cuda,
                                            kmv_stream_full_plain,
                                            kmv_stream_full_resident,
                                            kmv_stream_plain,
                                            kmv_stream_resident)
from repro_torch.kernels.ref import (flash_attention_ref,
                                     flash_dkv_bf16_tolerance,
                                     flash_dq_bf16_tolerance,
                                     flash_fwd_bf16_tolerance, rmsnorm_ref)
from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm_cuda, rmsnorm_plain
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, prefill_cross_kv)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import (Request, ServingEngine, TrainConfig,
                               loss_and_grads, make_train_step)
from repro_torch.tree import leaves_with_paths

KERNELS = [dict(name="linear"),
           dict(name="polynomial", degree=3, coef0=1.0),
           dict(name="rbf", sigma=0.7)]
IDS = [k["name"] for k in KERNELS]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # the plain versions must run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _data(m, r, n, c, seed=0):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    B = (rng.standard_normal((r, n)) / np.sqrt(n)).astype(np.float32)
    X = rng.standard_normal((m, c)).astype(np.float32)
    return A, B, X


def _close(got, want, kernel, tol):
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    atol = tol * max(1.0, float(np.abs(want).max())) \
        if kernel["name"] == "polynomial" else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


# r across every boundary of kmv_plan's regimes (rows up to 8, narrow
# tiles of 32 and 64 columns up to 64, wide tiles of 64 and 128 columns),
# m ragged against every tile, n a multiple of 4 but not of a chunk (300)
# or not of 4 (203, the element-by-element copies)
KMV_SHAPES = [(33, 17, 100, 2), (700, 70, 384, 1), (130, 1, 64, 4),
              (2000, 300, 96, 3)] + [
    (517, r, 300 if i % 2 == 0 else 203, 3)
    for i, r in enumerate([1, 2, 7, 8, 9, 31, 32, 33, 64, 65, 127, 128,
                           129, 300])]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", KMV_SHAPES)
def test_kmv_cuda_matches_plain(cuda_device, kernel, dtype, shape):
    """Every regime against kmv_plain, with X of c columns and its first
    column as a vector."""
    A, B, X = _data(*shape, seed=6)
    cfg = KernelConfig(**kernel)
    A_d = torch.from_numpy(A).to(cuda_device, dtype)
    B_d = torch.from_numpy(B).to(cuda_device, dtype)
    for Xin in (X, X[:, 0]):
        X_d = torch.from_numpy(np.ascontiguousarray(Xin)).to(cuda_device)
        before = kmv_cuda.launches
        got = kmv_cuda(A_d, B_d, X_d, cfg)
        want = kmv_plain(A_d, B_d, X_d, cfg)
        torch.cuda.synchronize()
        assert kmv_cuda.launches == before + 1
        assert got.shape == want.shape
        _close(got, want, kernel, 2e-2 if dtype == torch.bfloat16 else 2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 7, 32, 64, 256, 1024])
@pytest.mark.parametrize("sms", [None, 2], ids=["card", "2-SM-plan"])
def test_kmv_cuda_repeats_bit_for_bit(cuda_device, monkeypatch, dtype, r,
                                      sms):
    """Fixed-order sums and no atomics in every regime: a second launch on
    the same inputs gives the same bits (m = 3000 takes many splits).
    Planned as for a 2-SM card, the wide regime takes its 128 x 128 tile
    at r = 256 and 1024, and the rows regime 375-row splits."""
    if sms is not None:
        monkeypatch.setattr(kmv_module, "sm_count", lambda index: sms)
    A, B, X = _data(3000, r, 1000, 2, seed=8)
    cfg = KernelConfig(name="rbf", sigma=0.7)
    A_d = torch.from_numpy(A).to(cuda_device, dtype)
    B_d = torch.from_numpy(B).to(cuda_device, dtype)
    X_d = torch.from_numpy(X).to(cuda_device)
    got = kmv_cuda(A_d, B_d, X_d, cfg)
    assert torch.equal(got, kmv_cuda(A_d, B_d, X_d, cfg))
    _close(got, kmv_plain(A_d, B_d, X_d, cfg), dict(name="rbf"),
           2e-2 if dtype == torch.bfloat16 else 2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 3])
def test_kmv_cuda_symmetric_full_matvec(cuda_device, monkeypatch, kernel,
                                        dtype, c):
    """B = A (the full matvec) planned as for a 2-SM card takes the
    symmetric regime (the tiles on and above the diagonal, each also
    standing for its mirror; m = 3000 leaves the last tile ragged):
    against kmv_plain, against the wide kernel on a copy of A, and a
    second call gives the same bits."""
    monkeypatch.setattr(kmv_module, "sm_count", lambda index: 2)
    A, _, X = _data(3000, 1, 1000, c, seed=11)
    cfg = KernelConfig(**kernel)
    A_d = torch.from_numpy(A).to(cuda_device, dtype)
    X_d = torch.from_numpy(X).to(cuda_device)
    assert kmv_module.kmv_plan(3000, 3000, c, 2, True).regime == "symmetric"
    got = kmv_cuda(A_d, A_d, X_d, cfg)
    assert torch.equal(got, kmv_cuda(A_d, A_d, X_d, cfg))
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    _close(got, kmv_plain(A_d, A_d, X_d, cfg), kernel, tol)
    _close(got, kmv_cuda(A_d, A_d.clone(), X_d, cfg), kernel, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("r", [32, 64, 300])
def test_kmv_cuda_splits_of_several_tiles(cuda_device, monkeypatch, kernel,
                                          r):
    """With the workspace held to three splits, each block of a tile
    regime loops over several row tiles (the ragged last one masked)."""
    monkeypatch.setattr(kmv_module, "WS_MAX_FLOATS", 3 * r * 2)
    A, B, X = _data(1000, r, 300, 2, seed=10)
    cfg = KernelConfig(**kernel)
    A_d, B_d = (torch.from_numpy(t).to(cuda_device) for t in (A, B))
    X_d = torch.from_numpy(X).to(cuda_device)
    assert kmv_module.kmv_plan(1000, r, 2, 132).splits == 3
    got = kmv_cuda(A_d, B_d, X_d, cfg)
    _close(got, kmv_plain(A_d, B_d, X_d, cfg), kernel, 2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(33, 17, 100), (256, 256, 512),
                                   (1000, 32, 64)])
def test_gram_cuda_matches_plain(cuda_device, kernel, dtype, shape):
    A, B, _ = _data(*shape, 1, seed=7)
    cfg = KernelConfig(**kernel)
    A_d = torch.from_numpy(A).to(cuda_device, dtype)
    B_d = torch.from_numpy(B).to(cuda_device, dtype)
    got = gram_cuda(A_d, B_d, cfg, out_dtype=dtype)
    want = gram_plain(A_d, B_d, cfg, out_dtype=dtype)
    torch.cuda.synchronize()
    _close(got.float(), want.float(), kernel,
           2e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,sms", [((1, 1, 8192), None),
                                       ((32, 32, 8192), None),
                                       ((3, 2, 1000), None),
                                       ((70, 40, 1000), 7),
                                       ((33, 17, 102), 132)],
                         ids=["1x1", "32x32", "dot-ragged", "ragged-split",
                              "unaligned-n"])
def test_gram_cuda_splits_match_plain_and_repeat(cuda_device, monkeypatch,
                                                 kernel, dtype, shape, sms):
    """The round shapes (classical 1 x 1, K-SVM 32 x 32, n = 8192), the dot
    kernel on a ragged n, a split whose last run of chunks is short (70 x
    40 tiles over 1000 features, split as for a 7-SM card) and an n the
    vector copies cannot take: against gram_plain at the existing bounds,
    and two launches give the same bits (no atomics)."""
    if sms is not None:
        monkeypatch.setattr(gram_module, "sm_count", lambda index: sms)
    A, B, _ = _data(*shape, 1, seed=9)
    cfg = KernelConfig(**kernel)
    A_d = torch.from_numpy(A).to(cuda_device, dtype)
    B_d = torch.from_numpy(B).to(cuda_device, dtype)
    before = gram_cuda.launches
    got = gram_cuda(A_d, B_d, cfg, out_dtype=dtype)
    again = gram_cuda(A_d, B_d, cfg, out_dtype=dtype)
    assert gram_cuda.launches == before + 2
    want = gram_plain(A_d, B_d, cfg, out_dtype=dtype)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, again)
    _close(got.float(), want.float(), kernel,
           2e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("problem", ["ksvm", "krr"])
def test_fit_on_card_matches_fit_on_host(cuda_device, problem):
    """The facade through the kernels (card) and through the plain
    versions (host), one replayed schedule: iterates to 1e-5, the f32
    bound of tests/test_slabfree_parity.py."""
    rng = np.random.default_rng(8)
    m, n = 300, 40
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    if problem == "ksvm":
        y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
        opts = SolverOptions(method="sstep", s=8, max_iters=200, seed=3)
        make = lambda dev: KernelSVM(C=1.0, kernel="rbf",  # noqa: E731
                                     options=opts, device=dev)
    else:
        y = rng.standard_normal(m).astype(np.float32)
        opts = SolverOptions(method="sstep", s=4, b=8, max_iters=64,
                             seed=3, tol=1e-6, check_every=4)
        make = lambda dev: KernelRidge(lam=0.5, kernel="rbf",  # noqa: E731
                                       options=opts, device=dev)
    host = make("cpu")
    r_host = host.fit(A, y)
    card = make(cuda_device)
    r_card = card.fit(A, y, schedule=r_host.schedule)
    np.testing.assert_allclose(r_card.alpha.cpu().numpy(),
                               r_host.alpha.numpy(), rtol=1e-5, atol=1e-5)
    Q = A[:50]
    f_host = (host.decision_function(Q) if problem == "ksvm"
              else host.predict(Q))
    f_card = (card.decision_function(Q) if problem == "ksvm"
              else card.predict(Q))
    np.testing.assert_allclose(f_card.cpu().numpy(), f_host.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(200, 64, 17, 100, 2), (700, 256, 70,
                                                           384, 1),
                                   (130, 130, 1, 64, 4),
                                   (2000, 300, 300, 96, 3)])
def test_kmv_stream_cuda_matches_plain(cuda_device, kernel, dtype, shape):
    """The pipe against its plain chunk loop and against the resident KMV
    on the flattened rows; shapes with a ragged tail chunk, one chunk,
    and r = chunk_rows."""
    m, cr, r, n, c = shape
    A, B, X = _data(m, r, n, c, seed=9)
    cfg = KernelConfig(**kernel)
    A_t = torch.from_numpy(A).to(dtype)
    Xc = _chunk(A_t, cr, pin=True)
    B_d = torch.from_numpy(B).to(cuda_device, dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    for Xin in (X, X[:, :1]):
        Xvc = _chunk(torch.from_numpy(np.ascontiguousarray(Xin)).to(
            cuda_device), cr)
        before = kmv_stream_cuda.launches
        got = kmv_stream_cuda(Xc, B_d, Xvc, cfg, m=m)
        want = kmv_stream_plain(Xc, B_d, Xvc, cfg, m=m)
        resident = kmv_cuda(A_t.to(cuda_device), B_d,
                            torch.from_numpy(np.ascontiguousarray(Xin)).to(
                                cuda_device), cfg)
        compute_only = kmv_stream_resident(Xc.to(cuda_device), B_d, Xvc,
                                           cfg, m=m)
        torch.cuda.synchronize()
        assert kmv_stream_cuda.launches == before + 1
        assert got.shape == want.shape == (r, Xin.shape[1])
        _close(got, want, kernel, tol)
        _close(got, resident.reshape(got.shape), kernel, tol)
        _close(compute_only, got, kernel, tol)


# (m, cr, n, c) of the symmetric streamed full matvec: nc = 1 (a padded
# chunk), 2, 4 and 5 chunks, partial tails and chunks of several 128-row
# tiles, one partial tile a chunk at cr = 130 and 160, n off a multiple of
# 4 (203: element-by-element loads)
FULL_SHAPES = [(200, 256, 100, 1), (300, 160, 64, 3), (1000, 256, 203, 2),
               (520, 130, 96, 5), (2100, 512, 64, 1)]


def _full_inputs(dev, m, cr, n, c, dtype=torch.float32, seed=10, pin=True):
    A, _, X = _data(m, 1, n, c, seed=seed)
    Xc = _chunk(torch.from_numpy(A).to(dtype), cr, pin=pin)
    return Xc, _chunk(torch.from_numpy(X).to(dev), cr)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FULL_SHAPES)
def test_kmv_stream_full_cuda_matches_plain(cuda_device, kernel, dtype,
                                            shape):
    """The symmetric pipe against its plain pair loop; a second call gives
    the same bits, and so do the same launches over chunks already on the
    card; each call counts one launch."""
    m, cr, n, c = shape
    Xc, Xvc = _full_inputs(cuda_device, m, cr, n, c, dtype)
    cfg = KernelConfig(**kernel)
    before = kmv_stream_full_cuda.launches
    got = kmv_stream_full_cuda(Xc, Xvc, cfg, m=m)
    again = kmv_stream_full_cuda(Xc, Xvc, cfg, m=m)
    resident = kmv_stream_full_resident(Xc.to(cuda_device), Xvc, cfg, m=m)
    want = kmv_stream_full_plain(Xc, Xvc, cfg, m=m)
    torch.cuda.synchronize()
    assert kmv_stream_full_cuda.launches == before + 2
    assert got.shape == want.shape == (m, c)
    _close(got, want, kernel, 2e-2 if dtype == torch.bfloat16 else 2e-4)
    assert torch.equal(got, again)
    assert torch.equal(got, resident)


@pytest.mark.gpu
@pytest.mark.parametrize("drop", [1, 2], ids=["mirror-of-pair-0-1",
                                              "tail-pair"])
def test_kmv_stream_full_check_fails_wrong_variants(cuda_device, drop):
    """The parity check of the symmetric pipe fails by far a pipe that
    leaves one off-diagonal pair's mirror product out, or the pair of
    chunk 0 with the partial tail chunk."""
    m, cr, n, c = 1000, 256, 96, 2
    Xc, Xvc = _full_inputs(cuda_device, m, cr, n, c)
    cfg = KernelConfig("rbf", sigma=0.7)
    bad = kmv_stream_module.full_launch(Xc, Xvc, cfg, m, drop=drop)
    want = kmv_stream_full_plain(Xc, Xvc, cfg, m=m).double()
    ratio = float(((bad.double().cpu() - want.cpu()).abs()
                   / (2e-4 + 2e-4 * want.cpu().abs())).max())
    assert ratio > 100.0, ratio


@pytest.mark.gpu
def test_kmv_stream_full_refuses_pageable_chunks(cuda_device):
    Xc, Xvc = _full_inputs(cuda_device, 300, 128, 32, 1, pin=False)
    cfg = KernelConfig("rbf")
    for call in (lambda: kmv_stream_full_cuda(Xc, Xvc, cfg, m=300),
                 lambda: ops.kmv_stream_full(Xc, Xvc, cfg, m=300)):
        with pytest.raises(ValueError, match="pinned"):
            call()


@pytest.mark.gpu
def test_kmv_stream_full_holds_three_chunks(cuda_device):
    """A call's peak device memory above what was allocated before it is
    the anchor's and the two streaming slots, the pairs' workspace with
    the rows' norms, and the output: never more chunks of A."""
    m, cr, n, c = 4000, 512, 1024, 1
    Xc, Xvc = _full_inputs(cuda_device, m, cr, n, c)
    cfg = KernelConfig("rbf")
    kmv_stream_full_cuda(Xc, Xvc, cfg, m=m)             # loads the kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kmv_stream_full_cuda(Xc, Xvc, cfg, m=m)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    tiles = -(-cr // kmv_stream_module.PAIR_BM)
    ws = 4 * (2 * tiles * m * c + Xc.shape[0] * cr)
    chunk = cr * n * 4
    assert 3 * chunk <= growth <= 3 * chunk + ws + 4 * m * c + 4096, growth


@pytest.mark.gpu
def test_streamed_full_matvec_is_one_symmetric_launch(cuda_device):
    """StreamingGramOperator.full_matvec on the card: one launch of the
    symmetric pipe a call and none of the piece pipe, against the same
    operator on the host (the plain pair loop), also for scale_rows(y)."""
    rng = np.random.default_rng(8)
    m, n = 600, 80
    A = torch.from_numpy((rng.standard_normal((m, n)) / np.sqrt(n)).astype(
        np.float32))
    y = torch.from_numpy(np.where(rng.random(m) < 0.5, 1.0,
                                  -1.0).astype(np.float32))
    cfg = KernelConfig("rbf", sigma=0.7)
    card = StreamingGramOperator.from_dense(A, cfg, 128, device=cuda_device)
    host = StreamingGramOperator.from_dense(A, cfg, 128)
    X = torch.from_numpy(rng.standard_normal((m, 3)).astype(np.float32))
    for op_c, op_h in ((card, host), (card.scale_rows(y.to(cuda_device)),
                                      host.scale_rows(y))):
        for Xin in (X, X[:, 0].contiguous()):
            before = (kmv_stream_full_cuda.launches,
                      kmv_stream_cuda.launches)
            got = op_c.full_matvec(Xin.to(cuda_device))
            torch.cuda.synchronize()
            assert (kmv_stream_full_cuda.launches,
                    kmv_stream_cuda.launches) == (before[0] + 1, before[1])
            assert got.shape == Xin.shape
            _close(got, op_h.full_matvec(Xin), dict(name="rbf"), 2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [96, 37])
def test_gather_rows_cuda_is_exact(cuda_device, dtype, n):
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.standard_normal((300, n)).astype(
        np.float32)).to(dtype)
    Xc = _chunk(A, 64, pin=True)
    idx = torch.tensor([0, 299, 64, 63, 5, 5, 250], device=cuda_device)
    before = gather_rows_cuda.launches
    got = gather_rows_cuda(Xc, idx)
    torch.cuda.synchronize()
    assert gather_rows_cuda.launches == before + 1
    assert torch.equal(got.cpu(), gather_rows_plain(Xc, idx.cpu()))
    assert torch.equal(got.cpu(), A[idx.cpu()])


@pytest.mark.gpu
def test_unpinned_host_chunks_raise(cuda_device):
    A, B, X = _data(100, 8, 16, 1, seed=2)
    Xc = _chunk(torch.from_numpy(A), 32)              # pageable
    Xvc = _chunk(torch.from_numpy(X).to(cuda_device), 32)
    B_d = torch.from_numpy(B).to(cuda_device)
    cfg = KernelConfig("rbf")
    for call in (lambda: kmv_stream_cuda(Xc, B_d, Xvc, cfg, m=100),
                 lambda: ops.kmv_stream(Xc, B_d, Xvc, cfg, m=100),
                 lambda: ops.gather_rows(Xc, torch.zeros(
                     2, dtype=torch.long, device=cuda_device))):
        with pytest.raises(ValueError, match="pinned"):
            call()


@pytest.mark.gpu
def test_dropped_host_chunks_are_read_intact(cuda_device):
    """The pipe and the gather read pinned host memory behind the
    allocator's back: a chunk buffer dropped while that work is still
    queued must not be handed to the next pinned allocation and
    overwritten before it is read."""
    A, B, X = _data(4000, 8, 512, 1, seed=6)
    cfg = KernelConfig("rbf")
    A_t = torch.from_numpy(A)
    B_d = torch.from_numpy(B).to(cuda_device)
    Xvc = _chunk(torch.from_numpy(X).to(cuda_device), 1024)
    idx = torch.arange(0, 4000, 37, device=cuda_device)
    want = kmv_stream_plain(_chunk(A_t, 1024), B_d, Xvc, cfg, m=4000)
    # a wrapper's first launch loads its kernels, which waits for the
    # card and would drain the queue before the drop
    warm = _chunk(A_t, 1024, pin=True)
    kmv_stream_cuda(warm, B_d, Xvc, cfg, m=4000)
    gather_rows_cuda(warm, idx)
    torch.cuda.synchronize()
    del warm
    busy = torch.randn((4096, 4096), device=cuda_device)
    for launch in ("kmv_stream", "gather_rows"):
        # pin first: a fresh page-locked allocation may wait for the card
        Xc = _chunk(A_t, 1024, pin=True)
        for _ in range(40):        # keep the stream busy well past the drop
            busy = torch.tanh(busy @ busy)
        got = (kmv_stream_cuda(Xc, B_d, Xvc, cfg, m=4000)
               if launch == "kmv_stream" else gather_rows_cuda(Xc, idx))
        shape, dtype = Xc.shape, Xc.dtype
        del Xc
        junk = torch.empty(shape, dtype=dtype, pin_memory=True)
        junk.fill_(1e3)
        torch.cuda.synchronize()
        if launch == "kmv_stream":
            _close(got, want, dict(name="rbf"), 2e-4)
        else:
            assert torch.equal(got.cpu(), A_t[idx.cpu()])
        del junk


@pytest.mark.gpu
@pytest.mark.parametrize("problem", ["ksvm", "krr"])
def test_streamed_fit_on_card_matches_fit_on_host(cuda_device, problem):
    """A streamed fit through the pipe (card) against the resident fit
    through the plain versions (host), one replayed schedule, iterates to
    1e-5; predictions through the streamed operator and a query stream."""
    rng = np.random.default_rng(12)
    m, n = 300, 40
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    if problem == "ksvm":
        y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
        kw = dict(method="sstep", s=8, max_iters=200, seed=3, record=True,
                  check_every=25)
        make = lambda dev, **o: KernelSVM(  # noqa: E731
            C=1.0, kernel="rbf", options=SolverOptions(**kw, **o),
            device=dev)
    else:
        y = rng.standard_normal(m).astype(np.float32)
        kw = dict(method="sstep", s=4, b=8, max_iters=64, seed=3,
                  tol=1e-6, check_every=4)
        make = lambda dev, **o: KernelRidge(  # noqa: E731
            lam=0.5, kernel="rbf", options=SolverOptions(**kw, **o),
            device=dev)
    host = make("cpu")
    r_host = host.fit(A, y)
    card = make(cuda_device, stream=64)
    r_card = card.fit(A, y, schedule=r_host.schedule)
    assert isinstance(card.op_, StreamingGramOperator)
    assert card.op_.Xc.is_pinned() and card.A_.device.type == "cpu"
    np.testing.assert_allclose(r_card.alpha.cpu().numpy(),
                               r_host.alpha.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r_card.history, r_host.history, rtol=1e-5,
                               atol=1e-6)
    Q = A[:50]
    if problem == "ksvm":
        f_host = host.decision_function(Q)
        f_card = card.decision_function(Q)
        f_strm = BatchedPredictor(card.op_, card.alpha_ * card.y_,
                                  batch=16, compact=True,
                                  stream=20)(torch.from_numpy(Q))
    else:
        f_host, f_card = host.predict(Q), card.predict(Q)
        f_strm = BatchedPredictor(card.op_, card.alpha_, batch=16,
                                  scale=1 / 0.5,
                                  stream=20)(torch.from_numpy(Q))
    np.testing.assert_allclose(f_card.cpu().numpy(), f_host.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f_strm.cpu().numpy(), f_host.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_streamed_fit_never_puts_a_on_the_card(cuda_device):
    """A streamed fit's peak device memory, less what was allocated when
    it began, stays under A's own bytes (two chunk slots, the sampled
    rows and the O(m) vectors)."""
    rng = np.random.default_rng(4)
    m, n = 16384, 512
    A = torch.from_numpy((rng.standard_normal((m, n)) / np.sqrt(n)).astype(
        np.float32))
    y = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    est = KernelRidge(lam=1.0, kernel="rbf", device=cuda_device,
                      options=SolverOptions(s=4, b=16, max_iters=64,
                                            stream=1024, record=True,
                                            check_every=8))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    est.fit(A, y)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    assert growth < A.numel() * A.element_size() / 2, growth


@pytest.mark.gpu
@pytest.mark.parametrize("problem", ["ksvm", "krr"])
def test_nystrom_fit_on_card_matches_fit_on_host(cuda_device, problem):
    """One landmark set and schedule on both devices: the map goes
    through the gram kernel on the card and its plain version on the
    host (TF32 off).  The factor's conditioning is mild at these
    landmarks (rbf, well-spread rows), so 1e-4 holds for alpha."""
    rng = np.random.default_rng(21)
    m, n, l = 240, 24, 32
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    L = A[rng.choice(m, l, replace=False)]
    if problem == "ksvm":
        y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
        opts = SolverOptions(method="sstep", s=8, max_iters=160, seed=2,
                             approx="nystrom", landmarks=l)
        make = lambda dev: KernelSVM(C=1.0, kernel="rbf",  # noqa: E731
                                     options=opts, device=dev)
    else:
        y = rng.standard_normal(m).astype(np.float32)
        opts = SolverOptions(method="sstep", s=4, b=8, max_iters=64,
                             seed=2, approx="nystrom", landmarks=l,
                             tol=1e-6, check_every=4)
        make = lambda dev: KernelRidge(lam=0.5, kernel="rbf",  # noqa: E731
                                       options=opts, device=dev)
    host, card = make("cpu"), make(cuda_device)
    r_host = host.fit(A, y, landmarks=L)
    r_card = card.fit(A, y, schedule=r_host.schedule, landmarks=L)
    np.testing.assert_allclose(r_card.alpha.cpu().numpy(),
                               r_host.alpha.numpy(), rtol=1e-4, atol=1e-4)
    Q = A[:40]
    f_host = (host.decision_function(Q) if problem == "ksvm"
              else host.predict(Q))
    f_card = (card.decision_function(Q) if problem == "ksvm"
              else card.predict(Q))
    np.testing.assert_allclose(f_card.cpu().numpy(), f_host.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 16, 128), (2, 128), (3, 7, 384),
                                   (1, 1, 256), (37, 2048), (300, 16, 128),
                                   (5, 100), (1001, 128), (9, 1, 128),
                                   (3, 5, 2048), (1, 2048), (67, 640),
                                   (4, 1024, 4096), (3, 4096)])
def test_rmsnorm_cuda_matches_plain(cuda_device, dtype, shape):
    """Ragged row counts, D not a multiple of the 16-byte vector (100),
    the model's widths compiled in (128 qk-norm rows, 2048) at row counts
    that leave a block, a warp or half a warp short, and other widths on
    the generic kernel (256, 384, 640, and Falcon-Mamba's 4096 at its
    prefill's and its decode's rows)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    scale = torch.from_numpy(
        rng.standard_normal(shape[-1]).astype(np.float32))
    x_d, s_d = x.to(cuda_device, dtype), scale.to(cuda_device)
    before = rmsnorm_cuda.launches
    got = rmsnorm_cuda(x_d, s_d)
    want = rmsnorm_plain(x_d, s_d)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    assert got.shape == x_d.shape and got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
def test_rmsnorm_cuda_unaligned_view(cuda_device):
    """A contiguous view that starts off a 16-byte boundary takes the
    element-by-element path and still agrees."""
    rng = np.random.default_rng(12)
    base = torch.from_numpy(rng.standard_normal(3 * 256 + 1)
                            .astype(np.float32)).to(cuda_device)
    x = base[1:].view(3, 256)
    scale = torch.ones(256, device=cuda_device)
    got = rmsnorm_cuda(x, scale)
    np.testing.assert_allclose(got.cpu().numpy(),
                               rmsnorm_plain(x, scale).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def _qkv(BH, S, T, hd, hdv, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda n, d: torch.from_numpy(  # noqa: E731
        rng.standard_normal((BH, n, d)).astype(np.float32)).to(device, dtype)
    return mk(S, hd), mk(T, hd), mk(T, hdv)


def _fwd_counts():
    return {"fma": flash_fwd_cuda.launches,
            "wgmma": flash_fwd_cuda.launches_wgmma}


def _assert_within(got, want, tol, what=""):
    """|got - want| <= tol elementwise (a derived bound)."""
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), (
        f"{what}: max abs err {float(err.max()):.3e}, "
        f"{float((err / tol).max()):.3f}x the bound")


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 128, 128, 32, 32),
                                   (1, 256, 256, 64, 64),
                                   (3, 64, 64, 16, 8),
                                   (2, 17, 17, 128, 128),
                                   (2, 100, 40, 24, 128),
                                   (2, 512, 512, 128, 128),
                                   (2, 100, 40, 128, 128),
                                   (2, 40, 100, 128, 128),
                                   (2, 100, 40, 64, 64)])
def test_flash_fwd_cuda_matches_plain(cuda_device, causal, dtype, shape):
    """The JAX test's shapes, ragged tiles (S = 17, 100; T = 40, 100), hd
    != hdv both ways, and full 128-wide heads over several k tiles; o and
    lse, through the route ``flash_route`` names (bf16 at hd = hdv 64 or
    128 the tensor-core kernel, the rest the FP32-FMA one), whose counter
    alone moves."""
    q, k, v = _qkv(*shape, dtype, cuda_device, seed=13)
    route = flash_route(dtype, shape[3], shape[4])
    before = _fwd_counts()
    o, lse = flash_fwd_cuda(q, k, v, causal=causal)
    o_p, lse_p = flash_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in _fwd_counts().items()}
    assert moved == {r: int(r == route) for r in moved}
    assert o.shape == o_p.shape and o.dtype == dtype
    assert lse.shape == lse_p.shape and lse.dtype == torch.float32
    if route == "wgmma":
        # p rounded to bf16 before PV: the derived bound
        _assert_within(o, o_p, flash_fwd_bf16_tolerance(q, k, v, o_p,
                                                        causal), "o")
    else:
        # both sides widen the same inputs and compute in f32: bf16 o
        # differs by its final rounding (one ulp), lse is f32 on both
        rtol, atol = ((1e-2, 1e-3) if dtype == torch.bfloat16
                      else (2e-4, 2e-5))
        np.testing.assert_allclose(o.float().cpu().numpy(),
                                   o_p.float().cpu().numpy(), rtol=rtol,
                                   atol=atol)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.gpu
def test_flash_fwd_cuda_refuses_what_the_tpu_kernel_refuses(cuda_device):
    q, k, v = _qkv(1, 300, 300, 32, 32, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        flash_fwd_cuda(q, k, v)
    q, k, v = _qkv(1, 64, 64, 160, 32, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="exceed"):
        flash_fwd_cuda(q, k, v)


@pytest.mark.gpu
def test_tensor_core_route_refuses_unaligned_operands(cuda_device):
    """TMA reads from 16-byte aligned addresses: a contiguous bf16 view
    that starts 2 bytes in is refused, not read wrongly."""
    q, k, v = _qkv(1, 64, 64, 64, 64, torch.bfloat16, cuda_device)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    q_off = flat[1:].view(q.shape)
    q_off.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        flash_fwd_cuda(q_off, k, v)


BWD_SHAPES = [(2, 128, 128, 32, 32), (2, 64, 64, 48, 32),
              (3, 64, 64, 16, 8), (2, 17, 17, 128, 128),
              (2, 100, 40, 24, 128), (2, 40, 100, 128, 64),
              (2, 512, 512, 128, 128), (2, 100, 40, 128, 128),
              (2, 40, 100, 128, 128), (2, 100, 40, 64, 64),
              (2, 256, 256, 64, 64)]


def _bwd_inputs(shape, dtype, device, causal, seed):
    q, k, v = _qkv(*shape, dtype, device, seed=seed)
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        q.shape[:2] + v.shape[2:]).astype(np.float32)).to(device, dtype)
    o, lse = flash_fwd_plain(q, k, v, causal=causal)
    return q, k, v, do, lse, flash_delta(o, do)


def _bwd_counts():
    return {"dq": flash_bwd_cuda.launches_dq,
            "dq_wgmma": flash_bwd_cuda.launches_dq_wgmma,
            "fma": flash_bwd_cuda.launches_dkv,
            "wgmma": flash_bwd_cuda.launches_dkv_wgmma}


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_bwd_cuda_matches_plain(cuda_device, causal, dtype, shape):
    """The JAX gradient tests' shapes (hd != hdv as in test_grads_mla_vdim),
    ragged tails in S and T both ways, and full 128-wide heads over
    several tiles: dq, dk, dv from the same lse and delta; one launch of
    the dq and one of the dkv kernel that ``flash_route`` names."""
    q, k, v, do, lse, delta = _bwd_inputs(shape, dtype, cuda_device, causal,
                                          16)
    route = flash_route(dtype, shape[3], shape[4])
    before = _bwd_counts()
    got = flash_bwd_cuda(q, k, v, do, lse, delta, causal=causal)
    want = flash_bwd_plain(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in _bwd_counts().items()}
    fma = int(route == "fma")
    assert moved == {"dq": fma, "dq_wgmma": 1 - fma, "fma": fma,
                     "wgmma": 1 - fma}
    rtol, atol = (1e-2, 1e-3) if dtype == torch.bfloat16 else (2e-4, 2e-5)
    tols = (None, None, None)
    if route == "wgmma":
        tols = (flash_dq_bf16_tolerance(q, k, v, do, lse, delta, want[0],
                                        causal),
                *flash_dkv_bf16_tolerance(q, k, v, do, lse, delta, want[1],
                                          want[2], causal))
    for name, a, b, ref, tol in zip(("dq", "dk", "dv"), got, want,
                                    (q, k, v), tols):
        assert a.shape == ref.shape and a.dtype == dtype, name
        if tol is not None:
            _assert_within(a, b, tol, name)
            continue
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().cpu().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,route", [
    ((4, 512, 512, 128, 128), torch.bfloat16, "wgmma"),
    ((4, 200, 136, 64, 64), torch.bfloat16, "wgmma"),
    ((4, 512, 512, 128, 128), torch.float32, "fma")],
    ids=["wgmma-hd128", "wgmma-hd64-ragged", "fma-f32"])
def test_flash_bwd_cuda_repeats_bit_for_bit(cuda_device, shape, dtype,
                                            route):
    """No atomics in the dq and dkv kernels of either route: two calls on the
    same inputs give the same bits."""
    args = _bwd_inputs(shape, dtype, cuda_device, True, 17)
    before = _bwd_counts()
    a = flash_bwd_cuda(*args)
    b = flash_bwd_cuda(*args)
    dq_route = "dq_wgmma" if route == "wgmma" else "dq"
    assert _bwd_counts()[route] - before[route] == 2
    assert _bwd_counts()[dq_route] - before[dq_route] == 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_flash_bwd_cuda_refuses_bad_operands(cuda_device):
    q, k, v, do, lse, delta = _bwd_inputs((1, 64, 64, 32, 32), torch.float32,
                                          cuda_device, True, 18)
    with pytest.raises(ValueError, match="do"):
        flash_bwd_cuda(q, k, v, do[:, :32], lse, delta)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd_cuda(q, k, v, do, lse.double(), delta)
    with pytest.raises(ValueError, match="dtype"):
        flash_bwd_cuda(q, k, v, do.bfloat16(), lse, delta)


@pytest.mark.gpu
@pytest.mark.parametrize("hdv", [32, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_grads_on_card(cuda_device, causal, dtype, hdv):
    """The autograd Function on the card (kernels forward and backward;
    bf16 with hdv = hd = 64 through the tensor-core kernels): every input
    gets a gradient, held against autograd through the plain oracle on
    the same inputs (f32 2e-3 / 2e-4, the JAX gradient test's; bf16 3e-2,
    its bf16 bound, since the oracle's autograd rounds its own
    intermediates to bf16)."""
    q, k, v = _qkv(2, 256, 256, 64, hdv, dtype, cuda_device, seed=19)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    do = torch.randn(q.shape[:2] + v.shape[2:], device=cuda_device,
                     generator=gen).to(dtype)
    grads = []
    for fn in (flash_attention, flash_attention_ref):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        before = _bwd_counts()
        (fn(*leaves, causal=causal).float() * do.float()).sum().backward()
        if fn is flash_attention:
            dq_route = ("dq_wgmma" if flash_route(dtype, 64, hdv) == "wgmma"
                        else "dq")
            assert _bwd_counts()[dq_route] == before[dq_route] + 1
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    tol = (3e-2, 3e-2) if dtype == torch.bfloat16 else (2e-3, 2e-4)
    for a, b in zip(*grads):
        assert a is not None and bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().cpu().numpy(), rtol=tol[0],
                                   atol=tol[1])


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_takes_unaligned_bf16_views(cuda_device, hd):
    """A bf16 view that starts 2 bytes into its buffer goes through the
    tensor-core route forward and backward (the Function copies it to an
    aligned tensor; the launchers still refuse it, see above) and gives the
    same bits as an aligned copy of the same values."""
    q, k, v = _qkv(2, 256, 256, hd, hd, torch.bfloat16, cuda_device, seed=22)
    do = torch.randn(q.shape, device=cuda_device,
                     generator=torch.Generator(device=cuda_device)
                     .manual_seed(1)).to(torch.bfloat16)
    outs = []
    for aligned in (False, True):
        ops_ = []
        for t in (q, k, v):
            flat = torch.empty(t.numel() + 1, dtype=t.dtype,
                               device=cuda_device)
            off = int(not aligned)
            view = flat[off:off + t.numel()].view(t.shape)
            view.copy_(t)
            ops_.append(view.detach().requires_grad_())
        assert all((u.data_ptr() % 16 == 0) == aligned for u in ops_)
        before = _bwd_counts()
        o = flash_attention(*ops_, causal=True)
        o.backward(do)
        torch.cuda.synchronize()
        assert _bwd_counts()["dq_wgmma"] == before["dq_wgmma"] + 1
        outs.append([o.detach()] + [u.grad for u in ops_])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2])
def test_sdpa_flash_grads_on_card_match_host(cuda_device, B):
    """The model's (B, S, H, hd) layout through ops.sdpa_flash, forward
    and backward, on the card against the host; with B = 1 the head
    reshape is a strided view, which the Function makes contiguous for
    the kernels.  f32 2e-4 / 2e-5."""
    rng = np.random.default_rng(21)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, 128, 4, 32)).astype(np.float32)) for _ in range(4))
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves_ = [t.detach().clone().to(dev).requires_grad_()
                   for t in (q, k, v)]
        o = ops.sdpa_flash(*leaves_, causal=True)
        (o * do.to(dev)).sum().backward()
        grads[str(dev)] = [o.detach().cpu()] + [t.grad.cpu()
                                                for t in leaves_]
    for a, b in zip(grads[str(cuda_device)], grads["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 16, 128), (37, 2048), (5, 100)])
def test_rmsnorm_backward_on_card(cuda_device, dtype, shape):
    """The RMSNorm Function on the card (the kernel forward, the plain f32
    backward): dx and dscale against autograd through rmsnorm_ref, f32
    1e-5, bf16 2e-2 on dx (one bf16 rounding) and 1e-4 relative on the f32
    dscale; one kernel launch."""
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda_device, dtype)
    scale = torch.from_numpy(rng.standard_normal(shape[-1]).astype(
        np.float32)).to(cuda_device)
    dy = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, dtype)
    grads = []
    for fn in (RMSNorm.apply, rmsnorm_ref):
        xl, sl = x.clone().requires_grad_(), scale.clone().requires_grad_()
        before = rmsnorm_cuda.launches
        fn(xl, sl, 1e-6).backward(dy)
        if fn is RMSNorm.apply:
            assert rmsnorm_cuda.launches == before + 1
        grads.append((xl.grad, sl.grad))
    torch.cuda.synchronize()
    (dx, ds), (dx_r, ds_r) = grads
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert dx.dtype == dtype and ds.dtype == torch.float32
    np.testing.assert_allclose(dx.float().cpu().numpy(),
                               dx_r.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(ds.cpu().numpy(), ds_r.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def _reduced_lm(arch, impl, dtype="float32"):
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype,
                              attn_impl=impl)
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    return cfg, params


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3_1p7b", "granite_20b"])
@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_reduced_lm_forward_on_card_matches_host(cuda_device, arch, impl):
    """The reduced model's f32 forward through the kernels (card) and the
    plain versions (host), same weights: 1e-4, f32 summation order; every
    norm is one rmsnorm launch and every layer one flash launch."""
    cfg, params = _reduced_lm(arch, impl)
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (2, 64)))
    host = forward(params, cfg, toks)
    r0, f0 = rmsnorm_cuda.launches, flash_fwd_cuda.launches
    card = forward(_to(params, cuda_device), cfg, toks.to(cuda_device))
    torch.cuda.synchronize()
    n_norms = (4 if cfg.qk_norm else 2) * cfg.n_layers + 1
    assert rmsnorm_cuda.launches - r0 == n_norms
    assert flash_fwd_cuda.launches - f0 == (cfg.n_layers if impl == "flash"
                                            else 0)
    np.testing.assert_allclose(card.cpu().numpy(), host.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4096, 512), (4, 512), (4, 1024, 512),
                                   (4, 1, 512), (37, 512)])
def test_rmsnorm_cuda_at_the_mla_latent_width(cuda_device, dtype, shape):
    """D = 512, DeepSeek-V2-Lite's kv_lora_rank (MLA's kv_norm), on the
    generic vector kernel: the prefill's (4096, 512), the decode step's
    (4, 512) and ragged row counts, against the plain version."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    x_d, s_d = x.to(cuda_device, dtype), scale.to(cuda_device)
    before = rmsnorm_cuda.launches
    got = rmsnorm_cuda(x_d, s_d)
    want = rmsnorm_plain(x_d, s_d)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    assert got.shape == x_d.shape and got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["dense", "capacity"])
def test_reduced_deepseek_forward_on_card_matches_host(cuda_device, impl):
    """Reduced DeepSeek-V2-Lite (MLA + MoE), f32: the forward through the
    kernels (card) against the plain versions (host), same weights, 1e-4;
    three norms a layer (norm1, MLA's kv_norm, norm2) and final_norm, one
    rmsnorm launch each; then teacher-forced decode on the card against
    the host, dense dispatch."""
    cfg, params = _reduced_lm("deepseek_v2_lite_16b", "naive")
    cfg = dataclasses.replace(cfg, moe_impl=impl)
    toks = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (2, 64)))
    host = forward(params, cfg, toks)
    params_d = _to(params, cuda_device)
    r0 = rmsnorm_cuda.launches
    card = forward(params_d, cfg, toks.to(cuda_device))
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches - r0 == 3 * cfg.n_layers + 1
    np.testing.assert_allclose(card.cpu().numpy(), host.numpy(), rtol=1e-4,
                               atol=1e-4)
    cfg = dataclasses.replace(cfg, moe_impl="dense")
    outs = {}
    for dev, p in (("cpu", params), ("cuda", params_d)):
        st = init_decode_state(cfg, 2, 8, device=dev)
        logits = []
        for t in range(8):
            lg, st = decode_step(p, cfg, st, toks[:, t:t + 1].to(dev))
            logits.append(lg.cpu())
        outs[dev] = torch.stack(logits, 1)
    np.testing.assert_allclose(outs["cuda"].numpy(), outs["cpu"].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1p2b"])
def test_reduced_ssm_forward_on_card_matches_host(cuda_device, arch):
    """Reduced Falcon-Mamba (Mamba-1) and Zamba2 (Mamba-2 SSD with the
    shared attention block), f32, flash: the forward through the kernels
    (card) against the plain versions (host), same weights, 1e-4; one
    rmsnorm launch a norm (norm1 a layer, norm and norm2 an application
    of the shared block, final_norm) and one flash launch an application;
    then 8 teacher-forced decode steps on the card against the host."""
    cfg, params = _reduced_lm(arch, "flash")
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (2, 100)))
    host = forward(params, cfg, toks)
    params_d = _to(params, cuda_device)
    r0, f0 = rmsnorm_cuda.launches, sum(_fwd_counts().values())
    card = forward(params_d, cfg, toks.to(cuda_device))
    torch.cuda.synchronize()
    shared = cfg.n_periods if cfg.shared_attn_every else 0
    assert rmsnorm_cuda.launches - r0 == cfg.n_layers + 2 * shared + 1
    assert sum(_fwd_counts().values()) - f0 == shared
    np.testing.assert_allclose(card.cpu().numpy(), host.numpy(), rtol=1e-4,
                               atol=1e-4)
    outs = {}
    for dev, p in (("cpu", params), ("cuda", params_d)):
        st = init_decode_state(cfg, 2, 8, device=dev)
        logits = []
        for t in range(8):
            lg, st = decode_step(p, cfg, st, toks[:, t:t + 1].to(dev))
            logits.append(lg.cpu())
        outs[dev] = torch.stack(logits, 1)
    np.testing.assert_allclose(outs["cuda"].numpy(), outs["cpu"].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4096, 8192), (4, 8192), (2048, 8192),
                                   (37, 8192), (4, 1, 8192)])
def test_rmsnorm_cuda_at_the_qwen2_vl_width(cuda_device, dtype, shape):
    """D = 8192, Qwen2-VL-72B's d_model, on the generic vector kernel: the
    prefill's (4096, 8192), the decode step's (4, 8192), a training
    microbatch's (2048, 8192) and ragged rows, against the plain
    version."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal(8192).astype(np.float32))
    x_d, s_d = x.to(cuda_device, dtype), scale.to(cuda_device)
    before = rmsnorm_cuda.launches
    got = rmsnorm_cuda(x_d, s_d)
    want = rmsnorm_plain(x_d, s_d)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    assert got.shape == x_d.shape and got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(24, 1536, 1536, 64, 64),
                                   (24, 256, 256, 64, 64)],
                         ids=["encoder", "decoder"])
def test_flash_at_whisper_head_dims_matches_plain(cuda_device, shape):
    """Whisper-tiny's self-attention at hd 64 in bf16 (4 rows x 6 heads):
    the encoder's 1536 frames and the decoder's 256 tokens, causal,
    through the tensor-core forward, dq and dkv kernels, held to their
    derived bounds against the plain versions; lse at the f32 limits."""
    q, k, v, do, lse_p, delta = _bwd_inputs(shape, torch.bfloat16,
                                            cuda_device, True, 18)
    assert flash_route(torch.bfloat16, 64, 64) == "wgmma"
    f0, b0 = _fwd_counts(), _bwd_counts()
    o, lse = flash_fwd_cuda(q, k, v, causal=True)
    got = flash_bwd_cuda(q, k, v, do, lse_p, delta, causal=True)
    o_p, _ = flash_fwd_plain(q, k, v, causal=True)
    want = flash_bwd_plain(q, k, v, do, lse_p, delta, causal=True)
    torch.cuda.synchronize()
    assert _fwd_counts()["wgmma"] - f0["wgmma"] == 1
    assert _bwd_counts()["dq_wgmma"] - b0["dq_wgmma"] == 1
    assert _bwd_counts()["wgmma"] - b0["wgmma"] == 1
    _assert_within(o, o_p, flash_fwd_bf16_tolerance(q, k, v, o_p, True),
                   "o")
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=2e-4, atol=2e-5)
    tols = (flash_dq_bf16_tolerance(q, k, v, do, lse_p, delta, want[0],
                                    True),
            *flash_dkv_bf16_tolerance(q, k, v, do, lse_p, delta, want[1],
                                      want[2], True))
    for name, a, b, tol in zip(("dq", "dk", "dv"), got, want, tols):
        _assert_within(a, b, tol, name)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper_tiny", "qwen2_vl_72b"])
def test_reduced_encdec_and_mrope_forward_on_card_matches_host(cuda_device,
                                                               arch):
    """Reduced Whisper (encoder, cross-attention, layernorm) and Qwen2-VL
    (M-RoPE over three distinct streams), f32, flash: the forward
    through the kernels (card) against the plain versions (host), same
    weights and frames, 1e-4; one flash launch a self-attention (the
    encoder's and the decoder's; cross-attention is plain), one rmsnorm
    launch a norm (Whisper's layernorms are plain); then 8
    teacher-forced decode steps on the card (Whisper over the cross
    keys and values of prefill_cross_kv) against the host."""
    cfg, params = _reduced_lm(arch, "flash")
    rng = np.random.default_rng(22)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    kw = {}
    if cfg.encoder_layers:
        kw["audio_embed"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.mrope:
        pos = torch.arange(64).expand(3, 2, 64).clone()
        pos[1, :, 8:24] = 8 + torch.arange(16) // 4
        pos[2, :, 8:24] = 8 + torch.arange(16) % 4
        kw["positions"] = pos
    host = forward(params, cfg, toks, **kw)
    params_d = _to(params, cuda_device)
    kw_d = {k: v.to(cuda_device) for k, v in kw.items()}
    r0, f0 = rmsnorm_cuda.launches, sum(_fwd_counts().values())
    card = forward(params_d, cfg, toks.to(cuda_device), **kw_d)
    torch.cuda.synchronize()
    norms = 0 if cfg.norm == "layernorm" else 2 * cfg.n_layers + 1
    assert rmsnorm_cuda.launches - r0 == norms
    assert sum(_fwd_counts().values()) - f0 == (cfg.n_layers
                                                + cfg.encoder_layers)
    np.testing.assert_allclose(card.cpu().numpy(), host.numpy(), rtol=1e-4,
                               atol=1e-4)
    outs = {}
    for dev, p in (("cpu", params), ("cuda", params_d)):
        st = init_decode_state(cfg, 2, 8, device=dev,
                               with_encoder=bool(cfg.encoder_layers))
        if cfg.encoder_layers:
            st["cross_kv"] = prefill_cross_kv(
                p, cfg, kw["audio_embed"].to(dev))
        logits = []
        for t in range(8):
            lg, st = decode_step(p, cfg, st, toks[:, t:t + 1].to(dev))
            logits.append(lg.cpu())
        outs[dev] = torch.stack(logits, 1)
    np.testing.assert_allclose(outs["cuda"].numpy(), outs["cpu"].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_reduced_decode_and_engine_on_card_match_host(cuda_device):
    """Teacher-forced decode logits (1e-4) and the engine's greedy tokens
    (equal) on the card against the host, f32, reduced Qwen3."""
    cfg, params = _reduced_lm("qwen3_1p7b", "flash")
    params_d = _to(params, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (2, 12)))
    outs = {}
    for dev, p in (("cpu", params), ("cuda", params_d)):
        st = init_decode_state(cfg, 2, 16, device=dev)
        logits = []
        for t in range(toks.shape[1]):
            lg, st = decode_step(p, cfg, st, toks[:, t:t + 1].to(dev))
            logits.append(lg.cpu())
        outs[dev] = torch.stack(logits, 1)
    np.testing.assert_allclose(outs["cuda"].numpy(), outs["cpu"].numpy(),
                               rtol=1e-4, atol=1e-4)
    generated = {}
    for dev, p in (("cpu", params), ("cuda", params_d)):
        eng = ServingEngine(p, cfg, n_slots=2, max_seq=32)
        reqs = [Request(rid=i, prompt=[3 + i, 7, 11], max_new_tokens=5)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done(200)
        assert all(r.done for r in reqs)
        generated[dev] = [r.generated for r in reqs]
    assert generated["cuda"] == generated["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["full", "none"])
def test_reduced_lm_grads_on_card_match_host(cuda_device, remat):
    """loss_fn's gradients through the kernels (card: flash forward, dq,
    dkv, rmsnorm) against the plain versions (host), f32, same weights:
    1e-4; every leaf gets a finite, non-zero gradient (no kernel cuts the
    graph); launches: every norm and layer once in the forward, and again
    in the remat recompute (the final norm outside it), one dq and one
    dkv per layer."""
    cfg, params = _reduced_lm("qwen3_1p7b", "flash")
    cfg = dataclasses.replace(cfg, remat=remat)
    batch = TokenPipeline(cfg.vocab_size, 64, 2, seed=1).batch(0)
    l_host, g_host = loss_and_grads(params, cfg, batch)
    params_d = _to(params, cuda_device)
    before = (rmsnorm_cuda.launches, flash_fwd_cuda.launches,
              flash_bwd_cuda.launches_dq, flash_bwd_cuda.launches_dkv)
    l_card, g_card = loss_and_grads(params_d, cfg, _to(batch, cuda_device))
    torch.cuda.synchronize()
    n_norms = 4 * cfg.n_layers + 1
    again = remat == "full"
    assert (rmsnorm_cuda.launches - before[0],
            flash_fwd_cuda.launches - before[1],
            flash_bwd_cuda.launches_dq - before[2],
            flash_bwd_cuda.launches_dkv - before[3]) == (
        n_norms + again * (n_norms - 1), cfg.n_layers * (1 + again),
        cfg.n_layers, cfg.n_layers)
    np.testing.assert_allclose(float(l_card), float(l_host), rtol=1e-5)
    for (path, _), a, b in zip(leaves_with_paths(params), g_card, g_host):
        assert a is not None and bool(torch.isfinite(a).all()), path
        assert bool(a.abs().max() > 0), path
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=str(path))


@pytest.mark.gpu
def test_reduced_train_steps_on_card_match_host(cuda_device):
    """Three microbatched (2) train steps, bf16 activations, remat, flash,
    on the card and on the host from the same weights and batches: the
    losses within bf16's 5e-2 and falling on the card; lr equal."""
    cfg, params = _reduced_lm("qwen3_1p7b", "flash", dtype="bfloat16")
    acfg = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3)
    step = make_train_step(cfg, acfg, TrainConfig(microbatches=2))
    pipe = TokenPipeline(cfg.vocab_size, 64, 4, seed=2)
    runs = {}
    for dev, p in (("cpu", params), ("cuda", _to(params, cuda_device))):
        opt, losses = adamw_init(p), []
        for s in range(3):
            p, opt, m = step(p, opt, pipe.batch(s))
            losses.append((float(m["loss"]), float(m["lr"])))
        runs[dev] = losses
    for (lc, rc), (lh, rh) in zip(runs["cuda"], runs["cpu"]):
        assert abs(lc - lh) <= 5e-2 * abs(lh) and rc == rh
    assert runs["cuda"][-1][0] < runs["cuda"][0][0]


# ---- the captured round driver (core.loop.RoundGraphs) -----------------

def _card_solvers(dev, seed=5):
    """(name, round fn, xs, m, metric fn) for the four solvers on the card,
    rbf through the KMV and gram kernels, each over a schedule with a
    tail run (R not a multiple of the runs' length)."""
    rng = np.random.default_rng(seed)
    m, n = 300, 40
    A = torch.tensor(rng.standard_normal((m, n)) / np.sqrt(n),
                     dtype=torch.float32, device=dev)
    y = torch.tensor(np.where(rng.random(m) < 0.5, 1.0, -1.0),
                     dtype=torch.float32, device=dev)
    yk = torch.sin(A @ torch.ones(n, device=dev))
    rbf = KernelConfig("rbf", sigma=0.7)
    svm, krr = SVMConfig(C=1.0, kernel=rbf), KRRConfig(lam=0.5, kernel=rbf)
    gen = torch.Generator().manual_seed(seed)
    sched = torch.randint(0, m, (loop.FAST_RUN + 37,), generator=gen).to(dev)
    blocks = torch.stack([torch.randperm(m, generator=gen)[:8]
                          for _ in range(4 * 21)]).to(dev)
    gap = lambda a: krr_rel_residual(A, yk, a, krr)  # noqa: E731
    return [
        ("dcd", make_dcd_round_fn(A, y, svm), sched, m, gap),
        ("sstep_dcd", make_sstep_dcd_round_fn(A, y, svm, 8),
         pad_rounds(sched, 8), m, gap),
        ("bdcd", make_bdcd_round_fn(A, yk, krr), blocks, m, gap),
        ("sstep_bdcd", make_sstep_bdcd_round_fn(A, yk, krr, 4),
         pad_rounds(blocks, 4), m, gap),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["fast", "record", "tol"])
@pytest.mark.parametrize("solver", ["dcd", "sstep_dcd", "bdcd",
                                    "sstep_bdcd"])
def test_captured_rounds_equal_eager_loop_bit_for_bit(cuda_device, solver,
                                                      path):
    """The rounds replayed as CUDA graphs launch the same kernels in the
    same order as the eager loop: the same bits in alpha, the recorded
    states and the metric history (the K-RR ones through torch's small
    solve captured in the graph)."""
    _, rf, xs, m, metric = next(c for c in _card_solvers(cuda_device)
                                if c[0] == solver)
    a0 = torch.zeros(m, device=cuda_device)
    kw = {"fast": {}, "record": dict(record_state=True),
          "tol": dict(tol=NO_TOL, check_every=5, metric_fn=metric)}[path]
    got = loop.run_rounds(rf, a0, xs, **kw)
    want = loop._run_rounds_eager(rf, a0, xs, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.state).all())
    assert torch.equal(got.state, want.state)
    for name in ("state_hist", "metric_hist"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w), name
    assert (got.checks_run, got.rounds_run) == (want.checks_run,
                                                want.rounds_run)


@pytest.mark.gpu
def test_stale_schedule_buffer_breaks_bit_equality_on_card(cuda_device):
    """Replays that skip the copy of their schedule slice repeat the first
    run's coordinates and must not match the eager loop."""
    _, rf, xs, m, _ = _card_solvers(cuda_device)[1]
    a0 = torch.zeros(m, device=cuda_device)
    want = loop._run_rounds_eager(rf, a0, xs)
    with loop.RoundGraphs(rf, a0, xs, 4) as g:
        assert g.on_card and g.capture_s > 0 and g.pool_bytes > 0
        for j in range(g.n_runs):
            g.run(j, refresh=j == 0)
        stale = g.state.clone()
    assert not torch.equal(stale, want.state)


@pytest.mark.gpu
@pytest.mark.parametrize("problem", ["ksvm", "krr"])
def test_captured_fit_counts_exact_launches(cuda_device, problem):
    """kmv and gram count the launches a captured fit makes, once per
    round and once per check, and the warm-up's apart."""
    rng = np.random.default_rng(4)
    m, n = 200, 24
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    if problem == "ksvm":
        y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
        opts = SolverOptions(method="sstep", s=4, max_iters=4 * 150, seed=1)
        est = KernelSVM(C=1.0, kernel="rbf", options=opts,
                        device=cuda_device)
        rounds, checks = 150, 0
    else:
        y = rng.standard_normal(m).astype(np.float32)
        opts = SolverOptions(method="sstep", s=4, b=6, max_iters=4 * 23,
                             seed=1, record=True, check_every=5)
        est = KernelRidge(lam=0.5, kernel="rbf", options=opts,
                          device=cuda_device)
        rounds, checks = 23, 5
    for fn in (kmv_cuda, gram_cuda):
        fn.launches = fn.warmup_launches = 0
    res = est.fit(A, y)
    torch.cuda.synchronize()
    assert res.rounds_run == rounds
    assert (kmv_cuda.launches, gram_cuda.launches) == (rounds + checks,
                                                       rounds)
    # one eager round (and check) before the captures
    assert (kmv_cuda.warmup_launches, gram_cuda.warmup_launches) == (
        1 + (checks > 0), 1)


@pytest.mark.gpu
def test_round_with_a_host_read_fails_its_capture(cuda_device,
                                                  monkeypatch):
    """A round that reads a value on the host cannot be captured: the
    driver raises and does not run the rounds eagerly instead."""
    _, rf, xs, m, _ = _card_solvers(cuda_device)[0]
    eager = []
    monkeypatch.setattr(loop, "_run_rounds_eager",
                        lambda *a, **k: eager.append(1))

    def reads_host(alpha, i):
        if float(alpha.sum().item()) > 1e30:
            return alpha
        return rf(alpha, i)

    with pytest.raises(RuntimeError):
        loop.run_rounds(reads_host, torch.zeros(m, device=cuda_device), xs)
    assert not eager
    # the card still works: the same rounds, captured, run
    monkeypatch.undo()
    res = loop.run_rounds(rf, torch.zeros(m, device=cuda_device), xs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(res.state).all())


@pytest.mark.gpu
@pytest.mark.parametrize("problem", ["ksvm", "krr"])
@pytest.mark.parametrize("rep", ["exact", "nystrom"])
def test_captured_facade_fit_equals_eager_fit(cuda_device, monkeypatch,
                                             problem, rep):
    """The facade's fit through the graphs against the same fit with the
    operator declared not capturable (the eager loop): the same alpha and
    metric history, bit for bit."""
    rng = np.random.default_rng(11)
    m, n = 240, 24
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    extra = dict(approx="nystrom", landmarks=32) if rep == "nystrom" else {}
    if problem == "ksvm":
        y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
        opts = SolverOptions(method="sstep", s=8, max_iters=400, seed=2,
                             tol=1e-9, check_every=7, **extra)
        make = lambda: KernelSVM(C=1.0, kernel="rbf",  # noqa: E731
                                 options=opts, device=cuda_device)
    else:
        y = rng.standard_normal(m).astype(np.float32)
        opts = SolverOptions(method="sstep", s=4, b=8, max_iters=160,
                             seed=2, tol=1e-9, check_every=6, **extra)
        make = lambda: KernelRidge(lam=0.5, kernel="rbf",  # noqa: E731
                                   options=opts, device=cuda_device)
    est = make()
    got = est.fit(A, y)
    monkeypatch.setattr(type(est.op_), "capturable", False)
    want = make().fit(A, y, schedule=got.schedule)
    torch.cuda.synchronize()
    assert torch.equal(got.alpha, want.alpha)
    np.testing.assert_array_equal(got.history, want.history)
    assert got.rounds_run == want.rounds_run


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["sstep_dcd", "sstep_bdcd"])
def test_rounds_with_repeated_coordinates_repeat_bit_for_bit(cuda_device,
                                                             solver):
    """Rounds whose coordinates repeat many times over (m = 48, 32 or 64
    coordinates a round) sum the repeats in a fixed order: two captured
    drives and two eager ones give the same bits."""
    rng = np.random.default_rng(13)
    m, n = 48, 16
    A = torch.tensor(rng.standard_normal((m, n)) / np.sqrt(n),
                     dtype=torch.float32, device=cuda_device)
    y = torch.tensor(np.where(rng.random(m) < 0.5, 1.0, -1.0),
                     dtype=torch.float32, device=cuda_device)
    rbf = KernelConfig("rbf", sigma=0.7)
    gen = torch.Generator().manual_seed(3)
    if solver == "sstep_dcd":
        rf = make_sstep_dcd_round_fn(A, y, SVMConfig(C=1.0, kernel=rbf), 32)
        xs = pad_rounds(torch.randint(0, m, (32 * 20,),
                                      generator=gen).to(cuda_device), 32)
    else:
        rf = make_sstep_bdcd_round_fn(A, y, KRRConfig(lam=0.5, kernel=rbf),
                                      8)
        blocks = torch.stack([torch.randperm(m, generator=gen)[:8]
                              for _ in range(8 * 20)])
        xs = pad_rounds(blocks.to(cuda_device), 8)
    a0 = torch.zeros(m, device=cuda_device)
    runs = [loop.run_rounds(rf, a0, xs).state for _ in range(2)]
    runs += [loop._run_rounds_eager(rf, a0, xs).state for _ in range(2)]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(runs[0]).all())
    for other in runs[1:]:
        assert torch.equal(runs[0], other)


# ---------------------------------------------------------------------------
# fleets (tune.solve_fleet): KMV at c = F, one launch a round for the whole
# fleet, F = 1 and the captured fleet against the single fit and the eager
# loop bit for bit, the probe's measured time
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("c", [4, 8, 16])
@pytest.mark.parametrize("r", [32, 256, "B=A"])
def test_kmv_cuda_at_fleet_widths(cuda_device, monkeypatch, c, r):
    """KMV with X of c = F columns (a fleet's round and check) against
    kmv_plain, repeating bit for bit; B = A, planned as for a 2-SM card,
    keeps the symmetric regime at every c (its workspace passes
    WS_MAX_FLOATS here), and each column equals a c = 1 launch's within
    the tolerance."""
    monkeypatch.setattr(kmv_module, "sm_count", lambda index: 2)
    m = 3000
    A, B, X = _data(m, 1 if r == "B=A" else r, 1000, c, seed=12)
    monkeypatch.setattr(kmv_module, "WS_MAX_FLOATS", m * m)
    cfg = KernelConfig(name="rbf", sigma=0.7)
    A_d = torch.from_numpy(A).to(cuda_device)
    B_d = A_d if r == "B=A" else torch.from_numpy(B).to(cuda_device)
    X_d = torch.from_numpy(X).to(cuda_device)
    if r == "B=A":
        assert kmv_module.kmv_plan(m, m, c, 2, True).regime == "symmetric"
    got = kmv_cuda(A_d, B_d, X_d, cfg)
    assert torch.equal(got, kmv_cuda(A_d, B_d, X_d, cfg))
    _close(got, kmv_plain(A_d, B_d, X_d, cfg), dict(name="rbf"), 2e-4)
    _close(got[:, c - 1], kmv_cuda(A_d, B_d, X_d[:, c - 1].contiguous(),
                                   cfg), dict(name="rbf"), 2e-4)


def _fleet_data(problem, m=400, n=48, seed=21):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    if problem == "ksvm":
        y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
        # the gaps of C = 0.25 fall from 91.5 to 87.8 over the ten checks
        # (the host run): it converges midway, the others do not
        opts = SolverOptions(method="sstep", s=16, max_iters=640, seed=4,
                             tol=89.5, check_every=4)
        grid = {"Cs": [0.25, 1.0, 4.0, 16.0]}
    else:
        y = rng.standard_normal(m).astype(np.float32)
        opts = SolverOptions(method="sstep", s=4, b=16, max_iters=1024,
                             seed=4, tol=1e-4, check_every=4)
        grid = {"lams": [0.01, 0.1, 1.0, 100.0]}
    return A, y, opts, grid


@pytest.mark.gpu
@pytest.mark.parametrize("problem", ["ksvm", "krr"])
def test_one_member_fleet_equals_the_single_fit_on_card(cuda_device,
                                                        problem):
    """F = 1: the fleet's captured rounds and checks give the single fit's
    alpha, residual (gap) history and stopping point bit for bit."""
    from repro_torch.tune import solve_fleet
    A, y, opts, _ = _fleet_data(problem)
    if problem == "ksvm":
        single = KernelSVM(C=1.0, kernel="rbf", options=opts,
                           device=cuda_device).fit(A, y)
        fleet = solve_fleet(A, y, Cs=[1.0], kernel="rbf", options=opts,
                            device=cuda_device)
    else:
        single = KernelRidge(lam=1.0, kernel="rbf", options=opts,
                             device=cuda_device).fit(A, y)
        fleet = solve_fleet(A, y, lams=[1.0], kernel="rbf", options=opts,
                            device=cuda_device)
    assert torch.equal(fleet.alpha[0], single.alpha)
    np.testing.assert_array_equal(fleet.history[:, 0], single.history)
    assert fleet.rounds_run == single.rounds_run


@pytest.mark.gpu
@pytest.mark.parametrize("problem", ["ksvm", "krr"])
def test_captured_fleet_equals_its_eager_loop(cuda_device, monkeypatch,
                                              problem):
    """A four-member fleet replayed as CUDA graphs (the done mask a static
    device buffer) against the same fleet with the operator declared not
    capturable (the eager loop): alpha, histories and the converged mask
    bit for bit; one kmv and one gram launch a round for the whole fleet,
    one kmv a check, in either driver."""
    from repro_torch.core.kernels import ExactGramOperator
    from repro_torch.tune import solve_fleet
    A, y, opts, grid = _fleet_data(problem)

    def run():
        before = (kmv_cuda.launches, gram_cuda.launches)
        fr = solve_fleet(A, y, kernel="rbf", options=opts,
                         device=cuda_device, **grid)
        torch.cuda.synchronize()
        got = (kmv_cuda.launches - before[0], gram_cuda.launches - before[1])
        assert got == (fr.rounds_run + fr.history.shape[0], fr.rounds_run)
        return fr

    cap = run()
    with monkeypatch.context() as mp:
        mp.setattr(ExactGramOperator, "capturable", False)
        eag = run()
    assert torch.equal(cap.alpha, eag.alpha)
    np.testing.assert_array_equal(cap.history, eag.history)
    np.testing.assert_array_equal(cap.converged, eag.converged)
    assert cap.converged.any()


@pytest.mark.gpu
def test_probe_measured_time_excludes_capture(cuda_device):
    """On the card a probe's measured_s is the device time of its replayed
    rounds: below the probe fit's wall by at least the capture and the
    warm-up it records."""
    A, y, _, _ = _fleet_data("krr", m=2000, n=256)
    opts = SolverOptions(method="sstep", s="auto", b="auto", probe=2,
                         max_iters=2048, seed=4)
    res = KernelRidge(lam=1.0, kernel="rbf", options=opts,
                      device=cuda_device).fit(A, y)
    assert res.plan.probed and res.plan.budget.dma_bps > 0
    for p in res.plan.probed:
        assert p["capture_s"] > 0 and p["warmup_s"] > 0
        assert p["measured_s"] < p["wall_s"] - p["capture_s"]
    best = min(res.plan.probed, key=lambda p: p["measured_s"])
    assert (res.options.s, res.options.b) == (best["s"], best["b"])


# ---- guarded solves: apply_at, the f64 route, captured guarded rounds ----

# f64 kernels against their f64 plain versions: both sum the same f64
# products in other orders, (n + m) u ~ 1e-12 relative at these sizes
# before the epilogue; 1e-9 is three orders above that and five below
# the f32 bound, which an f32 accumulation cannot meet
TOL_F64 = 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("sb", [32, 256, 7])
def test_swapped_apply_at_matches_plain(cuda_device, kernel, sb):
    """The guarded rounds' apply_at, K(A[idx], A)^T w (the KMV kernel
    with its operands swapped: a short contraction into all of A's rows)
    against kmv_plain, repeating bit for bit, through the operator."""
    A, _, _ = _data(1500, 1, 96, 1, seed=31)
    cfg = KernelConfig(**kernel)
    A_d = torch.from_numpy(A).to(cuda_device)
    idx = torch.randint(0, 1500, (sb,), device=cuda_device)
    w = torch.randn(sb, device=cuda_device)
    from repro_torch.core import ExactGramOperator
    op = ExactGramOperator(A_d, cfg)
    before = kmv_cuda.launches
    got = op.apply_at(idx, w)
    assert kmv_cuda.launches == before + 1
    _close(got, kmv_plain(A_d[idx], A_d, w, cfg), kernel, 2e-4)
    assert torch.equal(got, op.apply_at(idx, w))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("shape", [(700, 32, 96, 1), (600, 600, 64, 1),
                                   (32, 900, 128, 1), (257, 70, 203, 3)])
def test_kmv_cuda_f64_route_matches_plain_f64(cuda_device, kernel, shape):
    """f64 operands take the f64 route and sum in f64: against kmv_plain
    in f64 at TOL_F64 (B = A the full matvec), repeating bit for bit."""
    m, r, n, c = shape
    A, B, X = _data(m, r, n, c, seed=32)
    cfg = KernelConfig(**kernel)
    A_d = torch.from_numpy(A).to(cuda_device, torch.float64)
    B_d = A_d if m == r else torch.from_numpy(B).to(cuda_device,
                                                    torch.float64)
    X_d = torch.from_numpy(X).to(cuda_device, torch.float64)
    got = kmv_cuda(A_d, B_d, X_d, cfg)
    assert got.dtype == torch.float64
    _close(got, kmv_plain(A_d, B_d, X_d, cfg), kernel, TOL_F64)
    assert torch.equal(got, kmv_cuda(A_d, B_d, X_d, cfg))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("shape", [(1, 1, 64), (32, 32, 300),
                                   (256, 256, 96), (70, 33, 203)])
def test_gram_cuda_f64_route_matches_plain_f64(cuda_device, kernel, shape):
    m, r, n = shape
    A, B, _ = _data(m, r, n, 1, seed=33)
    cfg = KernelConfig(**kernel)
    A_d = torch.from_numpy(A).to(cuda_device, torch.float64)
    B_d = torch.from_numpy(B).to(cuda_device, torch.float64)
    got = gram_cuda(A_d, B_d, cfg)
    assert got.dtype == torch.float64
    _close(got, gram_plain(A_d, B_d, cfg), kernel, TOL_F64)
    with pytest.raises(ValueError, match="f64 route"):
        gram_cuda(A_d, B_d, cfg, out_dtype=torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64],
                         ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("sb", [8, 32, 96, 256])
def test_kmv_stream_apply_matches_plain(cuda_device, kernel, dtype, sb):
    """The streamed apply_at (each chunk's rows of K(A, B) W while it sits
    in a slot of the two-slot pipe) against its plain chunk loop, a
    ragged tail chunk included (at sb = 96 in f64 and 256 in f32 a plan
    of several m splits, whose slices the tail chunk's reduce must read
    at the tail's width); the f64 route at TOL_F64."""
    m, cr, n, c = 1000, 256, 96, 2
    A, B, _ = _data(m, sb, n, 1, seed=34)
    cfg = KernelConfig(**kernel)
    Xc = _chunk(torch.from_numpy(A).to(dtype), cr, pin=True)
    B_d = torch.from_numpy(B).to(cuda_device, dtype)
    W = torch.randn(sb, c, device=cuda_device,
                    dtype=torch.float64 if dtype == torch.float64
                    else torch.float32)
    before = kmv_stream_module.kmv_stream_apply_cuda.launches
    got = ops.kmv_stream_apply(Xc, B_d, W, cfg, m=m)
    assert kmv_stream_module.kmv_stream_apply_cuda.launches == before + 1
    assert got.shape == (m, c)
    want = kmv_stream_module.kmv_stream_apply_plain(Xc, B_d, W, cfg, m=m)
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2,
           torch.float64: TOL_F64}[dtype]
    _close(got, want, kernel, tol)
    assert torch.equal(got, ops.kmv_stream_apply(Xc, B_d, W, cfg, m=m))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_kmv_stream_f64_route_matches_plain_f64(cuda_device, kernel):
    """The streamed KMV, its full matvec (as the chunk pieces) and the
    row gather in f64 against their plain versions."""
    m, cr, n = 700, 128, 96
    A, B, X = _data(m, 32, n, 2, seed=35)
    cfg = KernelConfig(**kernel)
    Xc = _chunk(torch.from_numpy(A).double(), cr, pin=True)
    Xvc = _chunk(torch.from_numpy(X).double(), cr).to(cuda_device)
    B_d = torch.from_numpy(B).to(cuda_device, torch.float64)
    got = kmv_stream_cuda(Xc, B_d, Xvc, cfg, m=m)
    assert got.dtype == torch.float64
    _close(got, kmv_stream_plain(Xc, B_d, Xvc, cfg, m=m), kernel, TOL_F64)
    full = kmv_stream_full_cuda(Xc, Xvc, cfg, m=m)
    assert full.dtype == torch.float64
    _close(full, kmv_stream_full_plain(Xc, Xvc, cfg, m=m), kernel, TOL_F64)
    idx = torch.randint(0, m, (40,), device=cuda_device)
    assert torch.equal(gather_rows_cuda(Xc, idx), gather_rows_plain(Xc, idx))


def _guarded_card_rounds(dev, fault_round=-1, seed=9):
    """(round fn, xs, guard, metric, m): a guarded s-step K-RR round on
    the card through the KMV and gram kernels, with a NaN fault lane."""
    from repro_torch.core import ExactGramOperator
    from repro_torch.resilience import finite_health, make_correct_fn
    rng = np.random.default_rng(seed)
    m, n, s, b = 300, 40, 4, 8
    A = torch.tensor(rng.standard_normal((m, n)) / np.sqrt(n),
                     dtype=torch.float32, device=dev)
    y = torch.sin(A @ torch.ones(n, device=dev))
    op = ExactGramOperator(A, KernelConfig("rbf", sigma=0.7))
    cfg = KRRConfig(lam=0.5, kernel=op.cfg)
    base = make_sstep_bdcd_round_fn(A, y, cfg, s, op=op, guard=True)
    gen = torch.Generator().manual_seed(seed)
    blocks = torch.stack([torch.randperm(m, generator=gen)[:b]
                          for _ in range(s * 21)]).to(dev)
    idx, valid = pad_rounds(blocks, s)
    hits = torch.arange(idx.shape[0], device=dev) == fault_round
    nan = torch.tensor(float("nan"), device=dev)
    zero = torch.zeros((), device=dev)

    def rf(carry, xz):
        a, f = base(carry, xz[:-1])
        return a, f + torch.where(xz[-1], nan, zero)

    guard = loop.GuardSpec(finite_health, make_correct_fn(op), 3)
    metric = lambda c: krr_rel_residual(A, y, c[0], cfg)  # noqa: E731
    return rf, (idx, valid, hits), guard, metric, m


@pytest.mark.gpu
@pytest.mark.parametrize("fault_round", [-1, 7])
def test_captured_guarded_rounds_equal_the_eager_loop(cuda_device,
                                                      fault_round):
    """The guarded rounds replayed as CUDA graphs (runs ending at every
    check and correction, the freeze a device flag) equal the eager
    guarded loop bit for bit: the carry, the histories, the corrections
    and the first bad round; a clean run's kmv and gram counts are the
    eager loop's."""
    rf, xs, guard, metric, m = _guarded_card_rounds(cuda_device,
                                                    fault_round)
    state0 = (torch.zeros(m, device=cuda_device),
              torch.zeros(m, device=cuda_device))
    kw = dict(tol=NO_TOL, check_every=5, metric_fn=metric)
    before = (kmv_cuda.launches, gram_cuda.launches)
    got = loop.run_rounds(rf, state0, xs, guard=guard, **kw)
    mid = (kmv_cuda.launches, gram_cuda.launches)
    want = loop._run_rounds_guarded_eager(rf, state0, xs, guard, **kw)
    after = (kmv_cuda.launches, gram_cuda.launches)
    torch.cuda.synchronize()
    for a, b in zip(got.state, want.state):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)
    assert torch.equal(got.metric_history(), want.metric_history())
    assert torch.equal(got.drift_history(), want.drift_history())
    assert (got.rounds_run, got.checks_run, got.corrections,
            got.diverged_round, got.diverged_kind) == \
        (want.rounds_run, want.checks_run, want.corrections,
         want.diverged_round, want.diverged_kind)
    assert got.diverged_round == fault_round
    if fault_round < 0:
        assert (mid[0] - before[0], mid[1] - before[1]) == \
            (after[0] - mid[0], after[1] - mid[1])


@pytest.mark.gpu
@pytest.mark.parametrize("approx", [None, "nystrom"])
@pytest.mark.parametrize("problem", ["ksvm", "krr"])
def test_guarded_fit_on_card_matches_fit_on_host(cuda_device, monkeypatch,
                                                 problem, approx):
    """A guarded facade fit with corrections, checks and a fault that walks
    one rung, on the card against the same fit on the host: the same
    events and corrections, alpha at 1e-5 (exact) or at the Nystrom
    card-versus-host bound 1e-4 (the factor goes through the gram kernel
    on the card and its plain version on the host, and K_LL^{-1/2}
    amplifies their difference, as in
    test_nystrom_fit_on_card_matches_fit_on_host); and on the card the
    captured guarded fit equals the same fit through the eager guarded
    loop bit for bit."""
    from repro_torch.core.kernels import (ExactGramOperator,
                                          LowRankGramOperator)
    from repro_torch.resilience import FaultPlan, inject
    rng = np.random.default_rng(12)
    m, n = 400, 32
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    y = (np.sign(A @ rng.standard_normal(n)) if problem == "ksvm"
         else np.sin(A @ rng.standard_normal(n))).astype(np.float32)
    kw = dict(method="sstep", s=8, max_iters=512, seed=2, guard=True,
              recompute_every=5, record=True, check_every=4, approx=approx,
              landmarks=64)
    if problem == "krr":
        kw["b"] = 4

    def fit(dev):
        est = (KernelSVM(C=1.0, kernel="rbf", device=dev,
                         options=SolverOptions(**kw)) if problem == "ksvm"
               else KernelRidge(lam=0.5, kernel="rbf", device=dev,
                                options=SolverOptions(**kw)))
        with inject(FaultPlan(nan_at_iter=200, target="f")):
            return est.fit(A, y)

    host, card = fit("cpu"), fit(cuda_device)
    tol = 1e-5 if approx is None else 1e-4
    np.testing.assert_allclose(card.alpha.cpu().numpy(), host.alpha.numpy(),
                               rtol=tol, atol=tol)
    assert card.health.events == host.health.events
    assert [e.action for e in card.health.fallbacks] == ["halve_s:8->4"]
    assert card.health.corrections == host.health.corrections > 0
    assert card.health.max_drift < 1e-4
    op_cls = ExactGramOperator if approx is None else LowRankGramOperator
    monkeypatch.setattr(op_cls, "capturable", False)
    eager = fit(cuda_device)
    assert torch.equal(eager.alpha, card.alpha)
    np.testing.assert_array_equal(eager.history, card.history)


# ---------------------------------------------------------------------------
# serving and telemetry (repro_torch.serve, repro_torch.obs)
# ---------------------------------------------------------------------------

SERVE_BUCKETS = [8, 16, 32, 64, 128, 256, 512, 1024]


@pytest.mark.gpu
@pytest.mark.parametrize("F", [9, 17])
@pytest.mark.parametrize("qb", SERVE_BUCKETS)
def test_kmv_at_every_serving_bucket(cuda_device, qb, F):
    """A registry group's served block: KMV with the bucket's queries as
    the sampled rows and the group's F stacked weight columns, against
    its plain version at the KMV bound, repeating bit for bit, and the
    block served through ``BatchedPredictor`` one launch of the same
    bits."""
    from repro_torch.core.kernels import ExactGramOperator
    A, B, X = _data(3000, qb, 256, F, seed=qb + F)
    A, B, X = (torch.tensor(t, device=cuda_device) for t in (A, B, X))
    rbf = KernelConfig("rbf", sigma=1.0)
    got = kmv_cuda(A, B, X, rbf)
    _close(got, kmv_plain(A, B, X, rbf), {"name": "rbf"}, 2e-4)
    assert torch.equal(got, kmv_cuda(A, B, X, rbf))
    pred = BatchedPredictor(ExactGramOperator(A, rbf), X, batch=1024)
    before = kmv_cuda.launches
    served = pred(B)
    assert kmv_cuda.launches - before == 1
    assert torch.equal(served, got)


def _served_fits(dev, m=600, n=48):
    rng = np.random.default_rng(21)
    A = (rng.standard_normal((m + 256, n)) / np.sqrt(n)).astype(np.float32)
    w = rng.standard_normal(n)
    yc = np.sign(A @ w).astype(np.float32)
    yr = np.sin(A @ w).astype(np.float32)
    kw = dict(method="sstep", s=8, max_iters=512, tol=1e-4, check_every=4,
              seed=1)
    svm = KernelSVM(C=1.0, kernel="rbf", device=dev,
                    options=SolverOptions(**kw))
    svm.fit(A[:m], yc[:m])
    krr = KernelRidge(lam=0.5, kernel="rbf", device=dev,
                      options=SolverOptions(b=4, **kw))
    krr.fit(A[:m], yr[:m])
    return svm, krr, A[m:]


@pytest.mark.gpu
def test_engine_window_on_card_equals_the_estimators(cuda_device):
    """Mixed traffic through the engine on the card: every ticket within
    the KMV bound of its estimator's own prediction on the card, one KMV
    launch a block for the group's two models, no new block shape after
    warm-up (the serve-cache observable flat)."""
    from repro_torch.core.predict import serve_cache_size
    from repro_torch.serve import DONE, ModelRegistry, ServingEngine
    svm, krr, Q = _served_fits(cuda_device)
    reg = ModelRegistry(predict_batch=64, device=cuda_device)
    reg.register("svm", svm)
    reg.register("krr", krr)
    eng = ServingEngine(reg, slots=32)
    # both fits hold the same A and kernel: one group of F = 2 models
    assert reg.n_groups == 1 and reg.group("svm").size == 2
    assert eng.warmup() == 4
    flat = serve_cache_size()
    rng = np.random.default_rng(3)
    tickets, before = [], kmv_cuda.launches
    for i in range(96):
        rows = 1 if rng.random() < 0.7 else int(rng.integers(2, 17))
        lo = int(rng.integers(0, 256 - rows))
        tickets.append(eng.submit(("svm", "krr")[i % 2], Q[lo:lo + rows]))
        if i % 8 == 7:
            eng.step()
    eng.run_until_idle()
    assert kmv_cuda.launches - before == eng.stats["blocks"]
    assert serve_cache_size() == flat
    for t in tickets:
        assert t.status == DONE and t.result.device.type == "cpu"
        est = svm if t.name == "svm" else krr
        want = (est.decision_function(t.X) if t.name == "svm"
                else est.predict(t.X))
        _close(t.result, want, {"name": "rbf"}, 2e-4)


@pytest.mark.gpu
def test_serve_cache_observable_is_flat_after_warmup(cuda_device):
    """Warm-up issues every bucket once; any later query count reaches no
    new block shape and builds no kernel."""
    from repro_torch.core.kernels import ExactGramOperator
    from repro_torch.core.predict import serve_cache_size
    A, _, X = _data(777, 1, 64, 5, seed=5)
    op = ExactGramOperator(torch.tensor(A, device=cuda_device),
                           KernelConfig("rbf"))
    pred = BatchedPredictor(op, torch.tensor(X, device=cuda_device),
                            batch=128)
    assert pred.warmup() == 5
    flat = serve_cache_size()
    rng = np.random.default_rng(0)
    for q in (1, 7, 8, 9, 100, 128, 129, 300):
        Xq = torch.tensor(rng.standard_normal((q, 64)).astype(np.float32),
                          device=cuda_device)
        assert tuple(pred(Xq).shape) == (q, 5)
    assert serve_cache_size() == flat


@pytest.mark.gpu
@pytest.mark.parametrize("guard", [False, True])
def test_instrumented_captured_fit_is_bit_equal(cuda_device, guard,
                                               tmp_path):
    """A captured fit with telemetry on: alpha, history and kmv / gram
    counts equal to the uninstrumented fit's; one metric_check interval a
    check (and one drift_correction a correction), device times inside the
    solve's host span, each check's interval positive; the instrumented
    estimator saves (its handle, holding CUDA events, is not copied)."""
    from repro_torch.obs import Telemetry
    rng = np.random.default_rng(4)
    m, n = 900, 64
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    y = np.sin(A @ rng.standard_normal(n)).astype(np.float32)
    kw = dict(method="sstep", s=8, b=8, tol=1e-9, check_every=4,
              max_iters=512, seed=2)
    if guard:
        kw.update(guard=True, recompute_every=3)
    out = []
    for tel in (None, Telemetry()):
        before = (kmv_cuda.launches, gram_cuda.launches)
        est = KernelRidge(lam=0.5, kernel="rbf", device=cuda_device,
                          options=SolverOptions(telemetry=tel, **kw))
        res = est.fit(A, y)
        out.append((res, (kmv_cuda.launches - before[0],
                          gram_cuda.launches - before[1])))
    (plain, n0), (marked, n1) = out
    assert torch.equal(plain.alpha, marked.alpha)
    np.testing.assert_array_equal(plain.history, marked.history)
    assert n0 == n1
    tel = marked.telemetry
    pairs = tel.paired_marks()
    checks = [s for s in pairs if s.name == "metric_check"]
    assert len(checks) == len(marked.history) > 0
    assert all(s.duration > 0 for s in checks)
    if guard:
        assert len([s for s in pairs if s.name == "drift_correction"]) == \
            marked.health.corrections > 0
    solve = [s for s in tel.spans if s.phase == "solve"]
    t0, t1 = min(s.t0 for s in solve), max(s.t1 for s in solve)
    assert all(t0 <= s.t0 <= s.t1 <= t1 for s in pairs)
    est.save(str(tmp_path / "model"))


# one rank of the two-process test below: gloo on CUDA tensors, the fits
# of the serial test at a small width, alpha written to DIR/rank{r}.pt
_DIST_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.api import KernelRidge, SolverOptions
from repro_torch.launch.mesh import make_mesh

world, rank, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", store=dist.FileStore(d + "/store", world),
                        rank=rank, world_size=world)
data = np.load(d + "/data.npz")
out = {}
for layout, shape in (("1d", (1, world)), ("2d", (world, 1))):
    opts = SolverOptions(method="sstep", s=4, b=8, tol=1e-6, check_every=4,
                         max_iters=256, layout=layout,
                         mesh=make_mesh(*shape))
    r = KernelRidge(lam=1.0, kernel="rbf", device="cuda", options=opts).fit(
        data["A"], data["y"], schedule=data["sched"])
    out[layout] = (r.alpha.cpu(), np.asarray(r.history))
torch.save(out, f"{d}/rank{rank}.pt")
dist.destroy_process_group()
"""


@pytest.mark.gpu
def test_distributed_layouts_on_card_match_serial(cuda_device, tmp_path):
    """Two processes share the card over gloo (CUDA tensors): the 1d and
    2d K-RR fits at a small width, each rank's alpha and residual history
    within 1e-5 of the serial fit on the card and bit for bit the other
    rank's."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    rng = np.random.default_rng(0)
    A = (rng.standard_normal((512, 256)) / 16.0).astype(np.float32)
    y = np.sin(A @ rng.standard_normal(256)).astype(np.float32)
    sched = rng.integers(0, 512, (256, 8))
    np.savez(tmp_path / "data.npz", A=A, y=y, sched=sched)
    (tmp_path / "rank.py").write_text(_DIST_RANK)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "rank.py"), "2", str(r),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    ser = KernelRidge(lam=1.0, kernel="rbf", device=cuda_device,
                      options=SolverOptions(method="sstep", s=4, b=8,
                                            tol=1e-6, check_every=4,
                                            max_iters=256)).fit(
        A, y, schedule=sched)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for layout in ("1d", "2d"):
        alpha, hist = ranks[0][layout]
        assert torch.equal(alpha, ranks[1][layout][0])
        np.testing.assert_allclose(alpha.numpy(), ser.alpha.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(hist, ser.history, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["defer s=2", "defer s=2 int8",
                                   "sharded"])
def test_cross_device_steps_on_one_nccl_rank_match_plain(cuda_device,
                                                         tmp_path, which):
    """The deferred and the FSDP + TP steps on a (1, 1) mesh over NCCL at
    world 1 (every collective an NCCL call of one rank): reduced Qwen3 in
    f32 through the kernels, 2 steps of 4 microbatches, against the plain
    single-device step on the same params and batches.  The loss at 1e-5
    and the first moment after step 1 per leaf within 1e-5 relative
    (Frobenius): without int8 the steps differ in summation order only.
    int8 moves each entry by at most half a step of its 256-entry block
    (max / 254, error feedback telescoping the rounds to the last one);
    over a leaf that is at most sqrt(256) / 254 of its Frobenius norm (the
    norm holds every block's largest entry), the bound with int8.  The
    collectives of each step equal ``step_collectives``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import COLLECTIVES, make_mesh
    from repro_torch.models.sharding import MeshRules
    from repro_torch.train.train_step import (defer_rules,
                                              make_defer_train_step,
                                              step_collectives)
    from repro_torch.train import init_train_state
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config("qwen3_1p7b", reduced=True),
                              dtype="float32", attn_impl="flash")
    acfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=64,
                         global_batch=8, seed=1)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        rules = MeshRules(make_mesh(1, 1))
        defer = which.startswith("defer")
        tcfg = TrainConfig(microbatches=4, defer_s=2 if defer else 1,
                           compress_int8="int8" in which)
        runs = []
        for r in (None, defer_rules(rules) if defer else rules):
            gen = torch.Generator(device=cuda_device).manual_seed(3)
            p, o = init_train_state(gen, cfg, acfg, device=cuda_device,
                                    rules=r)
            step = (make_train_step(cfg, acfg, TrainConfig(microbatches=4))
                    if r is None else
                    make_defer_train_step(cfg, acfg, tcfg, rules) if defer
                    else make_train_step(cfg, acfg, tcfg, rules))
            out = {"loss": [], "calls": []}
            for k in range(2):
                COLLECTIVES.reset()
                p, o, m = step(p, o, pipe.batch(k))
                out["calls"].append(dict(COLLECTIVES.calls))
                out["loss"].append(float(m["loss"]))
                if k == 0:
                    out["m1"] = [t.clone() for t in leaves(o["m"])]
            runs.append(out)
        plain, got = runs
        np.testing.assert_allclose(got["loss"], plain["loss"], rtol=1e-5)
        tol = 1e-5 + (16 / 254 if tcfg.compress_int8 else 0.0)
        for a, b in zip(got["m1"], plain["m1"]):
            assert float((a - b).norm() / b.norm().clamp_min(1e-30)) <= tol
        want = step_collectives(cfg, tcfg, rules, defer)
        assert got["calls"] == [want, want]
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_lm_kernels_at_tensor_parallel_head_counts(cuda_device):
    """What a rank of a (data, 2) mesh launches: the tensor-core flash
    forward and backward over its 8 of Qwen3's 16 heads, taken as strided
    views of the full heads (the autograd Function copies them to TMA-
    ready operands), equal to the same heads made contiguous, bit for bit,
    and within their derived bounds of the plain versions; the q-norm
    rmsnorm over those heads' rows within bf16's 2e-2 of its plain
    version."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    B, S, H, hd = 2, 256, 16, 128
    q, k, v, do = (torch.randn((B, S, H, hd), generator=gen,
                               device=cuda_device).to(bf16)
                   for _ in range(4))
    local = slice(H // 2, H)

    def run(q_, k_, v_):
        leaves_ = [t.detach().requires_grad_() for t in (q_, k_, v_)]
        out = ops.sdpa_flash(*leaves_, causal=True)
        out.backward(do[:, :, local])
        return [out.detach()] + [t.grad for t in leaves_]

    views = run(q[:, :, local], k[:, :, local], v[:, :, local])
    dense = run(*(t[:, :, local].contiguous() for t in (q, k, v)))
    for a, b in zip(views, dense):
        assert torch.equal(a, b)
    # the kernels at the rank's (B * H / 2, S, hd) against the plain ones
    q3, k3, v3, do3 = (t[:, :, local].permute(0, 2, 1, 3).reshape(
        B * H // 2, S, hd).contiguous() for t in (q, k, v, do))
    o, lse = flash_fwd_cuda(q3, k3, v3, causal=True)
    o_p, _ = flash_fwd_plain(q3, k3, v3, causal=True)
    tol = flash_fwd_bf16_tolerance(q3, k3, v3, o_p, True)
    assert bool(((o.float() - o_p.float()).abs() <= tol).all())
    delta = flash_delta(o, do3)
    got = flash_bwd_cuda(q3, k3, v3, do3, lse, delta, causal=True)
    want = flash_bwd_plain(q3, k3, v3, do3, lse, delta, causal=True)
    args = (q3, k3, v3, do3, lse, delta)
    t_dq = flash_dq_bf16_tolerance(*args, want[0], True)
    t_dk, t_dv = flash_dkv_bf16_tolerance(*args, want[1], want[2], True)
    for g, w, t in zip(got, want, (t_dq, t_dk, t_dv)):
        assert bool(((g.float() - w.float()).abs() <= t).all())
    rows = q[:, :, local].reshape(-1, hd).contiguous()
    scale = torch.randn((hd,), generator=gen, device=cuda_device)
    y, y_p = rmsnorm_cuda(rows, scale), rmsnorm_plain(rows, scale)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_p.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
def test_registry_reaches_every_site_on_the_card(cuda_device):
    """``analysis.registry`` launching every entry point for real reaches
    the 16 C entry points of csrc/; each launch noted its grid, block and
    dynamic shared memory (``csrc/launch_log.cuh``), and the sanitizer is
    clean on them, CHK-SMEM against the device's own opt-in limit."""
    from repro_torch.analysis import kernel_check, registry
    calls = registry.capture_entry_points(launch=True)
    sites = {(s.path, s.line) for s in registry.discover_sites()}
    assert len(sites) == 16 and {c.site for c in calls} == sites
    limit = torch.cuda.get_device_properties(
        cuda_device).shared_memory_per_block_optin
    assert kernel_check.smem_limit() == limit
    assert all(c.launches for c in calls)
    assert any(rec["smem"] > 48 * 1024 for c in calls
               for rec in c.launches)
    assert all(rec["smem"] <= limit and rec["grid"][0] >= 1
               for c in calls for rec in c.launches)
    assert kernel_check.run(calls) == []
