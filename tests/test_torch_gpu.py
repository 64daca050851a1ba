"""The port on the card: each CUDA kernel against its plain PyTorch
version on the same inputs, and a facade fit through the kernels against
the same fit through the plain versions on the host.

Every test here carries the ``gpu`` marker and skips itself (inside the
fixture) when no CUDA device is present.  The file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: KMV and the streamed KMV 2e-4 (tests/test_kmv.py), gram
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
from repro_torch.kernels.kmv import kmv_cuda, kmv_plain
from repro_torch.kernels.kmv_stream import (gather_rows_cuda,
                                            gather_rows_plain,
                                            kmv_stream_cuda,
                                            kmv_stream_plain,
                                            kmv_stream_resident)
from repro_torch.kernels.ref import (flash_attention_ref,
                                     flash_dkv_bf16_tolerance,
                                     flash_dq_bf16_tolerance,
                                     flash_fwd_bf16_tolerance, rmsnorm_ref)
from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm_cuda, rmsnorm_plain
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params)
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


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(33, 17, 100, 2), (700, 70, 384, 1),
                                   (130, 1, 64, 4), (2000, 300, 96, 3)])
def test_kmv_cuda_matches_plain(cuda_device, kernel, dtype, shape):
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
                                   (5, 100)])
def test_rmsnorm_cuda_matches_plain(cuda_device, dtype, shape):
    """Ragged row counts, D not a multiple of the 16-byte vector (100),
    and the model's widths (128 qk-norm rows, 2048)."""
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
