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
2e-5 f32 (tests/test_flash_attention.py), and for bf16 inputs 1e-2 /
1e-3 on o (one bf16 ulp: kernel and plain version both compute in f32
and differ only in the final rounding) with lse at the f32 limits.
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
from repro_torch.kernels.flash_attention import (flash_fwd_cuda,
                                                 flash_fwd_plain)
from repro_torch.kernels.gram import gram_cuda, gram_plain
from repro_torch.kernels.kmv import kmv_cuda, kmv_plain
from repro_torch.kernels.kmv_stream import (gather_rows_cuda,
                                            gather_rows_plain,
                                            kmv_stream_cuda,
                                            kmv_stream_plain,
                                            kmv_stream_resident)
from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params)
from repro_torch.train import Request, ServingEngine

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


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 128, 128, 32, 32),
                                   (1, 256, 256, 64, 64),
                                   (3, 64, 64, 16, 8),
                                   (2, 17, 17, 128, 128),
                                   (2, 100, 40, 24, 128),
                                   (2, 512, 512, 128, 128)])
def test_flash_fwd_cuda_matches_plain(cuda_device, causal, dtype, shape):
    """The JAX test's shapes, ragged tiles (S = 17, 100; T = 40), hd != hdv
    both ways, and full 128-wide heads over several k tiles; o and lse."""
    q, k, v = _qkv(*shape, dtype, cuda_device, seed=13)
    before = flash_fwd_cuda.launches
    o, lse = flash_fwd_cuda(q, k, v, causal=causal)
    o_p, lse_p = flash_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == before + 1
    assert o.shape == o_p.shape and o.dtype == dtype
    assert lse.shape == lse_p.shape and lse.dtype == torch.float32
    # both sides widen the same inputs and compute in f32: bf16 o differs
    # by its final rounding (one ulp), lse is f32 on both
    rtol, atol = (1e-2, 1e-3) if dtype == torch.bfloat16 else (2e-4, 2e-5)
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
