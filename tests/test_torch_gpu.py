"""The port on the card: each CUDA kernel against its plain PyTorch
version on the same inputs, and a facade fit through the kernels against
the same fit through the plain versions on the host.

Every test here carries the ``gpu`` marker and skips itself (inside the
fixture) when no CUDA device is present.  The file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: KMV 2e-4 (tests/test_kmv.py), gram 1e-4
(tests/test_pallas_gram.py), bf16 inputs 2e-2; polynomial absolute
tolerance relative to the largest output value (ROADMAP C2).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
from repro_torch.core.kernels import KernelConfig
from repro_torch.kernels.gram import gram_cuda, gram_plain
from repro_torch.kernels.kmv import kmv_cuda, kmv_plain

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
