"""The port's KMV and gram kernels: plain PyTorch versions against the
JAX package's Pallas kernels (interpret mode) and oracles, on the same
numpy inputs.  The CUDA kernels against their plain versions on the card
are in tests/test_torch_gpu.py.

Tolerances are the reference's own: KMV 2e-4 (tests/test_kmv.py), gram
1e-4 (tests/test_pallas_gram.py), bf16 inputs 2e-2.  Polynomial values
grow as (c0 + a.b)^3, so their absolute tolerance is taken relative to
the largest output value (f32 summation-order differences, ROADMAP C2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernels import KernelConfig as JKernelConfig
from repro.kernels.gram import gram_pallas
from repro.kernels.kmv import kmv_pallas
from repro.kernels.ref import gram_ref as j_gram_ref
from repro.kernels.ref import kmv_ref as j_kmv_ref
from repro_torch.core.kernels import KernelConfig, integer_pow
from repro_torch.kernels import ops
from repro_torch.kernels.gram import (BK, BLOCKS_PER_SM, DOT_MAX, gram_cuda,
                                      gram_plain, gram_splits)
from repro_torch.kernels.kmv import (NARROW_MAX_R, ROWS_MAX_R, WS_MAX_FLOATS,
                                     kmv_cuda, kmv_f64_plan, kmv_plain,
                                     kmv_plan)
from repro_torch.kernels.ref import kmv_ref

KERNELS = [dict(name="linear"),
           dict(name="polynomial", degree=3, coef0=1.0),
           dict(name="rbf", sigma=0.7)]
IDS = [k["name"] for k in KERNELS]


def _data(m, r, n, c, seed=0):
    """Rows scaled to unit-ish norm, so rbf values are far from 0."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    B = (rng.standard_normal((r, n)) / np.sqrt(n)).astype(np.float32)
    X = rng.standard_normal((m, c)).astype(np.float32)
    return A, B, X


def _close(got, want, kernel, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = tol * max(1.0, float(np.abs(want).max())) \
        if kernel["name"] == "polynomial" else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("shape,vec", [((33, 17, 100, 2), False),
                                       ((96, 24, 64, 1), True)])
def test_kmv_plain_matches_pallas_and_oracle(kernel, shape, vec):
    m, r, n, c = shape
    A, B, X = _data(m, r, n, c)
    if vec:
        X = X[:, 0]
    jcfg, cfg = JKernelConfig(**kernel), KernelConfig(**kernel)
    got = kmv_plain(_t(A), _t(B), _t(X), cfg)
    assert tuple(got.shape) == ((r,) if vec else (r, c))
    pallas = kmv_pallas(jnp.asarray(A), jnp.asarray(B), jnp.asarray(X),
                        jcfg, bm=32, br=16, bk=128, interpret=True)
    _close(got, pallas, kernel, 2e-4)
    _close(got, j_kmv_ref(jnp.asarray(A), jnp.asarray(B), jnp.asarray(X),
                          jcfg), kernel, 2e-4)
    # the port's own materializing oracle agrees too
    _close(kmv_ref(_t(A), _t(B), _t(X), cfg), got, kernel, 2e-4)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("shape", [(8, 1, 16, 1), (130, 70, 384, 3)])
def test_kmv_plain_matches_oracle_shapes(kernel, shape):
    A, B, X = _data(*shape, seed=1)
    jcfg, cfg = JKernelConfig(**kernel), KernelConfig(**kernel)
    _close(kmv_plain(_t(A), _t(B), _t(X), cfg),
           j_kmv_ref(jnp.asarray(A), jnp.asarray(B), jnp.asarray(X), jcfg),
           kernel, 2e-4)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_kmv_plain_bf16_inputs(kernel):
    A, B, X = _data(64, 24, 256, 2, seed=2)
    jcfg, cfg = JKernelConfig(**kernel), KernelConfig(**kernel)
    got = kmv_plain(_t(A, torch.bfloat16), _t(B, torch.bfloat16), _t(X),
                    cfg)
    want = j_kmv_ref(jnp.asarray(A).astype(jnp.bfloat16),
                     jnp.asarray(B).astype(jnp.bfloat16), jnp.asarray(X),
                     jcfg)
    _close(got, want, kernel, 2e-2)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
@pytest.mark.parametrize("shape", [(33, 17, 100), (64, 32, 256)])
def test_gram_plain_matches_pallas_and_oracle(kernel, shape):
    A, B, _ = _data(*shape, 1, seed=3)
    jcfg, cfg = JKernelConfig(**kernel), KernelConfig(**kernel)
    got = gram_plain(_t(A), _t(B), cfg)
    assert tuple(got.shape) == shape[:2]
    pallas = gram_pallas(jnp.asarray(A), jnp.asarray(B), jcfg, bm=32,
                         br=32, bk=128, interpret=True)
    _close(got, pallas, kernel, 1e-4)
    _close(got, j_gram_ref(jnp.asarray(A), jnp.asarray(B), jcfg), kernel,
           1e-4)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_gram_plain_bf16(kernel):
    A, B, _ = _data(64, 48, 256, 1, seed=4)
    jcfg, cfg = JKernelConfig(**kernel), KernelConfig(**kernel)
    got = gram_plain(_t(A, torch.bfloat16), _t(B, torch.bfloat16), cfg,
                     out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = j_gram_ref(jnp.asarray(A).astype(jnp.bfloat16),
                      jnp.asarray(B).astype(jnp.bfloat16), jcfg,
                      out_dtype=jnp.bfloat16)
    _close(got.float(), np.asarray(want.astype(jnp.float32)), kernel, 2e-2)


def test_integer_pow_matches_jnp_products():
    x = np.linspace(-3.0, 3.0, 101, dtype=np.float32)
    for d in (0, 1, 2, 3, 5, 8):
        np.testing.assert_array_equal(
            integer_pow(torch.from_numpy(x), d).numpy(),
            np.asarray(jnp.asarray(x) ** d))


def test_cpu_dispatch_runs_plain_versions_and_counts_nothing():
    A, B, X = _data(20, 5, 12, 3, seed=5)
    cfg = KernelConfig("rbf", sigma=0.5)
    before = (kmv_cuda.launches, gram_cuda.launches)
    np.testing.assert_array_equal(ops.kmv(_t(A), _t(B), _t(X), cfg),
                                  kmv_plain(_t(A), _t(B), _t(X), cfg))
    np.testing.assert_array_equal(ops.gram(_t(A), _t(B), cfg),
                                  gram_plain(_t(A), _t(B), cfg))
    assert (kmv_cuda.launches, gram_cuda.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: a kernel wrapper given host tensors raises."""
    A, B, X = _data(8, 4, 8, 1)
    cfg = KernelConfig("linear")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmv_cuda(_t(A), _t(B), _t(X), cfg)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gram_cuda(_t(A), _t(B), cfg)


# the first seven are the cases of the earlier m split (64 x 64 tiles)
@pytest.mark.parametrize("m,r", [(1, 1), (64, 1), (65, 32), (19996, 32),
                                 (19996, 256), (19996, 19996),
                                 (1000, 1024), (19996, 1), (19996, 1024),
                                 (7, 8), (33, 9), (2000, 64), (130, 65),
                                 (2000, 300), (700, 128), (5, 129)])
@pytest.mark.parametrize("c", [1, 4])
def test_kmv_plan_covers_m_with_nonempty_splits(m, r, c):
    """The regime follows r (rows up to 8, a tile as wide as r up to 64,
    wide tiles beyond, unless the contraction over m is at most 64 rows:
    then the narrow tile too); the tile covers r; the splits cover m,
    none empty, a tile regime's in whole BM-row tiles; the grid and the
    workspace stay within their limits."""
    plan = kmv_plan(m, r, c, sm_count=132)
    want = ("rows" if r <= ROWS_MAX_R else
            "narrow" if r <= NARROW_MAX_R or m <= NARROW_MAX_R
            else "wide")
    assert plan.regime == want
    assert (plan.splits - 1) * plan.rows_per_split < m \
        <= plan.splits * plan.rows_per_split
    if plan.regime == "rows":
        assert plan.br == r and plan.bm in (1, 2, 4)
    else:
        assert plan.rows_per_split % plan.bm == 0
        assert plan.br in ((32, 64) if plan.regime == "narrow"
                           else (64, 128))
        # as wide as r up to 64, or 32 for a short contraction
        assert plan.br >= (32 if m <= NARROW_MAX_R < r else min(r, 64))
        assert plan.splits <= 65535
        assert plan.splits == 1 or plan.splits * r * c <= WS_MAX_FLOATS


@pytest.mark.parametrize("r", [1, 32, 256, 1024, 19996])
def test_kmv_plan_masks_no_column_on_the_main_path(r):
    """At the main path's widths (the classical round, the K-SVM and K-RR
    s-step rounds, a prediction block) no launched tile has a masked
    column; at the full matvec's r = m = 19 996 under 1% of the tile's
    columns are masked."""
    plan = kmv_plan(19996, r, 1, sm_count=132)
    cols = -(-r // plan.br) * plan.br
    if r == 19996:
        assert (cols - r) / r < 0.01
    else:
        assert cols == r


@pytest.mark.parametrize("m,sms,want", [(19996, 132, "symmetric"),
                                         (19996, 114, "symmetric"),
                                         (3000, 2, "symmetric"),
                                         (1000, 132, "wide"),
                                         (40, 132, "narrow")])
def test_kmv_plan_is_symmetric_only_for_b_that_is_a(m, sms, want):
    """The full matvec K(A, A)^T X takes the symmetric regime (square
    128-row tiles, one a split) where its wide plan has them; the same
    shapes with another B keep the plain plan."""
    plan = kmv_plan(m, m, 1, sm_count=sms, same=True)
    assert plan.regime == want
    other = kmv_plan(m, m, 1, sm_count=sms)
    assert other.regime != "symmetric"
    if want == "symmetric":
        assert plan._replace(regime="wide") == other
        assert plan.bm == plan.br and plan.rows_per_split == plan.bm


@pytest.mark.parametrize("r", [1, 32, 256])
@pytest.mark.parametrize("sms", [132, 114])
def test_kmv_plan_fills_the_card_at_the_round_shapes(r, sms):
    """The rounds' KMV (classical r = 1, K-SVM r = 32, K-RR r = 256, m =
    19 996) launches at least one block per SM."""
    plan = kmv_plan(19996, r, 1, sm_count=sms)
    blocks = plan.splits * (1 if plan.regime == "rows"
                            else -(-r // plan.br))
    assert blocks >= sms


@pytest.mark.parametrize("m,r,n", [(1, 1, 8192), (32, 32, 8192),
                                   (256, 256, 8192), (19996, 32, 8192),
                                   (19996, 1024, 8192), (1024, 1024, 8192),
                                   (3, 2, 100), (33, 17, 100), (700, 70, 31),
                                   (1, 300, 40)])
def test_gram_splits_cover_n_with_whole_nonempty_chunks(m, r, n):
    """Every split is a whole number of BK-feature chunks, none empty, and
    together they cover n; the tile is the dot kernel's only for m, r <=
    DOT_MAX and never wider than 32 on a side of at most 32."""
    bm, br, splits, per = gram_splits(m, r, n, sm_count=132)
    chunks = -(-n // BK)
    assert per >= 1 and (splits - 1) * per < chunks <= splits * per
    assert ((bm, br) == (DOT_MAX, DOT_MAX)) == (m <= DOT_MAX
                                                and r <= DOT_MAX)
    if (bm, br) != (DOT_MAX, DOT_MAX):
        assert bm == (32 if m <= 32 else 64)
        assert br == (32 if r <= 32 else 64)


@pytest.mark.parametrize("m,r", [(1, 1), (32, 32), (256, 256)])
@pytest.mark.parametrize("sms", [132, 114])
def test_gram_splits_fill_the_card_at_the_round_shapes(m, r, sms):
    """The round's cross blocks (classical 1 x 1, K-SVM 32 x 32, K-RR 256 x
    256, n = 8192) launch at least one block per SM, and at most about
    BLOCKS_PER_SM; the large outputs (the Nystrom map's 19 996 x 1024,
    K-RR's slab) take one split."""
    bm, br, splits, _ = gram_splits(m, r, 8192, sm_count=sms)
    blocks = -(-m // bm) * -(-r // br) * splits
    assert sms <= blocks <= (BLOCKS_PER_SM + 1) * sms
    for big in ((19996, 1024), (19996, 256)):
        assert gram_splits(*big, 8192, sm_count=sms)[2] == 1


@pytest.mark.parametrize("m,r", [(1, 1), (32, 19996), (256, 19996),
                                 (19996, 19996), (19996, 32), (33, 5),
                                 (2048, 2048), (100000, 1)])
def test_kmv_f64_plan_covers_m_in_whole_tiles(m, r):
    """The f64 route's plan: 32 x 32 tiles, the m splits whole tiles
    covering m, none empty, within the grid's y limit."""
    plan = kmv_f64_plan(m, r, sm_count=132)
    assert (plan.regime, plan.bm, plan.br) == ("f64", 32, 32)
    assert plan.rows_per_split % 32 == 0
    assert (plan.splits - 1) * plan.rows_per_split < m \
        <= plan.splits * plan.rows_per_split
    assert 1 <= plan.splits <= 65535
