"""The port's batched slab-free prediction against the JAX package's
``BatchedPredictor`` (support-vector compaction, power-of-two buckets,
stacked weights), on the same numpy inputs; KMV bound 2e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernels import ExactGramOperator as JOp
from repro.core.kernels import KernelConfig as JKernelConfig
from repro.core.predict import BatchedPredictor as JPredictor
from repro.core.predict import compact_support as j_compact_support
from repro_torch.core import (BatchedPredictor, ExactGramOperator,
                              KernelConfig, batched_predict,
                              compact_support, validate_queries)

KERNELS = [dict(name="linear"),
           dict(name="polynomial", degree=3, coef0=1.0),
           dict(name="rbf", sigma=1.0)]
IDS = [k["name"] for k in KERNELS]


def _data(m=60, n=10, q=37, seed=0):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    w = (rng.standard_normal(m) * (rng.random(m) < 0.4)).astype(np.float32)
    Q = (rng.standard_normal((q, n)) / np.sqrt(n)).astype(np.float32)
    return A, w, Q


def _close(got, want, kernel):
    want = np.asarray(want)
    atol = 2e-4 * max(1.0, float(np.abs(want).max(initial=0.0))) \
        if kernel["name"] == "polynomial" else 2e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=atol)


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
def test_predictor_with_compaction_matches_jax(kernel):
    A, w, Q = _data()
    jop = JOp(jnp.asarray(A), JKernelConfig(**kernel))
    op = ExactGramOperator(torch.from_numpy(A), KernelConfig(**kernel))
    jp = JPredictor(jop, jnp.asarray(w), batch=16, scale=0.5, compact=True)
    p = BatchedPredictor(op, torch.from_numpy(w), batch=16, scale=0.5,
                         compact=True)
    assert p.op.n_samples == jp.op.n_samples == int((w != 0).sum())
    for q in (37, 5, 16, 0):
        got, want = p(torch.from_numpy(Q[:q])), jp(jnp.asarray(Q[:q]))
        assert tuple(got.shape) == tuple(want.shape) == (q,)
        _close(got, want, kernel)
    # compaction serves the same function as the full representation
    _close(batched_predict(op, torch.from_numpy(w), torch.from_numpy(Q),
                           batch=16, scale=0.5), jp(jnp.asarray(Q)), kernel)


def test_stacked_weights_and_block_shapes_match_jax():
    A, w, Q = _data(seed=1)
    W = np.stack([w, np.roll(w, 3)], axis=1)
    cfg = dict(name="rbf", sigma=1.0)
    jp = JPredictor(JOp(jnp.asarray(A), JKernelConfig(**cfg)),
                    jnp.asarray(W), batch=32, compact=True)
    p = BatchedPredictor(ExactGramOperator(torch.from_numpy(A),
                                           KernelConfig(**cfg)),
                         torch.from_numpy(W), batch=32, compact=True)
    got, want = p(torch.from_numpy(Q)), jp(jnp.asarray(Q))
    assert tuple(got.shape) == (Q.shape[0], 2)
    _close(got, want, cfg)
    assert [p.block_shape(q) for q in range(1, 70)] == \
        [jp.block_shape(q) for q in range(1, 70)]


def test_compact_support_matches_jax_including_all_zero_model():
    A, w, _ = _data(seed=2)
    cfg = dict(name="linear")
    jop = JOp(jnp.asarray(A), JKernelConfig(**cfg))
    op = ExactGramOperator(torch.from_numpy(A), KernelConfig(**cfg))
    jc, jw = j_compact_support(jop, jnp.asarray(w), tol=0.1)
    c, cw = compact_support(op, torch.from_numpy(w), tol=0.1)
    np.testing.assert_array_equal(c.A.numpy(), np.asarray(jc.A))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jw))
    z = np.zeros_like(w)
    jc, jw = j_compact_support(jop, jnp.asarray(z))
    c, cw = compact_support(op, torch.from_numpy(z))
    assert c.n_samples == jc.n_samples == 1
    assert float(cw.abs().sum()) == 0.0


def test_validate_queries_names_the_argument():
    A, _, Q = _data(seed=3)
    op = ExactGramOperator(torch.from_numpy(A), KernelConfig("rbf"))
    assert validate_queries(op, Q).dtype == torch.float32   # numpy in
    with pytest.raises(ValueError, match="A_test must be 2-D"):
        validate_queries(op, Q[0])
    with pytest.raises(ValueError, match="features"):
        validate_queries(op, Q[:, :4])
    with pytest.raises(ValueError, match="dtype"):
        validate_queries(op, Q.astype(np.float64))
    with pytest.raises(ValueError, match="batch"):
        BatchedPredictor(op, torch.zeros(A.shape[0]), batch=0)
