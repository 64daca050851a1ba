"""The port's performance model (``repro_torch.core.perf_model``) against
the JAX package's (``repro.core.perf_model``): every ported function over a
grid of (m, n, kernel, b, s, P, approx) to 1e-12 relative, with the
budgets and link rates the JAX module defaulted to passed explicitly to
both, and the device budget that takes their place.
"""
import itertools
import math

import numpy as np
import pytest

from repro.core import perf_model as J
from repro_torch.core import perf_model as T

RTOL = 1e-12
GIB = 2 ** 30
GRID = list(itertools.product(
    (512, 19_996), (64, 8192), ("linear", "polynomial", "rbf"), (1, 32),
    (1, 8, 32), (1, 4), (None, "nystrom")))
IDS = ["m{}-n{}-{}-b{}-s{}-P{}-{}".format(*g) for g in GRID]


def _same(got, want):
    """Equal to RTOL relative, recursively through dicts and sequences;
    exact for ints, bools, strings and None."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, float):
        if math.isinf(want):
            assert got == want
        else:
            assert got == pytest.approx(want, rel=RTOL, abs=0.0)
    else:
        assert got == want


@pytest.mark.parametrize("m,n,kernel,b,s,P,approx", GRID, ids=IDS)
def test_fit_costs_match_jax(m, n, kernel, b, s, P, approx):
    mach = J.Machine()
    tm = T.Machine()
    assert (tm.gamma, tm.beta, tm.phi, tm.mu) == (mach.gamma, mach.beta,
                                                  mach.phi, mach.mu)
    prob = dict(m=m, n=n, b=b, H=1000, kernel=kernel)
    _same(T.bdcd_cost(T.Problem(**prob), tm, P),
          J.bdcd_cost(J.Problem(**prob), mach, P))
    _same(T.sstep_bdcd_cost(T.Problem(**prob), tm, P, s),
          J.sstep_bdcd_cost(J.Problem(**prob), mach, P, s))
    _same(T.storage_words(T.Problem(**prob), P, s),
          J.storage_words(J.Problem(**prob), P, s))
    kw = dict(b=b, s=s, iters=777, P=P, approx=approx, landmarks=48)
    _same(T.modeled_fit_cost(m, n, kernel, **kw),
          J.modeled_fit_cost(m, n, kernel, **kw))
    _same(T.fleet_fit_cost(m, n, kernel, 6, **kw),
          J.fleet_fit_cost(m, n, kernel, 6, **kw))
    _same(T.lowrank_setup_cost(m, n, 48, kernel, P=P),
          J.lowrank_setup_cost(m, n, 48, kernel, P=P))
    _same(T.modeled_predict_cost(m, n, 300, kernel, approx=approx,
                                 landmarks=48, sv_fraction=0.4),
          J.modeled_predict_cost(m, n, 300, kernel, approx=approx,
                                 landmarks=48, sv_fraction=0.4))
    _same(T.modeled_predict_cost(m, n, 300, kernel, stream=64,
                                 dma_bps=48e9),
          J.modeled_predict_cost(m, n, 300, kernel, stream=64,
                                 dma_bps=48e9))
    gkw = dict(b=b, s=s, P=P)
    _same(T.guard_round_flops(m, n, kernel, **gkw),
          J.guard_round_flops(m, n, kernel, **gkw))
    _same(T.recompute_flops(m, n, kernel, P=P, approx=approx,
                            landmarks=48),
          J.recompute_flops(m, n, kernel, P=P, approx=approx, landmarks=48))
    ckw = dict(b=b, s=s, P=P, approx=approx, landmarks=48)
    _same(T.choose_recompute_every(m, n, kernel, **ckw),
          J.choose_recompute_every(m, n, kernel, **ckw))
    _same(T.guard_overhead(m, n, kernel, recompute_every=5, **ckw),
          J.guard_overhead(m, n, kernel, recompute_every=5, **ckw))
    for c in (1, 4):
        _same(T.slab_round_hbm_bytes(m, n, s * b, c=c),
              J.slab_round_hbm_bytes(m, n, s * b, c=c))
        _same(T.kmv_round_hbm_bytes(m, n, s * b, c=c),
              J.kmv_round_hbm_bytes(m, n, s * b, c=c))


@pytest.mark.parametrize("hbm", [64 * 2 ** 20, 16 * GIB])
@pytest.mark.parametrize("b", [1, 8])
def test_best_s_and_slab_fit_match_jax_at_explicit_budgets(hbm, b):
    for m in (4096, 1 << 20):
        jp, tp = J.Problem(m=m, n=64, b=b, H=1024), T.Problem(m=m, n=64,
                                                               b=b, H=1024)
        for P in (1, 64):
            _same(T.best_s(tp, T.Machine(), P, hbm_bytes=hbm,
                           return_frontier=True),
                  J.best_s(jp, J.Machine(), P, hbm_bytes=hbm,
                           return_frontier=True))
        for sb in (1, 64, 4096):
            assert T.slab_fits_hbm(m, sb, hbm) == J.slab_fits_hbm(m, sb, hbm)
            assert (T.streaming_required(m, 8192, sb, device_bytes=hbm)
                    == J.streaming_required(m, 8192, sb, device_bytes=hbm))


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("budget,dma", [(16 * 2 ** 20, 800e9),
                                        (2 * GIB, 48e9), (64 * GIB, 55e9)])
@pytest.mark.parametrize("m,n,sb", [(19_996, 8192, 256), (5000, 300, 32),
                                    (700, 17, 8)])
def test_stream_pricing_and_chunk_choice_match_jax(kernel, budget, dma, m, n,
                                                   sb):
    """ROADMAP C8: given the same explicit budget and link rate, the two
    packages choose the same chunk size (the port's default slot count is
    the JAX pipe's two)."""
    for c in (1, 4):
        _same(T.choose_chunk_rows(m, n, sb, kernel, c=c, dma_bps=dma,
                                  budget_bytes=budget, return_frontier=True),
              J.choose_chunk_rows(m, n, sb, kernel, c=c, dma_bps=dma,
                                  budget_bytes=budget, return_frontier=True))
        for cr in (128, 2048):
            _same(T.stream_chunk_cost(cr, n, sb, kernel, c=c, dma_bps=dma),
                  J.stream_chunk_cost(cr, n, sb, kernel, c=c, dma_bps=dma))
            _same(T.stream_pipeline_cost(m, n, sb, cr, kernel, c=c,
                                         dma_bps=dma),
                  J.stream_pipeline_cost(m, n, sb, cr, kernel, c=c,
                                         dma_bps=dma))
            assert (T.stream_working_set_bytes(cr, n, sb, c=c)
                    == J.stream_working_set_bytes(cr, n, sb, c=c))
            assert (T.stream_chunk_fits(cr, n, sb, c=c, budget_bytes=budget)
                    == J.stream_chunk_fits(cr, n, sb, c=c,
                                           budget_bytes=budget))


def test_three_slots_count_the_symmetric_pipes_third_chunk():
    """The port's streamed fit keeps three chunk slots (the symmetric
    full matvec's anchor): its working set counts one chunk more, so a
    budget that just fits two slots refuses the same chunk at three."""
    cr, n, sb = 2048, 8192, 256
    two = T.stream_working_set_bytes(cr, n, sb)
    three = T.stream_working_set_bytes(cr, n, sb, slots=T.STREAM_SLOTS)
    assert three - two == 4 * cr * (n + 1)
    assert T.stream_chunk_fits(cr, n, sb, budget_bytes=two)
    assert not T.stream_chunk_fits(cr, n, sb, budget_bytes=two,
                                   slots=T.STREAM_SLOTS)


@pytest.mark.parametrize("rate", [50.0, 2000.0, 50_000.0])
def test_serve_model_matches_jax(rate):
    for m, n, kernel in ((2000, 64, "rbf"), (50_000, 8192, "linear")):
        for q in (1, 13, 100):
            assert T.serve_bucket(q, 64) == J.serve_bucket(q, 64)
            _same(T.serve_block_time(q, m, n, kernel),
                  J.serve_block_time(q, m, n, kernel))
        _same(T.modeled_serve_latency(rate, 64, m, n, kernel),
              J.modeled_serve_latency(rate, 64, m, n, kernel))
        tp = T.choose_serve_plan(m, n, kernel, rate_qps=rate)
        jp = J.choose_serve_plan(m, n, kernel, rate_qps=rate)
        assert tp.slots == jp.slots
        _same(tp.model, jp.model)
        _same(list(tp.frontier), list(jp.frontier))


def test_collective_counts_match_jax():
    for layout, kernel in itertools.product(("serial", "1d", "2d"),
                                            ("linear", "rbf")):
        assert (T.round_collectives(layout, kernel)
                == J.round_collectives(layout, kernel))
        assert (T.setup_collectives(layout, kernel)
                == J.setup_collectives(layout, kernel))
    for mod in (T, J):
        with pytest.raises(ValueError, match="unknown layout"):
            mod.round_collectives("3d", "rbf")
        with pytest.raises(ValueError, match="budget"):
            mod.choose_recompute_every(100, 8, "rbf", budget=0.0)


def test_tpu_defaults_are_gone():
    """No VMEM budget, HBM-class link rate or 16 GiB device memory is
    left to default to: each is an explicit argument, and the Pallas
    working-set functions have no counterpart."""
    for name in ("VMEM_BYTES", "STREAM_DMA_BPS", "vmem_fits",
                 "pallas_working_set_bytes"):
        assert hasattr(J, name) and not hasattr(T, name)
    with pytest.raises(TypeError):
        T.slab_fits_hbm(1000, 8)
    with pytest.raises(TypeError):
        T.streaming_required(1000, 8, 8)
    with pytest.raises(TypeError):
        T.choose_chunk_rows(1000, 8, 8, "rbf")
    with pytest.raises(TypeError):
        T.stream_chunk_fits(128, 8, 8)
    with pytest.raises(TypeError):
        T.best_s(T.Problem(m=100, n=8), T.Machine(), 1)
    with pytest.raises(ValueError, match="dma_bps"):
        T.modeled_predict_cost(1000, 8, 100, "rbf", stream=16)


def test_device_budget_of_the_host():
    """On the CPU the budget is the host's available memory, and there is
    no link to cross (a CPU fit reads its data where it lies)."""
    b = T.DeviceBudget.of_device("cpu")
    assert b.hbm_bytes > 0 and b.stream_bytes == int(T.STREAM_SHARE
                                                     * b.hbm_bytes)
    assert b.dma_bps == float("inf") and b.slots == T.STREAM_SLOTS
    assert b.min_chunk_rows == 1
    cr = T.choose_chunk_rows(20_000, 64, 32, "rbf", dma_bps=b.dma_bps,
                             budget_bytes=b.stream_bytes, slots=b.slots)
    assert cr in T.STREAM_CHUNK_CANDIDATES
    assert np.isfinite(T.stream_pipeline_cost(20_000, 64, 32, cr, "rbf",
                                              dma_bps=b.dma_bps)["time"])
