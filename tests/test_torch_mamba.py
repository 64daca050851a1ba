"""The port's Mamba blocks (``repro_torch.models.mamba``) against the JAX
package's ``repro/models/mamba.py``, function for function, on the same
numpy inputs and params (the JAX params drawn from a key, perturbed from
a numpy seed so that the decays and gates are not at their constant
init, and carried across).

Bounds: f32 1e-5 (the port's doubling scan sums each state over its
window in another order than XLA's associative scan: ROADMAP C26); bf16
5e-2, the JAX model tests' bound; a gradient leaf f32 1e-5 of
max(1, its largest entry) (a leaf's entries are sums over every
position and channel and reach ~50 here, so their f32 rounding is
relative to that scale, not to each entry); the port's SSD against its
own scan at the reference's tests/test_ssd.py bounds (rtol 2e-3, atol
2e-4).
Every JAX function is jitted once for the module (its scans compile
slowly) and reused across the parametrised cases.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import mamba as jm
from repro_torch.configs import get_config
from repro_torch.models import mamba as tm

F32, BF16 = 1e-5, 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are small: one intra-op thread is
    faster than many, and keeps this file from oversubscribing the cores
    that parallel test workers share; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
LS = [8, 64, 100]                      # below, at and above the chunk

J_SCAN = jax.jit(jm._ssm_scan)
J_CHUNKED = jax.jit(jm._chunked_ssm, static_argnums=(3,))
J_SSD = jax.jit(jm._ssd_chunked, static_argnums=(5,))
J_CONV = jax.jit(jm._causal_conv)
J_FWD = {"mamba1": jax.jit(jm.mamba1_forward, static_argnums=(1,)),
         "mamba2": jax.jit(jm.mamba2_forward, static_argnums=(1,))}
J_DEC = {"mamba1": jax.jit(jm.mamba1_decode, static_argnums=(1,)),
         "mamba2": jax.jit(jm.mamba2_decode, static_argnums=(1,))}
T_FWD = {"mamba1": tm.mamba1_forward, "mamba2": tm.mamba2_forward}
T_DEC = {"mamba1": tm.mamba1_decode, "mamba2": tm.mamba2_decode}


def _cfgs(kind, **kw):
    arch = "falcon_mamba_7b" if kind == "mamba1" else "zamba2_1p2b"
    return (dataclasses.replace(j_get_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_leaf(got, want, tol, what=""):
    """max |got - want| within ``tol`` of max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _params(kind, jcfg, seed=0):
    """(JAX params, the port's) of one block: the JAX init, its dt_bias,
    A_log, D (and Mamba-2's norm_scale) moved off their constants."""
    init = jm.init_mamba1 if kind == "mamba1" else jm.init_mamba2
    p = {k: np.asarray(v) for k, v in init(jax.random.key(seed),
                                           jcfg).items()}
    rng = np.random.default_rng(seed + 100)
    for k, (lo, hi) in {"dt_bias": (-3.0, 0.0), "A_log": (-0.5, 1.0),
                        "D": (0.5, 1.5), "norm_scale": (0.5, 1.5)}.items():
        if k in p:
            p[k] = (p[k] + rng.uniform(lo, hi, p[k].shape)).astype(
                np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _x(shape, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _both(a, dtype="float32"):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


# ------------------------------------------------------------- scans ----

@pytest.mark.parametrize("L", LS)
def test_ssm_scan_matches_jax(L):
    decay = np.random.default_rng(1).uniform(0.5, 1.0, (2, L, 3, 4)
                                              ).astype(np.float32)
    inp = _x((2, L, 3, 4), 2)
    want = J_SCAN(jnp.asarray(decay), jnp.asarray(inp))
    got = tm._ssm_scan(torch.from_numpy(decay), torch.from_numpy(inp))
    _close(got, want, F32)


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("state", [(6, 4), (2, 3, 4)],
                         ids=["mamba1", "mamba2"])
def test_chunked_ssm_matches_jax(L, state):
    rng = np.random.default_rng(3)
    decay = rng.uniform(0.8, 1.0, (2, L, *state)).astype(np.float32)
    drive = _x((2, L, *state), 4)
    C = _x((2, L, state[-1]), 5)
    want = J_CHUNKED(jnp.asarray(decay), jnp.asarray(drive), jnp.asarray(C),
                     64)
    got = tm._chunked_ssm(torch.from_numpy(decay), torch.from_numpy(drive),
                          torch.from_numpy(C), 64)
    assert got.shape == (2, L, *state[:-1])
    _close(got, want, F32)


def _ssd_inputs(L, seed=6, nh=3, hd=4, n=5, dt_scale=0.3):
    rng = np.random.default_rng(seed)
    xh = _x((2, L, nh, hd), seed + 1)
    B = _x((2, L, n), seed + 2)
    C = _x((2, L, n), seed + 3)
    dt = (dt_scale * rng.uniform(0.05, 1.0, (2, L, nh))).astype(np.float32)
    a = -rng.uniform(0.2, 2.0, (nh,)).astype(np.float32)
    decay = np.exp(dt * a).astype(np.float32)
    return xh, B, C, dt, decay


@pytest.mark.parametrize("L", LS)
def test_ssd_chunked_matches_jax(L):
    args = _ssd_inputs(L)
    want = J_SSD(*map(jnp.asarray, args), 64)
    got = tm._ssd_chunked(*map(torch.from_numpy, args), 64)
    _close(got, want, F32)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("stream", [False, True])
def test_causal_conv_matches_jax(stream, dtype, tol):
    x = _x((2, 9, 6), 7)
    w = _x((6, 4), 8)
    jx, tx = _both(x, dtype)
    if not stream:
        _close(tm._causal_conv(tx, torch.from_numpy(w)).float(),
               J_CONV(jx, jnp.asarray(w)), tol)
        return
    s = _x((2, 3, 6), 9)
    js, ts = _both(s, dtype)
    jy, jstate = J_CONV(jx, jnp.asarray(w), js)
    ty, tstate = tm._causal_conv(tx, torch.from_numpy(w), ts)
    _close(ty.float(), jy, tol)
    _close(tstate.float(), jstate, 0)


# ------------------------------------------------------------ blocks ----

BLOCKS = [("mamba1", "scan"), ("mamba2", "ssd"), ("mamba2", "scan")]


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("kind,impl", BLOCKS)
def test_forward_matches_jax(kind, impl, L, dtype, tol):
    jcfg, cfg = _cfgs(kind, ssm_impl=impl)
    jp, tp = _params(kind, jcfg)
    jx, tx = _both(_x((2, L, cfg.d_model), 10), dtype)
    want = J_FWD[kind](jp, jcfg, jx)
    got = T_FWD[kind](tp, cfg, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got.float(), want, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_decode_steps_and_states_match_jax(kind, dtype, tol):
    """Five single-token steps from a non-zero state: each output, the
    conv state in the compute dtype and h in f32 against JAX's."""
    jcfg, cfg = _cfgs(kind)
    jp, tp = _params(kind, jcfg)
    init = tm.init_mamba1_state if kind == "mamba1" else tm.init_mamba2_state
    conv0, h0 = init(cfg, 2, getattr(torch, dtype), "cpu")
    assert conv0.dtype == getattr(torch, dtype) and h0.dtype == torch.float32
    jconv, tconv = _both(_x(tuple(conv0.shape), 11), dtype)
    h = _x(tuple(h0.shape), 12, scale=0.1)
    jstate, tstate = (jconv, jnp.asarray(h)), (tconv, torch.from_numpy(h))
    for t in range(5):
        jx, tx = _both(_x((2, 1, cfg.d_model), 13 + t), dtype)
        jy, jstate = J_DEC[kind](jp, jcfg, jx, jstate)
        ty, tstate = T_DEC[kind](tp, cfg, tx, tstate)
        _close(ty.float(), jy, tol)
    assert tstate[0].dtype == tx.dtype and tstate[1].dtype == torch.float32
    _close(tstate[0].float(), jstate[0], tol)
    _close(tstate[1], jstate[1], tol)


@pytest.mark.parametrize("kind,impl", BLOCKS)
def test_every_leaf_gradient_matches_jax(kind, impl):
    """jax.grad of sum(w * block(p, x)) against autograd, f32: every
    param leaf and x."""
    jcfg, cfg = _cfgs(kind, ssm_impl=impl)
    jp, tp = _params(kind, jcfg)
    x = _x((2, 100, cfg.d_model), 14)
    w = _x((2, 100, cfg.d_model), 15, scale=1.0)
    fwd = jm.mamba1_forward if kind == "mamba1" else jm.mamba2_forward
    jg, jgx = jax.jit(jax.grad(
        lambda p, x: jnp.sum(fwd(p, jcfg, x) * jnp.asarray(w)),
        argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    for v in tp.values():
        v.requires_grad_()
    (T_FWD[kind](tp, cfg, tx) * torch.from_numpy(w)).sum().backward()
    assert set(tp) == set(jg)
    for k, v in tp.items():
        _close_leaf(v.grad.numpy(), jg[k], F32, k)
    _close_leaf(tx.grad.numpy(), jgx, F32, "x")


# --------------------------------------------------------------- SSD ----

@pytest.mark.parametrize("L", LS)
def test_ssd_matches_scan(L):
    """The port's SSD against its own elementwise scan: the reference's
    tests/test_ssd.py bounds."""
    jcfg, cfg = _cfgs("mamba2", dtype="float32")
    _, tp = _params("mamba2", jcfg, seed=1)
    x = torch.from_numpy(_x((2, L, cfg.d_model), 16))
    a = tm.mamba2_forward(tp, dataclasses.replace(cfg, ssm_impl="scan"), x)
    b = tm.mamba2_forward(tp, dataclasses.replace(cfg, ssm_impl="ssd"), x)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("dt_scale", [0.3, 400.0], ids=["mild", "steep"])
def test_ssd_gradients_finite(dt_scale):
    """SSD's gradients are finite, and equal JAX's wherever JAX's are.
    At "steep" decays (dt a ~ -1e2 a step) the exponents above the
    diagonal reach thousands: the reference's exp of them overflows and
    its masked gradient is 0 * inf there, the port masks before exp
    (ROADMAP C27); the forward values agree at f32 limits either way."""
    args = _ssd_inputs(100, seed=17, dt_scale=dt_scale)
    w = _x((2, 100, 3, 4), 18, scale=1.0)

    def jloss(xh, B, C, dt, decay):
        return jnp.sum(jm._ssd_chunked(xh, B, C, dt, decay, 64)
                       * jnp.asarray(w))

    jargs = tuple(map(jnp.asarray, args))
    jvals = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y = tm._ssd_chunked(*targs, 64)
    _close(y.detach(), J_SSD(*jargs, 64), F32)
    (y * torch.from_numpy(w)).sum().backward()
    for name, t, jv in zip(("xh", "B", "C", "dt", "decay"), targs, jvals):
        g, jv = t.grad.numpy(), np.asarray(jv)
        assert np.isfinite(g).all(), name
        ok = np.isfinite(jv)
        if ok.any():
            _close_leaf(g[ok], jv[ok], F32, name)
