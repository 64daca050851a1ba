"""Mamba-1 (the S6 selective scan) and Mamba-2 (SSD, a scalar decay per
head) blocks with their O(1)-state single-token decode (the counterpart
of ``repro/models/mamba.py``, function for function).

The recurrence h_t = a_t * h_{t-1} + b_t is associative in (a, b):
(a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2).  The JAX package scans it
with ``jax.lax.associative_scan``; PyTorch has no stable counterpart, so
``_ssm_scan`` is a log-depth doubling scan (Hillis-Steele): at level k
every step t >= 2^k takes in the pair 2^k steps before it, b_t <- b_t +
a_t b_{t - 2^k} and a_t <- a_t a_{t - 2^k}, ceil(log2 L) levels of a few
elementwise ops over the whole (B, L, ...) tensor.  Each h_t is thus
summed as a balanced tree over its window in that order, where XLA's
associative scan pairs odd and even steps recursively: the same terms
in another order, so f32 agrees to rounding (ROADMAP C26).
``_chunked_ssm`` runs the scan inside each 64-step chunk and carries the
boundary state across chunks sequentially, as the reference does, so a
layer takes about (L / 64) x 6 x a few launches.

The scans, the causal conv, SSD's matrix form and Mamba-2's gated norm
are plain PyTorch, as the reference computes them outside any Pallas
kernel.  Params are f32 and cast to the compute dtype at use; the
decode state's h is f32 whatever the compute dtype (the reference's
``init_mamba{1,2}_state``), its conv state in the compute dtype.

With ``tp`` (a ``models.sharding.Sharded`` whose ``tp_parts`` hold
``"mamba"``) a block runs over this rank's channels (Mamba-1) or heads
(Mamba-2): ``in_proj``'s output, computed on the rank's chunk of its
columns, is gathered over ``model`` and the rank takes its x, z (and
dt) channels, B and C whole; the per-channel leaves are the rank's
(``tp.own`` slices a leaf given whole); Mamba-1's ``x_proj`` product
and Mamba-2's gated-norm sum of squares are summed over ``model``
(``tp.all_sum``), ``out_proj``'s partial products too (``tp.reduce``).
The decode state is the rank's: Mamba-1's conv state and h its
channels, Mamba-2's h its heads; Mamba-2's conv state comes whole (its
contiguous chunk of ``[x | B | C]`` is not the rank's channels) and
the whole new one is returned (``models.lm`` keeps the rank's chunk).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init

CHUNK = 64


def _ssm_scan(decay: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = decay_t * h_{t-1} + inp_t along axis 1 (h_0
    = inp_0): the doubling scan of the module docstring.  decay / inp:
    (B, L, ...) of one shape."""
    a, b = decay, inp
    L = b.shape[1]
    off = 1
    while off < L:
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]],
                      dim=1)
        if 2 * off < L:                  # the last level needs no a
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def _pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x (B, L, ...) with ``pad`` zero steps appended on axis 1."""
    return torch.cat([x, x.new_zeros((x.shape[0], pad, *x.shape[2:]))],
                     dim=1)


def _chunked_ssm(decay: torch.Tensor, drive: torch.Tensor, Cc: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Memory-bounded SSM: chunks of the time axis in order; inside a
    chunk the scan materialises h for ``chunk`` steps only, contracts it
    with C at once and carries the boundary state (the zero-padded tail
    decays to zero and drives nothing; its outputs are cut).

    decay / drive: (B, L, *state) with state (di, n) for Mamba-1, (nh,
    hd, n) for Mamba-2; Cc: (B, L, n).  Returns y (B, L, *state[:-1]): h
    contracted over its last (state) axis."""
    B, L = drive.shape[:2]
    state_shape = drive.shape[2:]
    ck = min(chunk, L)
    pad = (-L) % ck
    if pad:
        decay, drive, Cc = (_pad_time(t, pad) for t in (decay, drive, Cc))
    h = drive.new_zeros((B, *state_shape))
    ys = []
    for c0 in range(0, L + pad, ck):
        d, dr, cc = (t[:, c0:c0 + ck] for t in (decay, drive, Cc))
        h_rel = _ssm_scan(d, dr)
        cum = torch.cumprod(d, dim=1)                  # prod of decays
        h_abs = h_rel + cum * h[:, None]
        ys.append(torch.einsum("bl...n,bln->bl...", h_abs, cc))
        h = h_abs[:, -1]
    return torch.cat(ys, dim=1)[:, :L]


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv1d.  x: (B, L, C), w: (C, K).  With ``state``
    (B, K-1, C) given, the streaming update: returns (y, new_state).  The
    K taps are added in order as a sum of products in x's dtype, as the
    reference adds them (bf16 products and sums round as its do)."""
    K = w.shape[1]
    if state is None:
        pad = torch.cat([x.new_zeros((x.shape[0], K - 1, x.shape[2])), x],
                        dim=1)
    else:
        pad = torch.cat([state.to(x.dtype), x], dim=1)
    L = x.shape[1]
    y = sum(pad[:, k:k + L, :] * w[:, k].to(x.dtype) for k in range(K))
    if state is None:
        return y
    return y, pad[:, -(K - 1):, :]


# ====================================================================
# Mamba-1
# ====================================================================

def dt_rank(cfg: ModelConfig) -> int:
    return max(cfg.d_model // 16, 1)


def init_mamba1(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, di, n, kk = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.d_conv
    dev = gen.device
    r = dt_rank(cfg)
    in_proj = dense_init(gen, d, 2 * di)
    conv_w = torch.empty((di, kk), dtype=torch.float32, device=dev)
    conv_w.normal_(0.0, 1.0, generator=gen).mul_(0.1)
    x_proj = dense_init(gen, di, r + 2 * n)
    dt_proj = dense_init(gen, r, di)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": torch.full((di,), -4.6, device=dev),   # softplus ~ 0.01
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=dev)).expand(di, n).clone(),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d),
    }


def _tp_in(x: torch.Tensor, w: torch.Tensor, tp) -> torch.Tensor:
    """``x @ in_proj`` (``w`` in the compute dtype): with ``tp`` the
    product on the rank's columns gathered over ``model`` (module
    docstring), x's gradient summed over it."""
    if tp is None:
        return x @ w
    return tp.gather_act(tp.copy(x) @ w, -1)


def _tp_out(y: torch.Tensor, w: torch.Tensor, tp) -> torch.Tensor:
    """``y @ out_proj``, with ``tp`` the rank's partial product summed."""
    out = y @ w
    return out if tp is None else tp.reduce(out)


def _mamba1_own(p: dict, cfg: ModelConfig, tp) -> dict:
    """The rank's channels of every Mamba-1 leaf (module docstring)."""
    if tp is None:
        return p
    di = cfg.d_inner
    dims = {"conv_w": 0, "x_proj": 0, "dt_proj": 1, "dt_bias": 0,
            "A_log": 0, "D": 0}
    return dict(p, **{k: tp.own(p[k], di, d) for k, d in dims.items()})


def _mamba1_ssm_inputs(p: dict, xc: torch.Tensor, dtype: torch.dtype,
                       tp=None):
    """Shared by the forward and decode: decay and drive (B, L, di, n) f32
    and C (B, L, n) from the conv output (with ``tp`` the rank's channels:
    the ``x_proj`` partial products summed over ``model``)."""
    di, n = p["A_log"].shape
    r = p["x_proj"].shape[1] - 2 * n
    proj = xc @ p["x_proj"].to(dtype)
    if tp is not None:
        proj = tp.all_sum(proj)
    dt_in, Bc, Cc = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus((dt_in @ p["dt_proj"].to(dtype)).float()
                    + p["dt_bias"])                    # (B, L, di)
    A = -torch.exp(p["A_log"])                         # (di, n)
    decay = torch.exp(dt[..., None] * A)               # (B, L, di, n)
    drive = (dt[..., None] * Bc[:, :, None, :].float()
             * xc[..., None].float())                  # (B, L, di, n)
    return decay, drive, Cc


def _mamba1_xz(p: dict, cfg: ModelConfig, x: torch.Tensor, tp):
    """x and z (B, L, di) from ``in_proj``: with ``tp`` the rank's
    channels of each."""
    xz = _tp_in(x, p["in_proj"].to(x.dtype), tp)
    xr, z = xz.chunk(2, dim=-1)
    if tp is not None:
        xr, z = (tp.own(t, cfg.d_inner, 2) for t in (xr, z))
    return xr, z


def mamba1_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, tp=None):
    """x: (B, L, D) -> (B, L, D); over this rank's channels with ``tp``
    (module docstring)."""
    dtype = x.dtype
    xr, z = _mamba1_xz(p, cfg, x, tp)
    p = _mamba1_own(p, cfg, tp)
    xc = F.silu(_causal_conv(xr, p["conv_w"]))
    decay, drive, Cc = _mamba1_ssm_inputs(p, xc, dtype, tp)
    y = _chunked_ssm(decay, drive, Cc.float(), CHUNK)
    y = (y + p["D"] * xc.float()).to(dtype)
    y = y * F.silu(z)
    return _tp_out(y, p["out_proj"].to(dtype), tp)


def mamba1_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  state: Tuple[torch.Tensor, torch.Tensor], tp=None):
    """x: (B, 1, D); state: (conv_state (B, K-1, di), h (B, di, n) f32),
    with ``tp`` the rank's channels of both.  Returns (out (B, 1, D), new
    state); the input state is not written."""
    dtype = x.dtype
    conv_s, h = state
    xr, z = _mamba1_xz(p, cfg, x, tp)
    p = _mamba1_own(p, cfg, tp)
    xc, conv_s = _causal_conv(xr, p["conv_w"], conv_s)
    xc = F.silu(xc)
    decay, drive, Cc = _mamba1_ssm_inputs(p, xc, dtype, tp)
    h = decay[:, 0] * h + drive[:, 0]                  # (B, di, n)
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0].float())
    y = (y + p["D"] * xc[:, 0].float()).to(dtype)[:, None]
    y = y * F.silu(z)
    return _tp_out(y, p["out_proj"].to(dtype), tp), (conv_s, h)


def init_mamba1_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device):
    di, n = cfg.d_inner, cfg.ssm_state
    return (torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                        device=device),
            torch.zeros((batch, di, n), dtype=torch.float32, device=device))


# ====================================================================
# Mamba-2 (SSD): per-head scalar decay, outer-product state (hd x n)
# ====================================================================

def init_mamba2(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = di // cfg.mamba_headdim
    dev = gen.device
    # fused input projection: columns [z (di) | x (di) | B (n) | C (n) |
    # dt (nh)], as _mamba2_parts splits them
    in_proj = dense_init(gen, d, 2 * di + 2 * n + nh)
    conv_w = torch.empty((di + 2 * n, cfg.d_conv), dtype=torch.float32,
                         device=dev)
    conv_w.normal_(0.0, 1.0, generator=gen).mul_(0.1)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "dt_bias": torch.full((nh,), -4.6, device=dev),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d),
    }


def _mamba2_own(p: dict, cfg: ModelConfig, tp) -> dict:
    """The rank's heads of the per-head Mamba-2 leaves and its channels of
    ``norm_scale`` (``conv_w`` is cut in ``_mamba2_parts``)."""
    if tp is None:
        return p
    di = cfg.d_inner
    nh = di // cfg.mamba_headdim
    return dict(p, dt_bias=tp.own(p["dt_bias"], nh, 0),
                A_log=tp.own(p["A_log"], nh, 0), D=tp.own(p["D"], nh, 0),
                norm_scale=tp.own(p["norm_scale"], di, 0))


def _mamba2_parts(p: dict, cfg: ModelConfig, zxbcdt: torch.Tensor,
                  conv_state=None, tp=None):
    """z, x, B, C, dt, decay from ``in_proj``'s output, and the new conv
    state where ``conv_state`` (B, K-1, di + 2n) is given (whole: the last
    K - 1 steps of the pre-conv ``[x | B | C]``); with ``tp`` the rank's
    heads' z, x and dt, B and C whole (module docstring), ``p`` the
    rank's leaves (``_mamba2_own``) but ``conv_w``, whole."""
    di, n = cfg.d_inner, cfg.ssm_state
    nh = di // cfg.mamba_headdim
    z, xbc, dt_in = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    conv_w = p["conv_w"]
    new_conv = None
    if conv_state is not None:
        pad = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        new_conv = pad[:, -(conv_w.shape[1] - 1):, :]
    if tp is not None:
        def rank_x(t, dim):
            # the rank's x channels of [x | B | C], then B and C
            x_, bc = t.narrow(dim, 0, di), t.narrow(dim, di, 2 * n)
            return torch.cat([tp.own(x_, di, dim), bc], dim)
        z, dt_in = tp.own(z, di, 2), tp.own(dt_in, nh, 2)
        xbc, conv_w = rank_x(xbc, 2), rank_x(conv_w, 0)
        if conv_state is not None:
            conv_state = rank_x(conv_state, 2)
    if conv_state is None:
        xbc = F.silu(_causal_conv(xbc, conv_w))
    else:
        xbc = F.silu(_causal_conv(xbc, conv_w, conv_state)[0])
    xr, Bc, Cc = torch.split(xbc, [xbc.shape[-1] - 2 * n, n, n], dim=-1)
    dt = F.softplus(dt_in.float() + p["dt_bias"])      # (B, L, nh)
    a = -torch.exp(p["A_log"])                         # (nh,)
    decay = torch.exp(dt * a)                          # (B, L, nh)
    return z, xr, Bc, Cc, dt, decay, new_conv


def _ssd_chunked(xh: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                 dt: torch.Tensor, decay: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Mamba-2's SSD block decomposition (matrix form).  Per chunk of
    length c, per head (scalar decay a_t):

      g        = cumsum(log a)                      (c,)
      L[i, j]  = exp(g_i - g_j) for j <= i else 0   (c, c)
      Y_intra  = ((C B^T) o L) @ (dt * x)
      Y_inter  = exp(g) * (C @ h_in^T)
      h_out    = exp(g_c) h_in + X^T diag(exp(g_c - g) dt) B

    L is exp of the exponents with the entries above the diagonal set to
    -inf first: the reference's ``where(causal, exp(rel), 0)`` in value,
    but an entry above the diagonal (rel >= 0, which overflows where the
    decays are small) can neither overflow nor give a 0 * inf gradient
    (ROADMAP C27).  The padded tail has decay 1 and dt 0: the state just
    carries.  xh: (B, L, nh, hd) f32; Bc / Cc: (B, L, n); dt / decay: (B,
    L, nh).  Returns y: (B, L, nh, hd)."""
    B_, L, nh, hd = xh.shape
    n = Bc.shape[-1]
    ck = min(chunk, L)
    pad = (-L) % ck
    if pad:
        xh, Bc, Cc, dt = (_pad_time(t, pad) for t in (xh, Bc, Cc, dt))
        decay = torch.cat([decay, decay.new_ones((B_, pad, nh))], dim=1)
    nc = (L + pad) // ck

    def chunks(t):
        return t.reshape(B_, nc, ck, *t.shape[2:])

    xh_c, B_c, C_c, dt_c, dec_c = map(chunks, (xh, Bc, Cc, dt, decay))
    g = torch.cumsum(torch.log(torch.clamp(dec_c, min=1e-37)),
                     dim=2)                            # (B, nc, c, nh)
    rel = g[:, :, :, None, :] - g[:, :, None, :, :]    # (B, nc, c, c, nh)
    above = ~torch.ones((ck, ck), dtype=torch.bool,
                        device=xh.device).tril()[None, None, :, :, None]
    Lmat = torch.exp(rel.masked_fill(above, float("-inf")))
    CB = torch.einsum("bkin,bkjn->bkij", C_c.float(), B_c.float())
    M = CB[..., None] * Lmat                           # (B, nc, c, c, nh)
    Xdt = xh_c * dt_c[..., None]                       # (B, nc, c, nh, hd)
    y_intra = torch.einsum("bkijh,bkjhd->bkihd", M, Xdt)

    # inter-chunk: scan the (nh, hd, n) state across the chunks
    glast = g[:, :, -1:, :]                            # (B, nc, 1, nh)
    wexp = torch.exp(glast - g)                        # (B, nc, c, nh)
    # h_chunk[k] = sum_i exp(g_last - g_i) dt_i x_i B_i^T (B, nc, nh, hd, n)
    h_chunk = torch.einsum("bkihd,bkin->bkhdn", Xdt * wexp[..., None],
                           B_c.float())
    dec_chunk = torch.exp(glast[:, :, 0, :])           # (B, nc, nh)
    h = xh.new_zeros((B_, nh, hd, n))
    y_inter = []
    for k in range(nc):
        y_inter.append(torch.einsum("bin,bhdn,bih->bihd", C_c[:, k].float(),
                                    h, torch.exp(g[:, k])))
        h = dec_chunk[:, k, :, None, None] * h + h_chunk[:, k]
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(B_, L + pad, nh, hd)[:, :L]


def _gated_norm(p: dict, y: torch.Tensor, z: torch.Tensor,
                dtype: torch.dtype, tp=None, d_full: int = 0) -> torch.Tensor:
    """Mamba-2's gated RMSNorm, inline and plain as in the reference; with
    ``tp`` over the rank's channels, the mean of squares over all
    ``d_full`` of them (its sums summed over ``model``)."""
    y = y * F.silu(z)
    yf = y.float()
    if tp is None:
        ms = (yf * yf).mean(-1, keepdim=True)
    else:
        ms = tp.all_sum((yf * yf).sum(-1, keepdim=True)) / d_full
    return (yf * torch.rsqrt(ms + 1e-6) * p["norm_scale"]).to(dtype)


def mamba2_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, tp=None):
    """x: (B, L, D) -> (B, L, D), through SSD (``cfg.ssm_impl == "ssd"``)
    or the elementwise chunked scan ("scan"); over this rank's heads with
    ``tp`` (module docstring)."""
    dtype = x.dtype
    hd = cfg.mamba_headdim
    zxbcdt = _tp_in(x, p["in_proj"].to(dtype), tp)
    p = _mamba2_own(p, cfg, tp)
    z, xr, Bc, Cc, dt, decay, _ = _mamba2_parts(p, cfg, zxbcdt, tp=tp)
    B_, L = x.shape[:2]
    di = xr.shape[-1]
    nh = di // hd
    xh = xr.reshape(B_, L, nh, hd).float()
    if cfg.ssm_impl == "ssd":
        y = _ssd_chunked(xh, Bc.float(), Cc.float(), dt, decay, CHUNK)
    else:
        drive = (dt[..., None, None] * xh[..., None]
                 * Bc[:, :, None, None, :].float())
        decay_b = decay[..., None, None].expand(drive.shape)
        y = _chunked_ssm(decay_b, drive, Cc.float(), CHUNK)
    y = y + p["D"][:, None] * xh
    y = _gated_norm(p, y.reshape(B_, L, di).to(dtype), z, dtype, tp,
                    cfg.d_inner)
    return _tp_out(y, p["out_proj"].to(dtype), tp)


def mamba2_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  state: Tuple[torch.Tensor, torch.Tensor], tp=None):
    """x: (B, 1, D); state: (conv_state (B, K-1, di + 2n), h (B, nh, hd,
    n) f32), with ``tp`` the whole conv state and the rank's heads of h
    (module docstring).  Returns (out (B, 1, D), new state, its conv
    state whole); the input state is not written."""
    dtype = x.dtype
    hd = cfg.mamba_headdim
    conv_s, h = state
    zxbcdt = _tp_in(x, p["in_proj"].to(dtype), tp)
    p = _mamba2_own(p, cfg, tp)
    z, xr, Bc, Cc, dt, decay, conv_s = _mamba2_parts(p, cfg, zxbcdt, conv_s,
                                                     tp)
    B_ = x.shape[0]
    di = xr.shape[-1]
    xh = xr[:, 0].reshape(B_, di // hd, hd).float()
    drive = (dt[:, 0, :, None, None] * xh[..., None]
             * Bc[:, 0, None, None, :].float())
    h = decay[:, 0, :, None, None] * h + drive         # (B, nh, hd, n)
    y = torch.einsum("bhdn,bn->bhd", h, Cc[:, 0].float())
    y = y + p["D"][:, None] * xh
    y = _gated_norm(p, y.reshape(B_, 1, di).to(dtype), z, dtype, tp,
                    cfg.d_inner)
    return _tp_out(y, p["out_proj"].to(dtype), tp), (conv_s, h)


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device):
    di, n = cfg.d_inner, cfg.ssm_state
    nh = di // cfg.mamba_headdim
    return (torch.zeros((batch, cfg.d_conv - 1, di + 2 * n), dtype=dtype,
                        device=device),
            torch.zeros((batch, nh, cfg.mamba_headdim, n),
                        dtype=torch.float32, device=device))
