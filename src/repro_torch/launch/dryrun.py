"""Dry run of the production plan: every (architecture x input shape x
mesh) cell runs one rank's step, and its roofline terms are read off the
run (the counterpart of ``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape train_4k [--multi-pod] [--microbatches 1] [--out r.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The JAX dry run lowers and compiles each cell for 512 placeholder
devices.  Here one rank (coordinates (0, 0), or (0, 0, 0)) runs the
cell's real entry point on ``meta`` tensors, which carry shapes and
dtypes and no data: ``make_train_step(rules=)`` for a training cell,
``forward(rules=)`` for a prefill cell, ``decode_step(rules=)`` for a
decode cell, on the dry production mesh (``mesh.make_production_mesh``),
whose collectives are counted as a real mesh's and return tensors of
the result's shape.  A cell passes when that step runs; its inputs are
``launch.specs``'s chunks of the rank.  The attention of a causal layer
takes the port's flash path (``attn_impl="flash"``), the one the card
runs, wherever the flash kernel takes the cell's sequence lengths.

What the run is priced by:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over the
  dispatched ops, plus the hand-written kernels by their own formulas
  (``rmsnorm_cost``, ``flash_cost``: the operation counts behind
  ``PERF.md``'s bound column).  On ``meta`` the kernels' wrappers are
  stood in for by ``priced_kernels``, which makes the outputs' shapes
  and adds the formulas: the plain versions' ops (the (S x S) scores of
  the plain attention) are never dispatched, as the card never runs
  them.
* **Bytes**: inputs plus outputs of each dispatched op (``ByteCounter``,
  views and allocations excluded), the counterpart of XLA's "bytes
  accessed", plus the kernels' formula bytes.
* **Collective bytes**: by primitive, from the mesh's record
  (``launch.collective_log``), and the calls by ``(axis, kind)``, which
  equal ``train_step.step_collectives`` / ``decode_collectives``.
* **Memory**: the arguments' bytes from the specs' chunk shapes; the
  counterpart of the temporaries, the bytes saved for backward
  (``torch.autograd.graph.saved_tensors_hooks``).
* **Roofline terms**: each over the card's figures (``mesh.HW``, the
  H100's data sheet): ``t_compute``, ``t_memory``, ``t_collective``
  (each axis's bytes over its link, ``mesh.axis_link_bw``), the
  ``bottleneck`` and the ``roofline_fraction``, and ``model_flops`` (6 N
  D for training, 2 N_active D for inference) against the counted FLOPs.

The JAX dry run extrapolates its costs from probes at depth 1 and 2
periods, because XLA counts a scan body once.  The port's layers are a
Python loop, which would count every layer, but a full-depth run on
``meta`` takes minutes for the SSM family (Falcon-Mamba-7B's training
cell 250 s at 16 x 16: each 64-step chunk of its scans is a few dozen
small ops), so the port runs the same two probes (``probe_cfg``,
``extrapolated_costs``) and takes every cost to full depth as
``cost(1) + (cost(2) - cost(1)) (K - 1)``: FLOPs, bytes, kernel launches,
collective calls and bytes and the saved bytes all grow by layer.  The
probes are what runs: a cell passes when both do.  The JSON keys are the
JAX dry run's: ``hlo_flops_per_device`` and ``hlo_bytes_per_device``
hold the counted FLOPs and bytes, the kernels' included, ``lower_s``
the seconds to build the probes' steps and inputs, ``compile_s`` 0
(nothing compiles), ``probe_s`` the probes' runs; the port adds
``kernel_flops_per_device``, ``kernel_bytes_per_device``, ``kernels``
(launches by kernel), ``collective_calls`` (by ``"axis/kind"``) and
``attn_impl``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, canonical, get_config
from repro_torch.models import ModelConfig, decode_step, forward
from repro_torch.models.config import SHAPES
from repro_torch.models.lm import init_decode_state
from repro_torch.models.sharding import MeshRules
from repro_torch.optim import AdamWConfig
from repro_torch.train.train_step import TrainConfig, make_train_step
from repro_torch.tree import leaves

from . import specs as S
from .collective_log import collective_bytes, collective_seconds
from .mesh import COLLECTIVES, HW, make_production_mesh

FLASH_BLOCK = 256          # kernels/flash_attention.BLOCK
FLASH_HD_MAX = 128         # kernels/flash_attention.HD_MAX


# ------------------------------------------------ the kernels' formulas --

def causal_pairs(S_: int, T: int) -> int:
    """The (row, col) pairs with col <= row of an (S, T) score matrix."""
    if T >= S_:
        return S_ * (S_ + 1) // 2
    return T * (T + 1) // 2 + (S_ - T) * T


def rmsnorm_cost(rows: int, D: int, itemsize: int) -> Dict[str, float]:
    """RMSNorm over (rows, D): x read and y written once, the f32 scale
    read; four operations an element."""
    return {"flops": 4.0 * rows * D,
            "bytes": 2.0 * rows * D * itemsize + 4.0 * D}


def flash_cost(kernel: str, BH: int, S_: int, T: int, hd: int, hdv: int,
               itemsize: int, causal: bool) -> Dict[str, float]:
    """One flash kernel (``"fwd"``, ``"dq"`` or ``"dkv"``) over (BH, S, hd)
    q, (BH, T, hd) k and (BH, T, hdv) v: two operations a multiply-add of
    each product it forms over the unmasked pairs (forward: q k^T and p v;
    dq: q k^T, do v^T, ds k; dk/dv: q k^T, do v^T, p^T do, ds^T q); each
    input read and each output written once (lse and delta in f32)."""
    pairs = causal_pairs(S_, T) if causal else S_ * T
    qb, kb, vb = BH * S_ * hd, BH * T * hd, BH * T * hdv
    ob = BH * S_ * hdv
    stats = 4.0 * BH * S_
    if kernel == "fwd":
        return {"flops": 2.0 * BH * pairs * (hd + hdv),
                "bytes": (qb + kb + vb + ob) * itemsize + stats}
    inputs = (qb + kb + vb + ob) * itemsize + 2 * stats
    if kernel == "dq":
        return {"flops": 2.0 * BH * pairs * (2 * hd + hdv),
                "bytes": inputs + qb * itemsize}
    return {"flops": 2.0 * BH * pairs * (2 * hd + 2 * hdv),
            "bytes": inputs + (kb + vb) * itemsize}


class KernelTally:
    """The hand-written kernels a dry run launched: calls, FLOPs and bytes
    by kernel, priced by their formulas."""

    def __init__(self):
        self.launches: Dict[str, int] = {}
        self.flops = 0.0
        self.bytes = 0.0

    def add(self, name: str, cost: Dict[str, float]) -> None:
        self.launches[name] = self.launches.get(name, 0) + 1
        self.flops += cost["flops"]
        self.bytes += cost["bytes"]


@contextlib.contextmanager
def priced_kernels(tally: KernelTally):
    """Stand in for the LM's hand-written kernels on ``meta`` tensors:
    RMSNorm and the flash forward and backward make outputs of their
    kernels' shapes and add their formulas to ``tally``; the flash
    kernels first check the shapes as the card does.  Tensors on other
    devices take their usual route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, rmsnorm as rn
    saved = [(rn, "on_card", rn.on_card), (rn, "rmsnorm_cuda",
                                           rn.rmsnorm_cuda),
             (fa, "on_card", fa.on_card), (fa, "flash_fwd_cuda",
                                           fa.flash_fwd_cuda),
             (ops, "_on_card", ops._on_card), (ops, "flash_bwd_cuda",
                                               ops.flash_bwd_cuda)]

    def meta_or(real):
        return lambda t, name: t.device.type == "meta" or real(t, name)

    real = {name: fn for _, name, fn in saved}

    def rmsnorm(x, scale, eps=1e-6):
        if x.device.type != "meta":
            return real["rmsnorm_cuda"](x, scale, eps)
        tally.add("rmsnorm", rmsnorm_cost(x.numel() // x.shape[-1],
                                          x.shape[-1], x.element_size()))
        return torch.empty_like(x)

    def flash_fwd(q, k, v, causal=True, scale=None):
        if q.device.type != "meta":
            return real["flash_fwd_cuda"](q, k, v, causal, scale)
        BH, S_, T, hd, hdv = fa.check_shapes(q, k, v)
        tally.add("flash_fwd", flash_cost("fwd", BH, S_, T, hd, hdv,
                                          q.element_size(), causal))
        return (q.new_empty((BH, S_, hdv)),
                q.new_empty((BH, S_), dtype=torch.float32))

    def flash_bwd(q, k, v, do, lse, delta, causal=True, scale=None):
        if q.device.type != "meta":
            return real["flash_bwd_cuda"](q, k, v, do, lse, delta, causal,
                                          scale)
        BH, S_, T, hd, hdv = fa.check_shapes(q, k, v)
        for w in ("dq", "dkv"):
            tally.add(f"flash_bwd_{w}", flash_cost(
                w, BH, S_, T, hd, hdv, q.element_size(), causal))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    rn.on_card, rn.rmsnorm_cuda = meta_or(rn.on_card), rmsnorm
    fa.on_card, fa.flash_fwd_cuda = meta_or(fa.on_card), flash_fwd
    ops._on_card, ops.flash_bwd_cuda = meta_or(ops._on_card), flash_bwd
    try:
        yield tally
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ------------------------------------------------ bytes and saved bytes --

_FACTORIES = {"empty", "empty_like", "new_empty", "empty_strided",
              "new_empty_strided"}


def _nbytes(x) -> int:
    return (x.numel() * x.element_size()
            if isinstance(x, torch.Tensor) else 0)


class ByteCounter(TorchDispatchMode):
    """Bytes read and written by every dispatched op: its tensor inputs
    plus its tensor outputs.  A pure view (an output aliasing an input,
    not written) and an allocation move nothing and are left out."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        views = [r.alias_info is not None and not r.alias_info.is_write
                 for r in func._schema.returns]
        if name not in _FACTORIES and not (views and all(views)):
            flat = list(args) + list(kwargs.values())
            flat = [y for x in flat
                    for y in (x if isinstance(x, (list, tuple)) else (x,))]
            outs = out if isinstance(out, (list, tuple)) else (out,)
            self.bytes += sum(map(_nbytes, flat)) + sum(map(_nbytes, outs))
        return out


@contextlib.contextmanager
def saved_bytes():
    """Count the bytes of every tensor saved for backward in the block;
    yields a one-entry list holding the total."""
    total = [0]

    def pack(t):
        total[0] += _nbytes(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        yield total


# ------------------------------------------------------------ the cells --

def cell_supported(cfg: ModelConfig, shape_name: str):
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 512k-KV decode is "
                       "quadratic-history; skipped per assignment")
    return True, ""


def production_cfg(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """``cfg`` as the card runs it: causal attention through the flash
    kernel where it takes every causal sequence of the cell (a multiple
    of min(256, S), head dims at most 128), else the plain attention."""
    shape = SHAPES[shape_name]
    seqs = [shape.seq_len] + ([cfg.encoder_seq] if cfg.encoder_layers
                              else [])
    ok = (all(n % min(FLASH_BLOCK, n) == 0 for n in seqs)
          and cfg.head_dim <= FLASH_HD_MAX)
    return dataclasses.replace(cfg, attn_impl="flash" if ok else "naive")


def build_step(cfg: ModelConfig, shape, rules: MeshRules,
               microbatches: int = 1, device="meta"):
    """``(fn, args, arg_specs)`` for one rank's step of the cell (``shape``
    a name of ``SHAPES`` or a ``ShapeConfig``): args on ``device``,
    uninitialised (the training step takes the global batch and picks
    the rank's rows, as on the card; prefill takes the rank's rows;
    decode the rank's state chunks and the global tokens), arg_specs the
    ``launch.specs`` trees they come from."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    pspecs = S.param_specs(cfg, rules)
    params = S.local_tree(pspecs, device)
    if shape.kind == "train":
        tcfg = TrainConfig(microbatches=microbatches)
        step = make_train_step(cfg, AdamWConfig(), tcfg, rules)
        ospecs = S.opt_specs(cfg, rules)
        opt = S.local_tree(ospecs, device)
        opt["step"] = torch.zeros((), dtype=torch.int32)   # on the host
        bspecs = S.batch_specs(cfg, shape, rules)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in bspecs.items()}
        return step, (params, opt, batch), (pspecs, ospecs, bspecs)
    if shape.kind == "prefill":
        bspecs = S.batch_specs(cfg, shape, rules)
        batch = {k: torch.zeros(v.chunk, dtype=v.dtype, device=device)
                 for k, v in bspecs.items()}

        def prefill(params, batch):
            with torch.no_grad():
                return forward(params, cfg, batch["tokens"],
                               positions=batch.get("positions"),
                               audio_embed=batch.get("audio_embed"),
                               rules=rules)
        return prefill, (params, batch), (pspecs, bspecs)
    sspecs = S.decode_state_specs(cfg, shape, rules)
    tspecs = S.decode_token_specs(shape, rules)
    state = init_decode_state(cfg, shape.global_batch, shape.seq_len,
                              device=device, rules=rules,
                              with_encoder=bool(cfg.encoder_layers))

    def serve(params, state, tokens):
        with torch.no_grad():
            return decode_step(params, cfg, state, tokens, rules=rules)
    tokens = torch.zeros(tspecs.shape, dtype=tspecs.dtype, device=device)
    return serve, (params, state, tokens), (pspecs, sspecs, tspecs)


def _out_bytes(out) -> int:
    return sum(_nbytes(t) for t in leaves(out))


def probe_cfg(cfg: ModelConfig, k: int) -> ModelConfig:
    """``cfg`` cut to ``k`` periods of its pattern (and ``k`` encoder
    layers): the depth of a two-point probe."""
    repl = {"n_layers": k * len(cfg.pattern)}
    if cfg.encoder_layers:
        repl["encoder_layers"] = k
    return dataclasses.replace(cfg, **repl)


def measure(cfg: ModelConfig, shape, rules: MeshRules,
            microbatches: int = 1) -> dict:
    """One rank's step of the cell run on ``meta`` under the counters:
    ``{"build_s", "run_s", "costs"}``, the costs a flat dict of FLOPs,
    bytes, kernels, collectives and saved / output bytes."""
    t0 = time.perf_counter()
    fn, args, _ = build_step(cfg, shape, rules, microbatches)
    t1 = time.perf_counter()
    COLLECTIVES.reset()
    tally, counter = KernelTally(), ByteCounter()
    with priced_kernels(tally), saved_bytes() as saved, \
            FlopCounterMode(display=False) as flop_mode, counter:
        out = fn(*args)
    t2 = time.perf_counter()
    costs = {("flops",): float(flop_mode.get_total_flops()),
             ("bytes",): float(counter.bytes),
             ("kernel_flops",): tally.flops, ("kernel_bytes",): tally.bytes,
             ("temp_bytes",): float(saved[0]),
             ("output_bytes",): float(_out_bytes(out))}
    costs.update({("kernel", k): float(n) for k, n in tally.launches.items()})
    costs.update({("coll", p): float(b)
                  for p, b in collective_bytes().items()})
    costs.update({("calls", a, k): float(n)
                  for (a, k), n in COLLECTIVES.calls.items()})
    costs.update({("axis", a, p): float(b)
                  for (a, p), b in COLLECTIVES.axis_bytes.items()})
    return {"build_s": t1 - t0, "run_s": t2 - t1, "costs": costs}


def extrapolated_costs(cfg: ModelConfig, shape_name: str, rules: MeshRules,
                       microbatches: int = 1) -> dict:
    """Every cost of the full-depth step from probes at 1 and 2 periods:
    ``cost(k) = a + b k``, taken to ``cfg.n_periods`` (the JAX dry run's
    two-point probe; exact for what grows by layer, which every counted
    cost here does).  Also ``build_s`` and ``probe_s``, the probes'
    seconds."""
    if cfg.encoder_layers and cfg.encoder_layers != cfg.n_periods:
        raise ValueError(f"{cfg.name}: the probes scale the encoder with "
                         f"the periods, but {cfg.encoder_layers} encoder "
                         f"layers != {cfg.n_periods} periods")
    p1 = measure(probe_cfg(cfg, 1), shape_name, rules, microbatches)
    p2 = measure(probe_cfg(cfg, 2), shape_name, rules, microbatches)
    K = cfg.n_periods
    c1, c2 = p1["costs"], p2["costs"]
    costs = {key: c1.get(key, 0.0) + (c2.get(key, 0.0) - c1.get(key, 0.0))
             * (K - 1) for key in set(c1) | set(c2)}
    return {"costs": costs, "build_s": p1["build_s"] + p2["build_s"],
            "probe_s": p1["run_s"] + p2["run_s"]}


def _pick(costs: dict, tag: str) -> dict:
    """The costs under ``tag`` as ``{rest of key: value}``, integers
    where whole."""
    out = {}
    for key, v in sorted(costs.items(), key=str):
        if key[0] == tag and v:
            out[key[1] if len(key) == 2 else key[1:]] = (
                int(round(v)) if abs(v - round(v)) < 1e-6 else v)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             microbatches: int = 1, extra: Optional[dict] = None) -> dict:
    """One cell's result (the JAX dry run's keys; module docstring)."""
    cfg = get_config(arch)
    if extra:
        cfg = dataclasses.replace(cfg, **extra)
    ok, why = cell_supported(cfg, shape_name)
    result = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        result.update(status="skipped", reason=why)
        return result
    cfg = production_cfg(cfg, shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = MeshRules(mesh)
    n_chips = mesh.size
    shape = SHAPES[shape_name]

    ex = extrapolated_costs(cfg, shape_name, rules, microbatches)
    costs = ex["costs"]
    kflops, kbytes = costs[("kernel_flops",)], costs[("kernel_bytes",)]
    flops = costs[("flops",)] + kflops
    nbytes = costs[("bytes",)] + kbytes
    coll = _pick(costs, "coll")
    n_tok = (shape.global_batch * shape.seq_len
             if shape.kind in ("train", "prefill") else shape.global_batch)
    n_act = cfg.active_param_count()
    model_flops = (6 if shape.kind == "train" else 2) * n_act * n_tok
    if shape.kind == "train":
        arg_specs = (S.param_specs(cfg, rules), S.opt_specs(cfg, rules),
                     S.batch_specs(cfg, shape, rules))
    elif shape.kind == "prefill":
        arg_specs = (S.param_specs(cfg, rules),
                     S.batch_specs(cfg, shape, rules))
    else:
        arg_specs = (S.param_specs(cfg, rules),
                     S.decode_state_specs(cfg, shape, rules),
                     S.decode_token_specs(shape, rules))
    result.update({
        "status": "ok",
        "lower_s": round(ex["build_s"], 1),
        "compile_s": 0.0,
        "probe_s": round(ex["probe_s"], 1),
        "n_chips": int(n_chips),
        "attn_impl": cfg.attn_impl,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": nbytes,
        "kernel_flops_per_device": kflops,
        "kernel_bytes_per_device": kbytes,
        "kernels": _pick(costs, "kernel"),
        "collective_bytes": coll,
        "collective_bytes_total": float(sum(coll.values())),
        "collective_calls": {f"{a}/{k}": n for (a, k), n in
                             _pick(costs, "calls").items()},
        "t_compute": flops / HW["peak_flops_bf16"],
        "t_memory": nbytes / HW["hbm_bw"],
        "t_collective": collective_seconds(mesh.shape,
                                           _pick(costs, "axis")),
        "params": cfg.param_count(),
        "active_params": n_act,
        "model_flops_total": model_flops,
        "model_flops_per_device": model_flops / n_chips,
        "useful_flop_ratio": (model_flops / n_chips) / max(flops, 1.0),
    })
    terms = {k: result[k] for k in ("t_compute", "t_memory",
                                    "t_collective")}
    result["bottleneck"] = max(terms, key=terms.get)
    result["roofline_fraction"] = result["t_compute"] / max(
        sum(terms.values()), 1e-30)
    result["memory_analysis"] = {
        "argument_bytes": sum(S.chunk_bytes(t) for t in arg_specs),
        "output_bytes": int(costs[("output_bytes",)]),
        "temp_bytes": int(costs[("temp_bytes",)]),
        "generated_code_bytes": 0,
    }
    return result


def cells(all_cells: bool, arch: Optional[str], shape: Optional[str]):
    """The (arch, shape) pairs a command line asks for."""
    if all_cells:
        return [(a, s) for a in ARCHS for s in SHAPES]
    if not (arch and shape):
        raise SystemExit("give --arch and --shape, or --all")
    return [(canonical(arch), shape)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    mesh = "2x16x16" if args.multi_pod else "16x16"
    results = []
    for arch, shape in cells(args.all, args.arch, args.shape):
        print(f"=== dry-run {arch} x {shape} ({mesh}) ===", flush=True)
        try:
            r = run_cell(arch, shape, args.multi_pod, args.microbatches)
        except Exception as e:  # a failure here is a fault of the plan
            r = {"arch": arch, "shape": shape, "mesh": mesh,
                 "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
        results.append(r)
        print(json.dumps(r, indent=1, default=str), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    n_bad = sum(1 for r in results if r["status"] == "FAILED")
    print(f"\n{len(results)} cells: "
          f"{sum(1 for r in results if r['status'] == 'ok')} ok, "
          f"{sum(1 for r in results if r['status'] == 'skipped')} skipped, "
          f"{n_bad} FAILED")
    return 1 if n_bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
