"""LM training from the command line (the counterpart of
``repro/launch/train.py``); runs on the CUDA card unless ``--device cpu``
is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --batch 4 --seq 2048 --microbatches 2 --steps 6 --lr 3e-5
    # the MoE family: DeepSeek-V2-Lite (MLA + MoE), Arctic (MoE + dense
    # residual), on one device or a --mesh (MLA's heads split over model,
    # the experts over model: expert-parallel)
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch arctic-480b --reduced --device cpu --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch deepseek-v2-lite-16b --reduced --device cpu --mesh 2x2
    # the SSM family (Mamba blocks tensor-parallel over their channels or
    # heads, Zamba2's shared block as the dense block) and M-RoPE, on one
    # device or a --mesh
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch zamba2-1.2b --reduced --device cpu --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch falcon-mamba-7b --reduced --device cpu --mesh 2x2
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen2-vl-72b --reduced --device cpu --mesh 1x2
    # the s-step deferred sync on a 2 x 2 mesh of CPU ranks (gloo)
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --reduced --device cpu --mesh 2x2 --defer-s 2 --microbatches 4

Random weights from ``--seed``, the deterministic ``TokenPipeline``,
AdamW (warmup over the first 5% of ``--steps``, cosine decay to the
end), microbatched gradient accumulation, async checkpoints with
preemption-safe resume (``--ckpt-dir``), loss logging.  ``--reduced``
takes the config's smoke-test widths without remat, as the JAX driver
does.

``--mesh DxM`` other than 1x1 runs under ``torchrun`` with D x M ranks,
one process each (NCCL when the host has a card for each of its ranks,
gloo when ranks share a card or run on the CPU): the FSDP + TP step
(``make_train_step(rules=)``), or with ``--defer-s S`` the s-step
deferred-sync step, one gradient sync over ``data`` every S
microbatches (``make_defer_train_step``).  Every rank draws the same
full params from ``--seed`` and keeps its shards; rank 0 logs.
Checkpoints hold the full leaves, gathered to rank 0 (the format of the
single-device run), and a resume re-shards them onto whatever mesh it
runs on.  Every config trains on a mesh as on one device:
falcon-mamba-7b and zamba2-1.2b with their Mamba blocks tensor-parallel,
qwen2-vl-72b with the default position streams (t, t, t), as the JAX
training CLI feeds it.  whisper-tiny is refused before the first
step, on one device or a mesh: the token pipeline gives no frames for
its encoder, and the JAX training CLI, which feeds tokens only, fails
there too (ROADMAP C32).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.solve import process_backend
from repro_torch.models.lm import abstract_params, param_specs
from repro_torch.models.sharding import (MeshRules, gather_tree,
                                         shard_tree)
from repro_torch.optim import AdamWConfig
from repro_torch.train import (CheckpointManager, TrainConfig,
                               init_train_state, make_defer_train_step,
                               make_train_step)
from repro_torch.train.checkpoint import available_steps, load_checkpoint
from repro_torch.train.train_step import defer_rules
from repro_torch.tree import leaves, leaves_with_paths, map_tree, unflatten


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's smoke-test widths, no remat")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--defer-s", type=int, default=0,
                    help=">0: the s-step deferred-sync trainer (needs a "
                         "multi-rank --mesh)")
    ap.add_argument("--mesh", default="1x1",
                    help="data x model mesh, e.g. 2x2 (under torchrun)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-impl", choices=("naive", "flash"),
                    default="flash")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)

    d, m = (int(x) for x in args.mesh.split("x"))
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the training CLI feeds tokens only "
            f"(TokenPipeline), as the JAX training CLI does, and the "
            f"encoder needs its frames (audio_embed); train it through "
            f"make_train_step with batches that hold them")
    if args.defer_s > 0 and d * m == 1:
        raise ValueError("--defer-s needs a multi-rank mesh (--mesh DxM "
                         "under torchrun)")
    dev = resolve_device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        backend = process_backend(dev)
        if backend == "nccl":
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="env://")
    try:
        return _train(args, dev, d, m)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, dev, d: int, m: int):
    rules = MeshRules(make_mesh(d, m)) if d * m > 1 else None
    rank0 = rules is None or rules.mesh.rank == 0
    cfg = dataclasses.replace(get_config(args.arch, reduced=args.reduced),
                              attn_impl=args.attn_impl)
    if args.reduced:
        cfg = dataclasses.replace(cfg, remat="none")
    acfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps)
    tcfg = TrainConfig(microbatches=args.microbatches,
                       defer_s=max(args.defer_s, 1))
    if args.defer_s > 0:
        step_fn = make_defer_train_step(cfg, acfg, tcfg, rules)
        state_rules = defer_rules(rules)
    else:
        step_fn = make_train_step(cfg, acfg, tcfg, rules)
        state_rules = rules
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params, opt = init_train_state(gen, cfg, acfg, device=dev,
                                   rules=state_rules)
    n_params = sum(t.numel() for t in leaves(abstract_params(cfg)))
    if rank0:
        print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={dev} "
              f"mesh={d}x{m} defer_s={args.defer_s} "
              f"attn_impl={cfg.attn_impl} remat={cfg.remat} "
              f"dtype={cfg.dtype}", flush=True)

    start, mgr = 0, None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep_last=2,
                                save_every=args.ckpt_every)
        params, opt, start = _restore(mgr, params, opt, cfg, state_rules)
        if start and rank0:
            print(f"resumed from step {start}", flush=True)

    t0 = time.perf_counter()
    losses = []
    for s in range(start, args.steps):
        params, opt, metrics = step_fn(params, opt, pipe.batch(s))
        losses.append(float(metrics["loss"]))
        if (s + 1) % args.log_every == 0 and rank0:
            dt = (time.perf_counter() - t0) / max(s + 1 - start, 1)
            print(f"step {s + 1} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} {dt * 1e3:.0f} ms/step",
                  flush=True)
        if mgr and mgr.should_save(s + 1):
            _save(mgr, s + 1, params, opt, cfg, state_rules)
    if mgr:
        _save(mgr, args.steps, params, opt, cfg, state_rules)
        mgr.wait()
    if losses and rank0:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


def _full_state(params, opt, cfg, rules):
    """The full params and AdamW state (gathered over the mesh when
    ``rules``; collective)."""
    if rules is None:
        return {"params": params, "opt": opt}
    specs = param_specs(rules, cfg)
    return {"params": gather_tree(rules, params, specs),
            "opt": {"m": gather_tree(rules, opt["m"], specs),
                    "v": gather_tree(rules, opt["v"], specs),
                    "step": opt["step"]}}


def _save(mgr, step, params, opt, cfg, rules) -> None:
    """Save the full state from rank 0 (every rank gathers)."""
    state = _full_state(params, opt, cfg, rules)
    if rules is None or rules.mesh.rank == 0:
        mgr.save_async(step, state)


def _restore(mgr, params, opt, cfg, rules):
    """``(params, opt, step)`` from the latest checkpoint (with ``rules``
    each rank its shards of the full leaves saved, placed by path into
    the tree of ``params`` and ``opt``, whatever order the saving run
    held its leaves in), or the inputs and 0."""
    if rules is None:
        restored, meta = mgr.restore_latest(
            template={"params": params, "opt": opt})
        if restored is None:
            return params, opt, 0
        return restored["params"], restored["opt"], meta["step"]
    step = 0
    if available_steps(mgr.directory):
        arrs, meta = load_checkpoint(mgr.directory)
        saved = dict(zip(meta["paths"], arrs))
        tree = {"params": params, "opt": opt}
        state = unflatten(tree, [saved["/".join(map(str, path))]
                                 for path, _ in leaves_with_paths(tree)])
        specs = param_specs(rules, cfg)
        dev = leaves(params)[0].device

        def shards(tree):
            return map_tree(lambda t: t.to(dev),
                            shard_tree(rules, tree, specs))

        params = shards(state["params"])
        opt = {"m": shards(state["opt"]["m"]),
               "v": shards(state["opt"]["v"]),
               "step": state["opt"]["step"]}
        step = meta["step"]
    # no rank reads while rank 0 may write or collect old checkpoints
    dist.barrier()
    return params, opt, step


if __name__ == "__main__":
    main()
