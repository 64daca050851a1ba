"""LM training from the command line (the counterpart of
``repro/launch/train.py``); runs on the CUDA card unless ``--device cpu``
is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --batch 4 --seq 2048 --microbatches 2 --steps 6 --lr 3e-5

Random weights from ``--seed``, the deterministic ``TokenPipeline``,
AdamW (warmup over the first 5% of ``--steps``, cosine decay to the
end), microbatched gradient accumulation, async checkpoints with
preemption-safe resume (``--ckpt-dir``), loss logging.  ``--reduced``
takes the config's smoke-test widths without remat, as the JAX driver
does.  The deferred gradient sync (``--defer-s``) and a device mesh
(``--mesh``) exist only across devices and raise (ROADMAP A11b).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.train import (CheckpointManager, TrainConfig,
                               init_train_state, make_train_step)
from repro_torch.tree import leaves


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
                    help=">0: the s-step deferred-allreduce trainer "
                         "(not ported: ROADMAP A11b)")
    ap.add_argument("--mesh", default="1x1",
                    help="data x model mesh (only 1x1 runs: ROADMAP A11b)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-impl", choices=("naive", "flash"),
                    default="flash")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)

    if args.defer_s > 0:
        raise NotImplementedError("--defer-s: the s-step deferred-allreduce "
                                  "trainer exists only across devices and "
                                  "is not ported yet (ROADMAP A11b)")
    if args.mesh != "1x1":
        raise NotImplementedError(f"--mesh {args.mesh}: device meshes are "
                                  f"not ported yet (ROADMAP A11b)")
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_config(args.arch, reduced=args.reduced),
                              attn_impl=args.attn_impl)
    if args.reduced:
        cfg = dataclasses.replace(cfg, remat="none")
    acfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps)
    step_fn = make_train_step(cfg, acfg,
                              TrainConfig(microbatches=args.microbatches))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params, opt = init_train_state(gen, cfg, acfg, device=dev)
    n_params = sum(t.numel() for t in leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={dev} "
          f"attn_impl={cfg.attn_impl} remat={cfg.remat} dtype={cfg.dtype}")

    start, mgr = 0, None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep_last=2,
                                save_every=args.ckpt_every)
        restored, meta = mgr.restore_latest(
            template={"params": params, "opt": opt})
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = meta["step"]
            print(f"resumed from step {start}")

    t0 = time.perf_counter()
    losses = []
    for s in range(start, args.steps):
        params, opt, metrics = step_fn(params, opt, pipe.batch(s))
        losses.append(float(metrics["loss"]))
        if (s + 1) % args.log_every == 0:
            dt = (time.perf_counter() - t0) / max(s + 1 - start, 1)
            print(f"step {s + 1} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} {dt * 1e3:.0f} ms/step",
                  flush=True)
        if mgr and mgr.should_save(s + 1):
            mgr.save_async(s + 1, {"params": params, "opt": opt})
    if mgr:
        mgr.save_async(args.steps, {"params": params, "opt": opt})
        mgr.wait()
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
