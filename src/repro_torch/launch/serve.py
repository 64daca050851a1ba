"""LM serving from the command line: a prefill forward and batched greedy
decoding with KV caches, the counterpart of ``examples/lm_serve.py``;
runs on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --reduced --device cpu --attn-impl naive
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch falcon-mamba-7b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-tiny --attn-impl naive
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-vl-72b --reduced --device cpu

Random weights from ``--seed`` (no checkpoint is in the repository).  The
prompts go once through ``forward`` (the prefill, timed; with
``--attn-impl flash`` through the flash kernel) and then token by token
through the decode step, which generates ``--new-tokens`` more.  Dense
GQA configs (qwen3-1.7b, yi-6b, granite-20b, llama3-405b), the MoE
family: deepseek-v2-lite-16b (MLA, whose attention ignores
``--attn-impl``; 64.8 GB of f32 params, one 80 GB card) and
arctic-480b (``--reduced`` only on one card), and the SSM family run:
falcon-mamba-7b (Mamba-1, attention-free; 28.0 GB of f32 params) and
zamba2-1.2b (Mamba-2 with the shared attention block), and
qwen2-vl-72b (M-RoPE, with the three position streams equal, as the
JAX CLI feeds them; ``--reduced`` only on one card: 288 GB of f32
params).  whisper-tiny (the encoder-decoder stack) draws its
``encoder_seq`` frame embeddings from ``--seed`` too: the prefill
forward takes them, the decode runs on the cross-attention keys and
values ``prefill_cross_kv`` computes from them, and a ``ServingEngine``
then answers one request a prompt (its cross-attention state left at
zero, as the JAX engine leaves it).  At its published 1500 frames
whisper-tiny needs ``--attn-impl naive``: flash takes lengths that are
multiples of 256 only, and refuses 1500 as the JAX kernel does.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import (forward, init_decode_state, init_params,
                                prefill_cross_kv)
from repro_torch.train import Request, ServingEngine, greedy_generate


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's smoke-test widths")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--attn-impl", choices=("naive", "flash"),
                    default="flash")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_config(args.arch, reduced=args.reduced),
                              attn_impl=args.attn_impl)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(gen, cfg, device=dev)
    B, P = args.batch, args.prompt_len
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    frames = None
    if cfg.encoder_layers:
        frames = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                             generator=gen, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits = forward(params, cfg, prompt, audio_embed=frames)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    max_seq = P + args.new_tokens + 1
    state = init_decode_state(cfg, B, max_seq, device=dev,
                              with_encoder=frames is not None)
    t0 = time.perf_counter()
    if frames is not None:
        state["cross_kv"] = prefill_cross_kv(params, cfg, frames)
    out, state = greedy_generate(
        params, cfg, state, prompt, args.new_tokens,
        temperature=args.temperature,
        generator=gen if args.temperature > 0 else None)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    steps = P + args.new_tokens - 1
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"dtype={cfg.dtype} attn_impl={cfg.attn_impl} device={dev}")
    print(f"prefill: forward of {B} x {P} tokens in {t_prefill * 1e3:.1f} "
          f"ms, logits {tuple(logits.shape)}, finite="
          f"{bool(torch.isfinite(logits).all())}")
    print(f"decode: {steps} steps in {t_decode * 1e3:.1f} ms "
          f"({t_decode / steps * 1e3:.2f} ms a step), cache_pos="
          f"{int(state['pos'][0])}")
    for i in range(B):
        print(f"  req{i}: prompt={prompt[i].tolist()} -> {out[i].tolist()}")
    if out.shape != (B, args.new_tokens) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise SystemExit("generated tokens out of range")
    if frames is not None:
        _engine(params, cfg, prompt, args.new_tokens, max_seq, dev)
    print("ok")


def _engine(params, cfg, prompt, new_tokens: int, max_seq: int,
            dev: torch.device) -> None:
    """One request a prompt through a ``ServingEngine`` of two slots (its
    ``cross_kv`` zero, as in the JAX engine)."""
    reqs = [Request(rid=i, prompt=row.tolist(), max_new_tokens=new_tokens)
            for i, row in enumerate(prompt)]
    eng = ServingEngine(params, cfg, n_slots=2, max_seq=max_seq)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    steps = eng.run_until_done()
    _sync(dev)
    t = time.perf_counter() - t0
    print(f"engine: {len(reqs)} requests on 2 slots in {steps} steps, "
          f"{t * 1e3:.1f} ms (cross-attention over zero keys and values)")
    for r in reqs:
        print(f"  engine req{r.rid}: -> {r.generated}")
    if not all(r.done and len(r.generated) == new_tokens
               and all(0 <= x < cfg.vocab_size for x in r.generated)
               for r in reqs):
        raise SystemExit("the engine did not answer every request")


if __name__ == "__main__":
    main()
