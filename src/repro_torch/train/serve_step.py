"""The serving decode step and a simple generation loop (the counterpart
of ``repro/train/serve_step.py``).

PyTorch runs eagerly, so there is no jit; the step is the decode step
followed by greedy (argmax) or temperature sampling.  Sampling draws from
an explicit ``torch.Generator``.

With ``rules`` the step is sharded decode (``models.lm.decode_step``):
every rank passes the global tokens and gets the global next tokens.
Greedy: each rank takes the argmax of its rows' logits and the tokens
are gathered over ``data`` (``sharding.gather_rows``, one ``"token"``
collective where the batch is split), so ranks along ``model`` (whose
logits are the same) and along ``data`` hold the same tokens.  With
``temperature > 0`` the rows' logits are gathered over ``data`` instead
and every rank, seeding the same generator, draws the next token of
every row of the batch from them: the draws of the unsharded step on
the same logits, the same on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import ModelConfig, decode_step
from repro_torch.models.sharding import gather_rows


def make_serve_step(cfg: ModelConfig, rules=None, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None):
    """(params, state, tokens (B, 1)) -> (next tokens (B, 1), state).
    ``temperature > 0`` samples from ``softmax(logits / temperature)``
    with ``generator``, which must then be given (with ``rules`` every
    rank's generator seeded alike: module docstring)."""
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs an explicit "
                         "torch.Generator")

    def step(params, state, tokens):
        B = tokens.shape[0]
        logits, state = decode_step(params, cfg, state, tokens, rules=rules)
        if temperature > 0.0:
            logits = gather_rows(rules, logits, B)
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = gather_rows(rules, logits.argmax(-1), B)
        return nxt[:, None], state

    return step


def greedy_generate(params, cfg: ModelConfig, state: dict,
                    prompt: torch.Tensor, n_tokens: int, rules=None,
                    temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None):
    """Feed ``prompt`` (B, P) token by token, then generate ``n_tokens``.
    Returns (tokens (B, n_tokens), state)."""
    step = make_serve_step(cfg, rules, temperature, generator)
    B, P = prompt.shape
    tok = prompt[:, :1]
    outs = []
    for t in range(P + n_tokens - 1):
        nxt, state = step(params, state, tok)
        tok = prompt[:, t + 1:t + 2] if t + 1 < P else nxt
        if t + 1 >= P:
            outs.append(tok)
    return (torch.cat(outs, dim=1) if outs else prompt[:, :0]), state
