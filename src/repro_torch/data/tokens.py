"""Deterministic synthetic token pipeline for LM training (the counterpart
of ``repro/data/tokens.py``).

Batch ``k`` is a pure function of ``(seed, k)``: its generator is a
numpy ``SeedSequence([seed, k])``, so any worker can rebuild any batch
and a restart needs no loader state in the checkpoint.  The corpus is
the JAX package's: Zipfian unigram draws (logits ``-1.1 log rank``), and
for a random half of the rows the second half repeats the first (a
learnable copy pattern, so the loss falls).  The numbers differ from the
JAX PRNG's; the parity tests feed both packages the JAX batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def _zipf_probs(self) -> np.ndarray:
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        logits = -1.1 * np.log(ranks)
        p = np.exp(logits - logits.max())
        return p / p.sum()

    def batch(self, step: int) -> dict:
        """Host-side global batch for step ``step``: ``tokens`` and
        ``labels`` (tokens shifted by one), int64 (B, S) CPU tensors.  The
        train step moves them to the params' device."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, int(step)]))
        B, S = self.global_batch, self.seq_len
        toks = rng.choice(self.vocab_size, size=(B, S + 1),
                          p=self._zipf_probs())
        half = (S + 1) // 2
        copy_rows = rng.random((B, 1)) < 0.5
        copied = np.concatenate([toks[:, :half], toks[:, :S + 1 - half]],
                                axis=1)
        toks = torch.from_numpy(np.where(copy_rows, copied, toks))
        return {"tokens": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous()}
