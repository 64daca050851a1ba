"""Continuous-batching serving engine (the counterpart of
``repro/train/serving.py``, with the same slot admission, prompt cursor,
retirement and slot reset).

A fixed-shape decode step runs over a matrix of slots; requests stream in
and out of slots between steps:

  * admit: a free slot gets the next pending request; its prompt is
    teacher-forced through the same decode step (no separate prefill);
  * step: one batched decode for all slots;
  * retire: a slot whose request hit its token budget, EOS or the end of
    the cache frees up.

Every cache is slot-indexed, so an admission only zeroes its slot: the
attention caches of every layer and of every application of a shared
block, a Mamba layer's conv state and h, and an encoder-decoder's
cross-attention keys and values (``cross_kv``).  A stale attention row is
masked by ``pos`` anyway, but a Mamba h left unzeroed would carry the
slot's previous request into the next one.
An encoder-decoder config (Whisper) gets a state with ``cross_kv``
(``init_decode_state(with_encoder=True)``), as the JAX engine builds
it; nothing fills it, so every request attends over zeros, as in the
reference (ROADMAP C).
The next-token ids come back to the host once per step (as the JAX
engine's ``device_get``); the tokens fed to the next step go up in one
copy.

With ``rules`` the engine holds this rank's chunks of a sharded decode
state (``init_decode_state(rules=)``) and every rank runs the same
engine: the same admissions, the same global tokens into
``decode_step(rules=)``.  A slot's caches are zeroed on the data rank
that holds its row (on every rank where the batch is not split), and
one gather of the step's next tokens over ``data``
(``sharding.gather_rows``, kind ``"token"``) gives every rank every
slot's token, so admission and completion stay the same on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.models import ModelConfig, decode_step, init_decode_state
from repro_torch.models.sharding import batch_rows, gather_rows


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, params: dict, cfg: ModelConfig, n_slots: int = 4,
                 max_seq: int = 128, eos_id: Optional[int] = None,
                 rules=None):
        self.params = params
        self.cfg = cfg
        self.rules = rules
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.device = params["embed"]["table"].device
        self.state = init_decode_state(cfg, n_slots, max_seq,
                                       device=self.device, rules=rules,
                                       with_encoder=bool(cfg.encoder_layers))
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.pending: List[Request] = []
        # per-slot cursor into the prompt (-1 = generating)
        self._prompt_pos = [0] * n_slots
        self._tokens = [0] * n_slots          # the next step's input ids

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.pending.append(req)

    def _reset_slot_state(self, i: int):
        """Zero the caches of slot i (``caches``, ``shared_cache`` and
        ``cross_kv``, every leaf, as the JAX engine zeroes every
        slot-indexed leaf) and its position (in place: the engine owns its
        state); with ``rules`` the caches' row of slot i where this rank
        holds it."""
        rows = batch_rows(self.rules, self.n_slots)
        if rows.start <= i < rows.stop:
            for key in ("caches", "shared_cache", "cross_kv"):
                for pair in self.state.get(key, ()):
                    for c in pair:
                        c[i - rows.start].zero_()
        self.state["pos"][i] = 0

    def _admit(self):
        for i in range(self.n_slots):
            if self.slots[i] is None and self.pending:
                req = self.pending.pop(0)
                self.slots[i] = req
                self._reset_slot_state(i)
                self._prompt_pos[i] = 0
                self._tokens[i] = req.prompt[0]

    def step(self) -> Dict[int, int]:
        """One engine step.  Returns {rid: emitted_token} for slots that
        produced a NEW (non-prompt) token this step."""
        self._admit()
        if all(s is None for s in self.slots):
            return {}
        tokens = torch.tensor(self._tokens, dtype=torch.int64)[:, None]
        logits, self.state = decode_step(self.params, self.cfg, self.state,
                                         tokens.to(self.device),
                                         rules=self.rules)
        nxt = gather_rows(self.rules, logits.argmax(-1), self.n_slots)
        nxt_host = nxt.tolist()
        pos_host = self.state["pos"].tolist()
        emitted = {}
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            pp = self._prompt_pos[i]
            if pp >= 0 and pp + 1 < len(req.prompt):
                # still teacher-forcing the prompt
                self._prompt_pos[i] = pp + 1
                self._tokens[i] = req.prompt[pp + 1]
                continue
            self._prompt_pos[i] = -1
            tok = int(nxt_host[i])
            req.generated.append(tok)
            emitted[req.rid] = tok
            self._tokens[i] = tok
            if (len(req.generated) >= req.max_new_tokens
                    or (self.eos_id is not None and tok == self.eos_id)
                    or pos_host[i] >= self.max_seq - 1):
                req.done = True
                self.slots[i] = None
        return emitted

    def run_until_done(self, max_steps: int = 10000) -> int:
        """Step until no request is pending or in a slot; returns the
        number of steps taken."""
        for n in range(max_steps):
            if not self.pending and all(s is None for s in self.slots):
                return n
            self.step()
        return max_steps
