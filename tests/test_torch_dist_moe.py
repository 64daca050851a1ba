"""The port's sharded MLA / MoE models (``models.sharding.Sharded`` with
MLA's attention tensor-parallel on heads and the experts expert-parallel
on E, ``models.moe``'s expert range, the split latent cache) on the CPU,
held against the JAX package's GSPMD runs of the same functions: reduced
DeepSeek-V2-Lite (MLA, shared experts) and Arctic (GQA, dense residual)
in f32 at (2, 2) and (1, 2):

* the forward's logits, for both ``moe_impl``s (dense, capacity);
* two steps of the FSDP + TP / EP trainer (``make_train_step(rules=)``)
  for both ``moe_impl``s, and two of the s-step deferred trainer
  (``make_defer_train_step``, s = 2, capacity), held as
  ``tests/test_torch_dist_train.py::test_matches_jax`` holds them: the
  losses, AdamW's first moment after step 1 ((1 - b1) times the clipped
  gradient: every gradient leaf) and both moments after step 2 at 1e-4,
  the params after step 2 within 5e-3;
* STEPS decode steps from a random cache (DeepSeek's latent cache split
  over ``model``), logits every step and the final cache chunks at 1e-4;
* bf16: the capacity forward against the port's unsharded bf16 forward
  at 5e-2 on every position before its row's first routing difference
  (ROADMAP C22: the TP-reduced residual stream rounds otherwise, and a
  near-tied pick can flip), most positions held.

Ranks that hold the same chunk of a leaf hold the same bits after each
step, and every step's collectives equal ``step_collectives`` /
``decode_collectives`` exactly.  The processes: ``tests/torch_procs.py``.
"""
import sys

import numpy as np
import pytest
import torch

import torch_procs as tdm

TOL_BF16 = 5e-2


def _decisions(p, cfg, x):
    """(B, S, E) bool: the experts that take each token (the port's own
    routing of its MoE input)."""
    from repro_torch.models import moe
    with torch.no_grad():
        _, top_w, top_idx = moe._route(p, cfg, x)
        routed = moe._routed(top_w, top_idx, cfg.n_experts)
        pri = torch.where(routed > 0, routed, torch.full_like(
            routed, float("-inf"))).transpose(1, 2)
        w, idx = pri.topk(moe.capacity(cfg, x.shape[1]), -1)
        kept = torch.zeros_like(pri, dtype=torch.bool).scatter_(
            -1, idx, torch.isfinite(w))
        return kept.transpose(1, 2).numpy()


def _recording(seen):
    from unittest import mock

    from repro_torch.models import lm
    apply = lm.moe_apply

    def rec(p, c, x, tp=None):
        seen.append(_decisions(p, c, x))
        return apply(p, c, x, tp=tp)

    return mock.patch.object(lm, "moe_apply", rec)


def _bf16_forward(c, inp, rules, rec):
    """On a rank: the bf16 capacity forward of its rows, with its routing
    decisions."""
    from repro_torch import convert
    from repro_torch.models import forward
    from repro_torch.models.sharding import batch_rows
    cfg = tdm.port_cfg(c["arch"], dtype="bfloat16")
    params = convert.lm_shards(inp["params"][c["arch"]], cfg, rules,
                               device="cpu")
    toks = torch.from_numpy(inp["fwd_tokens"])[batch_rows(rules,
                                                          tdm.FWD[0])]
    seen = []
    with _recording(seen), torch.no_grad():
        rec["bf16"] = forward(params, cfg, toks, rules=rules).float().numpy()
    rec["bf16_routes"] = seen


SUITE = tdm.Suite("dist_moe", ("deepseek_v2_lite_16b", "arctic_480b"),
                  ((2, 2), (1, 2)),
                  trainers=(("sharded", "dense"), ("sharded", "capacity"),
                            ("defer", "capacity")),
                  fwd_impls=("dense", "capacity"), extra=_bf16_forward)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    tdm.one_torch_thread)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = tdm.start(SUITE, __file__, tmp_path_factory.mktemp(SUITE.name))
    yield r
    r.kill()                            # nothing outlives the module


@pytest.mark.parametrize("case", SUITE.model_cases(), ids=tdm.tid)
def test_forward_matches_jax_gspmd(runs, case):
    """The sharded forward's logits (each rank its rows), dense and
    capacity dispatch, against JAX's forward(rules=) on its mesh."""
    tdm.check_forward(runs, case)


@pytest.mark.parametrize("case", SUITE.model_cases(), ids=tdm.tid)
def test_decode_matches_jax_gspmd(runs, case):
    """Sharded MLA / MoE decode from a random cache: logits every step
    and the final cache chunks (DeepSeek's latent cache split over
    ``model``) against JAX's decode_step(rules=); collectives exactly
    ``decode_collectives``; the same chunks, the same bits."""
    tdm.check_decode(runs, case)
    if case["arch"].startswith("deepseek") and case["mesh"][1] > 1:
        ranks = runs.ranks(case["mesh"], tdm.tid(case))
        assert ranks[0]["specs"]["caches"][0][0][1] == "model"   # S split


@pytest.mark.parametrize("case", SUITE.model_cases(), ids=tdm.tid)
def test_bf16_forward_up_to_routing(runs, case):
    """bf16 capacity forward against the port's unsharded one at 5e-2 on
    every position before its row's first routing difference (C22)."""
    from repro_torch import convert
    from repro_torch.models import forward
    cfg = tdm.port_cfg(case["arch"], dtype="bfloat16")
    params = convert.lm_params(runs.inp["params"][case["arch"]], cfg,
                               device="cpu")
    seen = []
    with _recording(seen), torch.no_grad():
        want = forward(params, cfg, torch.from_numpy(
            runs.inp["fwd_tokens"])).float().numpy()
    held = total = 0
    S = tdm.FWD[1]
    for rec in runs.ranks(case["mesh"], tdm.tid(case)):
        lo, hi = rec["rows"]
        first = np.full(hi - lo, S)
        for got_d, want_d in zip(rec["bf16_routes"], seen):
            differs = (got_d != want_d[lo:hi]).any(-1)
            for b in range(hi - lo):
                hits = np.nonzero(differs[b])[0]
                if len(hits):
                    first[b] = min(first[b], hits[0])
        for b in range(hi - lo):
            tdm.close(rec["bf16"][b, :first[b]], want[lo + b, :first[b]],
                      TOL_BF16, f"row {lo + b}")
        held, total = held + first.sum(), total + (hi - lo) * S
    assert 4 * held >= total, (held, total)


@pytest.mark.parametrize("case", SUITE.train_cases(), ids=tdm.tid)
def test_training_matches_jax_gspmd(runs, case):
    """Two steps of the sharded or the deferred trainer: losses, AdamW's
    first moment after step 1 and both moments after step 2 (elementwise
    and per leaf in relative Frobenius norm at 1e-4), params within
    5e-3, against JAX's trainer on its mesh."""
    tdm.check_training(runs, case)


@pytest.mark.parametrize("case", SUITE.train_cases(), ids=tdm.tid)
def test_training_collectives_and_replicas(runs, case):
    """Each step's collectives on every rank equal ``step_collectives``;
    ranks that hold the same chunk of a leaf hold the same bits; every
    rank reports the same loss."""
    tdm.check_collectives_and_replicas(runs, case)


if __name__ == "__main__":
    tdm.main(SUITE, sys.argv)
