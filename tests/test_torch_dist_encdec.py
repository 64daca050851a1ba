"""The port's sharded encoder-decoder stack and M-RoPE on the CPU
(Whisper's encoder blocks and decoder cross-attention tensor-parallel on
``Sharded``, ``prefill_cross_kv(rules=)`` and the decode state's
``cross_kv`` chunks, Qwen2-VL's (3, B, S) positions split on their
batch axis), held against the JAX package's GSPMD runs of the same
functions: reduced Whisper-tiny and Qwen2-VL-72B in f32 at (2, 2), (1,
2) and (1, 4), where Whisper's 2 heads and Qwen2-VL's 2 kv heads do not
divide ``model`` (their attention gathered and replicated; ``cross_kv``
and the caches split on S, read by the split-S attention):

* the forward's logits at 1e-4 (Whisper with its frames, Qwen2-VL with
  random position streams);
* ``prefill_cross_kv(rules=)``'s chunks against JAX's
  ``prefill_cross_kv`` at 1e-4;
* STEPS decode steps from a random state (``cross_kv`` included), the
  logits every step and the final state chunks at 1e-4;
* two steps of the FSDP + TP trainer and two of the deferred one (s =
  2): the losses, AdamW's first moment after step 1 and both moments
  after step 2 at 1e-4, the params within 5e-3.

Ranks that hold the same chunk of a leaf hold the same bits, and every
step's collectives equal ``step_collectives`` / ``decode_collectives``.
The processes: ``tests/torch_procs.py``.
"""
import sys

import numpy as np
import pytest

import torch_procs as tdm

SUITE = tdm.Suite("dist_encdec", ("whisper_tiny", "qwen2_vl_72b"),
                  ((2, 2), (1, 2), (1, 4)))

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    tdm.one_torch_thread)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = tdm.start(SUITE, __file__, tmp_path_factory.mktemp(SUITE.name))
    yield r
    r.kill()                            # nothing outlives the module


@pytest.mark.parametrize("case", SUITE.model_cases(), ids=tdm.tid)
def test_forward_matches_jax_gspmd(runs, case):
    tdm.check_forward(runs, case)


@pytest.mark.parametrize("case", SUITE.model_cases(), ids=tdm.tid)
def test_decode_matches_jax_gspmd(runs, case):
    tdm.check_decode(runs, case)


@pytest.mark.parametrize("case", [c for c in SUITE.model_cases()
                                  if c["arch"] == "whisper_tiny"],
                         ids=tdm.tid)
def test_prefill_cross_kv_chunks_match_jax(runs, case):
    """Each rank's ``prefill_cross_kv(rules=)`` is its chunk, by
    ``cache_spec``, of JAX's ``prefill_cross_kv`` (its rows, its kv heads
    where they divide ``model``, else its frames)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.lm import decode_state_layout
    from repro_torch.models.sharding import MeshRules, shard_leaf
    import torch
    want = runs.jax(case["mesh"])[(tdm.tid(case), "cross_kv")]
    cfg = tdm.port_cfg(case["arch"])
    split_frames = False
    for r, rec in enumerate(runs.ranks(case["mesh"], tdm.tid(case))):
        mesh = Mesh(case["mesh"], rec["coords"])
        specs = decode_state_layout(MeshRules(mesh), cfg, tdm.FWD[0],
                                    1)["cross_kv"]
        assert len(rec["cross_kv"]) == cfg.n_layers
        for i, (pair, spair) in enumerate(zip(rec["cross_kv"], specs)):
            for j, (got, sp) in enumerate(zip(pair, spair)):
                w = shard_leaf(mesh, torch.from_numpy(
                    np.asarray(want[j][i])), sp).numpy()
                tdm.close(got, w, tdm.TOL, f"rank {r} layer {i} {j}")
                split_frames |= sp[1] is not None
    assert split_frames == (case["mesh"][1] == 4)


@pytest.mark.parametrize("case", SUITE.train_cases(), ids=tdm.tid)
def test_training_matches_jax_gspmd(runs, case):
    tdm.check_training(runs, case)


@pytest.mark.parametrize("case", SUITE.train_cases(), ids=tdm.tid)
def test_training_collectives_and_replicas(runs, case):
    tdm.check_collectives_and_replicas(runs, case)


if __name__ == "__main__":
    tdm.main(SUITE, sys.argv)
