"""The port on a mesh with the JAX production mesh's third axis, ``pod``,
on the CPU: reduced Qwen3-1.7B in f32 at (pod, data, model) = (2, 1, 2),
four gloo ranks, held against the JAX package's GSPMD runs on a mesh of
four host devices with the same axes.  The batch splits over ``("pod",
"data")``, params are replicated over ``pod``, and the sharded step sums
its gradient bucket over ``pod`` (``train.train_step._pod_sum``):

* two steps of the FSDP + TP trainer: the losses, AdamW's first moment
  after step 1 and both moments after step 2 at 1e-4, the params within
  5e-3; every step's collectives exactly ``step_collectives`` (its
  ``("pod", "grad")`` sum included) on every rank, and ranks that hold
  the same chunk of a leaf hold the same bits;
* the forward's logits (each rank its rows of the batch) at 1e-4;
* STEPS decode steps from a random state, the logits every step and the
  final cache chunks at 1e-4, the collectives ``decode_collectives``.

The processes: ``tests/torch_procs.py``.
"""
import sys

import pytest

import torch_procs as tdm

SUITE = tdm.Suite("dist_pod", ("qwen3_1p7b",), ((2, 1, 2),),
                  trainers=(("sharded", None),))

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    tdm.one_torch_thread)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = tdm.start(SUITE, __file__, tmp_path_factory.mktemp(SUITE.name))
    yield r
    r.kill()                            # nothing outlives the module


@pytest.mark.parametrize("case", SUITE.train_cases(), ids=tdm.tid)
def test_pod_training_matches_jax_gspmd(runs, case):
    tdm.check_training(runs, case)


@pytest.mark.parametrize("case", SUITE.train_cases(), ids=tdm.tid)
def test_pod_collectives_and_replicas(runs, case):
    tdm.check_collectives_and_replicas(runs, case)
    want = runs.ranks(case["mesh"], tdm.tid(case))[0]["want"]
    assert want[("pod", "grad")] == 1 and want[("data", "grad")] == 1


@pytest.mark.parametrize("case", SUITE.model_cases(), ids=tdm.tid)
def test_pod_forward_matches_jax_gspmd(runs, case):
    tdm.check_forward(runs, case)


@pytest.mark.parametrize("case", SUITE.model_cases(), ids=tdm.tid)
def test_pod_decode_matches_jax_gspmd(runs, case):
    tdm.check_decode(runs, case)


if __name__ == "__main__":
    tdm.main(SUITE, sys.argv)
