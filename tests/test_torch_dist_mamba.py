"""The port's sharded SSM family on the CPU (``models.mamba``'s
tensor-parallel Mamba-1 over d_inner channels and Mamba-2 over heads, the
shared attention block on ``Sharded``, the Mamba states' chunks and the
shared block's ``shared_cache``), held against the JAX package's GSPMD
runs of the same functions: reduced Falcon-Mamba-7B and Zamba2-1.2B in
f32 at (2, 2), (1, 2) and (1, 3), where neither d_inner, the heads nor
the vocabulary divide ``model`` (every leaf gathered, the compute
replicated; Zamba2's conv state still split, gathered at each step):

* the forward's logits at 1e-4;
* STEPS decode steps from a random state, the logits every step and the
  final state chunks at 1e-4;
* two steps of the FSDP + TP trainer and two of the deferred one (s =
  2): the losses, AdamW's first moment after step 1 and both moments
  after step 2 at 1e-4, the params within 5e-3.

Ranks that hold the same chunk of a leaf hold the same bits, and every
step's collectives equal ``step_collectives`` / ``decode_collectives``.
The processes: ``tests/torch_procs.py``.
"""
import sys

import pytest

import torch_procs as tdm

SUITE = tdm.Suite("dist_mamba", ("falcon_mamba_7b", "zamba2_1p2b"),
                  ((2, 2), (1, 2), (1, 3)))

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


@pytest.mark.parametrize("case", SUITE.train_cases(), ids=tdm.tid)
def test_training_matches_jax_gspmd(runs, case):
    tdm.check_training(runs, case)


@pytest.mark.parametrize("case", SUITE.train_cases(), ids=tdm.tid)
def test_training_collectives_and_replicas(runs, case):
    tdm.check_collectives_and_replicas(runs, case)


def test_mamba_parts_run_tensor_parallel_where_they_divide():
    """The Mamba block and the shared block's parts run tensor-parallel
    where d_inner / the heads divide ``model``, and the conv state of
    Zamba2 at (1, 3), split but not the rank's heads, is gathered."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.lm import param_specs
    from repro_torch.models.sharding import MeshRules, Sharded
    want = {("falcon_mamba_7b", (1, 2)): {"mamba"},
            ("falcon_mamba_7b", (1, 3)): set(),
            ("zamba2_1p2b", (2, 2)): {"mamba", "attn", "mlp"},
            ("zamba2_1p2b", (1, 3)): set()}
    for (arch, mesh), parts in want.items():
        rules = MeshRules(Mesh(mesh))
        cfg = tdm.port_cfg(arch)
        assert Sharded(rules, param_specs(rules, cfg)).tp_parts == parts


if __name__ == "__main__":
    tdm.main(SUITE, sys.argv)
