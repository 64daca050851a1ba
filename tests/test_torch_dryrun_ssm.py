"""The port's dry run over the SSM family's cells (Falcon-Mamba-7B and
Zamba2-1.2B) at both production meshes: the checks of
``test_torch_dryrun.py`` (each cell runs or is skipped as the JAX dry run
skips it, its collectives equal the step's formula), in a file of its
own because these cells take most of the dry run's time on ``meta``."""
import pytest
import torch

from test_torch_dryrun import SSM_ARCHS, check_arch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_every_ssm_cell_runs_with_the_formula_collectives(arch, mesh):
    out = check_arch(arch, mesh == "2x16x16")
    # the SSM family takes the 512k-token decode cell
    assert out["long_500k"]["status"] == "ok"
