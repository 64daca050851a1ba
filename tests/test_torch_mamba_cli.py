"""The SSM family through the command-line entry points on the CPU: the
serve CLI at reduced Falcon-Mamba-7B and Zamba2-1.2B, the training CLI
(its loss falls) at both, on one device and on a 2 x 2 ``--mesh`` of
gloo ranks under ``torch.distributed.run``."""
import numpy as np
import pytest
import torch
import torch_procs as tdm

from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are small: one intra-op thread is
    faster than many, and keeps this file from oversubscribing the cores
    that parallel test workers share; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_serve_cli_on_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "4", "--new-tokens",
                    "3"])
    out = capsys.readouterr().out
    assert "ok" in out.splitlines()[-1] and "req1" in out


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_train_cli_on_cpu_loss_decreases(arch):
    losses = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--steps", "12", "--batch", "4", "--seq",
                             "32"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_train_cli_mesh_raises_naming_a11e(arch):
    """Once it raised naming ROADMAP A11e: ``--mesh 2x2`` trains on four
    gloo ranks (the FSDP + TP step, the Mamba blocks tensor-parallel) and
    its loss falls."""
    losses = tdm.train_cli_on_mesh(
        ["--arch", arch, "--reduced", "--device", "cpu", "--mesh", "2x2",
         "--steps", "12", "--batch", "4", "--seq", "32", "--log-every",
         "1"], 4)
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
