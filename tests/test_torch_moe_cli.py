"""The MoE family through the command-line entry points on the CPU: the
serve CLI and the training CLI (its loss falls) at reduced
DeepSeek-V2-Lite and Arctic (split from tests/test_torch_moe.py)."""
import numpy as np
import pytest

from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli

@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_serve_cli_on_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "4", "--new-tokens",
                    "3"])
    out = capsys.readouterr().out
    assert "ok" in out.splitlines()[-1] and "req1" in out


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_train_cli_on_cpu_loss_decreases(arch):
    losses = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--steps", "12", "--batch", "4", "--seq",
                             "32"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
