"""The training CLI (``launch.train``) on the CPU at reduced Qwen3-1.7B:
its loss falls over 20 steps, it checkpoints every 10, and a second run
resumes from the last checkpoint (split from
tests/test_torch_train.py)."""
import numpy as np

from repro_torch.launch import train as train_cli
from repro_torch.train import available_steps


def test_train_cli_on_cpu_loss_decreases(capsys, tmp_path):
    """The CLI's own run on the reduced config; then a second run resumes
    from its last checkpoint."""
    ckpt = str(tmp_path / "ckpt")
    losses = train_cli.main(["--arch", "qwen3-1.7b", "--reduced",
                             "--device", "cpu", "--steps", "20",
                             "--ckpt-dir", ckpt, "--ckpt-every", "10"])
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5
    assert available_steps(ckpt) == [10, 20]
    out = capsys.readouterr().out
    assert "final loss" in out and "device=cpu" in out
    more = train_cli.main(["--arch", "qwen3-1.7b", "--reduced", "--device",
                           "cpu", "--steps", "22", "--ckpt-dir", ckpt])
    assert len(more) == 2
    assert "resumed from step 20" in capsys.readouterr().out
