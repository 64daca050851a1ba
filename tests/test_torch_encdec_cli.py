"""Whisper-tiny and Qwen2-VL-72B through the command-line entry points on
the CPU (the serve CLI at reduced widths, the training CLI at reduced
Qwen2-VL, whose loss falls; the Whisper trainer refused before its
first step, since the token pipeline gives no frames, as the JAX
training CLI gives none, on a ``--mesh`` too; Qwen2-VL's loss falls on a
2 x 2 ``--mesh`` of gloo ranks under ``torch.distributed.run``), and
every config of the reference through every unsharded model entry point
at its reduced widths."""
import dataclasses

import numpy as np
import pytest
import torch
import torch_procs as tdm

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import (check_supported, decode_step, forward,
                                init_decode_state, init_params, loss_fn,
                                prefill_cross_kv)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' tensors are small: one intra-op thread is
    faster than many, and keeps this file from oversubscribing the cores
    that parallel test workers share; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_serve_cli_on_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "3", "--prompt-len", "4", "--new-tokens",
                    "3"])
    out = capsys.readouterr().out
    assert "ok" in out.splitlines()[-1] and "req2" in out
    assert ("engine req2" in out) == arch.startswith("whisper")


def test_train_cli_on_cpu_loss_decreases():
    losses = train_cli.main(["--arch", "qwen2-vl-72b", "--reduced",
                             "--device", "cpu", "--steps", "12", "--batch",
                             "4", "--seq", "32", "--microbatches", "2"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_whisper_train_cli_is_refused_before_its_first_step():
    with pytest.raises(NotImplementedError, match="audio_embed"):
        train_cli.main(["--arch", "whisper-tiny", "--reduced", "--device",
                        "cpu", "--steps", "2"])


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_train_cli_mesh_raises_naming_a11f(arch):
    """Once it raised naming ROADMAP A11f: ``--mesh 2x2`` trains Qwen2-VL
    on four gloo ranks and its loss falls; Whisper is refused before any
    process group starts, as on one device (no frames, ROADMAP C32)."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--mesh", "2x2",
            "--steps", "12", "--batch", "4", "--seq", "32", "--log-every",
            "1"]
    if arch.startswith("whisper"):
        with pytest.raises(NotImplementedError, match="audio_embed"):
            train_cli.main(argv)
        return
    losses = tdm.train_cli_on_mesh(argv, 4)
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_config_runs_every_entry_point(arch):
    """check_supported passes, and init_params, forward, loss_fn,
    init_decode_state and decode_step run at the reduced widths, f32:
    finite logits of the right shape, decode logits equal to the
    prefill's (1e-4; capacity MoE dispatch pinned to dense, as the
    reference's own test pins it)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32", moe_impl="dense")
    check_supported(cfg)
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    B, S = 2, 8
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encoder_layers:
        batch["audio_embed"] = torch.randn(
            (B, cfg.encoder_seq, cfg.d_model), generator=gen)
    logits = forward(p, cfg, batch["tokens"],
                     audio_embed=batch.get("audio_embed"))
    assert logits.shape == (B, S, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(loss_fn(p, cfg, batch)))
    state = init_decode_state(cfg, B, S, device="cpu",
                              with_encoder=bool(cfg.encoder_layers))
    if cfg.encoder_layers:
        state["cross_kv"] = prefill_cross_kv(p, cfg, batch["audio_embed"])
    outs = []
    for t in range(S):
        lg, state = decode_step(p, cfg, state, batch["tokens"][:, t:t + 1])
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), logits, rtol=1e-4,
                               atol=1e-4)
