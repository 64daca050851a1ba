"""The port's dry run (``repro_torch.launch.dryrun``) over every
(architecture x shape) cell at both production meshes, (16, 16) and (2,
16, 16), on ``meta`` tensors: each cell runs, or is skipped with the JAX
dry run's reason; its collectives by (axis, kind) equal
``train_step.step_collectives`` / ``decode_collectives`` for the cell
(the formulas the sharded suites hold against real gloo runs), the
``pod`` sums included; its kernel FLOPs and bytes are the kernels'
formulas over the kernel calls a real run makes; the CLI runs a cell of
each family.  The SSM family's cells, the slowest on ``meta``, are in
``test_torch_dryrun_ssm.py`` (one file each, so the two run side by
side)."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES
from repro_torch.models.sharding import MeshRules
from repro_torch.train.train_step import (TrainConfig, decode_collectives,
                                          step_collectives)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("llama3_405b", "granite_20b", "yi_6b", "qwen3_1p7b",
         "qwen2_vl_72b", "deepseek_v2_lite_16b", "arctic_480b",
         "whisper_tiny")
SSM_ARCHS = ("falcon_mamba_7b", "zamba2_1p2b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cell_supported():
    """The JAX dry run's ``cell_supported``.  Importing the module sets
    XLA_FLAGS for 512 host devices; the variable is restored at once, so
    no other test's JAX sees it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import cell_supported
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return cell_supported


def check_arch(arch: str, multi_pod: bool) -> dict:
    """Every shape of ``arch`` on one production mesh: run or skipped as
    the JAX dry run skips it, and the collectives of each run equal the
    step's formula.  Returns the results by shape."""
    from repro.configs import get_config as jax_config
    supported = jax_cell_supported()
    rules = MeshRules(make_production_mesh(multi_pod=multi_pod))
    cfg = get_config(arch)
    out = {}
    for name, shape in SHAPES.items():
        r = dryrun.run_cell(arch, name, multi_pod)
        ok, why = supported(jax_config(arch), name)
        out[name] = r
        if not ok:
            assert r["status"] == "skipped" and r["reason"] == why, r
            continue
        assert r["status"] == "ok", r
        want = (step_collectives(cfg, TrainConfig(), rules, defer=False)
                if shape.kind == "train" else
                decode_collectives(cfg, rules, shape.global_batch,
                                   shape.seq_len)
                if shape.kind == "decode" else None)
        if want is not None:
            assert r["collective_calls"] == {
                f"{a}/{k}": n for (a, k), n in sorted(want.items()) if n}
        if shape.kind == "train" and multi_pod:
            assert r["collective_calls"]["pod/grad"] == 1
        assert r["hlo_flops_per_device"] > 0 and r["t_compute"] > 0
        assert r["memory_analysis"]["argument_bytes"] > 0
        assert r["bottleneck"] in ("t_compute", "t_memory", "t_collective")
        assert 0 < r["roofline_fraction"] <= 1
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_cell_runs_with_the_formula_collectives(arch, mesh):
    check_arch(arch, mesh == "2x16x16")


def test_keys_are_the_jax_dry_runs():
    """The JAX dry run's result keys (``dryrun.py:146-180``), and the
    port's own beside them."""
    r = dryrun.run_cell("qwen3_1p7b", "decode_32k", False)
    jax_keys = {"arch", "shape", "mesh", "status", "lower_s", "compile_s",
                "probe_s", "n_chips", "hlo_flops_per_device",
                "hlo_bytes_per_device", "collective_bytes",
                "collective_bytes_total", "t_compute", "t_memory",
                "t_collective", "params", "active_params",
                "model_flops_total", "model_flops_per_device",
                "useful_flop_ratio", "bottleneck", "roofline_fraction",
                "memory_analysis"}
    assert jax_keys <= set(r)
    assert set(r["memory_analysis"]) == {"argument_bytes", "output_bytes",
                                         "temp_bytes",
                                         "generated_code_bytes"}
    assert r["n_chips"] == 256
    assert set(r["collective_bytes"]) <= {"all-gather", "all-reduce",
                                          "reduce-scatter"}


def test_probes_extrapolate_to_full_depth():
    """At a depth the meta run can afford in full, the two-point probes
    give every cost of the full-depth run: what grows by layer grows
    linearly."""
    cfg = dataclasses.replace(get_config("qwen3_1p7b"), n_layers=5,
                              attn_impl="flash")
    rules = MeshRules(make_production_mesh(multi_pod=True))
    full = dryrun.measure(cfg, "train_4k", rules)["costs"]
    ex = dryrun.extrapolated_costs(cfg, "train_4k", rules)["costs"]
    assert set(ex) == set(full)
    for key, v in full.items():
        assert ex[key] == pytest.approx(v, rel=1e-9), key


@pytest.mark.parametrize("arch,shape", [("qwen3_1p7b", "train_4k"),
                                        ("qwen2_vl_72b", "prefill_32k")])
def test_kernel_costs_are_the_formulas_of_a_real_run(arch, shape):
    """The dry run prices the hand-written kernels by their formulas over
    the calls a real run makes: a reduced config's step on the CPU (the
    plain versions run) records each RMSNorm and flash call's shapes;
    their formulas sum to the dry run's kernel FLOPs and bytes for the
    same config, shape and (1, 1) mesh on ``meta``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, rmsnorm as rn
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.config import ShapeConfig
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              attn_impl="flash", dtype="float32")
    kind = SHAPES[shape].kind
    small = ShapeConfig("small", 256, 4, kind)
    rules = MeshRules(Mesh((1, 1)))
    meta = dryrun.measure(cfg, small, rules)["costs"]
    seen = {"flops": 0.0, "bytes": 0.0}
    real = (rn.rmsnorm_plain, fa.flash_fwd_plain, ops.flash_bwd_plain)

    def add(cost):
        seen["flops"] += cost["flops"]
        seen["bytes"] += cost["bytes"]

    def norm(x, scale, eps=1e-6):
        add(dryrun.rmsnorm_cost(x.numel() // x.shape[-1], x.shape[-1],
                                x.element_size()))
        return real[0](x, scale, eps)

    def fwd(q, k, v, causal=True, scale=None):
        BH, S_, T, hd, hdv = fa.check_shapes(q, k, v)
        add(dryrun.flash_cost("fwd", BH, S_, T, hd, hdv, q.element_size(),
                              causal))
        return real[1](q, k, v, causal, scale)

    def bwd(q, k, v, do, lse, delta, causal=True, scale=None):
        BH, S_, T, hd, hdv = fa.check_shapes(q, k, v)
        for w in ("dq", "dkv"):
            add(dryrun.flash_cost(w, BH, S_, T, hd, hdv, q.element_size(),
                                  causal))
        return real[2](q, k, v, do, lse, delta, causal, scale)

    fn, args, _ = dryrun.build_step(cfg, small, rules, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for t in dryrun.leaves(args[0]):
        t.normal_(0.0, 0.02, generator=gen)
    if kind == "train":
        for t in dryrun.leaves(args[1]):
            t.zero_()
    saved = (rn.rmsnorm_plain, fa.flash_fwd_plain, ops.flash_bwd_plain)
    rn.rmsnorm_plain, fa.flash_fwd_plain, ops.flash_bwd_plain = norm, fwd, bwd
    try:
        fn(*args)
    finally:
        rn.rmsnorm_plain, fa.flash_fwd_plain, ops.flash_bwd_plain = saved
    assert seen["flops"] > 0
    assert meta[("kernel_flops",)] == pytest.approx(seen["flops"], rel=1e-12)
    assert meta[("kernel_bytes",)] == pytest.approx(seen["bytes"], rel=1e-12)


def test_cli_runs_a_cell_of_each_family(tmp_path):
    """``python -m repro_torch.launch.dryrun`` for one cell (a process of
    its own), then the CLI's main in this process for a cell of each
    other family; each exits 0 with no cell FAILED."""
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "decode_32k", "--multi-pod", "--out",
         str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "1 cells: 1 ok, 0 skipped, 0 FAILED" in proc.stdout
    assert json.loads(out.read_text())[0]["mesh"] == "2x16x16"
    for arch, shape in (("deepseek-v2-lite-16b", "decode_32k"),
                        ("whisper_tiny", "prefill_32k"),
                        ("falcon_mamba_7b", "long_500k"),
                        ("qwen2_vl_72b", "long_500k")):
        assert dryrun.main(["--arch", arch, "--shape", shape]) == 0
