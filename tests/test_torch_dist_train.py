"""The port's cross-device LM training on the CPU, held against the JAX
package: the s-step deferred-sync step (``make_defer_train_step``) at
(4, 1) and (2, 2), s in {1, 2, 4}, with and without int8 error-feedback
compression; the FSDP + TP step (``make_train_step(rules=)``) at (4, 1)
and (2, 2); and a config whose heads do not divide ``model`` (3 heads, 1
kv head) at (1, 2), which takes the d_model-contraction fallback spec
for ``wq`` and runs its attention replicated over ``model``, through both
steps.  Reduced Qwen3-1.7B in f32, 16 x 16 tokens a step, 4
microbatches, 2 steps, AdamW at lr 1e-3.

The ranks are this file run as a script (``python
tests/test_torch_dist_train.py WORLD RANK DIR``), as in
``tests/test_torch_distributed.py``: gloo on CPU tensors, a
``FileStore``, every process under a time limit; one spawn per world
size (4: the (4, 1) and (2, 2) cases; 2: the (1, 2) ones), each case then
its own test.  The ranks import torch only; they start from the JAX
params (``convert.lm_shards``) and run the port's flash attention (its
plain version on the CPU) with layer remat.

The reference is the JAX package on 4 forced host devices, in two
subprocesses (one per mesh shape group; ``tests/test_system.py``'s way)
started with the ranks: its deferred step on a mesh from
``repro.compat.make_mesh_auto`` (params replicated), its GSPMD step on
the same mesh with params placed by ``tree_shardings``; naive attention,
no remat (neither changes the f32 math).  A port case without int8 at s
= 2 is held against JAX's s = 4 run (the same sum in another order).

Bounds.  The loss of both steps, AdamW's first moment after step 1
((1 - b1) times the clipped, synced gradient) and both moments after
step 2 at ``test_torch_train``'s f32 bound, 1e-4 (elementwise relative
and absolute, and per leaf in relative Frobenius norm); the params after
2 steps within the reference's 5e-3 (``tests/dist_worker.py``: two AdamW
steps turn summation-order noise in near-zero gradients into +-lr
updates), which holds whatever the gradients, so it checks the layout
and the gathers, and the moments check the gradients of both steps.
With int8 the moments also carry the quantization: error feedback
telescopes a step's rounds, so each data rank's synced sum is off its
exact sum by its last round's residual, at most half a quantization
step in each package.  Each entry gets a slack from the step of its
block in the last round of each step (``_int8_slack``, from unsharded
replays of both steps' rounds), is held within the f32 bound plus that
slack, and past the slack each leaf is held in relative Frobenius norm
at the f32 bound.  At most 1% of the entries of the first moment after
step 1 may be off by more than a hundredth of their slack (from the same
params, a rounding goes the other way in the two packages only where it
lands within f32 noise of a half step; a step without the compression,
or with other blocks, fails this).  From step 2 the params differ by
AdamW's +-lr noise, and a rounding that differs moves its block's
maximum and so its later rounds, so that count holds for step 1 only; a
residual carried over from step 1 would stay within the slack, which is
why ``tests/test_torch_sharding.py`` holds every step to a fresh step
from the same state, bit for bit.  Ranks that hold the
same chunk of a leaf hold it bit for bit after each step, and each
step's collectives by axis and kind equal
``train_step.step_collectives`` exactly: ``"grad"`` syncs nm / s a
deferred step.

The world-4 ranks also drive ``launch.train``'s checkpoint path across
meshes: a (2, 2) deferred run's step 1 saved as full leaves by rank 0,
restored onto the (4, 1) FSDP + TP step, which takes step 2.
"""
import hashlib
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_procs import Procs

ARCH = "qwen3_1p7b"
SEQ, BATCH, NM, STEPS, LR, SEED = 16, 16, 4, 2, 1e-3, 0
TIMEOUT_S = 300
TOL = 1e-4                  # tests/test_torch_train.py, f32
TOL_PARAMS = 5e-3           # tests/dist_worker.py
TIE_SHARE = 0.01
FALLBACK_HEADS = (3, 1)


def _cases():
    out = []
    for mesh in ((4, 1), (2, 2)):
        for s in (1, 2, 4):
            for int8 in (False, True):
                out.append(dict(world=4, mesh=mesh, kind="defer", s=s,
                                int8=int8, heads=None))
        out.append(dict(world=4, mesh=mesh, kind="sharded", s=1,
                        int8=False, heads=None))
    for kind, s in (("sharded", 1), ("defer", 2)):
        out.append(dict(world=2, mesh=(1, 2), kind=kind, s=s, int8=False,
                        heads=FALLBACK_HEADS))
    return out


CASES = _cases()


def _case_id(c) -> str:
    return (f"{c['kind']}-{c['mesh'][0]}x{c['mesh'][1]}-s{c['s']}"
            + ("-int8" if c["int8"] else "")
            + ("-h%d" % c["heads"][0] if c["heads"] else ""))


def _ref_key(c) -> str:
    """The JAX run a case is held against."""
    s = 4 if (c["kind"] == "defer" and c["s"] == 2 and not c["int8"]
              and not c["heads"]) else c["s"]
    return _case_id(dict(c, s=s))


# the JAX runs, by mesh shape group: one subprocess each
JAX_GROUPS = {
    g: sorted({_ref_key(c) for c in CASES
               if (c["mesh"] == (2, 2)) == (g == "2x2")})
    for g in ("2x2", "rest")}
REF_CASES = {_ref_key(c): c for c in CASES}


def _cfg_kw(heads):
    kw = dict(dtype="float32")
    if heads:
        kw.update(n_heads=heads[0], n_kv_heads=heads[1])
    return kw


# =========================================================================
# the ranks (this file as a script; torch only)
# =========================================================================

def _port_cfg(heads):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH, reduced=True),
                               attn_impl="flash", remat="full",
                               **_cfg_kw(heads))


def _acfg(AdamWConfig):
    return AdamWConfig(lr=LR, warmup_steps=0, total_steps=10)


def _batches(inp):
    return [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in inp["batches"]]


def _rank_case(c, inp):
    """One case on this rank: per step its loss, grad_norm, collectives
    and the hash of each local leaf; rank 0 also the gathered m after
    step 1 and params after step 2."""
    from repro_torch import convert
    from repro_torch.launch.mesh import COLLECTIVES, make_mesh
    from repro_torch.models.lm import param_specs
    from repro_torch.models.sharding import (MeshRules, gather_tree,
                                             leaf_specs, split_axes)
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.train_step import (TrainConfig, defer_rules,
                                              make_defer_train_step,
                                              make_train_step,
                                              step_collectives)
    from repro_torch.tree import leaves
    cfg = _port_cfg(c["heads"])
    mesh = make_mesh(*c["mesh"])
    rules = MeshRules(mesh)
    defer = c["kind"] == "defer"
    tcfg = TrainConfig(microbatches=NM, defer_s=c["s"],
                       compress_int8=c["int8"])
    acfg = _acfg(AdamWConfig)
    state_rules = defer_rules(rules) if defer else rules
    params = convert.lm_shards(inp["params"][str(c["heads"])], cfg,
                               state_rules, device="cpu")
    opt = adamw_init(params)
    step = (make_defer_train_step(cfg, acfg, tcfg, rules) if defer
            else make_train_step(cfg, acfg, tcfg, rules))
    specs = param_specs(state_rules, cfg)
    rec = {"loss": [], "grad_norm": [], "calls": [], "hashes": [],
           "want": step_collectives(cfg, tcfg, rules, defer),
           "coords": (mesh.index("data"), mesh.index("model")),
           "split": [[a for _, a in split_axes(mesh, s)]
                     for s in leaf_specs(specs, params)]}
    for k, batch in enumerate(_batches(inp)):
        COLLECTIVES.reset()
        params, opt, m = step(params, opt, batch)
        rec["calls"].append(dict(COLLECTIVES.calls))
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        rec["hashes"].append([hashlib.sha1(t.numpy().tobytes()).hexdigest()
                              for t in leaves(params)])
        if k == 0:      # copies: the next step updates in place
            first = {key: [t.numpy().copy() for t in leaves(gather_tree(
                state_rules, tree, specs))]
                for key, tree in (("m1", opt["m"]), ("p1", params))}
    last = {key: [t.numpy() for t in leaves(gather_tree(state_rules, tree,
                                                        specs))]
            for key, tree in (("p2", params), ("m2", opt["m"]),
                              ("v2", opt["v"]))}
    if mesh.rank == 0:
        rec.update(**first, **last)
    return rec


def _state_hashes(state) -> list:
    from repro_torch.tree import leaves
    return [hashlib.sha1(t.numpy().tobytes()).hexdigest()
            for t in leaves(state)]


def _rank_resume(inp, d: Path) -> dict:
    """The CLI's checkpoint path across meshes: step 1 of the deferred
    step at (2, 2), s = 2, saved by ``launch.train._save`` (full leaves
    gathered to rank 0), then ``launch.train._restore`` onto the FSDP +
    TP step at (4, 1) from a fresh start, which takes step 2.  The hashes
    of the saved full state (rank 0) and of the restored shards gathered
    again, the restored step and AdamW count, and step 2's loss."""
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.launch import train as cli
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import MeshRules
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import CheckpointManager
    from repro_torch.train.train_step import (TrainConfig, defer_rules,
                                              make_defer_train_step,
                                              make_train_step)
    cfg, acfg = _port_cfg(None), _acfg(AdamWConfig)
    batches = _batches(inp)
    rules = MeshRules(make_mesh(2, 2))
    srules = defer_rules(rules)
    params = convert.lm_shards(inp["params"]["None"], cfg, srules,
                               device="cpu")
    params, opt, _ = make_defer_train_step(
        cfg, acfg, TrainConfig(microbatches=NM, defer_s=2), rules)(
        params, adamw_init(params), batches[0])
    saved = _state_hashes(cli._full_state(params, opt, cfg, srules))
    mgr = CheckpointManager(str(d / "ckpt"), keep_last=2, save_every=1)
    cli._save(mgr, 1, params, opt, cfg, srules)
    mgr.wait()
    dist.barrier()      # the checkpoint is on disk before any rank reads
    rules = MeshRules(make_mesh(4, 1))
    fresh = convert.lm_shards(inp["params"]["None"], cfg, rules,
                              device="cpu")
    params, opt, step = cli._restore(mgr, fresh, adamw_init(fresh), cfg,
                                     rules)
    out = {"saved": saved if dist.get_rank() == 0 else None,
           "restored": _state_hashes(cli._full_state(params, opt, cfg,
                                                     rules)),
           "step": step, "opt_step": int(opt["step"])}
    _, _, m = make_train_step(cfg, acfg, TrainConfig(microbatches=NM),
                              rules)(params, opt, batches[1])
    out["loss"] = float(m["loss"])
    return out


def _rank_main(world: int, rank: int, d: Path) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(d / "store"), world), rank=rank,
        world_size=world)
    with open(d.parent / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    out = {_case_id(c): _rank_case(c, inp) for c in CASES
           if c["world"] == world}
    if world == 4:
        out["resume"] = _rank_resume(inp, d)
    torch.save(out, d / f"rank{rank}.pt")
    dist.destroy_process_group()


# =========================================================================
# the JAX reference (this file as a script with "jax"; 4 host devices)
# =========================================================================

def _jax_main(d: Path, group: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh_auto
    from repro.configs import get_config
    from repro.models.sharding import MeshRules, tree_shardings
    from repro.optim import AdamWConfig, adamw_init
    from repro.train.train_step import (TrainConfig, make_defer_train_step,
                                        make_train_step)
    with open(d / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in inp["batches"]]
    out = {}
    for key in JAX_GROUPS[group]:
        c = REF_CASES[key]
        cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                                  attn_impl="naive", remat="none",
                                  **_cfg_kw(c["heads"]))
        mesh = make_mesh_auto(c["mesh"], ("data", "model"))
        rules = MeshRules(mesh)
        tcfg = TrainConfig(microbatches=NM, defer_s=c["s"],
                           compress_int8=c["int8"])
        p = jax.tree.map(jnp.asarray, inp["params"][str(c["heads"])])
        o = adamw_init(p)
        if c["kind"] == "defer":
            rep = NamedSharding(mesh, P())
            p, o = jax.device_put((p, o), rep)
            step = make_defer_train_step(cfg, _acfg(AdamWConfig), tcfg,
                                         rules)
        else:
            p = jax.device_put(p, tree_shardings(rules, p))
            o = jax.device_put(o, {"m": tree_shardings(rules, o["m"]),
                                   "v": tree_shardings(rules, o["v"]),
                                   "step": NamedSharding(mesh, P())})
            step = make_train_step(cfg, _acfg(AdamWConfig), tcfg, rules)
        rec = {"loss": [], "grad_norm": []}
        for k, batch in enumerate(batches):
            p, o, m = step(p, o, batch)
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            if k == 0:      # a copy: the next step donates o's buffers
                rec["m1"] = jax.tree.map(np.array, o["m"])
        for name, tree in (("p2", p), ("m2", o["m"]), ("v2", o["v"])):
            rec[name] = jax.tree.map(np.array, tree)
        out[key] = rec
    with open(d / f"jax-{group}.pkl", "wb") as f:
        pickle.dump(out, f)


# =========================================================================
# the pytest side
# =========================================================================

def _inputs() -> dict:
    """The JAX initial params (numpy, stacked as JAX holds them) of each
    config and the two global batches every process reads."""
    import dataclasses

    import jax

    from repro.configs import get_config
    from repro.models import init_params
    params = {}
    for heads in (None, FALLBACK_HEADS):
        cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                                  **_cfg_kw(heads))
        params[str(heads)] = jax.tree.map(
            lambda a: np.asarray(a, np.float32),
            init_params(jax.random.key(SEED), cfg))
    vocab = get_config(ARCH, reduced=True).vocab_size
    rng = np.random.default_rng(SEED)
    batches = []
    for _ in range(STEPS):
        tok = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
        batches.append({"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    return {"params": params, "batches": batches}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    inp = _inputs()
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {"jax": Procs("jax", __file__,
                          [["jax", str(d), g] for g in JAX_GROUPS], jenv, d,
                          TIMEOUT_S)}
    for world in sorted({c["world"] for c in CASES}):
        wd = d / f"world{world}"
        wd.mkdir()
        procs[world] = Procs(f"world {world}", __file__,
                             [[str(world), str(r), str(wd)]
                              for r in range(world)], env, d, TIMEOUT_S)
    yield _Runs(d, procs, inp)
    for p in procs.values():            # nothing outlives the module
        p.kill()


class _Runs:
    """The module's processes and their results, read on first use."""

    def __init__(self, d, procs, inp):
        self.d, self.procs, self.inp = d, procs, inp
        self._ranks, self._jax = {}, None

    def ranks(self, world):
        if world not in self._ranks:
            self.procs[world].wait()
            self._ranks[world] = [
                torch.load(self.d / f"world{world}" / f"rank{r}.pt",
                           weights_only=False) for r in range(world)]
        return self._ranks[world]

    def jax(self):
        if self._jax is None:
            self.procs["jax"].wait()
            self._jax = {}
            for g in JAX_GROUPS:
                with open(self.d / f"jax-{g}.pkl", "rb") as f:
                    self._jax.update(pickle.load(f))
        return self._jax


def _port_leaves(tree, heads):
    """A JAX (stacked, numpy) params-shaped tree as the port's leaves."""
    from repro_torch import convert
    from repro_torch.tree import leaves, leaves_with_paths
    t = convert.lm_params(tree, _port_cfg(heads), device="cpu")
    return ([p for p, _ in leaves_with_paths(t)],
            [x.numpy() for x in leaves(t)])


def _quant_steps(c, params, batch):
    """Per entry of every leaf, the sum over data ranks of the
    quantization step of its block in the last of the ranks' rounds of
    one step on ``batch`` from ``params`` (the port's tree; an unsharded
    replay of the ranks' rounds, each layer's leaves of one name stacked
    into one array as the JAX package holds them)."""
    from repro_torch.optim import compress_int8
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import leaves_with_paths
    cfg = _port_cfg(c["heads"])
    groups = {}
    for i, (path, _) in enumerate(leaves_with_paths(params)):
        key = path[2:] if path[0] == "blocks" else path
        groups.setdefault(key, []).append(i)
    n_data, s = c["mesh"][0], c["s"]
    rows = BATCH // n_data
    mb = rows // NM
    total = None
    for d in range(n_data):
        resid = None
        for r in range(NM // s):
            lo = d * rows + r * s * mb
            part = {k: v[lo:lo + s * mb] for k, v in batch.items()}
            _, g = loss_and_grads(params, cfg, part, s)
            # the round's sum, fed back
            t = [x * s + (0.0 if resid is None else resid[i])
                 for i, x in enumerate(g)]
            resid, steps = [None] * len(t), [None] * len(t)
            for idx in groups.values():
                x = torch.stack([t[i] for i in idx])
                q, scale, _ = compress_int8(x)
                n = x.numel()
                per = scale.expand(-1, q.shape[1]).reshape(-1)[:n]
                deq = (q.float() * scale).reshape(-1)[:n].view(x.shape)
                for k, i in enumerate(idx):
                    resid[i] = t[i] - deq[k]
                    steps[i] = per.view(x.shape)[k]
        total = steps if total is None else [a + b for a, b in
                                             zip(total, steps)]
    return [x.numpy() for x in total]


def _int8_slack(inp, c, got, want, m1, m2):
    """Per entry of every leaf, how far int8 error feedback may set the
    port's AdamW moments apart from JAX's: ``{"m1", "m2", "v2": list}``.
    Each step's clipped synced gradient G_k is off by at most E_k =
    clip_k / (nm x n_data) x ``_quant_steps`` (step 1 replayed from the
    initial params, step 2 from the port's params after step 1); m1 =
    (1 - b1) G1, m2 = b1 m1 + (1 - b1) G2, v2 = (1 - b2) (b2 G1^2 + G2^2),
    with G1 and G2 read from JAX's moments."""
    from repro_torch import convert
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import leaves, unflatten
    a = AdamWConfig()
    cfg = _port_cfg(c["heads"])
    start = convert.lm_params(inp["params"][str(c["heads"])], cfg,
                              device="cpu")
    after1 = unflatten(start, [torch.from_numpy(x) for x in got["p1"]])
    batches = _batches(inp)
    E = []
    for k, params in enumerate((start, after1)):
        clip = min(1.0, a.grad_clip / (want["grad_norm"][k] + 1e-9))
        E.append([clip / (NM * c["mesh"][0]) * x
                  for x in _quant_steps(c, params, batches[k])])
    out = {"m1": [], "m2": [], "v2": []}
    for e1, e2, a1, a2 in zip(*E, m1, m2):
        g1 = np.abs(a1) / (1 - a.b1)
        g2 = np.abs(a2 - a.b1 * a1) / (1 - a.b1)
        out["m1"].append((1 - a.b1) * e1)
        out["m2"].append(a.b1 * (1 - a.b1) * e1 + (1 - a.b1) * e2)
        out["v2"].append((1 - a.b2) * (a.b2 * e1 * (2 * g1 + e1)
                                       + e2 * (2 * g2 + e2)))
    return out


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_matches_jax(runs, case):
    """Losses, AdamW's first moment after step 1 and both moments after
    step 2 (a gradient fault in either step shows here), and the params
    after step 2 (a layout or gather fault) against the JAX package."""
    ranks = runs.ranks(case["world"])
    got = ranks[0][_case_id(case)]
    want = runs.jax()[_ref_key(case)]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    state = {}
    for key in ("m1", "m2", "v2", "p2"):
        paths, state[key] = _port_leaves(want[key], case["heads"])
    if case["int8"]:
        slack = _int8_slack(runs.inp, case, got, want, state["m1"],
                            state["m2"])
    for key in ("m1", "m2", "v2"):
        ties = n = 0
        for i, (path, a, b) in enumerate(zip(paths, got[key], state[key])):
            q = slack[key][i] if case["int8"] else 0.0
            diff = np.abs(a - b)
            bound = TOL + TOL * np.abs(b) + q
            assert (diff <= bound).all(), (key, path,
                                           float((diff - bound).max()))
            # past the int8 slack, the leaf agrees to the f32 bound
            excess = np.maximum(diff - q, 0.0)
            assert (np.linalg.norm(excess)
                    <= TOL * max(np.linalg.norm(b), 1e-30)), (key, path)
            ties += int((diff > q / 100 + 1e-5 * np.abs(b)).sum())
            n += diff.size
        if case["int8"] and key == "m1":
            assert ties <= TIE_SHARE * n, (key, ties, n)
    worst = max(float(np.abs(a - b).max())
                for a, b in zip(got["p2"], state["p2"]))
    assert worst <= TOL_PARAMS, worst


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_replicated_chunks_equal_bit_for_bit(runs, case):
    """After each step the ranks that hold the same chunk of a leaf (the
    same coordinates on the axes that split it) hold the same bits."""
    recs = [r[_case_id(case)] for r in runs.ranks(case["world"])]
    axes = {"data": 0, "model": 1}
    for k in range(STEPS):
        for i, split in enumerate(recs[0]["split"]):
            groups = {}
            for rec in recs:
                key = tuple(rec["coords"][axes[a]] for a in split)
                groups.setdefault(key, set()).add(rec["hashes"][k][i])
            assert all(len(h) == 1 for h in groups.values()), (k, i, split)
    # and every rank reports the same loss
    assert len({tuple(r["loss"]) for r in recs}) == 1


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_collectives_per_step(runs, case):
    """Each step's collectives by (axis, kind) on every rank equal the
    model of ``step_collectives``; a deferred step syncs nm / s times."""
    for rec in (r[_case_id(case)] for r in runs.ranks(case["world"])):
        for calls in rec["calls"]:
            assert calls == rec["want"]
        if case["kind"] == "defer":
            assert rec["want"][("data", "grad")] == NM // case["s"]


def test_checkpoint_resumes_on_another_mesh(runs):
    """``launch.train``'s checkpoint of a (2, 2) deferred run restored
    onto the (4, 1) FSDP + TP step: the saved state is the uninterrupted
    run's after step 1, the restored leaves gathered again equal it bit
    for bit on every rank, and step 2's loss is the uninterrupted run's."""
    ranks = runs.ranks(4)
    run = ranks[0]["defer-2x2-s2"]
    recs = [r["resume"] for r in ranks]
    saved = recs[0]["saved"]
    n = len(run["p1"])
    assert saved[:n] == [hashlib.sha1(x.tobytes()).hexdigest()
                         for x in run["p1"]]
    for rec in recs:
        assert rec["restored"] == saved
        assert (rec["step"], rec["opt_step"]) == (1, 1)
    np.testing.assert_allclose([rec["loss"] for rec in recs],
                               run["loss"][1], rtol=TOL)


def test_s1_syncs_four_times_as_often_as_s4(runs):
    ranks = runs.ranks(4)[0]
    for mesh in ("4x1", "2x2"):
        g1 = ranks[f"defer-{mesh}-s1"]["calls"][0][("data", "grad")]
        g4 = ranks[f"defer-{mesh}-s4"]["calls"][0][("data", "grad")]
        assert g1 == 4 * g4


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(Path(sys.argv[2]), sys.argv[3])
    else:
        _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
