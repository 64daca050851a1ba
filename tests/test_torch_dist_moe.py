"""The port's sharded MLA / MoE models (``models.sharding.Sharded`` with
MLA's attention tensor-parallel on heads and the experts expert-parallel
on E, ``models.moe``'s expert range, the split latent cache) on the CPU,
held against the JAX package's GSPMD runs of the same functions: reduced
DeepSeek-V2-Lite (MLA, shared experts) and Arctic (GQA, dense residual)
in f32 at (2, 2) and (1, 2):

* the forward's logits, for both ``moe_impl``s (dense, capacity);
* two steps of the FSDP + TP / EP trainer (``make_train_step(rules=)``)
  for both ``moe_impl``s, and two of the s-step deferred trainer
  (``make_defer_train_step``, s = 2, capacity), held as
  ``tests/test_torch_dist_train.py::test_matches_jax`` holds them: the
  losses, AdamW's first moment after step 1 ((1 - b1) times the clipped
  gradient: every gradient leaf) and both moments after step 2 at 1e-4,
  the params after step 2 within 5e-3;
* STEPS decode steps from a random cache (DeepSeek's latent cache split
  over ``model``), logits every step and the final cache chunks at 1e-4;
* bf16: the capacity forward against the port's unsharded bf16 forward
  at 5e-2 on every position before its row's first routing difference
  (ROADMAP C22: the TP-reduced residual stream rounds otherwise, and a
  near-tied pick can flip), most positions held.

Ranks that hold the same chunk of a leaf hold the same bits after each
step, and every step's collectives equal ``step_collectives`` /
``decode_collectives`` exactly.  The ranks and the JAX reference (one
process for each arch and mesh, 4 forced host devices) run as in
``tests/test_torch_dist_train.py``.
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

ARCHS = ("deepseek_v2_lite_16b", "arctic_480b")
MESHES = ((2, 2), (1, 2))
IMPLS = ("dense", "capacity")
SEQ, BATCH, NM, TRAIN_STEPS, LR, SEED = 16, 8, 2, 2, 1e-3, 0
FWD = (4, 16)
MAX_SEQ, STEPS, POS = 32, 4, (3, 14, 15, 29)
TIMEOUT_S = 300
TOL = 1e-4                  # tests/test_torch_train.py, f32
TOL_PARAMS = 5e-3           # tests/dist_worker.py
TOL_BF16 = 5e-2


def _world(mesh) -> int:
    return mesh[0] * mesh[1]


def _train_cases():
    out = []
    for arch in ARCHS:
        for mesh in MESHES:
            for impl in IMPLS:
                out.append(dict(arch=arch, mesh=mesh, kind="sharded",
                                impl=impl))
            out.append(dict(arch=arch, mesh=mesh, kind="defer",
                            impl="capacity"))
    return out


TRAIN_CASES = _train_cases()
MODEL_CASES = [dict(arch=a, mesh=m) for a in ARCHS for m in MESHES]


def _tid(c) -> str:
    return f"{c['arch'].split('_')[0]}-{c['mesh'][0]}x{c['mesh'][1]}" + (
        f"-{c['kind']}-{c['impl']}" if "kind" in c else "")


def _port_cfg(arch, **kw):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, reduced=True),
                               **dict(dict(dtype="float32"), **kw))


def _acfg(AdamWConfig):
    return AdamWConfig(lr=LR, warmup_steps=0, total_steps=10)


def _decisions(p, cfg, x):
    """(B, S, E) bool: the experts that take each token (the port's own
    routing of its MoE input)."""
    from repro_torch.models import moe
    with torch.no_grad():
        _, top_w, top_idx = moe._route(p, cfg, x)
        routed = moe._routed(top_w, top_idx, cfg.n_experts)
        pri = torch.where(routed > 0, routed, torch.full_like(
            routed, float("-inf"))).transpose(1, 2)
        w, idx = pri.topk(moe.capacity(cfg, x.shape[1]), -1)
        kept = torch.zeros_like(pri, dtype=torch.bool).scatter_(
            -1, idx, torch.isfinite(w))
        return kept.transpose(1, 2).numpy()


def _recording(seen):
    from unittest import mock

    from repro_torch.models import lm
    apply = lm.moe_apply

    def rec(p, c, x, tp=None):
        seen.append(_decisions(p, c, x))
        return apply(p, c, x, tp=tp)

    return mock.patch.object(lm, "moe_apply", rec)


# =========================================================================
# the ranks (this file as a script; torch only)
# =========================================================================

def _rank_model(c, inp, rules):
    """The forwards (f32 both impls; bf16 capacity with its routing) and
    the decode steps of one arch on this rank."""
    from repro_torch import convert
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.models import decode_step, forward
    from repro_torch.models.lm import decode_state_layout
    from repro_torch.models.sharding import batch_rows
    from repro_torch.train.train_step import decode_collectives
    arch, mesh = c["arch"], rules.mesh
    rows = batch_rows(rules, FWD[0])
    toks = torch.from_numpy(inp["fwd_tokens"])[rows]
    rec = {"rows": (rows.start, rows.stop),
           "coords": (mesh.index("data"), mesh.index("model"))}
    for impl in IMPLS:
        cfg = _port_cfg(arch, moe_impl=impl)
        params = convert.lm_shards(inp["params"][arch], cfg, rules,
                                   device="cpu")
        with torch.no_grad():
            rec[f"fwd-{impl}"] = forward(params, cfg, toks,
                                         rules=rules).numpy()
    cfg = _port_cfg(arch, dtype="bfloat16")
    params = convert.lm_shards(inp["params"][arch], cfg, rules, device="cpu")
    seen = []
    with _recording(seen), torch.no_grad():
        rec["bf16"] = forward(params, cfg, toks, rules=rules).float().numpy()
    rec["bf16_routes"] = seen
    cfg = _port_cfg(arch)
    params = convert.lm_shards(inp["params"][arch], cfg, rules, device="cpu")
    state = convert.decode_state_shards(inp["states"][arch], cfg, rules,
                                        device="cpu")
    drows = batch_rows(rules, len(POS))
    rec.update(drows=(drows.start, drows.stop), dec=[], dec_calls=[],
               dec_want=decode_collectives(cfg, rules, len(POS), MAX_SEQ))
    for t in range(STEPS):
        COLLECTIVES.reset()
        lg, state = decode_step(params, cfg, state,
                                torch.from_numpy(inp["dec_tokens"][t]),
                                rules=rules)
        rec["dec_calls"].append(dict(COLLECTIVES.calls))
        rec["dec"].append(lg.numpy())
    rec["caches"] = [[t.numpy() for t in pair] for pair in state["caches"]]
    rec["specs"] = decode_state_layout(rules, cfg, len(POS),
                                       MAX_SEQ)["caches"]
    return rec


def _rank_train(c, inp, rules):
    """Two steps of one trainer: per step its loss, collectives and the
    hash of each local leaf; the gathered m after step 1, params and
    both moments after step 2."""
    from repro_torch import convert
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.models.lm import param_specs
    from repro_torch.models.sharding import gather_tree, leaf_specs, split_axes
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.train_step import (TrainConfig, defer_rules,
                                              make_defer_train_step,
                                              make_train_step,
                                              step_collectives)
    from repro_torch.tree import leaves
    cfg = _port_cfg(c["arch"], moe_impl=c["impl"], remat="full")
    defer = c["kind"] == "defer"
    tcfg = TrainConfig(microbatches=NM, defer_s=2 if defer else 1)
    acfg = _acfg(AdamWConfig)
    srules = defer_rules(rules) if defer else rules
    params = convert.lm_shards(inp["params"][c["arch"]], cfg, srules,
                               device="cpu")
    opt = adamw_init(params)
    step = (make_defer_train_step(cfg, acfg, tcfg, rules) if defer
            else make_train_step(cfg, acfg, tcfg, rules))
    specs = param_specs(srules, cfg)
    mesh = rules.mesh
    rec = {"loss": [], "calls": [], "hashes": [],
           "want": step_collectives(cfg, tcfg, rules, defer),
           "coords": (mesh.index("data"), mesh.index("model")),
           "split": [[a for _, a in split_axes(mesh, s)]
                     for s in leaf_specs(specs, params)]}
    for k in range(TRAIN_STEPS):
        COLLECTIVES.reset()
        params, opt, m = step(params, opt, {
            key: torch.from_numpy(v) for key, v in inp["batches"][k].items()})
        rec["calls"].append(dict(COLLECTIVES.calls))
        rec["loss"].append(float(m["loss"]))
        rec["hashes"].append([hashlib.sha1(t.numpy().tobytes()).hexdigest()
                              for t in leaves(params)])
        if k == 0:
            m1 = [t.numpy().copy() for t in leaves(gather_tree(
                srules, opt["m"], specs))]
    last = {key: [t.numpy() for t in leaves(gather_tree(srules, tree,
                                                        specs))]
            for key, tree in (("p2", params), ("m2", opt["m"]),
                              ("v2", opt["v"]))}
    if mesh.rank == 0:
        rec.update(m1=m1, **last)
    return rec


def _rank_main(world: int, rank: int, d: Path) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import MeshRules
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(d / "store"), world), rank=rank,
        world_size=world)
    with open(d.parent / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    out = {}
    for c in MODEL_CASES + TRAIN_CASES:
        if _world(c["mesh"]) == world:
            rules = MeshRules(make_mesh(*c["mesh"]))
            out[_tid(c)] = (_rank_train(c, inp, rules) if "kind" in c
                            else _rank_model(c, inp, rules))
    torch.save(out, d / f"rank{rank}.pt")
    dist.destroy_process_group()


# =========================================================================
# the JAX reference (this file as a script with "jax"; 4 host devices)
# =========================================================================

def _jax_main(d: Path, arch: str, mesh_shape) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh_auto
    from repro.configs import get_config
    from repro.launch.specs import _cache_pspec
    from repro.models import decode_step, forward
    from repro.models.sharding import MeshRules, tree_shardings
    from repro.optim import AdamWConfig, adamw_init
    from repro.train.train_step import (TrainConfig, make_defer_train_step,
                                        make_train_step)
    with open(d / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh_auto(mesh_shape, ("data", "model"))
    rules = MeshRules(mesh)
    batch_sh = NamedSharding(mesh, rules.fit(FWD, [rules.batch_axes, None]))

    def cfg_of(**kw):
        return dataclasses.replace(get_config(arch, reduced=True),
                                   **dict(dict(dtype="float32"), **kw))

    def placed(cfg):
        p = jax.tree.map(jnp.asarray, inp["params"][arch])
        return jax.device_put(p, tree_shardings(rules, p))

    out = {}
    case = dict(arch=arch, mesh=mesh_shape)
    toks = jax.device_put(jnp.asarray(inp["fwd_tokens"], jnp.int32),
                          batch_sh)
    for impl in IMPLS:
        cfg = cfg_of(moe_impl=impl)
        fwd = jax.jit(lambda p, t: forward(p, cfg, t, rules=rules))
        out[(_tid(case), f"fwd-{impl}")] = np.array(fwd(placed(cfg), toks))
    cfg = cfg_of()

    def place(path, leaf):
        spec = _cache_pspec(rules, cfg, "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf)
        return jax.device_put(jnp.asarray(leaf), NamedSharding(mesh, spec))

    state = jax.tree_util.tree_map_with_path(place, inp["states"][arch])
    tok_sh = NamedSharding(mesh, rules.fit((len(POS), 1),
                                           [rules.batch_axes, None]))
    step = jax.jit(lambda p, s, t: decode_step(p, cfg, s, t, rules=rules))
    p = placed(cfg)
    dec = []
    for t in range(STEPS):
        lg, state = step(p, state, jax.device_put(
            jnp.asarray(inp["dec_tokens"][t], jnp.int32), tok_sh))
        dec.append(np.array(lg))
    out[(_tid(case), "dec")] = dec
    out[(_tid(case), "state")] = jax.tree.map(np.array, state)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in inp["batches"]]
    for c in TRAIN_CASES:
        if (c["arch"], c["mesh"]) != (arch, mesh_shape):
            continue
        cfg = cfg_of(moe_impl=c["impl"])
        tcfg = TrainConfig(microbatches=NM,
                           defer_s=2 if c["kind"] == "defer" else 1)
        p = jax.tree.map(jnp.asarray, inp["params"][arch])
        o = adamw_init(p)
        if c["kind"] == "defer":
            rep = NamedSharding(mesh, P())
            p, o = jax.device_put((p, o), rep)
            tstep = make_defer_train_step(cfg, _acfg(AdamWConfig), tcfg,
                                          rules)
        else:
            p = jax.device_put(p, tree_shardings(rules, p))
            o = jax.device_put(o, {"m": tree_shardings(rules, o["m"]),
                                   "v": tree_shardings(rules, o["v"]),
                                   "step": NamedSharding(mesh, P())})
            tstep = make_train_step(cfg, _acfg(AdamWConfig), tcfg, rules)
        rec = {"loss": []}
        for k, batch in enumerate(batches):
            p, o, m = tstep(p, o, batch)
            rec["loss"].append(float(m["loss"]))
            if k == 0:      # a copy: the next step donates o's buffers
                rec["m1"] = jax.tree.map(np.array, o["m"])
        for name, tree in (("p2", p), ("m2", o["m"]), ("v2", o["v"])):
            rec[name] = jax.tree.map(np.array, tree)
        out[_tid(c)] = rec
    with open(d / f"jax-{_tid(case)}.pkl", "wb") as f:
        pickle.dump(out, f)


# =========================================================================
# the pytest side
# =========================================================================

def _inputs() -> dict:
    import dataclasses

    import jax

    from repro.configs import get_config
    from repro.models import init_decode_state, init_params
    rng = np.random.default_rng(SEED)
    params, states = {}, {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype="float32")
        params[arch] = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                    init_params(jax.random.key(SEED), cfg))
        st = jax.tree.map(np.asarray, init_decode_state(cfg, len(POS),
                                                        MAX_SEQ))
        st["caches"] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            st["caches"])
        st["pos"] = np.asarray(POS, np.int32)
        states[arch] = st
    vocab = get_config(ARCHS[0], reduced=True).vocab_size
    batches = []
    for _ in range(TRAIN_STEPS):
        tok = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
        batches.append({"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    return {"params": params, "states": states, "batches": batches,
            "fwd_tokens": rng.integers(0, vocab, FWD).astype(np.int64),
            "dec_tokens": rng.integers(0, vocab, (STEPS, len(POS), 1))
            .astype(np.int64)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_moe")
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
                          [["jax", str(d), c["arch"],
                            f"{c['mesh'][0]}x{c['mesh'][1]}"]
                           for c in MODEL_CASES], jenv, d, TIMEOUT_S)}
    for world in sorted({_world(m) for m in MESHES}):
        wd = d / f"world{world}"
        wd.mkdir()
        procs[world] = Procs(f"world {world}", __file__,
                             [[str(world), str(r), str(wd)]
                              for r in range(world)], env, d, TIMEOUT_S)
    yield _Runs(d, procs, inp)
    for p in procs.values():            # nothing outlives the module
        p.kill()


class _Runs:
    def __init__(self, d, procs, inp):
        self.d, self.procs, self.inp = d, procs, inp
        self._ranks, self._jax = {}, None

    def ranks(self, mesh, tid):
        world = _world(mesh)
        if world not in self._ranks:
            self.procs[world].wait()
            self._ranks[world] = [
                torch.load(self.d / f"world{world}" / f"rank{r}.pt",
                           weights_only=False) for r in range(world)]
        return [r[tid] for r in self._ranks[world]]

    def jax(self):
        if self._jax is None:
            self.procs["jax"].wait()
            self._jax = {}
            for c in MODEL_CASES:
                with open(self.d / f"jax-{_tid(c)}.pkl", "rb") as f:
                    self._jax.update(pickle.load(f))
        return self._jax


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _port_leaves(tree, arch):
    from repro_torch import convert
    from repro_torch.tree import leaves, leaves_with_paths
    t = convert.lm_params(tree, _port_cfg(arch), device="cpu")
    return ([p for p, _ in leaves_with_paths(t)],
            [x.numpy() for x in leaves(t)])


@pytest.mark.parametrize("case", MODEL_CASES, ids=_tid)
def test_forward_matches_jax_gspmd(runs, case):
    """The sharded forward's logits (each rank its rows), dense and
    capacity dispatch, against JAX's forward(rules=) on its mesh."""
    want = runs.jax()
    for r, rec in enumerate(runs.ranks(case["mesh"], _tid(case))):
        lo, hi = rec["rows"]
        for impl in IMPLS:
            _close(rec[f"fwd-{impl}"], want[(_tid(case), f"fwd-{impl}")]
                   [lo:hi], TOL, f"rank {r} {impl}")


@pytest.mark.parametrize("case", MODEL_CASES, ids=_tid)
def test_decode_matches_jax_gspmd(runs, case):
    """Sharded MLA / MoE decode from a random cache: logits every step
    and the final cache chunks (DeepSeek's latent cache split over
    ``model``) against JAX's decode_step(rules=); collectives exactly
    ``decode_collectives``; the same chunks, the same bits."""
    from repro_torch import convert
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.sharding import shard_leaf
    want = runs.jax()
    full = convert.decode_state(want[(_tid(case), "state")],
                                _port_cfg(case["arch"]), device="cpu")
    ranks = runs.ranks(case["mesh"], _tid(case))
    seen = {}
    for r, rec in enumerate(ranks):
        lo, hi = rec["drows"]
        for t in range(STEPS):
            _close(rec["dec"][t], want[(_tid(case), "dec")][t][lo:hi], TOL,
                   f"rank {r} step {t}")
        assert all(c == rec["dec_want"] for c in rec["dec_calls"])
        mesh = Mesh(case["mesh"], rec["coords"])
        for i, (pair, spair, wpair) in enumerate(zip(
                rec["caches"], rec["specs"], full["caches"])):
            for j, (got, sp, w) in enumerate(zip(pair, spair, wpair)):
                _close(got, shard_leaf(mesh, w, sp).numpy(), TOL,
                       f"rank {r} layer {i} cache {j}")
                key = (i, j) + tuple(c for c, a in zip(
                    rec["coords"], ("data", "model")) if a in sp)
                seen.setdefault(key, set()).add(
                    hashlib.sha1(got.tobytes()).hexdigest())
    assert all(len(h) == 1 for h in seen.values())
    if case["arch"].startswith("deepseek") and case["mesh"][1] > 1:
        assert ranks[0]["specs"][0][0][1] == "model"   # S split


@pytest.mark.parametrize("case", MODEL_CASES, ids=_tid)
def test_bf16_forward_up_to_routing(runs, case):
    """bf16 capacity forward against the port's unsharded one at 5e-2 on
    every position before its row's first routing difference (C22)."""
    from repro_torch import convert
    from repro_torch.models import forward
    cfg = _port_cfg(case["arch"], dtype="bfloat16")
    params = convert.lm_params(runs.inp["params"][case["arch"]], cfg,
                               device="cpu")
    seen = []
    with _recording(seen), torch.no_grad():
        want = forward(params, cfg, torch.from_numpy(
            runs.inp["fwd_tokens"])).float().numpy()
    held = total = 0
    for rec in runs.ranks(case["mesh"], _tid(case)):
        lo, hi = rec["rows"]
        first = np.full(hi - lo, FWD[1])
        for got_d, want_d in zip(rec["bf16_routes"], seen):
            differs = (got_d != want_d[lo:hi]).any(-1)
            for b in range(hi - lo):
                hits = np.nonzero(differs[b])[0]
                if len(hits):
                    first[b] = min(first[b], hits[0])
        for b in range(hi - lo):
            _close(rec["bf16"][b, :first[b]], want[lo + b, :first[b]],
                   TOL_BF16, f"row {lo + b}")
        held, total = held + first.sum(), total + (hi - lo) * FWD[1]
    assert 4 * held >= total, (held, total)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_tid)
def test_training_matches_jax_gspmd(runs, case):
    """Two steps of the sharded or the deferred trainer: losses, AdamW's
    first moment after step 1 and both moments after step 2 (elementwise
    and per leaf in relative Frobenius norm at 1e-4), params within
    5e-3, against JAX's trainer on its mesh."""
    ranks = runs.ranks(case["mesh"], _tid(case))
    got, want = ranks[0], runs.jax()[_tid(case)]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    for key in ("m1", "m2", "v2"):
        paths, ref = _port_leaves(want[key], case["arch"])
        for path, a, b in zip(paths, got[key], ref):
            diff = np.abs(a - b)
            assert (diff <= TOL + TOL * np.abs(b)).all(), (key, path)
            assert (np.linalg.norm(diff)
                    <= TOL * max(np.linalg.norm(b), 1e-30)), (key, path)
    _, p2 = _port_leaves(want["p2"], case["arch"])
    worst = max(float(np.abs(a - b).max()) for a, b in zip(got["p2"], p2))
    assert worst <= TOL_PARAMS, worst


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_tid)
def test_training_collectives_and_replicas(runs, case):
    """Each step's collectives on every rank equal ``step_collectives``;
    ranks that hold the same chunk of a leaf hold the same bits; every
    rank reports the same loss."""
    recs = runs.ranks(case["mesh"], _tid(case))
    axes = {"data": 0, "model": 1}
    for rec in recs:
        assert all(c == rec["want"] for c in rec["calls"])
    for k in range(TRAIN_STEPS):
        for i, split in enumerate(recs[0]["split"]):
            groups = {}
            for rec in recs:
                key = tuple(rec["coords"][axes[a]] for a in split)
                groups.setdefault(key, set()).add(rec["hashes"][k][i])
            assert all(len(h) == 1 for h in groups.values()), (k, i)
    assert len({tuple(r["loss"]) for r in recs}) == 1


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(Path(sys.argv[2]), sys.argv[3],
                  tuple(int(x) for x in sys.argv[4].split("x")))
    else:
        _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
