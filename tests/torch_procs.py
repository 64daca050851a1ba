"""The processes of the port's CPU rank tests (tests/test_torch_dist_*.py):
``Procs`` runs a test file as a script in several processes at once (gloo
ranks, JAX references), joins them under a time limit and fails the
tests on a non-zero exit, with the end of each process's log.

Below it, the harness of the sharded-model suites
(``tests/test_torch_dist_moe.py``, ``tests/test_torch_dist_mamba.py``,
``tests/test_torch_dist_encdec.py``): gloo ranks of the port and JAX
processes (forced host devices) run the same functions on the same numpy
inputs; a ``Suite`` names the configs, the meshes, the trainers and the
forwards' MoE dispatch, and the test files hold the results.

Per config and mesh: the forward's logits (with Qwen2-VL's (3, B, S)
positions and Whisper's frames given), STEPS decode steps from a random
decode state (``shared_cache`` and ``cross_kv`` included) and, for an
encoder-decoder, ``prefill_cross_kv(rules=)``'s chunks; two steps of the
FSDP + TP trainer and two of the deferred one (s = 2).  A JAX process
sees as many host devices as its mesh has ranks.  The reference's
deferred step splits its batch over ``data`` on dim 0 of every entry,
the 3-axis of M-RoPE's positions too (``src/repro/train/train_step.py``
``batch_spec``), so where the data axis has more than one rank that
case runs on the default positions (ROADMAP C34).
"""
import dataclasses
import hashlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import pytest
import torch


class Procs:
    """``script`` run with each of ``argvs``, all started at once, logs in
    ``d``; ``wait()`` joins them within ``timeout`` seconds of the start."""

    def __init__(self, name, script, argvs, env, d: Path, timeout: float):
        self.name, self.timeout, self.t0 = name, timeout, time.monotonic()
        self.procs, self.logs = [], []
        for i, argv in enumerate(argvs):
            log = d / f"{name}-log{i}.txt"
            self.logs.append(log)
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, script, *argv], env=env, stdout=f,
                    stderr=subprocess.STDOUT))
        self.done = False

    def wait(self):
        if not self.done:
            for p in self.procs:
                left = max(1.0, self.timeout
                           - (time.monotonic() - self.t0))
                try:
                    p.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    self.kill()
                    pytest.fail(f"{self.name}: a process ran past "
                                f"{self.timeout} s (a hung collective?)")
            bad = [(i, p.returncode, log.read_text()[-3000:])
                   for i, (p, log) in enumerate(zip(self.procs, self.logs))
                   if p.returncode]
            assert not bad, f"{self.name} failed: {bad}"
            self.done = True

    def kill(self):
        for p in self.procs:
            p.kill()
            p.wait()


# =========================================================================
# the sharded-model suites (tests/test_torch_dist_{moe,mamba,encdec}.py)
# =========================================================================
SEQ, BATCH, NM, TRAIN_STEPS, LR, SEED = 16, 8, 2, 2, 1e-3, 0
FWD = (4, 16)
MAX_SEQ, STEPS, POS = 32, 4, (3, 14, 15, 29)
TIMEOUT_S = 300
TOL = 1e-4                  # tests/test_torch_train.py, f32
TOL_PARAMS = 5e-3           # tests/dist_worker.py


@dataclasses.dataclass(frozen=True)
class Suite:
    """``trainers``: each arch and mesh's training cases, (kind,
    ``moe_impl`` or None for the config's own); ``fwd_impls``: the f32
    forwards' ``moe_impl``s; ``extra(c, inp, rules, rec)``: what a suite
    records besides in a model case, on a rank."""
    name: str
    archs: tuple
    meshes: tuple
    trainers: tuple = (("sharded", None), ("defer", None))
    fwd_impls: tuple = (None,)
    extra: Optional[Callable] = None

    def model_cases(self):
        return [dict(arch=a, mesh=m) for a in self.archs
                for m in self.meshes]

    def train_cases(self):
        return [dict(arch=a, mesh=m, kind=k,
                     **({} if impl is None else {"impl": impl}))
                for a in self.archs for m in self.meshes
                for k, impl in self.trainers]


def world(mesh) -> int:
    return int(np.prod(mesh))


def axis_names(mesh) -> tuple:
    """The axes of a case's mesh: (data, model), or (pod, data, model)."""
    return (("pod",) if len(mesh) == 3 else ()) + ("data", "model")


def tid(c) -> str:
    return (f"{c['arch'].split('_')[0]}-{'x'.join(map(str, c['mesh']))}"
            + "".join(f"-{c[k]}" for k in ("kind", "impl") if k in c))


def impl_kw(impl) -> dict:
    """The config override of a ``moe_impl`` (None: none)."""
    return {} if impl is None else {"moe_impl": impl}


def fwd_key(impl) -> str:
    return "fwd" if impl is None else f"fwd-{impl}"


def port_cfg(arch, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, reduced=True),
                               **dict(dict(dtype="float32"), **kw))


def acfg_of(AdamWConfig):
    return AdamWConfig(lr=LR, warmup_steps=0, total_steps=10)


def train_batch(inp, c, k):
    """Step ``k``'s batch of a training case: Qwen2-VL's deferred case
    on a data axis of more than one rank without its positions (module
    docstring)."""
    b = dict(inp["batches"][c["arch"]][k])
    if c["kind"] == "defer" and c["mesh"][0] > 1:
        b.pop("positions", None)
    return b


def fwd_extra(inp, arch, rows=slice(None)) -> dict:
    """The forward's positions / frames, their rows ``rows``."""
    out = {}
    for k, v in inp["fwd_extra"][arch].items():
        v = torch.from_numpy(v)
        out[k] = v[:, rows] if k == "positions" else v[rows]
    return out


# =========================================================================
# the ranks (a test file as a script; torch only)
# =========================================================================

def _rank_model(suite, c, inp, rules):
    from repro_torch import convert
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.models import decode_step, forward, prefill_cross_kv
    from repro_torch.models.lm import decode_state_layout
    from repro_torch.models.sharding import batch_rows
    from repro_torch.train.train_step import decode_collectives
    arch, mesh = c["arch"], rules.mesh
    cfg = port_cfg(arch)
    rows = batch_rows(rules, FWD[0])
    params = convert.lm_shards(inp["params"][arch], cfg, rules, device="cpu")
    rec = {"rows": (rows.start, rows.stop),
           "coords": tuple(mesh.index(a) for a in mesh.axis_names)}
    with torch.no_grad():
        for impl in suite.fwd_impls:
            rec[fwd_key(impl)] = forward(
                params, port_cfg(arch, **impl_kw(impl)),
                torch.from_numpy(inp["fwd_tokens"])[rows], rules=rules,
                **fwd_extra(inp, arch, rows)).numpy()
        if cfg.encoder_layers:
            audio = torch.from_numpy(inp["fwd_extra"][arch]["audio_embed"])
            rec["cross_kv"] = [[t.numpy() for t in pair] for pair in
                               prefill_cross_kv(params, cfg, audio,
                                                rules=rules)]
    if suite.extra is not None:
        suite.extra(c, inp, rules, rec)
    state = convert.decode_state_shards(inp["states"][arch], cfg, rules,
                                        device="cpu")
    drows = batch_rows(rules, len(POS))
    rec.update(drows=(drows.start, drows.stop), dec=[], dec_calls=[],
               dec_want=decode_collectives(cfg, rules, len(POS), MAX_SEQ))
    for t in range(STEPS):
        COLLECTIVES.reset()
        with torch.no_grad():
            lg, state = decode_step(params, cfg, state,
                                    torch.from_numpy(inp["dec_tokens"][t]),
                                    rules=rules)
        rec["dec_calls"].append(dict(COLLECTIVES.calls))
        rec["dec"].append(lg.numpy())
    specs = decode_state_layout(rules, cfg, len(POS), MAX_SEQ)
    rec["state"] = {k: [[t.numpy() for t in pair] for pair in state[k]]
                    for k in ("caches", "shared_cache", "cross_kv")
                    if k in state}
    rec["specs"] = {k: specs[k] for k in rec["state"]}
    return rec


def _rank_train(c, inp, rules):
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
    cfg = port_cfg(c["arch"], remat="full", **impl_kw(c.get("impl")))
    defer = c["kind"] == "defer"
    tcfg = TrainConfig(microbatches=NM, defer_s=2 if defer else 1)
    acfg = acfg_of(AdamWConfig)
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
           "coords": tuple(mesh.index(a) for a in mesh.axis_names),
           "split": [[a for _, a in split_axes(mesh, s)]
                     for s in leaf_specs(specs, params)]}
    for k in range(TRAIN_STEPS):
        COLLECTIVES.reset()
        params, opt, m = step(params, opt, {
            key: torch.from_numpy(v)
            for key, v in train_batch(inp, c, k).items()})
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


def rank_main(suite: Suite, n: int, rank: int, d: Path) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import MeshRules
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(d / "store"), n), rank=rank,
        world_size=n)
    with open(d.parent / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    out = {}
    for c in suite.model_cases() + suite.train_cases():
        if world(c["mesh"]) == n:
            shape = dict(zip(axis_names(c["mesh"]), c["mesh"]))
            rules = MeshRules(make_mesh(shape["data"], shape["model"],
                                        pod=shape.get("pod")))
            out[tid(c)] = (_rank_train(c, inp, rules) if "kind" in c
                           else _rank_model(suite, c, inp, rules))
    torch.save(out, d / f"rank{rank}.pt")
    dist.destroy_process_group()


# =========================================================================
# the JAX reference (a test file as a script with "jax")
# =========================================================================

def jax_main(suite: Suite, d: Path, arch: str, mesh_shape) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh_auto
    from repro.configs import get_config
    from repro.launch.specs import _cache_pspec
    from repro.models import decode_step, forward, prefill_cross_kv
    from repro.models.sharding import MeshRules, tree_shardings
    from repro.optim import AdamWConfig, adamw_init
    from repro.train.train_step import (TrainConfig, make_defer_train_step,
                                        make_train_step)
    with open(d / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh_auto(mesh_shape, axis_names(mesh_shape))
    rules = MeshRules(mesh)

    def cfg_of(**kw):
        return dataclasses.replace(get_config(arch, reduced=True),
                                   **dict(dict(dtype="float32"), **kw))

    cfg = cfg_of()

    def put(a, axes):
        a = jnp.asarray(a)
        return jax.device_put(a, NamedSharding(mesh, rules.fit(a.shape,
                                                               axes)))

    def placed():
        p = jax.tree.map(jnp.asarray, inp["params"][arch])
        return jax.device_put(p, tree_shardings(rules, p))

    out = {}
    case = dict(arch=arch, mesh=mesh_shape)
    bax = rules.batch_axes
    toks = put(inp["fwd_tokens"].astype(np.int32), [bax, None])
    extra = {k: (put(v.astype(np.int32), [None, bax, None])
                 if k == "positions" else put(v, [bax, None, None]))
             for k, v in inp["fwd_extra"][arch].items()}
    p = placed()
    for impl in suite.fwd_impls:
        fcfg = cfg_of(**impl_kw(impl))
        fwd = jax.jit(lambda p, t, e: forward(p, fcfg, t, rules=rules, **e))
        out[(tid(case), fwd_key(impl))] = np.array(fwd(p, toks, extra))
    if cfg.encoder_layers:
        kv = jax.jit(lambda p, a: prefill_cross_kv(p, cfg, a, rules))(
            p, extra["audio_embed"])
        out[(tid(case), "cross_kv")] = jax.tree.map(np.array, kv)

    def place(path, leaf):
        spec = _cache_pspec(rules, cfg, "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf)
        return jax.device_put(jnp.asarray(leaf), NamedSharding(mesh, spec))

    state = jax.tree_util.tree_map_with_path(place, inp["states"][arch])
    step = jax.jit(lambda p, s, t: decode_step(p, cfg, s, t, rules=rules))
    dec = []
    for t in range(STEPS):
        lg, state = step(p, state, put(
            inp["dec_tokens"][t].astype(np.int32), [bax, None]))
        dec.append(np.array(lg))
    out[(tid(case), "dec")] = dec
    out[(tid(case), "state")] = jax.tree.map(np.array, state)
    for c in suite.train_cases():
        if (c["arch"], c["mesh"]) != (arch, mesh_shape):
            continue
        defer = c["kind"] == "defer"
        tcfg = TrainConfig(microbatches=NM, defer_s=2 if defer else 1)
        ccfg = cfg_of(**impl_kw(c.get("impl")))
        p = jax.tree.map(jnp.asarray, inp["params"][arch])
        o = adamw_init(p)
        if defer:
            rep = NamedSharding(mesh, P())
            p, o = jax.device_put((p, o), rep)
            tstep = make_defer_train_step(ccfg, acfg_of(AdamWConfig), tcfg,
                                          rules)
        else:
            p = jax.device_put(p, tree_shardings(rules, p))
            o = jax.device_put(o, {"m": tree_shardings(rules, o["m"]),
                                   "v": tree_shardings(rules, o["v"]),
                                   "step": NamedSharding(mesh, P())})
            tstep = make_train_step(ccfg, acfg_of(AdamWConfig), tcfg, rules)
        rec = {"loss": []}
        for k in range(TRAIN_STEPS):
            batch = {key: jnp.asarray(v)
                     for key, v in train_batch(inp, c, k).items()}
            p, o, m = tstep(p, o, batch)
            rec["loss"].append(float(m["loss"]))
            if k == 0:      # a copy: the next step donates o's buffers
                rec["m1"] = jax.tree.map(np.array, o["m"])
        for name, tree in (("p2", p), ("m2", o["m"]), ("v2", o["v"])):
            rec[name] = jax.tree.map(np.array, tree)
        out[tid(c)] = rec
    with open(d / f"jax-{tid(case)}.pkl", "wb") as f:
        pickle.dump(out, f)


def main(suite: Suite, argv) -> None:
    if argv[1] == "jax":
        jax_main(suite, Path(argv[2]), argv[3],
                 tuple(int(x) for x in argv[4].split("x")))
    else:
        rank_main(suite, int(argv[1]), int(argv[2]), Path(argv[3]))


# =========================================================================
# the pytest side
# =========================================================================

def inputs(suite: Suite) -> dict:
    import jax

    from repro.configs import get_config
    from repro.models import init_decode_state, init_params
    rng = np.random.default_rng(SEED)
    params, states, batches, extra = {}, {}, {}, {}
    for arch in suite.archs:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype="float32")
        params[arch] = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                    init_params(jax.random.key(SEED), cfg))
        st = jax.tree.map(np.asarray, init_decode_state(
            cfg, len(POS), MAX_SEQ, with_encoder=bool(cfg.encoder_layers)))
        for key in ("caches", "shared_cache", "cross_kv"):
            if key in st:
                st[key] = jax.tree.map(
                    lambda a: rng.standard_normal(a.shape).astype(
                        np.float32), st[key])
        st["pos"] = np.asarray(POS, np.int32)
        states[arch] = st

        def frames(b, cfg=cfg):
            return {"audio_embed": rng.standard_normal(
                (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}

        def positions(b, s):
            return {"positions": rng.integers(0, 2 * s, (3, b, s))
                    .astype(np.int64)}

        def more(b, s, cfg=cfg):
            if cfg.encoder_layers:
                return frames(b)
            return positions(b, s) if cfg.mrope else {}

        extra[arch] = more(*FWD)
        batches[arch] = []
        for _ in range(TRAIN_STEPS):
            tok = rng.integers(0, cfg.vocab_size,
                               (BATCH, SEQ + 1)).astype(np.int32)
            batches[arch].append({"tokens": tok[:, :-1],
                                  "labels": tok[:, 1:],
                                  **more(BATCH, SEQ)})
    vocab = get_config(suite.archs[0], reduced=True).vocab_size
    return {"params": params, "states": states, "batches": batches,
            "fwd_extra": extra,
            "fwd_tokens": rng.integers(0, vocab, FWD).astype(np.int64),
            "dec_tokens": rng.integers(0, vocab, (STEPS, len(POS), 1))
            .astype(np.int64)}


def start(suite: Suite, script: str, d: Path) -> "Runs":
    """Write the inputs and start every process (the JAX ones with as
    many host devices as their mesh has ranks)."""
    inp = inputs(suite)
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    procs = {}
    for n in sorted({world(m) for m in suite.meshes}):
        jenv = dict(env, JAX_PLATFORMS="cpu",
                    XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
        procs[("jax", n)] = Procs(
            f"jax {n}", script,
            [["jax", str(d), c["arch"], "x".join(map(str, c["mesh"]))]
             for c in suite.model_cases() if world(c["mesh"]) == n],
            jenv, d, TIMEOUT_S)
        wd = d / f"world{n}"
        wd.mkdir()
        procs[n] = Procs(f"world {n}", script,
                         [[str(n), str(r), str(wd)] for r in range(n)],
                         env, d, TIMEOUT_S)
    return Runs(suite, d, procs, inp)


class Runs:
    def __init__(self, suite, d, procs, inp):
        self.suite, self.d, self.procs, self.inp = suite, d, procs, inp
        self._ranks, self._jax = {}, {}

    def ranks(self, mesh, key):
        n = world(mesh)
        if n not in self._ranks:
            self.procs[n].wait()
            self._ranks[n] = [
                torch.load(self.d / f"world{n}" / f"rank{r}.pt",
                           weights_only=False) for r in range(n)]
        return [r[key] for r in self._ranks[n]]

    def jax(self, mesh):
        n = world(mesh)
        if n not in self._jax:
            self.procs[("jax", n)].wait()
            self._jax[n] = {}
            for c in self.suite.model_cases():
                if world(c["mesh"]) == n:
                    with open(self.d / f"jax-{tid(c)}.pkl", "rb") as f:
                        self._jax[n].update(pickle.load(f))
        return self._jax[n]

    def kill(self):
        for p in self.procs.values():
            p.kill()


def close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _port_leaves(tree, arch):
    from repro_torch import convert
    from repro_torch.tree import leaves, leaves_with_paths
    t = convert.lm_params(tree, port_cfg(arch), device="cpu")
    return ([p for p, _ in leaves_with_paths(t)],
            [x.numpy() for x in leaves(t)])


def check_forward(runs: Runs, case) -> None:
    """The sharded forward's logits (each rank its rows), each of the
    suite's ``fwd_impls``, against JAX's forward(rules=) on its mesh."""
    want = runs.jax(case["mesh"])
    for r, rec in enumerate(runs.ranks(case["mesh"], tid(case))):
        lo, hi = rec["rows"]
        for impl in runs.suite.fwd_impls:
            close(rec[fwd_key(impl)],
                  want[(tid(case), fwd_key(impl))][lo:hi], TOL,
                  f"rank {r} {impl}")


def check_decode(runs: Runs, case) -> None:
    """STEPS sharded decode steps from a random state: the logits every
    step and the final chunks of every cache (``caches``,
    ``shared_cache``, ``cross_kv``) against JAX's decode_step(rules=);
    collectives exactly ``decode_collectives``; ranks that hold the same
    chunk hold the same bits."""
    from repro_torch import convert
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.sharding import shard_leaf
    want = runs.jax(case["mesh"])
    full = convert.decode_state(want[(tid(case), "state")],
                                port_cfg(case["arch"]), device="cpu")
    seen = {}
    for r, rec in enumerate(runs.ranks(case["mesh"], tid(case))):
        lo, hi = rec["drows"]
        for t in range(STEPS):
            close(rec["dec"][t], want[(tid(case), "dec")][t][lo:hi], TOL,
                  f"rank {r} step {t}")
        assert all(c == rec["dec_want"] for c in rec["dec_calls"]), (
            rec["dec_calls"], rec["dec_want"])
        mesh = Mesh(case["mesh"], rec["coords"])
        assert set(rec["state"]) == {k for k in ("caches", "shared_cache",
                                                 "cross_kv") if k in full}
        for key, pairs in rec["state"].items():
            for i, (pair, spair, wpair) in enumerate(zip(
                    pairs, rec["specs"][key], full[key])):
                for j, (got, sp, w) in enumerate(zip(pair, spair, wpair)):
                    close(got, shard_leaf(mesh, w, sp).numpy(), TOL,
                          f"rank {r} {key} {i} {j}")
                    used = {x for e in sp if e is not None
                            for x in (e if isinstance(e, tuple) else (e,))}
                    k = (key, i, j) + tuple(c for c, a in zip(
                        rec["coords"], axis_names(case["mesh"]))
                        if a in used)
                    seen.setdefault(k, set()).add(
                        hashlib.sha1(got.tobytes()).hexdigest())
    assert all(len(h) == 1 for h in seen.values())


def check_training(runs: Runs, case) -> None:
    """Two steps of the sharded or the deferred trainer: losses, AdamW's
    first moment after step 1 and both moments after step 2 (elementwise
    and per leaf in relative Frobenius norm at 1e-4), params within
    5e-3, against JAX's trainer on its mesh."""
    got = runs.ranks(case["mesh"], tid(case))[0]
    want = runs.jax(case["mesh"])[tid(case)]
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


def check_collectives_and_replicas(runs: Runs, case) -> None:
    """Each step's collectives on every rank equal ``step_collectives``;
    ranks that hold the same chunk of a leaf hold the same bits; every
    rank reports the same loss."""
    recs = runs.ranks(case["mesh"], tid(case))
    axes = {a: i for i, a in enumerate(axis_names(case["mesh"]))}
    for rec in recs:
        assert all(c == rec["want"] for c in rec["calls"]), (
            rec["calls"], rec["want"])
    for k in range(TRAIN_STEPS):
        for i, split in enumerate(recs[0]["split"]):
            groups = {}
            for rec in recs:
                key = tuple(rec["coords"][axes[a]] for a in split)
                groups.setdefault(key, set()).add(rec["hashes"][k][i])
            assert all(len(h) == 1 for h in groups.values()), (k, i)
    assert len({tuple(r["loss"]) for r in recs}) == 1


def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_convert_shards(jp, jstate, cfg, mesh_shape=(2, 2)) -> None:
    """On every rank of a ``mesh_shape`` mesh (no process group: the
    chunks only): ``convert.lm_shards`` of the JAX params ``jp`` is each
    leaf's ``shard_leaf`` by its spec, and ``convert.decode_state_shards``
    of the JAX decode state ``jstate`` holds, leaf for leaf, the keys,
    shapes and dtypes of ``init_decode_state(rules=)``'s chunks (the
    shared block's ``shared_cache`` and ``cross_kv`` included) and each
    leaf's ``shard_leaf`` of the whole state by its ``cache_spec``."""
    from repro_torch import convert
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_decode_state
    from repro_torch.models.lm import decode_state_layout, param_specs
    from repro_torch.models.sharding import MeshRules, leaf_specs, shard_leaf
    from repro_torch.tree import leaves
    full = convert.lm_params(jp, cfg, device="cpu")
    whole = convert.decode_state(jstate, cfg, device="cpu")
    B = len(jstate["pos"])
    for coords in np.ndindex(*mesh_shape):
        rules = MeshRules(Mesh(mesh_shape, coords))
        specs = param_specs(rules, cfg)
        shards = convert.lm_shards(jp, cfg, rules, device="cpu")
        for t, f, sp in zip(leaves(shards), leaves(full),
                            leaf_specs(specs, full)):
            assert torch.equal(t, shard_leaf(rules.mesh, f, sp))
        got = convert.decode_state_shards(jstate, cfg, rules, device="cpu")
        made = init_decode_state(cfg, B, got["max_seq"], device="cpu",
                                 rules=rules,
                                 with_encoder="cross_kv" in jstate)
        assert set(got) == set(made)
        assert torch.equal(got["pos"], whole["pos"])
        for key in ("caches", "shared_cache", "cross_kv"):
            assert len(got.get(key, ())) == len(made.get(key, ()))
            for pair, mpair in zip(got.get(key, ()), made.get(key, ())):
                assert len(pair) == len(mpair)
                for t, m in zip(pair, mpair):
                    assert t.shape == m.shape and t.dtype == m.dtype
        layout = decode_state_layout(rules, cfg, B, got["max_seq"])
        for key in ("caches", "shared_cache", "cross_kv"):
            for pair, spair, wpair in zip(got.get(key, ()),
                                          layout.get(key, ()),
                                          whole.get(key, ())):
                for t, sp, w in zip(pair, spair, wpair):
                    assert torch.equal(t, shard_leaf(rules.mesh, w, sp))


def train_cli_on_mesh(argv, nproc: int, timeout: float = 240.0) -> list:
    """``launch/train.py`` with ``argv`` under ``torch.distributed.run``
    with ``nproc`` CPU ranks (gloo, loopback, a free port): rank 0's
    ``step`` lines' losses, in order (the run must exit 0)."""
    import re
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         f"--nproc-per-node={nproc}", "--master-addr=127.0.0.1",
         f"--master-port={port}", "-m", "repro_torch.launch.train",
         *argv], env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    return [float(x) for x in re.findall(r"^step \d+ loss=([-\d.]+)",
                                         r.stdout, re.M)]


__all__ = ["Procs", "Suite", "check_collectives_and_replicas",
           "check_convert_shards", "check_decode", "check_forward",
           "check_training", "main", "one_torch_thread", "start",
           "tid", "train_cli_on_mesh"]
