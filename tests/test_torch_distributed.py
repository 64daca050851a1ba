"""The port's distributed layouts on the CPU: ``core.distributed``'s six
solvers, the facade's 1d / 2d fits, the Nystrom 1d round trip, the
guarded 1d fit, the 1d fleet and the collective counts, held against the
JAX package on the same numpy inputs and schedules.

The ranks are this file run as a script, ``python
tests/test_torch_distributed.py WORLD RANK DIR``: one process per rank,
gloo on CPU tensors, a ``FileStore`` in ``DIR`` (no port to collide on),
every process under a time limit so a hung collective fails its tests
instead of the suite.  One spawn per world size, started once for the
module: world 2 runs the 1d layout on a (1, 2) mesh and the 2d layout on
(2, 1); world 4 the 1d layout on (1, 4) and the 2d layout on (2, 2) (the
facade also on its auto (4, 1)).  Each rank writes every case's result;
each case is then its own test, reading the spawn's results.  The ranks
import torch only.

References, in the pytest process: JAX's ``dist_*`` on its 1-device mesh
at the same (kernel, s, slab_free), and JAX's serial legacy solvers,
both within the reference's 5e-5 (``tests/dist_worker.py``); the JAX
facade on its 1-device mesh at rtol = atol = 1e-5
(``tests/test_api.py``), the Nystrom map rebuilt by the port at 1e-4
(``tests/test_torch_nystrom.py``).  Every rank's alpha must equal every
other rank's bit for bit, and the collectives each run counted must be
``rounds x round_collectives + setup_collectives`` (once a solve; + the
2d alpha assembly after each chunk) + rank 0's checks
(``core.perf_model``).
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

M, N = 64, 32
KERNELS = {"linear": dict(name="linear"),
           "polynomial": dict(name="polynomial", degree=2, coef0=1.0),
           "rbf": dict(name="rbf", sigma=1.0)}
S_VALUES = (1, 4, 16)
H_1D, H_2D, B = 32, (32, 27), 4
MESHES = {2: {"1d": (1, 2), "2d": (2, 1)}, 4: {"1d": (1, 4), "2d": (2, 2)}}
TIMEOUT_S = 300
TOL_SOLVER = 5e-5                          # tests/dist_worker.py
TOL_FACADE = dict(rtol=1e-5, atol=1e-5)    # tests/test_api.py
TOL_MAP = 1e-4                             # tests/test_torch_nystrom.py
LAMS = (0.25, 1.0, 4.0)
CS = (0.5, 1.0, 2.0)


def _solver_cases():
    """``(world, layout, problem, kernel, s, slab_free, H)``: every port
    ``dist_*`` solver (s = 1 through ``dist_dcd_ksvm`` /
    ``dist_bdcd_krr``) on both meshes of each world."""
    out = []
    for world in MESHES:
        for problem in ("ksvm", "krr"):
            for k in KERNELS:
                for s in S_VALUES:
                    for sf in (True, False):
                        out.append((world, "1d", problem, k, s, sf, H_1D))
                    for H in H_2D:
                        out.append((world, "2d", problem, k, s, True, H))
    return out


SOLVER_CASES = _solver_cases()
# the facade's fits: (problem, options) on the rbf kernel
FACADE = {
    "ksvm-sstep": ("ksvm", dict(method="sstep", s=8, max_iters=27)),
    "ksvm-classical": ("ksvm", dict(method="classical", max_iters=27)),
    "ksvm-sstep-tol": ("ksvm", dict(method="sstep", s=4, tol=1e-3,
                                    check_every=2, max_iters=96)),
    "krr-sstep": ("krr", dict(method="sstep", s=8, b=4, max_iters=27)),
    "krr-classical": ("krr", dict(method="classical", b=4, max_iters=27)),
    "krr-sstep-tol": ("krr", dict(method="sstep", s=4, b=4, tol=5e-2,
                                  check_every=2, max_iters=400)),
    "krr-classical-tol": ("krr", dict(method="classical", b=4, tol=5e-2,
                                      check_every=8, max_iters=400)),
}
# per world: the facade's layouts, by name -> (layout, explicit mesh)
FACADE_LAYOUTS = {2: {"1d": ("1d", None), "2d": ("2d", None)},
                  4: {"1d": ("1d", None), "2d": ("2d", None),
                      "2d-2x2": ("2d", (2, 2))}}
FACADE_CASES = [(w, lay, name) for w, lays in FACADE_LAYOUTS.items()
                for lay in lays for name in FACADE]
SEED = 7


def _case_id(case) -> str:
    world, layout, problem, k, s, sf, H = case
    return f"w{world}-{layout}-{problem}-{k}-s{s}-sf{int(sf)}-H{H}"


def _inputs(seed: int = 0) -> dict:
    """The numpy inputs every rank and every reference reads."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(M) < 0.5, 1.0, -1.0).astype(np.float32)
    w = rng.standard_normal(N)
    A = ((rng.standard_normal((M, N)) + 0.8 * y[:, None] * w
          / np.linalg.norm(w)) / np.sqrt(N)).astype(np.float32)
    Ar = (rng.standard_normal((M, N)) / np.sqrt(N)).astype(np.float32)
    yr = (np.sin(Ar @ rng.standard_normal(N))
          + 0.1 * rng.standard_normal(M)).astype(np.float32)
    out = dict(A=A, y=y, Ar=Ar, yr=yr,
               sched_svm=rng.integers(0, M, H_1D).astype(np.int32),
               sched_krr=rng.integers(0, M, (H_1D, B)).astype(np.int32))
    # guarded fits (the reference's tests/test_resilience.py script)
    Ag = rng.standard_normal((128, 16)).astype(np.float32)
    out.update(Ag=Ag, yg=(Ag @ rng.standard_normal(16) + 0.1).astype(
        np.float32))
    return out


# =========================================================================
# the ranks (this file as a script; torch only)
# =========================================================================

def _kernel(name):
    from repro_torch.core import KernelConfig
    return KernelConfig(**KERNELS[name])


def _solve_case(mesh, inp, case):
    """One solver case on this rank: (alpha on every rank, calls, words)
    with the counts of the solver call alone (the 2d assembly after)."""
    from repro_torch.core import KRRConfig, SVMConfig
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import COLLECTIVES
    _, layout, problem, k, s, sf, H = case
    zero = torch.zeros(M)
    COLLECTIVES.reset()
    if problem == "ksvm":
        A, y = torch.from_numpy(inp["A"]), torch.from_numpy(inp["y"])
        sched = torch.from_numpy(inp["sched_svm"][:H])
        cfg = SVMConfig(C=1.0, kernel=_kernel(k))
        if layout == "1d":
            a = (D.dist_dcd_ksvm(mesh, A, y, zero, sched, cfg, slab_free=sf)
                 if s == 1 else
                 D.dist_sstep_dcd_ksvm(mesh, A, y, zero, sched, cfg, s,
                                       slab_free=sf))
        else:
            a = D.dist_sstep_dcd_ksvm_2d(mesh, A, y, zero, sched, cfg, s)
    else:
        A, y = torch.from_numpy(inp["Ar"]), torch.from_numpy(inp["yr"])
        sched = torch.from_numpy(inp["sched_krr"][:H])
        cfg = KRRConfig(lam=0.7, kernel=_kernel(k))
        if layout == "1d":
            a = (D.dist_bdcd_krr(mesh, A, y, zero, sched, cfg, slab_free=sf)
                 if s == 1 else
                 D.dist_sstep_bdcd_krr(mesh, A, y, zero, sched, cfg, s,
                                       slab_free=sf))
        else:
            a = D.dist_sstep_bdcd_krr_2d(mesh, A, y, zero, sched, cfg, s)
    calls = {f"{ax}/{kd}": v for (ax, kd), v in COLLECTIVES.calls.items()}
    words = {f"{ax}/{kd}": v for (ax, kd), v in COLLECTIVES.words.items()}
    if layout == "2d":
        a = D.assemble_2d(mesh, a, M)
    return dict(alpha=a.numpy(), calls=calls, words=words)


def _fit_record(res, est=None, Q=None):
    from repro_torch.launch.mesh import COLLECTIVES
    out = dict(alpha=res.alpha.numpy(), rounds=res.rounds_run,
               iters=res.iters_run, converged=res.converged,
               history=(None if res.history is None
                        else np.asarray(res.history)),
               calls={f"{a}/{k}": v for (a, k), v in
                      COLLECTIVES.calls.items()},
               P=res.comm.get("P"))
    if est is not None:
        out["pred"] = (est.decision_function(Q) if hasattr(
            est, "decision_function") else est.predict(Q)).numpy()
    return out


def _facade_case(world, inp, lay_name, name):
    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.launch.mesh import COLLECTIVES, make_mesh
    layout, shape = FACADE_LAYOUTS[world][lay_name]
    problem, kw = FACADE[name]
    opts = SolverOptions(layout=layout, seed=SEED,
                         mesh=None if shape is None else make_mesh(*shape),
                         **kw)
    COLLECTIVES.reset()
    if problem == "ksvm":
        est = KernelSVM(C=1.0, kernel="rbf", options=opts, device="cpu")
        res = est.fit(inp["A"], inp["y"],
                      schedule=inp[f"fsched-{name}"])
        return _fit_record(res, est, inp["A"][:16])
    est = KernelRidge(lam=1.0, kernel="rbf", options=opts, device="cpu")
    res = est.fit(inp["Ar"], inp["yr"], schedule=inp[f"fsched-{name}"])
    return _fit_record(res, est, inp["Ar"][:16])


def _nystrom_cases(inp):
    """The 1d Nystrom fits (the JAX landmarks and schedules replayed) and
    the serial fits of the same landmarks."""
    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.launch.mesh import COLLECTIVES
    out = {}
    for problem in ("ksvm", "krr"):
        kw = dict(method="sstep", s=4, max_iters=64, approx="nystrom",
                  landmarks=16, record=True, check_every=4, seed=SEED)
        for layout in ("1d", "serial"):
            opts = SolverOptions(layout=layout, **kw,
                                 **({"b": 4} if problem == "krr" else {}))
            COLLECTIVES.reset()
            if problem == "ksvm":
                est = KernelSVM(C=1.0, kernel="rbf", options=opts,
                                device="cpu")
                res = est.fit(inp["A"], inp["y"],
                              schedule=inp["nsched-ksvm"],
                              landmarks=inp["nland-ksvm"])
                Q = inp["A"][:16]
            else:
                est = KernelRidge(lam=1.0, kernel="rbf", options=opts,
                                  device="cpu")
                res = est.fit(inp["Ar"], inp["yr"],
                              schedule=inp["nsched-krr"],
                              landmarks=inp["nland-krr"])
                Q = inp["Ar"][:16]
            out[f"{problem}-{layout}"] = _fit_record(res, est, Q)
    return out


def _guard_cases(inp, tmp: Path):
    """The reference's guarded 1d script (plain, guarded, a NaN fault),
    a guarded 2d fit, and a guarded 1d fit killed at a checkpoint and
    resumed (every rank names the same directory; rank 0 writes it)."""
    from repro_torch.api import KernelRidge, SolverOptions
    from repro_torch.resilience import FaultPlan, SimulatedKill, inject
    A, y = inp["Ag"], inp["yg"]
    kw = dict(method="sstep", s=8, b=8, max_iters=256, seed=3)
    out = {}

    def fit(layout, **extra):
        return KernelRidge(lam=0.5, kernel="linear", device="cpu",
                           options=SolverOptions(layout=layout, **kw,
                                                 **extra)).fit(A, y)

    for layout in ("1d", "2d"):
        out[f"plain-{layout}"] = _fit_record(fit(layout))
        out[f"guard-{layout}"] = _fit_record(fit(layout, guard=True))
    with inject(FaultPlan(nan_at_iter=64)) as plan:
        r = fit("1d", guard=True)
    out["fault-1d"] = dict(_fit_record(r), fired=plan.carry_fired,
                           acts=[e.action for e in r.health.fallbacks])
    ck = dict(guard=True, checkpoint_every=4,
              checkpoint_dir=str(tmp / "ckpt"))
    killed = False
    with inject(FaultPlan(kill_at_iter=96)):
        try:
            fit("1d", **ck)
        except SimulatedKill:
            killed = True
    r = KernelRidge(lam=0.5, kernel="linear", device="cpu",
                    options=SolverOptions(layout="1d", **kw, **ck)).fit(
        A, y, resume_from=str(tmp / "ckpt"))
    out["resume-1d"] = dict(_fit_record(r), killed=killed,
                            resumed=r.health.resumed_from is not None)
    return out


def _fleet_cases(inp):
    """The 1d fleets (fast and tolerance paths) and the sequential 1d
    fits of their members."""
    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.tune import solve_fleet
    out = {}
    kw = dict(method="sstep", s=4, b=4, max_iters=64, layout="1d",
              seed=SEED)
    for path, extra in (("fast", {}), ("tol", dict(tol=5e-2,
                                                    check_every=2))):
        opts = SolverOptions(**kw, **extra)
        COLLECTIVES.reset()
        f = solve_fleet(inp["Ar"], inp["yr"], lams=LAMS, kernel="rbf",
                        options=opts, device="cpu",
                        schedule=inp["sched_krr"].repeat(2, axis=0))
        out[f"krr-{path}"] = dict(
            alpha=f.alpha.numpy(), rounds=f.rounds_run,
            history=f.history, converged=f.converged,
            calls={f"{a}/{k}": v for (a, k), v in
                   COLLECTIVES.calls.items()},
            singles=[KernelRidge(lam=lam, kernel="rbf", options=opts,
                                 device="cpu").fit(
                inp["Ar"], inp["yr"],
                schedule=inp["sched_krr"].repeat(2, axis=0)).alpha.numpy()
                for lam in LAMS])
    opts = SolverOptions(method="sstep", s=4, max_iters=64, layout="1d",
                         seed=SEED)
    f = solve_fleet(inp["A"], inp["y"], Cs=CS, kernel="rbf", options=opts,
                    device="cpu", schedule=np.tile(inp["sched_svm"], 2))
    out["ksvm-fast"] = dict(
        alpha=f.alpha.numpy(), rounds=f.rounds_run,
        singles=[KernelSVM(C=c, kernel="rbf", options=opts,
                           device="cpu").fit(
            inp["A"], inp["y"],
            schedule=np.tile(inp["sched_svm"], 2)).alpha.numpy()
            for c in CS])
    return out


def _auto_case(inp):
    """``layout="auto"`` over the world: the plan every rank resolved."""
    from repro_torch.api import KernelRidge, SolverOptions
    r = KernelRidge(lam=1.0, kernel="rbf", device="cpu",
                    options=SolverOptions(layout="auto", s=4, b=4,
                                          max_iters=16, seed=SEED)).fit(
        inp["Ar"], inp["yr"])
    return dict(layout=r.options.layout, alpha=r.alpha.numpy(),
                searched=sorted({f["layout"] for f in r.plan.frontier}))


def _rank_main(world: int, rank: int, d: Path) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(d / "store"), world), rank=rank,
        world_size=world)
    inp = dict(np.load(d / "inputs.npz"))
    meshes = {lay: make_mesh(*shape) for lay, shape in MESHES[world].items()}
    out = {"solver": {}, "facade": {}}
    for case in SOLVER_CASES:
        if case[0] == world:
            out["solver"][_case_id(case)] = _solve_case(meshes[case[1]],
                                                        inp, case)
    for _, lay, name in (c for c in FACADE_CASES if c[0] == world):
        out["facade"][f"{lay}-{name}"] = _facade_case(world, inp, lay, name)
    out["nystrom"] = _nystrom_cases(inp)
    out["guard"] = _guard_cases(inp, d)
    out["fleet"] = _fleet_cases(inp)
    out["auto"] = _auto_case(inp)
    torch.save(out, d / f"rank{rank}.pt")
    dist.destroy_process_group()


# =========================================================================
# the pytest side
# =========================================================================

class _Spawn:
    """The ranks of one world size, started at once; ``results()`` waits
    for them (each under ``TIMEOUT_S``) and returns every rank's
    results."""

    def __init__(self, world: int, d: Path, inputs: dict):
        self.world, self.d = world, d
        np.savez(d / "inputs.npz", **inputs)
        env = dict(os.environ)
        src = str(Path(__file__).resolve().parents[1] / "src")
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        self.t0 = time.monotonic()
        # each rank logs to a file: a full pipe would block its rank, and
        # with it every collective
        self.procs = []
        for r in range(world):
            with open(d / f"log{r}.txt", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, str(world), str(r), str(d)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        self._results = None

    def results(self):
        if self._results is None:
            for p in self.procs:
                left = max(1.0, TIMEOUT_S - (time.monotonic() - self.t0))
                try:
                    p.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    pytest.fail(f"world {self.world}: a rank ran past "
                                f"{TIMEOUT_S} s (a hung collective?)")
            bad = [(r, p.returncode,
                    (self.d / f"log{r}.txt").read_text()[-3000:])
                   for r, p in enumerate(self.procs) if p.returncode]
            assert not bad, f"world {self.world} ranks failed: {bad}"
            self._results = [torch.load(self.d / f"rank{r}.pt",
                                        weights_only=False)
                             for r in range(self.world)]
        return self._results


def _jax_facade_schedules() -> dict:
    """The schedules the JAX facade draws for each facade case (its seed,
    its H and b), so the ranks replay exactly the JAX fit's coordinates."""
    import jax

    from repro.core import block_schedule, coordinate_schedule
    out = {}
    for name, (problem, kw) in FACADE.items():
        key = jax.random.key(SEED)
        H = kw["max_iters"]
        out[f"fsched-{name}"] = np.asarray(
            coordinate_schedule(key, H, M) if problem == "ksvm"
            else block_schedule(key, H, M, kw["b"]))
    return out


@pytest.fixture(scope="module")
def jax_nystrom():
    """The JAX facade's 1d Nystrom fits on its 1-device mesh: landmarks,
    schedules and results (the ranks replay the first two)."""
    from repro.api import KernelRidge as JKR
    from repro.api import KernelSVM as JKS
    from repro.api import SolverOptions as JSO
    inp = _inputs()
    out = {}
    for problem in ("ksvm", "krr"):
        kw = dict(method="sstep", s=4, max_iters=64, approx="nystrom",
                  landmarks=16, record=True, check_every=4, seed=SEED,
                  layout="1d")
        if problem == "ksvm":
            est = JKS(C=1.0, kernel="rbf", options=JSO(**kw))
            res = est.fit(inp["A"], inp["y"])
            pred = est.decision_function(inp["A"][:16])
        else:
            est = JKR(lam=1.0, kernel="rbf", options=JSO(b=4, **kw))
            res = est.fit(inp["Ar"], inp["yr"])
            pred = est.predict(inp["Ar"][:16])
        out[problem] = dict(
            alpha=np.asarray(res.alpha), history=np.asarray(res.history),
            schedule=np.asarray(res.schedule), pred=np.asarray(pred),
            landmarks=np.asarray(est.op_.fmap.landmarks))
    return out


@pytest.fixture(scope="module")
def spawns(tmp_path_factory, jax_nystrom):
    inp = _inputs()
    inp.update(_jax_facade_schedules())
    for problem in ("ksvm", "krr"):
        inp[f"nsched-{problem}"] = jax_nystrom[problem]["schedule"]
        inp[f"nland-{problem}"] = jax_nystrom[problem]["landmarks"]
    out = {}
    for world in MESHES:
        out[world] = _Spawn(world, tmp_path_factory.mktemp(f"world{world}"),
                            inp)
    yield out
    for spawn in out.values():          # nothing outlives the module
        for p in spawn.procs:
            p.kill()
            p.wait()


def _same_on_every_rank(results, *path):
    """The first rank's value at ``path``, after checking every rank's is
    equal to it bit for bit."""
    vals = []
    for res in results:
        v = res
        for k in path:
            v = v[k]
        vals.append(np.asarray(v))
    for r, v in enumerate(vals[1:], 1):
        assert v.shape == vals[0].shape and np.array_equal(
            v, vals[0], equal_nan=True), f"rank {r} differs from rank 0"
    return vals[0]


_JAX_CACHE = {}
# the s at which each solver case is also held against JAX's dist_* on its
# 1-device mesh (a shard_map compile each: ~1-2 s on the CPU)
S_DIST_REF = 4


def _jax_solver_refs(problem, layout, k, s, sf, H):
    """The JAX references of one solver case, cached: JAX's serial
    classical solver (the reference tests/dist_worker.py holds every
    layout to), JAX's serial s-step solver at the same (s, slab_free),
    and at ``S_DIST_REF`` JAX's ``dist_*`` on its 1-device mesh."""
    key = (problem, layout, k, s, sf, H)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    import jax
    import jax.numpy as jnp

    from repro.core import (KRRConfig, KernelConfig, SVMConfig, bdcd_krr,
                            dcd_ksvm, gram_slab, sstep_bdcd_krr,
                            sstep_dcd_ksvm)
    from repro.core import distributed as JD
    inp = _inputs()
    kcfg = KernelConfig(**KERNELS[k])
    zero = jnp.zeros(M, jnp.float32)
    gram = None if sf else gram_slab
    refs = {}
    if problem == "ksvm":
        A, y = jnp.asarray(inp["A"]), jnp.asarray(inp["y"])
        sched = jnp.asarray(inp["sched_svm"][:H])
        cfg = SVMConfig(C=1.0, kernel=kcfg)
        refs["serial classical"] = dcd_ksvm(A, y, zero, sched, cfg)[0]
        refs["serial s-step"] = sstep_dcd_ksvm(A, y, zero, sched, cfg, s,
                                               gram_fn=gram)[0]
        if s == S_DIST_REF:
            mesh = jax.make_mesh((1, 1), ("data", "model"))
            refs["dist"] = (
                JD.dist_sstep_dcd_ksvm(mesh, A, y, zero, sched, cfg, s=s,
                                       slab_free=sf) if layout == "1d"
                else JD.dist_sstep_dcd_ksvm_2d(mesh, A, y, zero, sched, cfg,
                                               s=s))
    else:
        A, y = jnp.asarray(inp["Ar"]), jnp.asarray(inp["yr"])
        sched = jnp.asarray(inp["sched_krr"][:H])
        cfg = KRRConfig(lam=0.7, kernel=kcfg)
        refs["serial classical"] = bdcd_krr(A, y, zero, sched, cfg)[0]
        refs["serial s-step"] = sstep_bdcd_krr(A, y, zero, sched, cfg, s,
                                               gram_fn=gram)[0]
        if s == S_DIST_REF:
            mesh = jax.make_mesh((1, 1), ("data", "model"))
            refs["dist"] = (
                JD.dist_sstep_bdcd_krr(mesh, A, y, zero, sched, cfg, s=s,
                                       slab_free=sf) if layout == "1d"
                else JD.dist_sstep_bdcd_krr_2d(mesh, A, y, zero, sched, cfg,
                                               s=s))
    _JAX_CACHE[key] = {name: np.asarray(v) for name, v in refs.items()}
    return _JAX_CACHE[key]


@pytest.mark.parametrize("case", SOLVER_CASES, ids=_case_id)
def test_dist_solver_matches_jax(spawns, case):
    world, layout, problem, k, s, sf, H = case
    refs = _jax_solver_refs(problem, layout, k, s, sf, H)
    got = _same_on_every_rank(spawns[world].results(), "solver",
                              _case_id(case), "alpha")
    scale = max(1.0, float(np.abs(refs["serial classical"]).max()))
    for name, want in refs.items():
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL_SOLVER * scale, err_msg=name)


@pytest.mark.parametrize("case", SOLVER_CASES, ids=_case_id)
def test_dist_solver_collectives_match_the_model(spawns, case):
    """Calls and words of each run against ``perf_model``'s structural
    counts: the layout's collectives a round, its setup collectives once
    a call, nothing else; the words a round those the layout's docstring
    gives."""
    from repro_torch.core.perf_model import (round_collectives,
                                             setup_collectives)
    world, layout, problem, k, s, sf, H = case
    res = spawns[world].results()[0]["solver"][_case_id(case)]
    calls, words = res["calls"], res["words"]
    R = -(-H // s)
    sb = s * (B if problem == "krr" else 1)
    setup = setup_collectives(layout, k)
    want = R * round_collectives(layout, k) + setup
    assert sum(v for key, v in calls.items()
               if key.endswith("/round")) == R * round_collectives(layout,
                                                                   k)
    assert sum(calls.values()) == want
    assert sum(v for key, v in calls.items()
               if key.endswith("/setup")) == setup
    shape = MESHES[world][layout]
    if layout == "1d":
        if sf:
            per = sb * (sb + 1) if k == "linear" else M * sb
        else:
            per = (M + 1) * sb if k == "rbf" else M * sb
        assert words["model/round"] == R * per
    else:
        m_loc, n_loc = M // shape[0], N // shape[1]
        extra = 3 if problem == "krr" else 2
        assert words["data/round"] == R * (sb * n_loc + sb * extra)
        assert words["model/round"] == R * (m_loc + sb) * sb


def _jax_facade(problem, layout, name):
    key = ("facade", problem, layout, name)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    from repro.api import KernelRidge as JKR
    from repro.api import KernelSVM as JKS
    from repro.api import SolverOptions as JSO
    inp = _inputs()
    kw = FACADE[name][1]
    opts = JSO(layout=layout, seed=SEED, **kw)
    if problem == "ksvm":
        est = JKS(C=1.0, kernel="rbf", options=opts)
        res = est.fit(inp["A"], inp["y"])
        pred = est.decision_function(inp["A"][:16])
    else:
        est = JKR(lam=1.0, kernel="rbf", options=opts)
        res = est.fit(inp["Ar"], inp["yr"])
        pred = est.predict(inp["Ar"][:16])
    _JAX_CACHE[key] = dict(
        alpha=np.asarray(res.alpha), pred=np.asarray(pred),
        history=None if res.history is None else np.asarray(res.history),
        rounds=res.rounds_run, iters=res.iters_run,
        converged=res.converged)
    return _JAX_CACHE[key]


@pytest.mark.parametrize("case", FACADE_CASES,
                         ids=[f"w{w}-{lay}-{n}" for w, lay, n in FACADE_CASES])
def test_facade_layout_fit_matches_jax(spawns, case):
    world, lay, name = case
    problem = FACADE[name][0]
    layout = FACADE_LAYOUTS[world][lay][0]
    want = _jax_facade(problem, layout, name)
    results = spawns[world].results()
    got = results[0]["facade"][f"{lay}-{name}"]
    _same_on_every_rank(results, "facade", f"{lay}-{name}", "alpha")
    assert (got["rounds"], got["iters"], got["converged"]) == (
        want["rounds"], want["iters"], want["converged"])
    np.testing.assert_allclose(got["alpha"], want["alpha"], **TOL_FACADE)
    np.testing.assert_allclose(got["pred"], want["pred"], **TOL_FACADE)
    if want["history"] is None:
        assert got["history"] is None
    else:
        np.testing.assert_allclose(got["history"], want["history"],
                                   rtol=1e-5)


@pytest.mark.parametrize("case", FACADE_CASES,
                         ids=[f"w{w}-{lay}-{n}" for w, lay, n in FACADE_CASES])
def test_facade_layout_collectives(spawns, case):
    """A facade fit's collectives: its rounds' (``round_collectives``),
    one setup set per fit (``setup_collectives``: the fit shards A and
    reduces the row norms once, however many chunks it runs), the 2d
    alpha assembly after each chunk, and one check from rank 0 per metric
    read; its ``comm`` priced at the layout's P."""
    from repro_torch.core.perf_model import (round_collectives,
                                             setup_collectives)
    world, lay, name = case
    layout, shape = FACADE_LAYOUTS[world][lay]
    got = spawns[world].results()[0]["facade"][f"{lay}-{name}"]
    calls = got["calls"]
    checks = 0 if got["history"] is None else len(got["history"])
    chunks = max(checks, 1)
    by_kind = {kd: sum(v for key, v in calls.items()
                       if key.endswith("/" + kd))
               for kd in ("round", "setup", "check")}
    assert by_kind == {
        "round": got["rounds"] * round_collectives(layout, "rbf"),
        "setup": (setup_collectives(layout, "rbf")
                  + chunks * (layout == "2d")),
        "check": checks}
    assert calls.get("mesh/check", 0) == checks
    shape = shape or ((1, world) if layout == "1d" else (world, 1))
    assert got["P"] == (shape[1] if layout == "1d" else world)


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("problem", ["ksvm", "krr"])
def test_nystrom_1d_round_trip(spawns, jax_nystrom, world, problem):
    """approx="nystrom" on the 1d layout (Phi's l columns sharded): the
    JAX 1d fit at the map's 1e-4, the port's serial fit of the same
    landmarks at 1e-5, predictions through the fitted map alike."""
    results = spawns[world].results()
    got = results[0]["nystrom"][f"{problem}-1d"]
    ser = results[0]["nystrom"][f"{problem}-serial"]
    want = jax_nystrom[problem]
    _same_on_every_rank(results, "nystrom", f"{problem}-1d", "alpha")
    np.testing.assert_allclose(got["alpha"], ser["alpha"], **TOL_FACADE)
    np.testing.assert_allclose(got["pred"], ser["pred"], **TOL_FACADE)
    np.testing.assert_allclose(got["history"], ser["history"], rtol=1e-5)
    scale = max(1.0, float(np.abs(want["alpha"]).max()))
    np.testing.assert_allclose(got["alpha"], want["alpha"], rtol=0,
                               atol=TOL_MAP * scale)
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=0,
                               atol=TOL_MAP * max(1.0, float(np.abs(
                                   want["pred"]).max())))
    # linear rounds over Phi: only the contracted (sb, sb+1) words
    assert got["calls"]["model/round"] == got["rounds"]


@pytest.mark.parametrize("world", sorted(MESHES))
def test_guarded_1d_recovers_a_poisoned_rank(spawns, world):
    """The reference's check (tests/test_resilience.py): the guarded 1d
    fit equals the plain one; a NaN in one rank's shard before the round
    all-reduce fires once, the ladder halves s, and the fit ends within
    1e-5 of the unpoisoned fit."""
    results = spawns[world].results()
    g = results[0]["guard"]
    plain = _same_on_every_rank(results, "guard", "plain-1d", "alpha")
    np.testing.assert_allclose(g["guard-1d"]["alpha"], plain,
                               **TOL_FACADE)
    fault = g["fault-1d"]
    _same_on_every_rank(results, "guard", "fault-1d", "alpha")
    assert all(r["guard"]["fault-1d"]["fired"] for r in results)
    assert fault["acts"] == ["halve_s:8->4"]
    assert float(np.abs(fault["alpha"] - plain).max()) < 1e-5


@pytest.mark.parametrize("world", sorted(MESHES))
def test_guarded_2d_equals_plain_2d(spawns, world):
    results = spawns[world].results()
    g = _same_on_every_rank(results, "guard", "guard-2d", "alpha")
    plain = _same_on_every_rank(results, "guard", "plain-2d", "alpha")
    np.testing.assert_allclose(g, plain, **TOL_FACADE)
    np.testing.assert_allclose(
        plain, results[0]["guard"]["plain-1d"]["alpha"], **TOL_FACADE)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_guarded_1d_kill_and_resume(spawns, world):
    """Killed at the checkpoint after iteration 96 on every rank (rank 0
    writes the snapshot), resumed from it: the uninterrupted guarded
    fit's alpha."""
    results = spawns[world].results()
    for r in results:
        assert r["guard"]["resume-1d"]["killed"]
        assert r["guard"]["resume-1d"]["resumed"]
    got = _same_on_every_rank(results, "guard", "resume-1d", "alpha")
    np.testing.assert_allclose(got, results[0]["guard"]["guard-1d"]["alpha"],
                               **TOL_FACADE)


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("which", ["krr-fast", "krr-tol", "ksvm-fast"])
def test_fleet_1d_matches_sequential_fits(spawns, world, which):
    """The 1d fleet: each member within 1e-5 of its own sequential 1d fit
    on the same schedule, one reduction a round for all F members, the
    row norms reduced once for the whole fleet."""
    from repro_torch.core.perf_model import setup_collectives
    results = spawns[world].results()
    f = results[0]["fleet"][which]
    _same_on_every_rank(results, "fleet", which, "alpha")
    # a member frozen at its convergence holds the alpha its own fit
    # stopped at, on the same check
    np.testing.assert_allclose(f["alpha"], np.asarray(f["singles"]),
                               **TOL_FACADE)
    if which.startswith("krr"):
        checks = 0 if f["history"] is None else len(f["history"])
        assert f["calls"] == {"model/round": f["rounds"],
                              "model/setup": setup_collectives("1d", "rbf"),
                              **({"mesh/check": checks} if checks else {})}


@pytest.mark.parametrize("world", sorted(MESHES))
def test_fleet_1d_members_match_jax(spawns, world):
    """Each member of the 1d K-RR fleet against JAX's s-step solver at
    its lambda on the same schedule."""
    import jax.numpy as jnp

    from repro.core import KRRConfig, KernelConfig, sstep_bdcd_krr
    inp = _inputs()
    f = spawns[world].results()[0]["fleet"]["krr-fast"]
    sched = jnp.asarray(inp["sched_krr"].repeat(2, axis=0))
    for i, lam in enumerate(LAMS):
        want = sstep_bdcd_krr(jnp.asarray(inp["Ar"]), jnp.asarray(inp["yr"]),
                              jnp.zeros(M), sched,
                              KRRConfig(lam=lam, kernel=KernelConfig("rbf")),
                              4)[0]
        np.testing.assert_allclose(f["alpha"][i], np.asarray(want),
                                   **TOL_FACADE)


# ---------------------------------------------------------------- in process

def test_identity_mesh_needs_no_group():
    from repro_torch.launch.mesh import COLLECTIVES, Mesh, make_mesh
    mesh = make_mesh()
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 1, "model": 1}
    assert mesh.groups is None and mesh.size == 1 and mesh.rank == 0
    t = torch.arange(3.0)
    COLLECTIVES.reset()
    assert mesh.all_reduce(t, "model") is t
    assert torch.equal(mesh.root_value(t), t)
    assert COLLECTIVES.calls == {("model", "round"): 1,
                                 ("mesh", "check"): 1}
    assert COLLECTIVES.words == {("model", "round"): 3, ("mesh", "check"): 3}
    with pytest.raises(ValueError, match="kind"):
        mesh.all_reduce(t, "model", "other")
    with pytest.raises(ValueError, match="process group"):
        make_mesh(1, 2)


@pytest.mark.parametrize("layout", ["1d", "2d"])
def test_identity_mesh_fit_matches_serial(layout):
    """On the (1, 1) mesh (no process group) a layout's fit is the serial
    fit's problem, solved with the distributed rounds."""
    from repro_torch.api import KernelRidge, SolverOptions
    inp = _inputs()
    kw = dict(method="sstep", s=4, b=4, max_iters=32, seed=SEED)
    ser = KernelRidge(lam=1.0, kernel="rbf", device="cpu",
                      options=SolverOptions(**kw)).fit(inp["Ar"], inp["yr"])
    got = KernelRidge(lam=1.0, kernel="rbf", device="cpu",
                      options=SolverOptions(layout=layout, **kw)).fit(
        inp["Ar"], inp["yr"])
    np.testing.assert_allclose(got.alpha.numpy(), ser.alpha.numpy(),
                               **TOL_FACADE)
    assert got.comm["P"] == 1


def test_mesh_cache_follows_the_default_group(tmp_path):
    """A mesh is cached over the default group that built it: after that
    group is destroyed and another initialised, ``make_mesh`` builds new
    axis groups over the new one."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.mesh import make_mesh
    meshes = []
    for i in range(2):
        dist.init_process_group("gloo", store=dist.FileStore(
            str(tmp_path / f"store{i}"), 1), rank=0, world_size=1)
        try:
            mesh = make_mesh(1, 1)
            assert make_mesh(1, 1) is mesh
            assert mesh.world is dist.group.WORLD
            # no mesh of a destroyed group stays cached
            assert all(m.world is dist.group.WORLD
                       for m in mesh_mod._MESHES.values())
            t = mesh.all_reduce(torch.arange(3.0), "model")
            assert torch.equal(t, torch.arange(3.0))
            meshes.append(mesh)
        finally:
            dist.destroy_process_group()
    assert meshes[1] is not meshes[0]
    assert meshes[1].groups["model"] is not meshes[0].groups["model"]


@pytest.mark.parametrize("device,local,cards,want", [
    ("cpu", 1, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"),
    ("cuda", 4, 1, "gloo"), ("cuda", 2, 0, "gloo")])
def test_solve_cli_backend_follows_the_host(monkeypatch, device, local,
                                            cards, want):
    """``launch/solve.py`` under torchrun: NCCL only with a card for each
    local rank (NCCL refuses two ranks on one card), else gloo."""
    from repro_torch.launch.solve import process_backend
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert process_backend(torch.device(device)) == want


def test_mesh_axis_names_validated():
    """A user mesh lacking the layout's axes is refused at fit, with the
    JAX facade's message (tests/test_api.py)."""
    from types import SimpleNamespace

    from repro_torch.api import KernelSVM, SolverOptions
    inp = _inputs()
    mesh = SimpleNamespace(axis_names=("rows",))
    for layout in ("1d", "2d"):
        est = KernelSVM(C=1.0, device="cpu", options=SolverOptions(
            layout=layout, mesh=mesh, max_iters=8))
        with pytest.raises(ValueError, match="mesh lacks axes"):
            est.fit(inp["A"], inp["y"])


@pytest.mark.parametrize("bad,message", [
    (dict(stream=16, layout="1d"), "serial layout"),
    (dict(stream=16, layout="2d"), "serial layout"),
    (dict(layout="2d", slab_free=False), "2d layout is slab-free"),
    (dict(layout="3d"), "layout must be one of"),
])
def test_layout_options_refused_as_in_jax(bad, message):
    from repro.api import SolverOptions as JSO

    from repro_torch.api import SolverOptions
    with pytest.raises(ValueError, match=message):
        SolverOptions(**bad)
    with pytest.raises(ValueError, match=message):
        JSO(**bad)


def test_autotune_layout_auto_at_one_rank_is_serial():
    """At world size 1 the serial layout is the only candidate, as in the
    JAX package on one device."""
    from repro_torch.api import KernelRidge, SolverOptions
    inp = _inputs()
    r = KernelRidge(lam=1.0, kernel="rbf", device="cpu",
                    options=SolverOptions(layout="auto", s=4, b=4,
                                          max_iters=16)).fit(inp["Ar"],
                                                             inp["yr"])
    assert r.options.layout == "serial"
    assert {f["layout"] for f in r.plan.frontier} == {"serial"}


@pytest.mark.parametrize("world", sorted(MESHES))
def test_autotune_layout_auto_over_the_ranks(spawns, world):
    """At P ranks the tuner searches serial, 1d and 2d, each priced at
    its P, and every rank resolves the same plan (rank 0's budget sent to
    all) and the same alpha."""
    results = spawns[world].results()
    assert results[0]["auto"]["searched"] == ["1d", "2d", "serial"]
    assert len({r["auto"]["layout"] for r in results}) == 1
    _same_on_every_rank(results, "auto", "alpha")


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
