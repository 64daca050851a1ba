"""The port's sharded decode (``models.lm.decode_step(rules=)``, the
decode-state layout ``models.sharding.cache_spec``, the split-S
attention of ``models.attention``) on the CPU, held against the JAX
package's GSPMD decode and the port's unsharded decode: reduced
Qwen3-1.7B in f32, every cache layout case of ``cache_spec``:

* (4, 1), B = 4: the batch over ``data``;
* (2, 2), B = 4: the batch over ``data``, the kv heads over ``model``
  (the attention tensor-parallel);
* (2, 2), B = 1: the batch does not divide ``data``, so S is split over
  ``data`` (every data rank computes the one row over its chunk);
* (1, 2) with 4 heads and 1 kv head: the kv heads do not divide
  ``model``, so S is split over ``model`` (the attention gathered and
  computed whole).

The caches start drawn at random (every slot, as if earlier tokens had
filled them) with the rows at positions 3, 14, 15 and 29 of 32: over
STEPS steps row 0 stays in the first half (the second chunk of a 2-way
split of S is empty for it), rows 1 and 2 cross the middle, row 3 runs
past the end (its last writes are dropped).  After each step the logits
of each rank's rows and, after the last, each rank's cache chunks must
match the JAX package's ``decode_step(rules=)`` on 4 forced host devices
(params placed by ``tree_shardings``, the state by
``launch/specs._cache_pspec``, the tokens as ``decode_token_specs``) and
the port's unsharded decode at ``test_torch_lm``'s f32 bound, 1e-4; ranks
that compute the same rows hold the same logits bit for bit and ranks
that hold the same chunk of a cache the same bits; each step's
collectives equal ``train_step.decode_collectives`` exactly.  The engine
(``ServingEngine(rules=)``) and ``greedy_generate(rules=)`` give the
unsharded engine's and generator's tokens, and ``make_serve_step(rules=,
temperature=1)`` draws the unsharded step's tokens.

The ranks are this file run as a script (``python
tests/test_torch_dist_decode.py WORLD RANK DIR``), gloo on CPU tensors, a
``FileStore``, every process under a time limit, as in
``tests/test_torch_dist_train.py``; the JAX reference is this file with
``jax DIR``.  The split-S merge itself (an empty chunk adds exactly zero,
no NaN) is held here in one process.
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
MAX_SEQ, STEPS, SEED = 32, 6, 0
POS = (3, 14, 15, 29)
TIMEOUT_S = 300
TOL = 1e-4                  # tests/test_torch_lm.py, f32
KV1_HEADS = (4, 1)
N_REQUESTS, PROMPT, NEW = 5, 3, 4

CASES = [dict(world=4, mesh=(4, 1), B=4, heads=None),
         dict(world=4, mesh=(2, 2), B=4, heads=None),
         dict(world=4, mesh=(2, 2), B=1, heads=None),
         dict(world=2, mesh=(1, 2), B=4, heads=KV1_HEADS)]


def _case_id(c) -> str:
    return (f"{c['mesh'][0]}x{c['mesh'][1]}-B{c['B']}"
            + ("-kv%d" % c["heads"][1] if c["heads"] else ""))


def _cfg_kw(heads):
    kw = dict(dtype="float32")
    if heads:
        kw.update(n_heads=heads[0], n_kv_heads=heads[1])
    return kw


def _port_cfg(heads):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH, reduced=True),
                               **_cfg_kw(heads))


def _requests():
    rng = np.random.default_rng(SEED + 3)
    return [(i, rng.integers(0, 512, PROMPT).tolist())
            for i in range(N_REQUESTS)]


def _sampled(params, cfg, rules):
    """NEW tokens drawn at temperature 1 by ``make_serve_step`` after the
    prompt, every rank's generator seeded alike."""
    from repro_torch.models import init_decode_state
    from repro_torch.train import make_serve_step
    step = make_serve_step(cfg, rules, temperature=1.0,
                           generator=torch.Generator().manual_seed(SEED))
    state = init_decode_state(cfg, 2, MAX_SEQ, device="cpu", rules=rules)
    tok, out = torch.tensor([[1], [2]]), []
    for _ in range(NEW):
        tok, state = step(params, state, tok)
        out.append(tok)
    return torch.cat(out, 1).numpy()


def _engine(params, cfg, rules):
    from repro_torch.train import Request, ServingEngine
    eng = ServingEngine(params, cfg, n_slots=2, max_seq=MAX_SEQ,
                        rules=rules)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW)
            for i, p in _requests()]
    for r in reqs:
        eng.submit(r)
    steps = eng.run_until_done()
    return [r.generated for r in reqs], steps


# =========================================================================
# the ranks (this file as a script; torch only)
# =========================================================================

def _rank_case(c, inp):
    """One case on this rank: per step the logits of its rows and the
    collectives; the final cache chunks with their specs; the engine's
    and the generator's tokens."""
    from repro_torch import convert
    from repro_torch.launch.mesh import COLLECTIVES, make_mesh
    from repro_torch.models import decode_step, init_decode_state
    from repro_torch.models.lm import decode_state_layout
    from repro_torch.models.sharding import MeshRules, batch_rows
    from repro_torch.train import greedy_generate
    from repro_torch.train.train_step import decode_collectives
    cfg = _port_cfg(c["heads"])
    mesh = make_mesh(*c["mesh"])
    rules = MeshRules(mesh)
    key = str(c["heads"])
    params = convert.lm_shards(inp["params"][key], cfg, rules, device="cpu")
    state = convert.decode_state_shards(inp["states"][(key, c["B"])], cfg,
                                        rules, device="cpu")
    toks = torch.from_numpy(inp["tokens"][c["B"]])
    rows = batch_rows(rules, c["B"])
    rec = {"rows": (rows.start, rows.stop), "logits": [], "calls": [],
           "want": decode_collectives(cfg, rules, c["B"], MAX_SEQ),
           "coords": (mesh.index("data"), mesh.index("model"))}
    for t in range(STEPS):
        COLLECTIVES.reset()
        logits, state = decode_step(params, cfg, state, toks[t], rules=rules)
        rec["calls"].append(dict(COLLECTIVES.calls))
        rec["logits"].append(logits.numpy())
    rec["pos"] = state["pos"].numpy()
    rec["caches"] = [[t.numpy() for t in pair] for pair in state["caches"]]
    rec["specs"] = decode_state_layout(rules, cfg, c["B"], MAX_SEQ)["caches"]
    if c["B"] > 1:
        rec["engine"] = _engine(params, cfg, rules)
        prompt = torch.from_numpy(inp["prompt"])
        rec["greedy"] = greedy_generate(
            params, cfg, init_decode_state(cfg, 2, MAX_SEQ, device="cpu",
                                           rules=rules), prompt, NEW,
            rules=rules)[0].numpy()
        rec["sampled"] = _sampled(params, cfg, rules)
    return rec


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
    torch.save(out, d / f"rank{rank}.pt")
    dist.destroy_process_group()


# =========================================================================
# the JAX reference (this file as a script with "jax"; 4 host devices)
# =========================================================================

def _jax_main(d: Path) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.compat import make_mesh_auto
    from repro.configs import get_config
    from repro.launch.specs import _cache_pspec
    from repro.models import decode_step
    from repro.models.sharding import MeshRules, tree_shardings
    with open(d / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    out = {}
    for c in CASES:
        key = str(c["heads"])
        cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                                  **_cfg_kw(c["heads"]))
        mesh = make_mesh_auto(c["mesh"], ("data", "model"))
        rules = MeshRules(mesh)
        p = jax.tree.map(jnp.asarray, inp["params"][key])
        p = jax.device_put(p, tree_shardings(rules, p))

        def place(path, leaf):
            spec = _cache_pspec(rules, cfg, "/".join(
                str(getattr(k, "key", getattr(k, "idx", k))) for k in path),
                leaf)
            return jax.device_put(jnp.asarray(leaf), NamedSharding(mesh,
                                                                   spec))

        state = jax.tree_util.tree_map_with_path(
            place, inp["states"][(key, c["B"])])
        tok_sh = NamedSharding(mesh, rules.fit((c["B"], 1),
                                               [rules.batch_axes, None]))
        step = jax.jit(lambda p, s, t: decode_step(p, cfg, s, t,
                                                   rules=rules))
        rec = {"logits": []}
        for t in range(STEPS):
            tok = jax.device_put(jnp.asarray(inp["tokens"][c["B"]][t],
                                             jnp.int32), tok_sh)
            logits, state = step(p, state, tok)
            rec["logits"].append(np.array(logits))
        rec["state"] = jax.tree.map(np.array, state)
        out[_case_id(c)] = rec
    with open(d / "jax.pkl", "wb") as f:
        pickle.dump(out, f)


# =========================================================================
# the pytest side
# =========================================================================

def _inputs() -> dict:
    """The JAX initial params of each config (numpy, stacked as JAX holds
    them), the random starting decode states (JAX's layout) at each B,
    the tokens of every step, and a prompt for the generator."""
    import dataclasses

    import jax

    from repro.configs import get_config
    from repro.models import init_decode_state, init_params
    rng = np.random.default_rng(SEED)
    params, states = {}, {}
    for heads in (None, KV1_HEADS):
        cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                                  **_cfg_kw(heads))
        params[str(heads)] = jax.tree.map(
            lambda a: np.asarray(a, np.float32),
            init_params(jax.random.key(SEED), cfg))
        for B in (1, 4):
            st = jax.tree.map(np.asarray, init_decode_state(cfg, B, MAX_SEQ))
            st["caches"] = jax.tree.map(
                lambda a: rng.standard_normal(a.shape).astype(np.float32),
                st["caches"])
            st["pos"] = np.asarray(POS[:B] if B > 1 else POS[1:2],
                                   np.int32)
            states[(str(heads), B)] = st
    vocab = get_config(ARCH, reduced=True).vocab_size
    tokens = {B: rng.integers(0, vocab, (STEPS, B, 1)).astype(np.int64)
              for B in (1, 4)}
    prompt = rng.integers(0, vocab, (2, PROMPT)).astype(np.int64)
    return {"params": params, "states": states, "tokens": tokens,
            "prompt": prompt}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_decode")
    inp = _inputs()
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {"jax": Procs("jax", __file__, [["jax", str(d)]], jenv, d,
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
    """The module's processes and their results, read on first use; the
    port's unsharded runs, made here on first use."""

    def __init__(self, d, procs, inp):
        self.d, self.procs, self.inp = d, procs, inp
        self._ranks, self._jax, self._plain = {}, None, {}

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
            with open(self.d / "jax.pkl", "rb") as f:
                self._jax = pickle.load(f)
        return self._jax

    def plain(self, heads, B):
        """The port's unsharded decode of the same inputs: per step the
        logits, the final state; the unsharded engine and generator."""
        key = (str(heads), B)
        if key not in self._plain:
            from repro_torch import convert
            from repro_torch.models import decode_step, init_decode_state
            from repro_torch.train import greedy_generate
            cfg = _port_cfg(heads)
            params = convert.lm_params(self.inp["params"][str(heads)], cfg,
                                       device="cpu")
            state = convert.decode_state(self.inp["states"][key], cfg,
                                         device="cpu")
            toks = torch.from_numpy(self.inp["tokens"][B])
            logits = []
            for t in range(STEPS):
                lg, state = decode_step(params, cfg, state, toks[t])
                logits.append(lg.numpy())
            self._plain[key] = {
                "logits": logits, "state": state,
                "engine": _engine(params, cfg, None),
                "greedy": greedy_generate(
                    params, cfg, init_decode_state(cfg, 2, MAX_SEQ,
                                                   device="cpu"),
                    torch.from_numpy(self.inp["prompt"]), NEW)[0].numpy(),
                "sampled": _sampled(params, cfg, None)}
        return self._plain[key]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def _hold(case, ranks, logits, caches):
    """Each rank's logits rows and cache chunks against full ``logits``
    (per step, (B, V)) and ``caches`` (the port's per-layer pairs)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.sharding import shard_leaf
    for r, rec in enumerate(ranks):
        lo, hi = rec["rows"]
        for t in range(STEPS):
            _close(rec["logits"][t], logits[t][lo:hi], f"rank {r} step {t}")
        mesh = Mesh(case["mesh"], rec["coords"])
        for i, (pair, spair, wpair) in enumerate(zip(
                rec["caches"], rec["specs"], caches)):
            for got, sp, w in zip(pair, spair, wpair):
                want = shard_leaf(mesh, torch.as_tensor(np.asarray(w)), sp)
                assert got.shape == tuple(want.shape), (i, sp)
                _close(got, want.numpy(), f"rank {r} layer {i} cache")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_matches_jax_gspmd(runs, case):
    """Logits every step and the final cache chunks against the JAX
    package's decode_step(rules=) on its own mesh of 4 host devices."""
    from repro_torch import convert
    ranks = [r[_case_id(case)] for r in runs.ranks(case["world"])]
    want = runs.jax()[_case_id(case)]
    full = convert.decode_state(want["state"], _port_cfg(case["heads"]),
                                device="cpu")
    _hold(case, ranks, want["logits"],
          [[t.numpy() for t in pair] for pair in full["caches"]])
    for rec in ranks:
        assert rec["pos"].tolist() == full["pos"].tolist()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_matches_the_unsharded_decode(runs, case):
    ranks = [r[_case_id(case)] for r in runs.ranks(case["world"])]
    plain = runs.plain(case["heads"], case["B"])
    _hold(case, ranks, plain["logits"],
          [[t.numpy() for t in pair] for pair in plain["state"]["caches"]])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_replicated_outputs_equal_bit_for_bit(runs, case):
    """Ranks that compute the same rows hold the same logits, and ranks
    that hold the same chunk of a cache leaf (the same coordinates on
    the axes that split it) the same bits."""
    ranks = [r[_case_id(case)] for r in runs.ranks(case["world"])]
    by_rows = {}
    for rec in ranks:
        by_rows.setdefault(rec["rows"], []).append(rec)
    for recs in by_rows.values():
        for rec in recs[1:]:
            for t in range(STEPS):
                assert np.array_equal(rec["logits"][t], recs[0]["logits"][t])
    axes = {"data": 0, "model": 1}
    for i, spair in enumerate(ranks[0]["specs"]):
        for j, sp in enumerate(spair):
            split = [a for a in sp if a is not None
                     and case["mesh"][axes[a]] > 1]
            seen = {}
            for rec in ranks:
                key = tuple(rec["coords"][axes[a]] for a in split)
                seen.setdefault(key, set()).add(hashlib.sha1(
                    rec["caches"][i][j].tobytes()).hexdigest())
            assert all(len(h) == 1 for h in seen.values()), (i, j, sp)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_collectives_per_step(runs, case):
    """Each step's collectives by (axis, kind) on every rank equal
    ``decode_collectives``; a split S merges once a layer."""
    cfg = _port_cfg(case["heads"])
    for rec in (r[_case_id(case)] for r in runs.ranks(case["world"])):
        for calls in rec["calls"]:
            assert calls == rec["want"]
        split = any(sp[0][1] is not None
                    and case["mesh"][("data", "model").index(sp[0][1])] > 1
                    for sp in rec["specs"])
        assert (sum(k for (_, kind), k in rec["want"].items()
                    if kind == "seq") == cfg.n_layers * split)


@pytest.mark.parametrize("case", [c for c in CASES if c["B"] > 1],
                         ids=_case_id)
def test_engine_and_generator_match_the_unsharded_ones(runs, case):
    """ServingEngine(rules=) answers the requests with the unsharded
    engine's tokens in as many steps, and greedy_generate(rules=) gives
    the unsharded generator's tokens, on every rank."""
    plain = runs.plain(case["heads"], case["B"])
    for rec in (r[_case_id(case)] for r in runs.ranks(case["world"])):
        assert rec["engine"] == plain["engine"]
        assert np.array_equal(rec["greedy"], plain["greedy"])


@pytest.mark.parametrize("case", [c for c in CASES if c["B"] > 1],
                         ids=_case_id)
def test_sampling_draws_the_unsharded_tokens(runs, case):
    """Temperature sampling with ``rules``: the rows' logits gathered over
    ``data`` and every rank's generator seeded alike draw the unsharded
    step's tokens on every rank."""
    plain = runs.plain(case["heads"], case["B"])
    for rec in (r[_case_id(case)] for r in runs.ranks(case["world"])):
        assert np.array_equal(rec["sampled"], plain["sampled"])


class _FakeMesh:
    """A mesh whose gather along its one axis returns the packed chunks of
    every rank, computed beforehand in this process."""

    def __init__(self, packed):
        self.packed = packed

    def all_gather(self, t, axis, dim, kind):
        assert (axis, dim, kind) == ("model", 0, "seq")
        return torch.cat(self.packed, 0)


@pytest.mark.parametrize("n", [2, 4])
def test_split_s_merge_adds_nothing_for_an_empty_chunk(n):
    """The merge of ``chunk_attention`` over n chunks equals the attention
    over the whole cache (f32, 1e-6), with no NaN where a row's later
    chunks hold no valid slot; an empty chunk's weight is exactly zero,
    so leaving it out gives the same bits."""
    from repro_torch.models.attention import (NEG_INF, SeqSplit, _sdpa,
                                              chunk_attention, merge_chunks)
    gen = torch.Generator().manual_seed(0)
    B, S, H, G, hd = 3, 16, 4, 2, 8
    q = torch.randn((B, 1, H, hd), generator=gen)
    k = torch.randn((B, S, G, hd), generator=gen)
    v = torch.randn((B, S, G, hd), generator=gen)
    pos = torch.tensor([0, 5, S - 1])          # row 0: one valid slot
    T = S // n
    parts = [chunk_attention(q, k[:, i * T:(i + 1) * T],
                             v[:, i * T:(i + 1) * T], i * T, pos,
                             hd ** -0.5) for i in range(n)]
    assert float(parts[-1][1][0].max()) == float(torch.tensor(NEG_INF))
    packed = [torch.cat([o.float(), lse[..., None]], -1)[None]
              for o, lse in parts]
    o_rank0, lse_rank0 = parts[0]
    got = merge_chunks(SeqSplit(_FakeMesh(packed), "model", 0), o_rank0,
                       lse_rank0)
    assert bool(torch.isfinite(got).all())
    valid = torch.arange(S)[None] <= pos[:, None]
    want = _sdpa(q, torch.repeat_interleave(k, H // G, 2),
                 torch.repeat_interleave(v, H // G, 2), valid[:, None, :],
                 torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    # row 0 only ever reads the first chunk: the others add exact zeros
    alone = merge_chunks(SeqSplit(_FakeMesh(packed[:1]), "model", 0),
                         o_rank0, lse_rank0)
    assert torch.equal(got[0], alone[0])


def test_write_slot_writes_only_the_chunk_that_holds_pos():
    from repro_torch.models.attention import slot_masks, write_slot
    cache = torch.zeros((3, 4, 2))
    new = torch.ones((3, 1, 2))
    pos = torch.tensor([5, 2, 8])            # 8: past a cache of 8 slots
    at, valid = slot_masks(4, 4, pos)        # this chunk: slots 4..7
    assert valid.tolist() == [[True, True, False, False], [False] * 4,
                              [True] * 4]
    got = write_slot(cache, new, at)
    assert got[0, 1].tolist() == [1.0, 1.0]
    assert float(got[1].abs().sum()) == 0.0 and float(got[2].abs().sum()) == 0
    assert float(cache.abs().sum()) == 0.0   # the input is not written


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(Path(sys.argv[2]))
    else:
        _rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
