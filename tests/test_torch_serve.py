"""The port's serving layer (``repro_torch.serve``, the predictor's
buckets and warm-up, host-side query validation, ``est.save``) against
the JAX package's ``repro.serve``, on the same numpy inputs, replaying
the JAX fits' ``FitResult.schedule`` (and a Nystrom fit's landmarks),
at the sizes of tests/test_serve.py (m = 96, n = 8) on ``device="cpu"``.

Bounds: alpha 1e-5 (the f32 iterate bound, tests/test_slabfree_parity.py),
served values 2e-4 (the KMV bound, tests/test_kmv.py); the port's own
registry and engine against its estimators at 1e-6 (one KMV, the same
inputs).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.api import KernelRidge as JKernelRidge
from repro.api import KernelSVM as JKernelSVM
from repro.api import SolverOptions as JSolverOptions
from repro.core.predict import BatchedPredictor as JBatchedPredictor
from repro.core.kernels import ExactGramOperator as JExact
from repro.core.kernels import KernelConfig as JKernelConfig
from repro.serve import ModelRegistry as JModelRegistry
from repro.serve import ServingEngine as JServingEngine
from repro_torch.api import KernelConfig, KernelRidge, KernelSVM, SolverOptions
from repro_torch.core.kernels import (ExactGramOperator, LowRankGramOperator,
                                      StreamingGramOperator)
from repro_torch.core.predict import (BatchedPredictor, check_queries,
                                      compact_support, serve_cache_size,
                                      validate_queries)
from repro_torch.kernels import ops
from repro_torch.serve import (DONE, EXPIRED, MANIFEST_VERSION, SHED,
                               ModelRegistry, ServableModel, ServingEngine,
                               load_model, operator_key, save_model)

CPU = "cpu"
ALPHA = dict(rtol=1e-5, atol=1e-5)
SERVED = dict(rtol=2e-4, atol=2e-4)
SAME = dict(rtol=1e-6, atol=1e-6)


def _data(m=96, n=8, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    w = rng.standard_normal(n)
    yc = np.sign(A @ w + 0.1 * rng.standard_normal(m)).astype(np.float32)
    yr = (A @ w + 0.1 * rng.standard_normal(m)).astype(np.float32)
    return A, yc, yr


def _kw(**kw):
    base = dict(method="sstep", s=8, max_iters=512, tol=1e-6, seed=3)
    base.update(kw)
    return base


def _pair(cls_j, cls_t, A, y, *, landmarks=False, **hyper):
    """(JAX estimator, port estimator) fitted alike: the port replays the
    JAX fit's schedule (and a Nystrom fit's landmarks)."""
    opts = hyper.pop("opts", {})
    je = cls_j(options=JSolverOptions(**_kw(**opts)), **hyper)
    jr = je.fit(A, y)
    te = cls_t(options=SolverOptions(**_kw(**opts)), device=CPU, **hyper)
    kw = {"schedule": np.asarray(jr.schedule)}
    if landmarks:
        kw["landmarks"] = np.asarray(je.op_.fmap.landmarks)
    te.fit(A, y, **kw)
    np.testing.assert_allclose(te.alpha_.numpy(), np.asarray(je.alpha_),
                               **ALPHA)
    return je, te


@pytest.fixture(scope="module")
def fitted():
    A, yc, yr = _data()
    jsvm, svm = _pair(JKernelSVM, KernelSVM, A, yc, C=1.0, kernel="rbf")
    jsvm2, svm2 = _pair(JKernelSVM, KernelSVM, A, yc, C=0.25, kernel="rbf")
    jkrr, krr = _pair(JKernelRidge, KernelRidge, A, yr, lam=0.5,
                      kernel="rbf")
    return dict(A=A, yc=yc, yr=yr, svm=svm, svm2=svm2, krr=krr, jsvm=jsvm,
                jsvm2=jsvm2, jkrr=jkrr)


def _registries(fitted, names, predict_batch=64):
    """(JAX registry, port registry) holding the same models."""
    jreg = JModelRegistry(predict_batch=predict_batch)
    reg = ModelRegistry(predict_batch=predict_batch, device=CPU)
    for name in names:
        jreg.register(name, fitted["j" + name])
        reg.register(name, fitted[name])
    return jreg, reg


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

class TestArtifacts:
    def test_roundtrip_exact_ksvm(self, fitted, tmp_path):
        svm, A = fitted["svm"], fitted["A"]
        assert svm.save(str(tmp_path))
        m = load_model(str(tmp_path), device=CPU)
        assert m.problem == "ksvm"
        assert torch.equal(m.alpha, svm.alpha_)
        assert torch.equal(m.y, svm.y_)
        assert isinstance(m.op, ExactGramOperator)
        assert torch.equal(m.op.A, svm.op_.A)
        assert m.cfg == svm.cfg
        assert m.options == svm.result_.options
        reg = ModelRegistry(device=CPU)
        reg.register("m", m)
        np.testing.assert_allclose(
            reg.predict("m", A[:7]).numpy(),
            svm.decision_function(A[:7]).numpy(), **SAME)
        np.testing.assert_allclose(
            reg.predict("m", A[:7]).numpy(),
            np.asarray(fitted["jsvm"].decision_function(A[:7])), **SERVED)

    def test_roundtrip_nystrom_krr(self, tmp_path):
        A, _, yr = _data(seed=4)
        jkrr, krr = _pair(JKernelRidge, KernelRidge, A, yr, landmarks=True,
                          lam=0.5, kernel="rbf",
                          opts=dict(approx="nystrom", landmarks=32))
        krr.save(str(tmp_path))
        m = load_model(str(tmp_path), device=CPU)
        assert m.problem == "krr"
        assert isinstance(m.op, LowRankGramOperator)
        assert m.op.fmap is not None
        assert m.A_raw is not None            # refit base travels along
        np.testing.assert_array_equal(m.A_raw.numpy(), A)
        reg = ModelRegistry(device=CPU)
        reg.register("m", m)
        got = reg.predict("m", A[:6]).numpy()
        np.testing.assert_allclose(got, krr.predict(A[:6]).numpy(), **SAME)
        np.testing.assert_allclose(got, np.asarray(jkrr.predict(A[:6])),
                                   **SERVED)

    def test_roundtrip_streamed_krr(self, fitted, tmp_path):
        """A streamed fit's artifact keeps its chunk rows and serves what
        the streamed estimator serves (its refit base is the chunks'
        rows)."""
        A, yr = fitted["A"], fitted["yr"]
        krr = KernelRidge(lam=0.5, kernel="rbf", device=CPU,
                          options=SolverOptions(**_kw(stream=32)))
        krr.fit(A, yr, schedule=fitted["krr"].result_.schedule)
        np.testing.assert_allclose(krr.alpha_.numpy(),
                                   fitted["krr"].alpha_.numpy(), **ALPHA)
        krr.save(str(tmp_path))
        m = load_model(str(tmp_path), device=CPU)
        assert isinstance(m.op, StreamingGramOperator)
        assert m.op.chunk_rows == 32 and m.A_raw is None
        np.testing.assert_array_equal(m.features.numpy(), A)
        reg = ModelRegistry(device=CPU)
        reg.register("m", m)
        np.testing.assert_allclose(reg.predict("m", A[:5]).numpy(),
                                   krr.predict(A[:5]).numpy(), **SAME)

    def test_refuses_newer_manifest(self, fitted, tmp_path):
        fitted["svm"].save(str(tmp_path))
        meta = tmp_path / "step_00000000" / "meta.json"
        doc = json.loads(meta.read_text())
        doc["extra"]["serve_manifest"]["version"] = MANIFEST_VERSION + 1
        meta.write_text(json.dumps(doc))
        with pytest.raises(ValueError, match="manifest version"):
            load_model(str(tmp_path), device=CPU)

    def test_refuses_non_model_checkpoint(self, fitted, tmp_path):
        from repro_torch.resilience.checkpoint import save_fit
        save_fit(str(tmp_path), fitted["svm"].result_, fitted["svm"].op_)
        with pytest.raises(ValueError, match="serve_manifest"):
            load_model(str(tmp_path), device=CPU)

    def test_refuses_empty_directory(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="no model artifact"):
            load_model(str(tmp_path), device=CPU)

    def test_unfitted_estimator_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="not fitted"):
            save_model(str(tmp_path), KernelSVM(device=CPU))

    def test_save_drops_the_telemetry_handle(self, fitted, tmp_path):
        """A fit recorded with telemetry saves and loads: its handle is
        not persisted (nor copied), the rest of its options are."""
        from repro_torch.obs import Telemetry
        A, yr = fitted["A"], fitted["yr"]
        krr = KernelRidge(lam=0.5, kernel="rbf", device=CPU,
                          options=SolverOptions(**_kw(telemetry=Telemetry())))
        krr.fit(A, yr, schedule=fitted["krr"].result_.schedule)
        assert krr.result_.telemetry.spans
        krr.save(str(tmp_path))
        m = load_model(str(tmp_path), device=CPU)
        assert m.options.telemetry is None
        assert m.options == dataclasses.replace(krr.result_.options,
                                                telemetry=None)
        assert torch.equal(m.alpha, fitted["krr"].alpha_)

    def test_fingerprint_persists(self, fitted, tmp_path):
        fitted["krr"].save(str(tmp_path))
        m = load_model(str(tmp_path), device=CPU)
        assert m.fingerprint is not None
        assert m.fingerprint["problem"] == "krr"
        assert m.fingerprint == ServableModel.from_estimator(
            fitted["krr"]).fingerprint

    def test_serve_w_folds_per_model_scalars(self, fitted):
        """K-SVM serves alpha * y, K-RR alpha / lam — as the reference's
        ``ServableModel.serve_w``."""
        from repro.serve import ServableModel as JServable
        for name in ("svm", "krr"):
            got = ServableModel.from_estimator(fitted[name]).serve_w
            want = JServable.from_estimator(fitted["j" + name]).serve_w
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **ALPHA)

    def test_problem_is_checked(self, fitted):
        m = ServableModel.from_estimator(fitted["svm"])
        with pytest.raises(ValueError, match="problem must be one of"):
            dataclasses.replace(m, problem="lasso")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_dedup_two_models_one_operator(self, fitted):
        reg = ModelRegistry(predict_batch=64, device=CPU)
        reg.register("a", fitted["svm"])
        reg.register("b", fitted["svm2"])
        assert reg.n_groups == 1
        group = reg.group("a")
        assert group is reg.group("b")
        assert group.size == 2
        # the shared operator is ONE object, not two equal copies
        assert reg.models["a"].op is reg.models["b"].op
        assert tuple(group.W.shape) == (fitted["A"].shape[0], 2)
        assert group.nbytes == fitted["A"].nbytes + 2 * 4 * 96

    def test_dedup_across_artifact_roundtrip(self, fitted, tmp_path):
        """A model restored from disk joins the group of a live-fitted
        sibling — dedup keys on operator CONTENT, not object identity."""
        fitted["svm"].save(str(tmp_path))
        reg = ModelRegistry(device=CPU)
        reg.register("live", fitted["svm2"])
        reg.load("restored", str(tmp_path))
        assert reg.n_groups == 1
        assert reg.models["live"].op is reg.models["restored"].op

    def test_distinct_data_distinct_groups(self, fitted):
        A2, yc2, _ = _data(seed=9)
        other = KernelSVM(C=1.0, kernel="rbf", device=CPU,
                          options=SolverOptions(**_kw()))
        other.fit(A2, yc2)
        reg = ModelRegistry(device=CPU)
        reg.register("a", fitted["svm"])
        reg.register("b", other)
        assert reg.n_groups == 2

    @pytest.mark.parametrize("name", ["svm", "svm2", "krr"])
    def test_group_predict_matches_estimator_and_jax(self, fitted, name):
        jreg, reg = _registries(fitted, ("svm", "svm2", "krr"))
        Xq = fitted["A"][:9]
        got = reg.predict(name, Xq).numpy()
        est = fitted[name]
        want = (est.decision_function(Xq) if name != "krr"
                else est.predict(Xq)).numpy()
        np.testing.assert_allclose(got, want, **SAME)
        np.testing.assert_allclose(got, np.asarray(jreg.predict(name, Xq)),
                                   **SERVED)

    def test_generation_and_groups_follow_jax(self, fitted):
        jreg, reg = _registries(fitted, ())
        steps = [("register", "a", "svm"), ("register", "b", "svm2"),
                 ("register", "r", "krr"), ("register", "a", "svm"),
                 ("unregister", "b", None), ("unregister", "a", None)]
        for op, name, est in steps:
            if op == "register":
                jreg.register(name, fitted["j" + est])
                reg.register(name, fitted[est])
            else:
                jreg.unregister(name)
                reg.unregister(name)
            assert reg.generation == jreg.generation
            assert reg.n_groups == jreg.n_groups
            assert sorted(reg.models) == sorted(jreg.models)
            assert [g.names for g in reg.groups()] == \
                [g.names for g in jreg.groups()]

    def test_unregister_shrinks_group(self, fitted):
        reg = ModelRegistry(device=CPU)
        reg.register("a", fitted["svm"])
        reg.register("b", fitted["svm2"])
        gen = reg.generation
        reg.unregister("b")
        assert reg.generation > gen
        assert reg.n_groups == 1
        assert reg.group("a").size == 1
        reg.unregister("a")
        assert reg.n_groups == 0

    def test_unknown_name(self, fitted):
        reg = ModelRegistry(device=CPU)
        with pytest.raises(KeyError, match="ghost"):
            reg.predict("ghost", fitted["A"][:2])

    def test_register_rejects_junk(self):
        with pytest.raises(TypeError, match="fitted estimator"):
            ModelRegistry(device=CPU).register("x", {"not": "a model"})

    def test_registry_needs_a_device_or_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default resolves")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ModelRegistry()

    def test_operator_key_is_content(self, fitted):
        A = fitted["A"]
        rbf = KernelConfig("rbf")
        op = ExactGramOperator(torch.tensor(A), rbf)
        same = ExactGramOperator(torch.tensor(A.copy()), rbf)
        assert operator_key(op) == operator_key(same)
        assert operator_key(op) != operator_key(
            ExactGramOperator(torch.tensor(A), KernelConfig("linear")))
        moved = A.copy()
        moved[5, 3] += 1e-3
        assert operator_key(op) != operator_key(
            ExactGramOperator(torch.tensor(moved), rbf))
        assert operator_key(op) != operator_key(
            ExactGramOperator(torch.tensor(A.astype(np.float64)), rbf))

    def test_group_operator_is_not_hashed_again(self, fitted, monkeypatch):
        """A model whose operator IS a group's joins it without its data
        being read again; any other operator is hashed once."""
        from repro_torch.serve import registry as registry_module
        calls = []
        real = registry_module.operator_key
        monkeypatch.setattr(registry_module, "operator_key",
                            lambda op: calls.append(op) or real(op))
        reg = ModelRegistry(device=CPU)
        reg.register("a", fitted["svm"])
        shared = reg.models["a"].op
        reg.register("b", dataclasses.replace(
            ServableModel.from_estimator(fitted["svm2"]), op=shared))
        assert len(calls) == 1 and reg.n_groups == 1
        reg.register("c", fitted["svm2"])     # an equal copy: hashed
        assert len(calls) == 2 and reg.n_groups == 1


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _drive(eng, A, plan):
    """Submit ``plan`` ((name, rows, step_after) triples) to ``eng``."""
    tickets = []
    for name, rows, step in plan:
        tickets.append(eng.submit(name, A[:rows]))
        if step:
            eng.step()
    eng.run_until_idle()
    return tickets


class TestEngine:
    def test_mixed_traffic_no_new_block_shape(self, fitted):
        """After warmup, steady mixed-model traffic reaches no new serve
        block (``serve_cache_size`` stands for the jit cache)."""
        reg = ModelRegistry(predict_batch=64, device=CPU)
        for name in ("svm", "svm2", "krr"):
            reg.register(name, fitted[name])
        eng = ServingEngine(reg, slots=32, max_queue=256)
        assert eng.warmup() == 4 * reg.n_groups
        before = serve_cache_size()
        rng = np.random.default_rng(0)
        plan = [(("svm", "svm2", "krr")[i % 3], int(rng.integers(1, 5)),
                 i % 7 == 0) for i in range(60)]
        tickets = _drive(eng, fitted["A"], plan)
        assert serve_cache_size() == before
        assert all(t.status == DONE for t in tickets)
        assert eng.stats["served"] == 60

    def test_tickets_match_the_jax_engine(self, fitted):
        """The same submit/step sequence through the JAX engine and the
        port's: the same statuses, stats and block count, every ticket's
        values within the KMV bound."""
        jreg, reg = _registries(fitted, ("svm", "svm2", "krr"))
        jeng = JServingEngine(jreg, slots=16, max_queue=40)
        eng = ServingEngine(reg, slots=16, max_queue=40)
        rng = np.random.default_rng(1)
        plan = [(("svm", "svm2", "krr")[int(rng.integers(0, 3))],
                 int(rng.integers(1, 9)), i % 5 == 4) for i in range(48)]
        jt = _drive(jeng, fitted["A"], plan)
        tt = _drive(eng, fitted["A"], plan)
        assert eng.stats == jeng.stats
        assert [t.status for t in tt] == [t.status for t in jt]
        for a, b in zip(tt, jt):
            assert a.result.device.type == "cpu"
            np.testing.assert_allclose(a.result.numpy(),
                                       np.asarray(b.result), **SERVED)

    def test_one_kmv_per_group_block(self, fitted, monkeypatch):
        """A served block is one KMV for the whole group (F columns), not
        one per model: 3 models in 2 groups over 2 steps, 4 blocks."""
        A2, yc2, _ = _data(seed=9)
        other = KernelSVM(C=1.0, kernel="rbf", device=CPU,
                          options=SolverOptions(**_kw()))
        other.fit(A2, yc2)
        reg = ModelRegistry(predict_batch=64, device=CPU)
        reg.register("a", fitted["svm"])
        reg.register("b", fitted["svm2"])
        reg.register("c", other)
        eng = ServingEngine(reg, slots=16)
        calls = []
        real = ops.kmv_plain
        monkeypatch.setattr(ops, "kmv_plain",
                            lambda *a, **k: calls.append(a[2].shape)
                            or real(*a, **k))
        for step in range(2):
            for name in ("a", "b", "c", "a"):
                eng.submit(name, fitted["A"][:3])
            eng.step()
        assert eng.stats["blocks"] == 4
        assert [tuple(c) for c in calls] == [(96, 2), (96, 1)] * 2

    def test_results_match_direct_predict(self, fitted):
        reg = ModelRegistry(predict_batch=64, device=CPU)
        reg.register("a", fitted["svm"])
        reg.register("r", fitted["krr"])
        eng = ServingEngine(reg, slots=16)
        Xq = fitted["A"][3:8]
        ta = eng.submit("a", Xq)
        tr = eng.submit("r", Xq)
        eng.run_until_idle()
        np.testing.assert_allclose(
            ta.result.numpy(),
            fitted["svm"].decision_function(Xq).numpy(), **SAME)
        np.testing.assert_allclose(tr.result.numpy(),
                                   fitted["krr"].predict(Xq).numpy(), **SAME)

    def test_bounded_queue_sheds(self, fitted):
        reg = ModelRegistry(predict_batch=64, device=CPU)
        reg.register("a", fitted["svm"])
        eng = ServingEngine(reg, slots=8, max_queue=3)
        tickets = [eng.submit("a", fitted["A"][:1]) for _ in range(6)]
        assert [t.status for t in tickets].count(SHED) == 3
        assert eng.stats["shed"] == 3
        eng.run_until_idle()
        assert [t.status for t in tickets].count(DONE) == 3

    def test_deadline_expires_unserved(self, fitted):
        reg = ModelRegistry(predict_batch=64, device=CPU)
        reg.register("a", fitted["svm"])
        vt = [0.0]
        eng = ServingEngine(reg, slots=8, clock=lambda: vt[0])
        t_late = eng.submit("a", fitted["A"][:1], deadline_s=0.5)
        t_ok = eng.submit("a", fitted["A"][:1], deadline_s=100.0)
        vt[0] = 1.0                         # miss the first deadline
        eng.step()
        assert t_late.status == EXPIRED and t_late.result is None
        assert t_ok.status == DONE
        assert eng.stats["expired"] == 1
        assert eng.latency_quantiles() == {"p50": 1.0, "p99": 1.0}

    def test_oversized_request_rejected_not_stuck(self, fitted):
        reg = ModelRegistry(predict_batch=64, device=CPU)
        reg.register("a", fitted["svm"])
        eng = ServingEngine(reg, slots=4)
        big = eng.submit("a", fitted["A"][:10])
        small = eng.submit("a", fitted["A"][:2])
        eng.step()
        assert small.status == DONE          # FIFO skip, no head-of-line
        assert big.status != DONE
        assert eng.pending == 1
        with pytest.raises(RuntimeError, match="failed to drain"):
            eng.run_until_idle(max_steps=3)

    def test_refit_swap_mid_stream_matches_jax(self, fitted):
        """Tickets served before a refit carry the old weights, those
        after the new; the refit replays the JAX refit's schedule and
        lands on its alpha."""
        A, yr = fitted["A"], fitted["yr"]
        jreg, reg = _registries(fitted, ("krr",))
        jeng, eng = (JServingEngine(jreg, slots=16),
                     ServingEngine(reg, slots=16))
        t_pre = eng.submit("krr", A[:3])
        eng.step()
        pre = t_pre.result.clone()
        gen = reg.generation
        jres = jreg.refit("krr", A[:5] + 0.25, yr[:5])
        res = reg.refit("krr", A[:5] + 0.25, yr[:5],
                        schedule=np.asarray(jres.schedule))
        assert reg.generation == gen + 2 == jreg.generation
        np.testing.assert_allclose(res.alpha.numpy(),
                                   np.asarray(jres.alpha), **ALPHA)
        assert res.converged == jres.converged
        t_post, jt_post = eng.submit("krr", A[:3]), jeng.submit("krr",
                                                                  A[:3])
        eng.step()
        jeng.step()
        assert t_post.status == DONE
        np.testing.assert_allclose(t_post.result.numpy(),
                                   reg.predict("krr", A[:3]).numpy(), **SAME)
        np.testing.assert_allclose(t_post.result.numpy(),
                                   np.asarray(jt_post.result), **SERVED)
        np.testing.assert_allclose(pre.numpy(),
                                   fitted["krr"].predict(A[:3]).numpy(),
                                   **SAME)
        assert not np.allclose(pre.numpy(), t_post.result.numpy())

    def test_single_row_submit(self, fitted):
        reg = ModelRegistry(predict_batch=64, device=CPU)
        reg.register("a", fitted["svm"])
        eng = ServingEngine(reg, slots=8)
        t = eng.submit("a", fitted["A"][0])     # (n,) promotes to (1, n)
        eng.step()
        assert t.status == DONE and tuple(t.result.shape) == (1,)

    def test_submit_keeps_the_block_on_the_host(self, fitted):
        reg = ModelRegistry(predict_batch=64, device=CPU)
        reg.register("a", fitted["svm"])
        eng = ServingEngine(reg, slots=8)
        t = eng.submit("a", torch.tensor(fitted["A"][:2]))
        assert t.X.device.type == "cpu" and t.X.dtype == torch.float32

    @pytest.mark.parametrize("bad", [dict(slots=0), dict(max_queue=0),
                                     dict(slots=1.5)])
    def test_engine_rejects_bad_sizes(self, fitted, bad):
        reg = ModelRegistry(predict_batch=64, device=CPU)
        with pytest.raises(ValueError):
            ServingEngine(reg, **bad)

    def test_slots_clamp_to_the_largest_bucket(self, fitted):
        reg = ModelRegistry(predict_batch=16, device=CPU)
        assert ServingEngine(reg, slots=256).slots == 16


# ---------------------------------------------------------------------------
# eager predict-path validation
# ---------------------------------------------------------------------------

class TestValidation:
    @pytest.mark.parametrize("name", ["svm", "krr"])
    def test_estimator_wrong_width(self, fitted, name):
        est = fitted[name]
        fn = est.decision_function if name == "svm" else est.predict
        with pytest.raises(ValueError, match="A_test.*4 features.*8"):
            fn(np.zeros((3, 4), np.float32))

    def test_estimator_wrong_ndim(self, fitted):
        with pytest.raises(ValueError, match="A_test must be 2-D"):
            fitted["svm"].decision_function(np.zeros((3, 8, 1), np.float32))

    def test_estimator_wrong_dtype(self, fitted):
        with pytest.raises(ValueError, match="A_test has dtype torch.int32"):
            fitted["krr"].predict(np.zeros((3, 8), np.int32))

    def test_submit_names_argument(self, fitted):
        reg = ModelRegistry(device=CPU)
        reg.register("a", fitted["svm"])
        eng = ServingEngine(reg, slots=8)
        with pytest.raises(ValueError, match="X has 5 features"):
            eng.submit("a", np.zeros((2, 5), np.float32))
        with pytest.raises(ValueError, match="X has dtype torch.int32"):
            eng.submit("a", np.zeros((2, 8), np.int32))
        with pytest.raises(KeyError, match="ghost"):
            eng.submit("ghost", np.zeros((2, 8), np.float32))
        assert eng.stats["submitted"] == 0   # rejected before enqueue

    def test_refit_names_argument(self, fitted):
        reg = ModelRegistry(device=CPU)
        reg.register("r", fitted["krr"])
        with pytest.raises(ValueError, match="X_new"):
            reg.refit("r", np.zeros((2, 5), np.float32), np.zeros(2))
        with pytest.raises(ValueError, match="y_new has 3 rows"):
            reg.refit("r", np.zeros((2, 8), np.float32), np.zeros(3))

    def test_lowrank_without_fmap_cannot_serve(self):
        op = LowRankGramOperator(Phi=torch.ones((4, 2)), fmap=None)
        with pytest.raises(ValueError, match="feature map"):
            validate_queries(op, torch.zeros((1, 2)), name="Xq")

    def test_check_queries_stays_where_the_block_is(self, fitted):
        op = fitted["svm"].op_
        X = torch.zeros((3, 8))
        assert check_queries(op, X, name="X") is X
        assert validate_queries(op, np.zeros((3, 8), np.float32)).device \
            == op.device


# ---------------------------------------------------------------------------
# BatchedPredictor edge cases
# ---------------------------------------------------------------------------

class TestPredictorEdges:
    def _ops(self, m=40, n=6, seed=0):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((m, n)).astype(np.float32)
        w = rng.standard_normal(m).astype(np.float32)
        return (ExactGramOperator(torch.tensor(A), KernelConfig("rbf")),
                JExact(A, JKernelConfig("rbf")), A, w)

    def test_empty_query_batch(self):
        op, _, A, w = self._ops()
        w = torch.tensor(w)
        out = BatchedPredictor(op, w, batch=16)(torch.zeros((0, 6)))
        assert tuple(out.shape) == (0,)
        W = torch.stack([w, 2 * w], dim=1)
        out2 = BatchedPredictor(op, W, batch=16)(torch.zeros((0, 6)))
        assert tuple(out2.shape) == (0, 2)

    @pytest.mark.parametrize("F", [1, 3])
    def test_batch_larger_than_largest_bucket(self, F):
        """q > batch splits into full blocks + a bucketed tail: the same
        values as one dense call and as the JAX predictor, no new block
        shape after warmup."""
        op, jop, A, w = self._ops(m=40)
        W = np.stack([w * (j + 1) for j in range(F)], axis=1)
        W = W[:, 0] if F == 1 else W
        pred = BatchedPredictor(op, torch.tensor(W), batch=16)
        pred.warmup()
        before = serve_cache_size()
        Xq = np.random.default_rng(1).standard_normal((53, 6)).astype(
            np.float32)
        out = pred(Xq)
        assert tuple(out.shape) == (53,) + ((F,) if F > 1 else ())
        assert serve_cache_size() == before
        dense = BatchedPredictor(op, torch.tensor(W), batch=64)(Xq)
        np.testing.assert_allclose(out.numpy(), dense.numpy(), **SAME)
        jout = JBatchedPredictor(jop, W, batch=16)(Xq)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **SERVED)

    def test_compact_support_zero_svs(self):
        op, _, A, _ = self._ops()
        cop, cw = compact_support(op, torch.zeros(40))
        assert cw.shape[0] == 1              # operators cannot be empty
        assert float(cw.abs().max()) == 0.0
        out = BatchedPredictor(cop, cw, batch=8)(A[:5])
        np.testing.assert_array_equal(out.numpy(), np.zeros(5))

    def test_compact_support_zero_svs_above_tol(self):
        op, _, A, _ = self._ops()
        cop, cw = compact_support(op, torch.full((40,), 1e-6), tol=1e-3)
        assert float(cw.abs().max()) == 0.0

    def test_compact_support_stacked(self):
        op, _, A, w = self._ops()
        w1, w2 = w.copy(), w.copy()
        w1[10:] = 0.0
        w2[:30] = 0.0
        W = torch.tensor(np.stack([w1, w2], axis=1))
        cop, cW = compact_support(op, W)
        assert tuple(cW.shape) == (20, 2)    # union of supports
        np.testing.assert_allclose(
            BatchedPredictor(cop, cW, batch=8)(A[:5]).numpy(),
            BatchedPredictor(op, W, batch=8)(A[:5]).numpy(), **SAME)

    @pytest.mark.parametrize("batch", [8, 64, 100, 1024])
    def test_bucket_sizes_match_jax(self, batch):
        op, jop, _, w = self._ops()
        pred = BatchedPredictor(op, torch.tensor(w), batch=batch)
        jpred = JBatchedPredictor(jop, w, batch=batch)
        assert pred.bucket_sizes() == jpred.bucket_sizes()
        assert [pred.block_shape(q) for q in (1, 7, 9, 64, 65, 2000)] == \
            [jpred.block_shape(q) for q in (1, 7, 9, 64, 65, 2000)]

    def test_warmup_issues_every_bucket_once(self):
        # an operator shape no other test serves: its blocks are new
        op, jop, _, w = self._ops(m=41, seed=3)
        pred = BatchedPredictor(op, torch.tensor(w), batch=64)
        before = serve_cache_size()
        assert pred.warmup() == JBatchedPredictor(jop, w,
                                                  batch=64).warmup() == 4
        assert serve_cache_size() == before + 4
        pred.warmup()
        pred(np.zeros((17, 6), np.float32))
        assert serve_cache_size() == before + 4


# ---------------------------------------------------------------------------
# refit == cold fit
# ---------------------------------------------------------------------------

class TestRefitEquivalence:
    def test_refit_matches_cold_fit(self):
        """A warm-started refit on grown data converges to the predictions
        of a cold fit on the combined data (both to a tight tolerance)."""
        A, _, yr = _data(m=64, seed=7)
        opts = SolverOptions(**_kw(tol=1e-7, max_iters=4096, check_every=4))
        est = KernelRidge(lam=1.0, kernel="rbf", options=opts, device=CPU)
        est.fit(A, yr)
        reg = ModelRegistry(predict_batch=64, device=CPU)
        reg.register("m", est)
        rng = np.random.default_rng(11)
        X_new = rng.standard_normal((12, 8)).astype(np.float32)
        y_new = rng.standard_normal(12).astype(np.float32)
        res = reg.refit("m", X_new, y_new)
        assert res.converged
        cold = KernelRidge(lam=1.0, kernel="rbf", options=opts, device=CPU)
        cold.fit(np.concatenate([A, X_new]), np.concatenate([yr, y_new]))
        np.testing.assert_allclose(reg.predict("m", A[:16]).numpy(),
                                   cold.predict(A[:16]).numpy(), atol=1e-5)

    @pytest.mark.parametrize("problem", ["ksvm", "krr"])
    def test_refit_replays_the_jax_refit(self, fitted, problem):
        """The refit with the JAX refit's schedule replayed: its alpha
        within 1e-5 of the JAX refit's, its predictions within the KMV
        bound of the JAX registry's."""
        name = "svm" if problem == "ksvm" else "krr"
        y = fitted["yc"] if problem == "ksvm" else fitted["yr"]
        jreg, reg = _registries(fitted, (name,))
        rng = np.random.default_rng(5)
        X_new = rng.standard_normal((6, 8)).astype(np.float32)
        y_new = (np.sign(rng.standard_normal(6)) if problem == "ksvm"
                 else rng.standard_normal(6)).astype(np.float32)
        jres = jreg.refit(name, X_new, y_new)
        res = reg.refit(name, X_new, y_new,
                        schedule=np.asarray(jres.schedule))
        np.testing.assert_allclose(res.alpha.numpy(),
                                   np.asarray(jres.alpha), **ALPHA)
        assert res.iters_run == jres.iters_run
        Xq = fitted["A"][:8]
        np.testing.assert_allclose(reg.predict(name, Xq).numpy(),
                                   np.asarray(jreg.predict(name, Xq)),
                                   **SERVED)
        assert reg.models[name].y.shape[0] == y.shape[0] + 6

    def test_refit_moves_model_to_new_group(self, fitted):
        reg = ModelRegistry(predict_batch=64, device=CPU)
        reg.register("a", fitted["svm"])
        reg.register("b", fitted["svm2"])
        assert reg.n_groups == 1
        rng = np.random.default_rng(5)
        X_new = rng.standard_normal((6, 8)).astype(np.float32)
        y_new = np.sign(rng.standard_normal(6)).astype(np.float32)
        reg.refit("a", X_new, y_new)
        assert reg.n_groups == 2
        assert reg.group("b").size == 1
        assert reg.models["a"].op is not reg.models["b"].op

    def test_lowrank_model_without_raw_features_cannot_refit(self, fitted):
        m = ServableModel.from_estimator(fitted["krr"])
        lr = dataclasses.replace(m, op=LowRankGramOperator(
            Phi=torch.ones((96, 2)), fmap=None), A_raw=None)
        with pytest.raises(ValueError, match="A_raw=None"):
            lr.features


def test_facade_save_serves_through_load_and_registry(fitted, tmp_path):
    """``est.save()`` writes an artifact that ``load_model`` and
    ``ModelRegistry.load`` serve (the facade's artifact path)."""
    path = fitted["krr"].save(str(tmp_path / "krr"))
    assert path.endswith("step_00000000")
    reg = ModelRegistry(device=CPU)
    reg.load("krr", str(tmp_path / "krr"))
    eng = ServingEngine(reg, slots=8)
    t = eng.submit("krr", fitted["A"][:4])
    eng.run_until_idle()
    np.testing.assert_allclose(t.result.numpy(),
                               fitted["krr"].predict(fitted["A"][:4]).numpy(),
                               **SAME)
    np.testing.assert_allclose(
        t.result.numpy(), np.asarray(fitted["jkrr"].predict(fitted["A"][:4])),
        **SERVED)
