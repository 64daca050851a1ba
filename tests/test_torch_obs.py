"""The port's telemetry (``repro_torch.obs`` and the facade's
``SolverOptions(telemetry=)``) against the JAX package's ``repro.obs``,
on the same numpy inputs, replaying the JAX fits' ``FitResult.schedule``,
at the sizes of tests/test_obs.py (m = 48, n = 4) on ``device="cpu"``.

What is held: the metrics registry's Prometheus text and JSON byte for
byte against the reference's for the same sequence of operations; the
instrumented fits' span names and phases and their ``metric_check`` /
``drift_correction`` counts equal to the JAX instrumented fit's of the
same schedule; ``audit_fit``'s modeled column equal to the reference's
(the port's ``FitResult.comm`` is the reference's model); a fit with
telemetry on bit-equal to one with it off, with the same kernel calls;
the serving metrics' counters and occupancy histogram equal to the JAX
engine's for the same traffic.  Times are not compared: they are each
host's own.
"""
import json

import numpy as np
import pytest
import torch

from repro.api import KernelRidge as JKernelRidge
from repro.api import KernelSVM as JKernelSVM
from repro.api import SolverOptions as JSolverOptions
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Telemetry as JTelemetry
from repro.obs.audit import audit_fit as j_audit_fit
from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
from repro_torch.core import loop
from repro_torch.kernels import ops
from repro_torch.obs import (Mark, MetricsRegistry, Telemetry,
                             active_telemetry, chunk_mark, default_registry,
                             span_begin, span_end)
from repro_torch.obs.audit import AuditReport, PhaseRow, audit_fit
from repro_torch.obs.export import (load_trace, save_trace, to_chrome_trace,
                                    validate_chrome_trace)

CPU = "cpu"


def _problem(m=48, n=4, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    y = (A @ rng.standard_normal(n)).astype(np.float32)
    return A, y


def _opts(**kw):
    base = dict(method="sstep", s=4, b=4, tol=1e-10, check_every=4,
                max_iters=64)
    base.update(kw)
    return base


def _fit_pair(jtel, tel, problem="krr", **kw):
    """The same instrumented fit through the JAX facade and the port's
    (the JAX schedule replayed): (JAX FitResult, port FitResult)."""
    A, y = _problem()
    if problem == "ksvm":
        y = np.sign(y).astype(np.float32)
        jest = JKernelSVM(C=1.0, kernel="rbf",
                          options=JSolverOptions(**_opts(telemetry=jtel,
                                                         **kw)))
        est = KernelSVM(C=1.0, kernel="rbf", device=CPU,
                        options=SolverOptions(**_opts(telemetry=tel, **kw)))
    else:
        jest = JKernelRidge(lam=0.5, kernel="rbf",
                            options=JSolverOptions(**_opts(telemetry=jtel,
                                                           **kw)))
        est = KernelRidge(lam=0.5, kernel="rbf", device=CPU,
                          options=SolverOptions(**_opts(telemetry=tel, **kw)))
    jres = jest.fit(A, y)
    res = est.fit(A, y, schedule=np.asarray(jres.schedule))
    return jres, res


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def _ops_sequence(reg):
    """One sequence of metric operations, the same for either package."""
    c = reg.counter("requests_total", "total requests")
    c.inc()
    c.inc(2.0, route="a")
    c.inc(route="b")
    c.labels(route="a").inc(0.5)
    g = reg.gauge("depth", "queue depth")
    g.set(5.0)
    g.inc(-2.0)
    g.set(1.5, shard="x")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.002, 0.02, 0.2, 0.05, 1e-4):
        h.observe(v)
    reg.histogram("empty_seconds")
    reg.counter("quiet_total")
    return reg


class TestMetrics:
    def test_counter_inc_and_labels(self):
        c = MetricsRegistry().counter("requests_total", "total requests")
        c.inc()
        c.inc(2.0, route="a")
        c.inc(route="a")
        assert c.value() == 1.0
        assert c.value(route="a") == 3.0

    def test_counter_rejects_decrease(self):
        c = MetricsRegistry().counter("x_total")
        with pytest.raises(ValueError, match="cannot decrease"):
            c.inc(-1.0)

    def test_gauge_set_and_negative_inc(self):
        g = MetricsRegistry().gauge("depth")
        g.set(5.0)
        g.inc(-2.0)
        assert g.value() == 3.0

    @pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.75, 0.99, 1.0])
    def test_histogram_quantiles_match_jax(self, q):
        h = MetricsRegistry().histogram("lat", buckets=(0.1, 1.0))
        jh = JMetricsRegistry().histogram("lat", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 0.7, 5.0):   # 5.0 lands in +Inf overflow
            h.observe(v)
            jh.observe(v)
        assert h.quantile(q) == jh.quantile(q)

    def test_histogram_bad_quantile_and_empty(self):
        h = MetricsRegistry().histogram("lat2", buckets=(1.0,))
        assert np.isnan(h.quantile(0.5))
        with pytest.raises(ValueError, match="quantile"):
            h.quantile(1.5)
        with pytest.raises(ValueError, match="needs >= 1 bucket"):
            MetricsRegistry().histogram("lat3", buckets=())

    def test_kind_clash_raises(self):
        reg = MetricsRegistry()
        reg.counter("thing")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("thing")
        assert reg.counter("thing") is reg.counter("thing")

    def test_bound_labels_fast_path(self):
        reg = MetricsRegistry()
        c = reg.counter("t_total")
        done = c.labels(status="done")
        done.inc()
        done.inc(2.0)
        assert c.value(status="done") == 3.0
        with pytest.raises(ValueError, match="cannot decrease"):
            done.inc(-1.0)
        with pytest.raises(TypeError, match="no set"):
            done.set(5.0)
        bound = reg.gauge("d").labels()
        bound.set(4.0)
        bound.inc(-1.0)
        assert reg.gauge("d").value() == 3.0

    def test_prometheus_text_is_byte_equal_to_jax(self):
        text = _ops_sequence(MetricsRegistry()).to_prometheus_text()
        assert text == _ops_sequence(JMetricsRegistry()).to_prometheus_text()
        assert 'requests_total{route="a"} 2.5' in text
        assert 'lat_seconds_bucket{le="+Inf"} 6' in text
        assert MetricsRegistry().to_prometheus_text() == ""

    def test_json_is_equal_to_jax(self):
        got = _ops_sequence(MetricsRegistry()).to_json()
        assert got == _ops_sequence(JMetricsRegistry()).to_json()
        payload = json.loads(got)
        assert payload["lat_seconds"]["values"]["count"] == 6
        assert payload["requests_total"]["kind"] == "counter"

    def test_default_registry_is_process_singleton(self):
        assert default_registry() is default_registry()


# ---------------------------------------------------------------------------
# Telemetry spans, marks, activation
# ---------------------------------------------------------------------------

class TestTelemetry:
    def test_span_and_mark_recording(self):
        tel = Telemetry()
        with tel.span("build", "setup", m=8):
            tel.mark("seam", phase="solve", value=3.0)
        assert len(tel.spans) == 1 and len(tel.marks) == 1
        sp = tel.spans[0]
        assert sp.name == "build" and sp.phase == "setup"
        assert sp.duration >= 0 and sp.args == {"m": 8}
        assert tel.marks[0].value == 3.0
        lo, hi = tel.window()
        assert lo <= hi
        tel.clear()
        assert tel.spans == [] and tel.marks == []
        assert tel.window() is None

    def test_disabled_handle_records_nothing(self):
        tel = Telemetry(enabled=False)
        with tel.span("x"):
            tel.mark("y")
        assert tel.spans == [] and tel.marks == []
        with tel.activate():
            assert active_telemetry() is None

    def test_activation_nests_and_restores(self):
        a, b = Telemetry(), Telemetry()
        assert active_telemetry() is None
        with a.activate():
            assert active_telemetry() is a
            with b.activate():
                assert active_telemetry() is b
            assert active_telemetry() is a
        assert active_telemetry() is None

    def test_paired_marks_lifo_and_unmatched_dropped(self):
        marks = [("a", 1.0, "B", None), ("a", 2.0, "B", None),
                 ("a", 3.0, "E", 7.0), ("b", 4.0, "B", None),
                 ("a", 5.0, "E", None)]
        tel, jtel = Telemetry(), JTelemetry()
        from repro.obs.spans import Mark as JMark
        tel.marks = [Mark(n, "round", t, k, v) for n, t, k, v in marks]
        jtel.marks = [JMark(n, "round", t, k, v) for n, t, k, v in marks]
        pairs = tel.paired_marks()
        assert [(p.t0, p.t1) for p in pairs] == [(2.0, 3.0), (1.0, 5.0)]
        assert pairs[0].args == {"value": 7.0}
        assert [(p.name, p.t0, p.t1, p.args) for p in pairs] == \
            [(p.name, p.t0, p.t1, p.args) for p in jtel.paired_marks()]

    def test_marks_recorded_into_the_active_handle(self):
        tel = Telemetry()
        with tel.activate():
            span_begin("seg")
            chunk_mark("seam", value=torch.tensor(8.0))
            span_end("seg")
        assert sorted(m.kind for m in tel.marks) == ["B", "E", "i"]
        seam = [m for m in tel.marks if m.name == "seam"][0]
        assert seam.value == 8.0 and seam.phase == "round"
        assert len(tel.paired_marks()) == 1

    def test_no_active_handle_is_silent(self):
        chunk_mark("quiet")                  # must not raise
        span_begin("quiet", device="cpu")
        span_end("quiet")


# ---------------------------------------------------------------------------
# zero cost when off: the same calls, the same bits
# ---------------------------------------------------------------------------

def _counting(monkeypatch):
    """Count the plain kernel calls (the CPU's kmv and gram launches)."""
    calls = {"kmv": 0, "gram": 0}
    for name in ("kmv", "gram"):
        real = getattr(ops, f"{name}_plain")

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ops, f"{name}_plain", counted)
    return calls


class TestZeroCostDisabled:
    @pytest.mark.parametrize("guard", [False, True])
    @pytest.mark.parametrize("problem", ["ksvm", "krr"])
    def test_instrumented_fit_is_bit_equal_with_the_same_calls(
            self, monkeypatch, problem, guard):
        A, y = _problem()
        if problem == "ksvm":
            y = np.sign(y).astype(np.float32)
        kw = _opts(guard=guard, recompute_every=4) if guard else _opts()
        results, counts = [], []
        for tel in (None, Telemetry(), Telemetry(enabled=False)):
            calls = _counting(monkeypatch)
            cls = KernelSVM if problem == "ksvm" else KernelRidge
            est = cls(kernel="rbf", device=CPU,
                      options=SolverOptions(**kw, telemetry=tel))
            results.append(est.fit(A, y))
            counts.append(dict(calls))
            monkeypatch.undo()
        base = results[0]
        for res, n in zip(results[1:], counts[1:]):
            assert torch.equal(res.alpha, base.alpha)
            np.testing.assert_array_equal(res.history, base.history)
            assert n == counts[0]
        assert base.telemetry is None and results[2].telemetry is None
        assert results[1].telemetry is not None

    def test_unmarked_driver_records_nothing(self):
        """With marks off the driver makes no mark, even under an active
        handle; with them on, one metric_check span a check."""
        rf = lambda s, x: s + x                      # noqa: E731
        xs = torch.arange(12, dtype=torch.float32)
        for marks in (False, True):
            tel = Telemetry()
            with tel.activate():
                res = loop.run_rounds(rf, torch.zeros(()), xs,
                                      check_every=4, metric_fn=lambda s: s,
                                      marks=marks)
            assert float(res.state) == 66.0 and res.checks_run == 3
            assert len(tel.paired_marks()) == (3 if marks else 0)

    @pytest.mark.parametrize("capture", [True, False])
    def test_marked_guarded_driver_matches_unmarked(self, capture):
        """The guarded driver with marks (captured form and eager loop)
        gives the unmarked run's state, histories and counts; one
        drift_correction span a correction, one metric_check a check."""
        def rf(carry, x):
            a, f = carry
            return a + x, f + 2 * x

        def correct(carry):
            a, f = carry
            return (a, 2 * a), (f - 2 * a).abs().max()

        guard = loop.GuardSpec(health_fn=lambda c: torch.isfinite(c[0]).all(),
                               correct_fn=correct, correct_every=3)
        xs = torch.linspace(0.0, 1.0, 10)
        state0 = (torch.zeros(2), torch.zeros(2))
        out = []
        for marks in (False, True):
            tel = Telemetry()
            with tel.activate():
                out.append(loop.run_rounds(
                    rf, state0, xs, check_every=4, guard=guard,
                    metric_fn=lambda c: c[0].sum(), capture=capture,
                    marks=marks))
            names = [s.name for s in tel.paired_marks()]
            assert names.count("drift_correction") == (3 if marks else 0)
            assert names.count("metric_check") == (3 if marks else 0)
        plain, marked = out
        for a, b in zip(plain.state, marked.state):
            assert torch.equal(a, b)
        assert torch.equal(plain.metric_history(), marked.metric_history())
        assert torch.equal(plain.drift_history(), marked.drift_history())
        assert (plain.rounds_run, plain.checks_run, plain.corrections) == \
            (marked.rounds_run, marked.checks_run, marked.corrections)


# ---------------------------------------------------------------------------
# instrumented fits end to end, against the JAX instrumented fits
# ---------------------------------------------------------------------------

def _names(tel):
    return [(s.name, s.phase) for s in tel.spans]


def _mark_counts(tel):
    return {name: sum(m.name == name for m in tel.marks)
            for name in ("metric_check", "drift_correction", "fallback")}


class TestInstrumentedFit:
    @pytest.mark.parametrize("problem", ["ksvm", "krr"])
    @pytest.mark.parametrize("guard", [False, True])
    def test_spans_and_marks_follow_jax(self, problem, guard):
        kw = dict(guard=True, recompute_every=4) if guard else {}
        jtel, tel = JTelemetry(), Telemetry()
        jres, res = _fit_pair(jtel, tel, problem, **kw)
        assert res.telemetry is tel
        np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jres.alpha),
                                   rtol=1e-5, atol=1e-5)
        assert _names(tel) == _names(jtel)
        assert _mark_counts(tel) == _mark_counts(jtel)
        assert [m.kind for m in tel.marks] == [m.kind for m in jtel.marks]
        assert len(tel.paired_marks()) == len(jtel.paired_marks())
        if guard:
            c, jc = (t.metrics.counter("repro_guard_corrections_total")
                     for t in (tel, jtel))
            assert c.value() == jc.value() >= 1
        solve = [s for s in tel.spans if s.phase == "solve"]
        assert solve and all(s.args == js.args for s, js in zip(
            solve, [s for s in jtel.spans if s.phase == "solve"]))

    def test_fast_path_carries_no_marks(self):
        jtel, tel = JTelemetry(), Telemetry()
        _fit_pair(jtel, tel, tol=0.0)
        assert tel.marks == [] and jtel.marks == []
        assert [s.args for s in tel.spans if s.name == "solve"] == \
            [{"path": "fast", "s": 4}]

    def test_marks_lie_inside_the_solve_span(self):
        tel = Telemetry()
        _fit_pair(JTelemetry(), tel)
        solve = [s for s in tel.spans if s.name == "solve"][0]
        assert all(solve.t0 <= m.t <= solve.t1 for m in tel.marks)
        fit = [s for s in tel.spans if s.name == "fit"][0]
        assert fit.args == {"problem": "krr", "m": 48, "n": 4}

    def test_fallback_counted_and_marked(self):
        from repro.resilience import FaultPlan as JFaultPlan
        from repro.resilience import inject as j_inject
        from repro_torch.resilience import FaultPlan, inject
        jtel, tel = JTelemetry(), Telemetry()
        kw = dict(guard=True, recompute_every=4, tol=0.0)
        with j_inject(JFaultPlan(nan_at_iter=20, target="f")), \
                inject(FaultPlan(nan_at_iter=20, target="f")):
            jres, res = _fit_pair(jtel, tel, **kw)
        assert _mark_counts(tel) == _mark_counts(jtel)
        assert _mark_counts(tel)["fallback"] == 1
        c, jc = (t.metrics.counter("repro_guard_fallbacks_total")
                 for t in (tel, jtel))
        assert c.to_json() == jc.to_json()

    def test_streamed_fit_marks_its_eager_checks(self):
        """A streamed fit runs the eager loop: its checks are marked
        around the calls, its alpha bit-equal to the unmarked fit's."""
        A, y = _problem()
        out = []
        for tel in (None, Telemetry()):
            est = KernelRidge(lam=0.5, kernel="rbf", device=CPU,
                              options=SolverOptions(**_opts(stream=16,
                                                            telemetry=tel)))
            out.append(est.fit(A, y))
        assert torch.equal(out[0].alpha, out[1].alpha)
        tel = out[1].telemetry
        assert _mark_counts(tel)["metric_check"] == 2 * len(out[1].history)

    def test_no_telemetry_fit_unchanged(self):
        _, res = _fit_pair(None, None)
        assert res.telemetry is None


class TestTelemetryOption:
    def test_true_is_a_fresh_handle_and_false_is_off(self):
        a, b = SolverOptions(telemetry=True), SolverOptions(telemetry=True)
        assert isinstance(a.telemetry, Telemetry)
        assert a.telemetry is not b.telemetry
        assert SolverOptions(telemetry=False).telemetry is None

    def test_junk_is_refused(self):
        with pytest.raises(ValueError, match="telemetry must be None"):
            SolverOptions(telemetry="yes")
        with pytest.raises(ValueError, match="telemetry must be None"):
            SolverOptions(telemetry=JTelemetry())

    def test_only_the_distributed_knobs_stay_unported(self):
        """No knob stays unported since the distributed layouts run: the
        port's options have every field of the JAX package's, and
        ``layout`` and ``mesh`` take the values the JAX package's take."""
        import dataclasses

        from repro_torch import api
        from repro_torch.launch.mesh import make_mesh
        assert not hasattr(api, "UNPORTED")
        assert ({f.name for f in dataclasses.fields(SolverOptions)}
                == {f.name for f in dataclasses.fields(JSolverOptions)})
        for layout in ("serial", "1d", "2d", "auto"):
            assert SolverOptions(layout=layout,
                                 mesh=make_mesh()).layout == layout

    def test_probe_fits_are_counted_not_recorded(self, monkeypatch):
        """The autotuner's probe fits run without the tuned fit's
        telemetry; the handle counts each probe."""
        from repro_torch.core.perf_model import DeviceBudget
        monkeypatch.setattr(DeviceBudget, "of_device", classmethod(
            lambda cls, device: DeviceBudget(16 * 2 ** 30, 16 * 2 ** 20,
                                             8e11, slots=2)))
        A, y = _problem()
        tel = Telemetry()
        est = KernelRidge(lam=0.5, kernel="rbf", device=CPU,
                          options=SolverOptions(s="auto", b="auto", probe=1,
                                                max_iters=64,
                                                telemetry=tel))
        res = est.fit(A, y)
        probes = tel.metrics.counter("repro_autotune_probes_total")
        assert probes.value(layout="serial") == len(res.plan.probed) >= 1
        assert [s.name for s in tel.spans].count("fit") == 1


# ---------------------------------------------------------------------------
# audit
# ---------------------------------------------------------------------------

class TestAudit:
    @pytest.mark.parametrize("guard", [False, True])
    def test_modeled_column_equals_jax(self, guard):
        kw = dict(guard=True, recompute_every=4) if guard else {}
        jres, res = _fit_pair(JTelemetry(), Telemetry(), **kw)
        report, jreport = audit_fit(res), j_audit_fit(jres)
        assert [r.phase for r in report.rows] == \
            [r.phase for r in jreport.rows]
        for r, jr in zip(report.rows, jreport.rows):
            np.testing.assert_allclose(r.modeled_s, jr.modeled_s,
                                       rtol=1e-12, atol=0)
            np.testing.assert_allclose(r.modeled_share, jr.modeled_share,
                                       rtol=1e-12, atol=0)
            assert (r.measured_s is None) == (jr.measured_s is None)
        np.testing.assert_allclose(report.modeled_total_s,
                                   jreport.modeled_total_s, rtol=1e-12)

    def test_report_shape(self):
        _, res = _fit_pair(JTelemetry(), Telemetry(), guard=True,
                           recompute_every=4)
        report = audit_fit(res)
        assert isinstance(report, AuditReport)
        assert all(isinstance(r, PhaseRow) for r in report.rows)
        assert {"setup", "compute", "check", "correct"} <= \
            {r.phase for r in report.rows}
        assert report.measured_total_s > 0 and report.ratio > 0
        d = report.to_dict()
        assert set(d) >= {"rows", "ratio", "tol", "flagged"}
        assert "phase" in report.render() and "ratio" in report.render()
        check = [r for r in report.rows if r.phase == "check"][0]
        assert check.measured_s > 0

    def test_audit_requires_telemetry(self):
        _, res = _fit_pair(None, None)
        with pytest.raises(ValueError, match="telemetry"):
            audit_fit(res)


# ---------------------------------------------------------------------------
# trace export
# ---------------------------------------------------------------------------

class TestTraceExport:
    def test_chrome_trace_schema(self, tmp_path):
        tel = Telemetry()
        _fit_pair(JTelemetry(), tel, max_iters=32)
        trace = to_chrome_trace(tel)
        validate_chrome_trace(trace)
        evs = trace["traceEvents"]
        assert any(e["ph"] == "X" and e["tid"] == 2 for e in evs)
        assert all({"name", "ph", "ts", "pid", "tid"} <= set(e)
                   for e in evs if e["ph"] != "M")
        path = save_trace(str(tmp_path / "t.json"), tel)
        assert len(load_trace(path)["traceEvents"]) == len(evs)

    @pytest.mark.parametrize("bad", [
        {},
        {"traceEvents": {}},
        {"traceEvents": [{"name": "x", "ph": "Q", "ts": 0.0, "pid": 1,
                          "tid": 1}]},
        {"traceEvents": [{"name": "x", "ph": "X", "ts": -1.0, "dur": 1.0,
                          "pid": 1, "tid": 1}]},
        {"traceEvents": [{"name": "x", "ph": "B", "ts": 0.0, "pid": 1,
                          "tid": 1}]},
        {"traceEvents": [{"ph": "i", "ts": 0.0, "pid": 1, "tid": 1}]},
    ], ids=["no-events", "not-a-list", "phase", "negative-ts", "unclosed",
            "no-name"])
    def test_validate_rejects_bad_traces(self, bad):
        with pytest.raises(ValueError):
            validate_chrome_trace(bad)


# ---------------------------------------------------------------------------
# serving metrics
# ---------------------------------------------------------------------------

class TestServeMetrics:
    def _engines(self, jtel, tel):
        from repro.serve import ModelRegistry as JModelRegistry
        from repro.serve import ServingEngine as JServingEngine
        from repro_torch.serve import ModelRegistry, ServingEngine
        A, y = _problem(m=32)
        jkr = JKernelRidge(lam=0.5, kernel="rbf",
                           options=JSolverOptions(method="sstep", s=4, b=4,
                                                  max_iters=32))
        jres = jkr.fit(A, y)
        kr = KernelRidge(lam=0.5, kernel="rbf", device=CPU,
                         options=SolverOptions(method="sstep", s=4, b=4,
                                               max_iters=32))
        kr.fit(A, y, schedule=np.asarray(jres.schedule))
        jreg, reg = JModelRegistry(predict_batch=8), ModelRegistry(
            predict_batch=8, device=CPU)
        jreg.register("krr", jkr)
        reg.register("krr", kr)
        return (JServingEngine(jreg, slots=8, max_queue=12, telemetry=jtel),
                ServingEngine(reg, slots=8, max_queue=12, telemetry=tel))

    def test_engine_instruments_follow_jax(self):
        jtel, tel = JTelemetry(), Telemetry()
        jeng, eng = self._engines(jtel, tel)
        Q = _problem(m=16)[0]
        for e in (jeng, eng):
            for i in range(16):              # the last 4 are shed
                e.submit("krr", Q[i][None, :])
            e.step()
            e.run_until_idle()
        c = tel.metrics.counter("repro_serve_tickets_total")
        assert c.value(status="submitted") == 16
        assert c.value(status="done") == 12 and c.value(status="shed") == 4
        text, jtext = (t.metrics.to_prometheus_text() for t in (tel, jtel))
        same = [ln for ln in text.splitlines()
                if "latency" not in ln]
        assert same == [ln for ln in jtext.splitlines()
                        if "latency" not in ln]
        lat = tel.metrics.histogram("repro_serve_ticket_latency_seconds")
        assert lat.count == 12 and not np.isnan(lat.quantile(0.5))
        steps = [s for s in tel.spans if s.name == "engine_step"]
        assert len(steps) == eng.stats["steps"] and \
            all(s.phase == "serve" for s in steps)

    def test_engine_without_telemetry_unchanged(self):
        jeng, eng = self._engines(None, None)
        eng.submit("krr", _problem(m=4)[0][:1])
        assert eng.run_until_idle() == 1
        assert eng._tel is None


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

class TestCLI:
    def test_report(self, capsys):
        from repro_torch.obs.__main__ import main
        assert main(["report", "--m", "48", "--iters", "32",
                     "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "phase" in out and "ratio" in out

    def test_trace_and_scrape(self, tmp_path, capsys):
        from repro_torch.obs.__main__ import main
        out_path = tmp_path / "t.json"
        assert main(["trace", "--m", "48", "--iters", "32", "--device",
                     "cpu", "--out", str(out_path)]) == 0
        validate_chrome_trace(json.loads(out_path.read_text()))
        assert main(["scrape", "--m", "48", "--iters", "32",
                     "--tickets", "8", "--device", "cpu"]) == 0
        assert "repro_serve_tickets_total" in capsys.readouterr().out
