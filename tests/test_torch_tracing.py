"""The program's host spans (nngp_tpu_torch/tracing.py): off, one shared
object that records nothing; on, nested spans on torch.profiler's clock,
exactly the spans of the run loop's table for T iterations and K ASIS
pairs, the same states and records as a run with tracing off, the
set-up timers' seconds; and the arithmetic over them (``idle_by_span``,
``sweep_bench.profile_iteration``)."""

import numpy as np
import pytest
import torch

import nngp_tpu_torch
from nngp_tpu_torch import tracing
from nngp_tpu_torch.models import gaussian as G

torch.set_num_threads(1)

STATE_FIELDS = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
                "field", "tk_ancillary", "tk_sufficient", "prop_mean",
                "prop_m2", "prop_count")
SETUP = ("ordering_s", "nn_search_s", "coloring_s", "nn_dist2_s",
         "prior_fields_s", "to_device_s")


def _fit(seed=3, n=200, chains=3):
    rng = np.random.default_rng(seed)
    locs = rng.uniform(size=(n, 2))
    X = {"a": rng.normal(size=n)}
    y = rng.normal(size=n) + locs[:, 0] + X["a"]
    return nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=4, n_chains=chains, seed=seed, device="cpu",
        verbose=False, stationary_covfun="exponential_isotropic")


def _run(mc, T, K, diagnostics=True):
    return nngp_tpu_torch.run(
        mc, n_iterations_update=T, covparams_steps=K, verbose=False,
        field_thinning=0.5, compute_diagnostics=diagnostics,
        Gelman_Rubin_Brooks_stop=(0.0, 0.0))


def _counts(spans):
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def test_off_is_one_shared_object_and_records_nothing():
    a, b = tracing.span("a"), tracing.span("b", index=3)
    assert a is b
    with a as got:
        assert got is None
    assert tracing._spans is None
    with tracing.record() as spans:
        pass
    with tracing.span("after"):
        pass
    assert spans == []


def test_timings_without_recording():
    timings = {}
    with tracing.span("stage", timings):
        sum(range(1000))
    assert list(timings) == ["stage_s"] and timings["stage_s"] > 0


def test_nesting_parents_and_order():
    with tracing.record() as spans:
        with tracing.span("a", index=7):
            with tracing.span("b"):
                pass
            with tracing.span("c"):
                with tracing.span("d"):
                    pass
        with tracing.span("e"):
            pass
    assert [s.name for s in spans] == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in spans] == [-1, 0, 0, 2, -1]
    assert spans[0].index == 7 and spans[1].index is None
    a, b, c, d, e = spans
    for s in spans:
        assert s.start_ns <= s.end_ns
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns
    assert c.start_ns <= d.start_ns <= d.end_ns <= c.end_ns <= a.end_ns
    assert a.end_ns <= e.start_ns
    assert tracing.self_seconds(spans, 0) == pytest.approx(
        a.seconds - b.seconds - c.seconds, abs=1e-12)
    assert tracing.seconds(spans, "d") == d.seconds


def test_span_closes_on_an_exception():
    with tracing.record() as spans:
        with pytest.raises(ValueError):
            with tracing.span("a"):
                raise ValueError
        with tracing.span("b"):
            pass
    assert [s.parent for s in spans] == [-1, -1]
    assert spans[0].end_ns > 0


def test_a_record_inside_a_record_raises():
    with tracing.record() as spans:
        with pytest.raises(RuntimeError, match="already recording"):
            with tracing.record():
                pass
        with tracing.span("still"):
            pass
    assert [s.name for s in spans] == ["still"]
    assert tracing.span("x") is tracing.span("y")


@pytest.mark.parametrize("T,K,diagnostics", [(4, 1, True), (3, 2, False),
                                             (2, 3, True)])
def test_run_gives_the_spans_of_the_table(T, K, diagnostics):
    mc = _fit()
    with tracing.record() as spans:
        _run(mc, T, K, diagnostics)
    want = {"cycle": 1, "iterations": 1, "records_to_host": 1,
            "records_append": 1, "factor": 1 + 2 * K * T, "iteration": T,
            "draws": T, "ancillary": K * T, "sufficient": K * T,
            "level_solve": K * T, "adapt": T, "beta": T, "sweeps": T,
            "noise": T, "record": T}
    if diagnostics:
        want["diagnostics"] = 1
    assert _counts(spans) == want
    name = lambda i: spans[i].name if i >= 0 else None   # noqa: E731
    parents = {}
    for s in spans:
        parents.setdefault(s.name, set()).add(name(s.parent))
    assert parents["cycle"] == {None}
    assert parents["iteration"] == {"iterations"}
    assert parents["level_solve"] == {"ancillary"}
    assert parents["factor"] == {"iterations", "ancillary", "sufficient"}
    for k in ("draws", "ancillary", "sufficient", "adapt", "beta", "sweeps",
              "noise", "record"):
        assert parents[k] == {"iteration"}, k
    assert spans[0].index == 0
    assert [s.index for s in spans
            if s.name == "iteration"] == list(range(T))


def test_cycle_index_is_the_cycle_start():
    mc = _fit()
    _run(mc, 2, 1)
    with tracing.record() as spans:
        nngp_tpu_torch.run(mc, n_iterations_update=3, n_cycles=2,
                           verbose=False, Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    assert [s.index for s in spans if s.name == "cycle"] == [2, 5]


def test_recording_leaves_states_and_records_bit_identical():
    a, b = _fit(), _fit()
    _run(a, 4, 2)
    with tracing.record() as spans:
        _run(b, 4, 2)
    assert spans
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(a.states, f).numpy(),
                                      getattr(b.states, f).numpy(),
                                      err_msg=f)
    for ra, rb in zip(a.records, b.records):
        for k, v in ra.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(rb[k], v, err_msg=k)


def test_setup_timings_are_the_setup_spans(tmp_path):
    with tracing.record() as spans:
        mc = _fit()
    assert list(mc.setup_timings) == list(SETUP)
    setup = {s.name + "_s": s.seconds for s in spans}
    assert set(setup) == set(SETUP)
    for k in SETUP:
        assert mc.setup_timings[k] == setup[k], k
    path = str(tmp_path / "fit.pkl")
    nngp_tpu_torch.save(mc, path)
    with tracing.record() as spans:
        back = nngp_tpu_torch.load(path, device="cpu")
    assert list(back.setup_timings) == ["nn_search_s", "coloring_s",
                                        "nn_dist2_s"]
    assert {s.name + "_s": s.seconds for s in spans} == back.setup_timings


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            tracing.record() as spans:
        with tracing.span("outer"):
            with record_function("inner"):
                torch.ones(64).sum()
    inner = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner"]
    assert len(inner) == 1
    start = inner[0].start_ns()
    end = start + inner[0].duration_ns()
    assert abs(start - spans[0].start_ns) < 1_000_000
    assert end <= spans[0].end_ns + 1_000_000


def _span(name, parent, start, end):
    return tracing.Span(name, parent, start, end)


def test_idle_by_span_puts_each_piece_down_to_the_innermost_span():
    # cycle [0, 100): iterations [0, 60) holds iteration [5, 50) holding
    # level_solve [10, 30); records_to_host [60, 90)
    spans = [_span("cycle", -1, 0, 100), _span("iterations", 0, 0, 60),
             _span("iteration", 1, 5, 50), _span("level_solve", 2, 10, 30),
             _span("records_to_host", 0, 60, 90), _span("later", -1, 200, 300)]
    busy = [(-5, 2), (12, 20), (15, 25), (40, 70), (95, 250)]
    idle = tracing.idle_by_span(spans, busy, 0)
    # idle: [2, 12) [25, 40) [70, 95)
    want = {"iterations": 3, "iteration": 5 + 10, "level_solve": 2 + 5,
            "records_to_host": 20, "cycle": 5}
    assert idle.keys() == want.keys()
    for k, v in want.items():
        assert idle[k] == pytest.approx(v * 1e-9, abs=1e-15), k
    assert sum(idle.values()) == pytest.approx(50e-9, abs=1e-15)
    assert tracing.idle_by_span(spans, [], 4) == {
        "records_to_host": pytest.approx(30e-9)}
    assert tracing.idle_by_span(spans, [(0, 100)], 0) == {}


def test_idle_by_span_sums_to_the_idle_time_of_a_random_trace():
    rng = np.random.default_rng(5)
    spans = [_span("cycle", -1, 0, 10_000)]
    t = 0
    for it in range(20):
        i = len(spans)
        spans.append(_span("iteration", 0, t + 10, t + 480))
        for j in range(3):
            s = t + 20 + 150 * j
            spans.append(_span("ancillary", i, s, s + 120))
            spans.append(_span("level_solve", i + 1 + 2 * j, s + 30, s + 90))
        t += 500
    starts = np.sort(rng.integers(-100, 10_100, 400))
    busy = [(int(s), int(s + rng.integers(1, 40))) for s in starts]
    covered, cur = 0, None
    for s, e in sorted((max(s, 0), min(e, 10_000)) for s, e in busy
                       if e > 0 and s < 10_000):
        if cur is None or s > cur[1]:
            covered += 0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    covered += cur[1] - cur[0]
    idle = tracing.idle_by_span(spans, busy, 0)
    assert sum(idle.values()) == pytest.approx((10_000 - covered) * 1e-9,
                                               rel=1e-12)
    assert set(idle) <= {"cycle", "iteration", "ancillary", "level_solve"}


def test_profile_iteration_reads_the_programs_spans():
    from nngp_tpu_torch.experiments import sweep_bench

    mc = _fit()
    blocks = {k: getattr(G, k) for k in dir(G)}
    out = sweep_bench.profile_iteration(mc, T=3, chains=4, steps=2)
    assert {k: getattr(G, k) for k in dir(G)} == blocks
    assert out["chains"] == 4 and out["covparams_steps"] == 2
    calls = {k: v["calls"] for k, v in out["blocks"].items()}
    assert calls == {"factor": (1 + 2 * 2 * 3) / 3, "iteration": 1,
                     "draws": 1, "ancillary": 2, "level_solve": 2,
                     "sufficient": 2, "adapt": 1, "beta": 1, "sweeps": 1,
                     "noise": 1, "record": 1}
    assert 0 < out["blocks"]["level_solve"]["host_ms"] < out["traced_ms"]
    # a CPU run measures no device: those figures are not given
    assert out["idle_share"] is None and out["idle_ms"] is None
