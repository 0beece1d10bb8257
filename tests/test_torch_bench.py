"""The port's bench (nngp_tpu_torch/bench.py) on the CPU: the smoke run
end to end in a subprocess, checked as tests/test_bench_smoke.py checks
bench.py; its headline arithmetic on inputs worked out by hand; the
budget's cut of the window retries; a failed leg or preflight still
printing the line with exit 1; the preflight's refusal of a CPU fit; and
the two signature repairs of the API (run's n_cores, initialize's
dtype)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nngp_tpu_torch
from nngp_tpu_torch import bench
from nngp_tpu_torch.diagnostics.preflight import chromatic_sweep_parity

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_smoke_emits_json():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "nngp_tpu_torch.bench", "--smoke",
         "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [l for l in r.stdout.strip().splitlines() if l.startswith("{")]
    assert len(lines) == 1, r.stdout
    result = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in result
    assert result["metric"].endswith("[cpu]")
    detail = result["detail"]
    assert "errors" not in detail, detail.get("errors")
    assert result["value"] > 0.0
    assert result["vs_baseline"] > 0.0
    assert detail["sweep_parity_preflight"] is None   # no kernel on the CPU
    legs = [detail["best_config"]] + [
        detail[k] for k in ("reference_protocol_3_chains", "best_chains_leg")
        if k in detail]
    assert len(legs) == 2
    assert {leg["schedule"] for leg in legs} == {"plain"}
    lean = [leg for leg in legs if leg["lean_records"]]
    assert lean, f"no lean leg in {list(detail)}"
    assert lean[0]["covparams_steps"] == 3
    assert lean[0]["ess_per_s"]["field_mean"] > 0.0
    assert lean[0]["rhat_timed_window"] is not None
    assert lean[0]["field_kept_samples"] > 0


def _leg(K, chains, range_ess, field_ess, wall=2.0, iters=100):
    ess = {"range": range_ess, "field_mean": field_ess}
    return {"covparams_steps": K, "n_chains": chains,
            "ess_per_s": {k: v / wall for k, v in ess.items()},
            "ess_per_iter": {k: v / iters for k, v in ess.items()}}


BASE = {"it_per_s": 2.0,
        "per_op_s": {"factor_build": 0.25, "trisolve": 0.1, "loglik": 0.15,
                     "beta_block": 0.01, "chromatic": 0.09}}


@pytest.mark.parametrize("K,chains,want_base", [
    # K = 1: min ESS/iter 0.3 over 3 chains = 0.1 a chain; x 3 chains x
    # the baseline's 2 it/s = 0.6
    (1, 3, 0.6),
    # K = 3: the baseline pays 2 more pairs at 0.25 + 0.1 + 0.15 = 0.5 s:
    # 1 / (0.5 + 2 * 0.5) = 2/3 it/s; 0.3 / 6 chains * 3 * 2/3 = 0.1
    (3, 6, 0.1),
])
def test_headline_by_hand(K, chains, want_base):
    # range ESS 30, field ESS 50 over 100 iterations in 2 s: min = range
    leg = _leg(K, chains, range_ess=30.0, field_ess=50.0)
    h, b = bench._headline(leg, BASE)
    assert h == pytest.approx(15.0)
    assert b == pytest.approx(want_base)
    assert bench._headline(leg, None) == (pytest.approx(15.0), None)
    # the field is the minimum when it mixes worse
    assert bench._headline(_leg(K, chains, 30.0, 10.0), BASE)[0] == \
        pytest.approx(5.0)


@pytest.mark.parametrize("h,b,want", [
    (15.0, 0.6, 25.0), (1.0, 3.0, 0.33), (2.0, None, 0.0), (2.0, 0.0, 0.0),
    (2.0, -1.0, 0.0), (2.0, float("nan"), 0.0)])
def test_ratio_by_hand(h, b, want):
    assert bench._ratio(h, b) == want


def _toy_fit(**kw):
    rng = np.random.default_rng(0)
    locs = rng.uniform(size=(120, 2))
    y = rng.normal(size=120)
    return nngp_tpu_torch.initialize(locs, y, m=4, n_chains=2, device="cpu",
                                     verbose=False, **kw)


def test_preflight_raises_on_a_cpu_fit():
    with pytest.raises(ValueError, match="no kernel"):
        chromatic_sweep_parity(_toy_fit())


def test_run_accepts_n_cores():
    mc = nngp_tpu_torch.run(_toy_fit(), n_iterations_update=5, verbose=False,
                            n_cores=3)
    assert mc.iterations == 5


def test_initialize_dtype():
    assert _toy_fit(dtype=np.float32).states.field.dtype == torch.float32
    with pytest.raises(ValueError, match="float32"):
        _toy_fit(dtype=np.float64)


def test_budget_stops_window_retries():
    """A window, once started, completes; a retry that would end past the
    deadline is skipped and recorded as budget_hit."""
    import time

    kw = dict(smoke=True, device="cpu", window_retries=2)
    cut = bench.measure_engine(deadline=time.monotonic(), **kw)
    # 100 iterations of the 800-site smoke are far from stationary
    assert cut["window_stationary"] is False
    assert cut["budget_hit"] is True
    assert cut["iters"] == 50 and cut["wall_s"] > 0
    assert bench.measure_engine(**kw)["budget_hit"] is False


@pytest.mark.parametrize("fail", ["leg", "preflight"])
def test_failure_still_prints_the_line_and_exits_1(monkeypatch, capsys, fail):
    """A leg that raises, or a preflight that fails (no later leg runs),
    lands in detail.errors; the JSON line prints and main returns 1."""
    calls = []

    def engine(**kw):
        calls.append(kw)
        if fail == "preflight":
            kw["parity_out"].update(ok=False, max_abs_diff=1.0)
        raise RuntimeError("boom")

    monkeypatch.setattr(bench, "measure_engine", engine)
    monkeypatch.setattr(bench, "measure_r_equivalent_baseline",
                        lambda **kw: {"it_per_s": 2.0, "per_op_s": {}})
    assert bench.main(["--smoke", "--device", "cpu"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    errors = result["detail"]["errors"]
    assert set(errors) == {"best_chains_leg", "reference_protocol_3_chains"}
    assert result["value"] == 0.0 and result["vs_baseline"] == 0.0
    if fail == "preflight":
        assert len(calls) == 1
        assert errors["reference_protocol_3_chains"] == [
            "not run: the sweep parity preflight failed"]
        assert result["detail"]["sweep_parity_preflight"]["ok"] is False
    else:
        assert len(calls) == 2
