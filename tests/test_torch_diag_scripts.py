"""The port's diagnostics scripts (nngp_tpu_torch/experiments: grb_guard,
hm_mpsrf, hm_crossval, am_ab, halo_overhead_table) against the JAX scripts
of experiments/, loaded from their files with no edits, on the CPU at small
sizes (each package's ``load_heavy_metals`` patched to the 400-site
synthetic workload where a script reads the data).

Tolerances:
- grb_guard: every number within 1e-10 relative (host float64 NumPy on
  both sides, the same inputs);
- hm_mpsrf: every number within 1e-8 relative (one nngp_tpu.save file, the
  same float32 records, float64 on the host);
- hm_crossval: the collapsed float64 sampler's draws bit for bit (the
  same subsample, graph, covariates and seeds); the engine leg runs;
- am_ab: the isotropic arm has no AM moments, its states equal
  nngp_tpu's with prop_* stripped to None bit for bit, and one Gibbs
  iteration from them matches nngp_tpu's under the same draws at
  tests/test_torch_gibbs.py's tolerance;
- halo_overhead_table: the totals, the level solve's row and the overlap
  equal the JAX script's counting on nngp_tpu's plan of the same graph.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nngp_tpu
from nngp_tpu_torch.experiments import (am_ab, grb_guard,
                                        halo_overhead_table, hm_crossval,
                                        hm_mpsrf)
from tests.test_torch_audits import leaves, load_script, small_hm, trace_locals
from tests.test_torch_gibbs import C as GIBBS_CHAINS
from tests.test_torch_gibbs import _run_both

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
__all__ = ["small_hm"]      # the fixture, imported for the tests below


def assert_numbers_close(port, ref, rtol):
    """Every number of ``ref`` has a counterpart in ``port`` within ``rtol``
    relative."""
    got = dict(leaves(port))
    for path, want in leaves(ref):
        assert path in got, path
        assert math.isclose(got[path], want, rel_tol=rtol, abs_tol=0.0), \
            (path, got[path], want)


def test_grb_guard_matches_jax(tmp_path):
    ref = load_script("grb_guard").main()
    port = grb_guard.main(["--device", "cpu", "--out",
                           str(tmp_path / "grb_guard.json")])
    assert port["device"] == "cpu"
    assert set(ref) <= set(port)
    assert_numbers_close(port, ref, 1e-10)
    assert json.loads((tmp_path / "grb_guard.json").read_text()) == port


def test_hm_mpsrf_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    locs = rng.uniform(size=(200, 2))
    X = {"a": rng.normal(size=200), "b": rng.normal(size=200)}
    y = rng.normal(size=200) + locs[:, 0] + X["a"]
    mc = nngp_tpu.initialize(locs, y, X_locs=X, m=4, n_chains=3, seed=2,
                             stationary_covfun="exponential_isotropic")
    mc = nngp_tpu.run(mc, n_cycles=1, n_iterations_update=40, verbose=False,
                      field_thinning=0.5, Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    fit = str(tmp_path / "fit.pkl")
    nngp_tpu.save(mc, fit)
    (tmp_path / "experiments").mkdir()
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(ROOT)   # the script imports experiments.*
    load_script("hm_mpsrf").main(fit)
    ref = json.loads((tmp_path / "experiments" / "hm_mpsrf.json").read_text())
    port = hm_mpsrf.main([fit, "--device", "cpu", "--out",
                          str(tmp_path / "port.json")])
    assert set(ref) <= set(port) and port["fit"] == ref["fit"]
    assert port["principal_direction"]["loadings"] == \
        ref["principal_direction"]["loadings"]
    assert port["top_W_correlations"] == ref["top_W_correlations"]
    assert port["mpsrf_without_top_param"] == ref["mpsrf_without_top_param"]
    assert_numbers_close(port, ref, 1e-8)


def _capped_run(run, iters):
    def capped(mc, *a, **kw):
        kw["n_iterations_update"] = min(kw.get("n_iterations_update", 200),
                                        iters)
        return run(mc, *a, **kw)
    return capped


def test_hm_crossval_collapsed_sampler_bit_identical(small_hm, monkeypatch):
    """Both scripts at CROSSVAL_N = 60, one engine cycle capped at 40
    iterations, 60 oracle iterations: the oracle's draws bit for bit."""
    monkeypatch.setenv("CROSSVAL_N", "60")
    monkeypatch.setenv("CROSSVAL_ENGINE_CYCLES", "1")
    monkeypatch.setenv("CROSSVAL_ITERS", "60")
    monkeypatch.setattr(nngp_tpu, "run", _capped_run(nngp_tpu.run, 40))
    script = load_script("hm_crossval")
    ref = trace_locals(script.main, "main", ("samples",))[-1][0]
    ref_report = json.loads((small_hm / "experiments" / "hm_crossval.json")
                            .read_text())
    out = small_hm / "port.json"
    argv = ["--device", "cpu", "--n", "60", "--engine-cycles", "1",
            "--engine-iters", "40", "--iters", "60", "--out", str(out)]
    port = trace_locals(lambda: hm_crossval.main(argv), "collapsed_sampler",
                        ("samples",))[-1][0]
    assert port.keys() == ref.keys()
    for k in ref:
        assert len(port[k]) == len(ref[k]) == 60
        np.testing.assert_array_equal(np.asarray(port[k]), np.asarray(ref[k]),
                                      err_msg=k)
    report = json.loads(out.read_text())
    assert set(ref_report) <= set(report)
    assert report["n_sub"] == 60 and report["oracle_iters"] == 60
    assert report["n_unique"] == ref_report["n_unique"]
    assert report["engine_iters"] == ref_report["engine_iters"] == 40
    for k, p in ref_report["params"].items():
        for q in ("oracle_mean", "oracle_mcse", "oracle_sd"):
            assert report["params"][k][q] == p[q], (k, q)
        for q in ("engine_mean", "engine_sd"):
            assert math.isfinite(report["params"][k][q]), (k, q)


def test_am_ab_isotropic_arm_matches_jax(small_hm):
    """The isotropic arm: no AM moments, nngp_tpu's stripped states bit for
    bit, and one iteration from them as nngp_tpu runs it (the first
    GIBBS_CHAINS chains, tests/test_torch_gibbs.py's helper)."""
    from nngp_tpu.utils.datasets import load_heavy_metals

    mc_t = am_ab.arm_fit("isotropic", 1, "cpu")
    st = mc_t.states
    assert st.prop_mean is None and st.prop_m2 is None \
        and st.prop_count is None
    assert am_ab.arm_fit("am", 1, "cpu").states.prop_mean is not None

    locs, y, X = load_heavy_metals()
    mc = nngp_tpu.initialize(locs[:8000], y[:8000],
                             X_locs={k: v[:8000] for k, v in X.items()}, m=5,
                             stationary_covfun="exponential_sphere",
                             n_chains=3, seed=1)
    stripped = dataclasses.replace(mc.states, prop_mean=None, prop_m2=None,
                                   prop_count=None)
    for f in dataclasses.fields(stripped):
        want = getattr(stripped, f.name)
        got = getattr(st, f.name)
        if want is None:
            assert got is None, f.name
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f.name)
    first = dataclasses.replace(stripped, **{
        f.name: np.asarray(getattr(stripped, f.name))[:GIBBS_CHAINS]
        for f in dataclasses.fields(stripped)
        if getattr(stripped, f.name) is not None})
    _run_both(mc, its=[0], iter_start=0, states=first)


def test_am_ab_arms_run(small_hm):
    """Each arm through run_arm on the CPU at 2 cycles of 30 iterations:
    the JAX script's record keys and finite figures."""
    with open(os.path.join(ROOT, "experiments", "am_ab_cpu.jsonl")) as f:
        jax_keys = set(json.loads(f.readline()))
    for arm in am_ab.ARMS:
        row = am_ab.run_arm(arm, 1, 2, 30, "cpu")
        assert jax_keys <= set(row), jax_keys - set(row)
        assert row["arm"] == arm and row["iterations"] == 60
        assert all(math.isfinite(v) for _, v in leaves(row))
        assert row["kernel_launches"] == {"chromatic_sweeps": 0,
                                          "factor_build": 0}  # CPU: twins
    with pytest.raises(ValueError, match="arm"):
        am_ab.arm_fit("nope", 1, "cpu")


def test_halo_overhead_table_matches_jax(tmp_path, monkeypatch):
    """The JAX script's counting on nngp_tpu's D = 8 plan of its first 3,000
    sites (nngp_tpu.initialize patched to take them), and the port's rows
    on the port's plan of the same sites."""
    from nngp_tpu_torch.parallel.halo import build_halo_plan

    n = 3000
    init = nngp_tpu.initialize
    monkeypatch.setattr(nngp_tpu, "initialize",
                        lambda locs, y, **kw: init(locs[:n], y[:n], **kw))
    (tmp_path / "experiments").mkdir()
    monkeypatch.chdir(tmp_path)
    load_script("halo_overhead_table").main()
    ref = json.loads((tmp_path / "experiments" / "halo_overhead_table.json")
                     .read_text())

    rng = np.random.default_rng(7)           # the script's draws
    locs = rng.uniform(0, 1000.0, size=(100_000, 2))[:n]
    y = rng.normal(size=100_000)[:n]
    import nngp_tpu_torch

    mc = nngp_tpu_torch.initialize(locs, y, m=5,
                                   reordering="middleout", n_chains=2, seed=5,
                                   device="cpu", verbose=False)
    port = halo_overhead_table.overhead_rows(build_halo_plan(mc.graph, 8))
    assert (port["n"], port["D"]) == (ref["n"], ref["D"]) == (n, 8)
    assert port["overlap_fraction"] == ref["overlap_fraction"]
    assert port["totals"] == ref["totals"]
    assert port["per_stage"][-1] | {"blocks": 0} == \
        ref["per_stage"][-1] | {"blocks": 0}            # the level solve
    for key in ("owned_site_updates", "halo_values_sent"):
        assert sum(r[key] for r in port["per_stage"][:-1]) == \
            sum(r[key] for r in ref["per_stage"][:-1]), key
    assert [r["stage"] for r in port["per_stage"][:-1]] == \
        [f"sweep colour {c}" for c in range(mc.graph.n_colors)]
    assert port["need_rows_per_device"] >= n // 8


SCRIPTS = (grb_guard, hm_mpsrf, hm_crossval, am_ab, halo_overhead_table)


@pytest.mark.parametrize("module", SCRIPTS,
                         ids=[m.__name__.rsplit(".", 1)[1] for m in SCRIPTS])
def test_card_asked_for_without_one_raises(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        module.main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_grb_guard_runs_by_python_m_without_jax(tmp_path):
    code = ("import runpy, sys; sys.argv = ['grb_guard', '--device', 'cpu', "
            f"'--out', {str(tmp_path / 'g.json')!r}]; "
            "runpy.run_module('nngp_tpu_torch.experiments.grb_guard', "
            "run_name='__main__'); "
            "assert 'jax' not in sys.modules and 'nngp_tpu' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "C_stationary_rank_deficient_B" in json.loads(
        (tmp_path / "g.json").read_text())
