"""CPU tests of the benchmark harness: the generator, the frozen counts, the
trace arithmetic, discovery by name, the refusal without a card, the
import guard, the reference against scipy, and the comparison that decides
``correct`` against the sampler, its control and planted faults at a tiny
size.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import registry, run
from benchmark.counts import draws, factor_build, peaks, sweep
from benchmark.data import heavy_metals
from benchmark.trace import Event, breakdown, mean_call_s, union_s

ROOT = registry.ROOT
CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


CONFIGS = sorted(f[:-5] for f in os.listdir(os.path.join(registry.HERE,
                                                         "configs")))


def tiny_spec(cell="hm_exp.c96.k3", C=4, K=1, T=4, config=None):
    """The cell at a size a test can hold: 300 sites in a 1 x 1 degree
    box, 3 covariates, C chains, cycles of T iterations; ``config`` names a
    file of ``configs/`` to fit instead of the cell's."""
    spec = registry.cell(registry.benchmark(), cell)
    cfg = copy.deepcopy(spec["config"] if config is None else json.load(
        open(os.path.join(registry.HERE, "configs", f"{config}.json"))))
    cfg.update(n_sites=300, n_obs=330, n_covariates=3, n_iterations_update=T)
    cfg["generator"].update(lon_range=[-100.0, -99.0], lat_range=[30.0, 31.0])
    tr = dict(spec["traffic"], n_chains=C, covparams_steps=K,
              field_columns=8, warmup_iterations=2)
    return dict(spec, config=cfg, traffic=tr)


# --- the generator -------------------------------------------------------

def test_generator_counts_and_determinism():
    cfg = registry.cell(registry.benchmark(), "hm_exp.c96.k3")["config"]
    locs, site_of_obs = heavy_metals.geometry(cfg)
    assert locs.shape == (58097, 2)
    assert site_of_obs.shape == (64274,)
    assert len(np.unique(locs, axis=0)) == 58097
    assert len(np.unique(site_of_obs)) == 58097
    assert (locs[:, 0] >= -125).all() and (locs[:, 0] <= -67).all()
    assert (locs[:, 1] >= 25).all() and (locs[:, 1] <= 49).all()
    again, again_obs = heavy_metals.geometry(cfg)
    assert np.array_equal(locs, again) and np.array_equal(site_of_obs,
                                                          again_obs)


def test_generator_same_seed_same_data_and_signal():
    cfg = tiny_spec()["config"]
    a, b = heavy_metals.make(cfg, 2**31 + 11), heavy_metals.make(cfg, 2**31 + 11)
    c = heavy_metals.make(cfg, 5)
    assert np.array_equal(a["observed_field"], b["observed_field"])
    assert np.array_equal(a["observed_locs"], c["observed_locs"])  # geometry
    assert not np.array_equal(a["observed_field"], c["observed_field"])
    assert len(a["X_locs"]) == 3
    # duplicated sites carry the same location covariates
    _, inv = np.unique(a["observed_locs"], axis=0, return_inverse=True)
    x = a["X_locs"]["x1"]
    first = {}
    for i, k in enumerate(inv.reshape(-1)):
        assert x[i] == first.setdefault(k, x[i])


def test_vecchia_field_has_the_configured_scale():
    rng = np.random.default_rng(0)
    xyz = heavy_metals.lonlat_to_xyz(np.stack(
        [rng.uniform(-100, -90, 3000), rng.uniform(30, 40, 3000)], 1))
    w = heavy_metals.vecchia_field(xyz, np.random.default_rng(1),
                                   rng.normal(size=3000), 0.2, 0.01, 5)
    assert 0.1 < np.var(w) < 0.3
    # nearby sites are correlated: the spatial signal the data carries
    from scipy.spatial import cKDTree
    _, j = cKDTree(xyz).query(xyz, k=2)
    assert np.corrcoef(w, w[j[:, 1]])[0, 1] > 0.5


# --- the frozen counts ---------------------------------------------------

def test_sweep_count_by_hand():
    # C=2, S=1, n=3, nnz=4, 2 colours: q min(8, 2*2+4) = 8 values
    nbytes, flops = sweep.sweep_bytes_flops(2, 1, 3, 4, 2)
    assert nbytes == 4 * 8 + 4 * (12 + 12 + 6 + 6 + 4 + 4 + 3 + 3)
    assert flops == 2 * 1 * (3 * 4 + 8 * 3)


def test_draws_count_by_hand():
    nbytes, flops = draws.draws_bytes_flops(2, 10, 4)
    assert nbytes == 4 * 2 * 14 + 16
    assert flops == 38 * 2 * 10


def test_factor_row_ops_by_hand():
    # m = 1: cholesky 2 + root, two solves of 1, then 2+1+root+1+2
    assert factor_build.row_ops(1) == (2 + 8) + 2 + (2 + 1 + 8 + 1 + 2)
    assert factor_build.row_ops(0) == 1 + 8 + 1


def test_factor_ops_exponential_by_hand():
    d2 = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    valid = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    nat = torch.tensor([[2.0], [3.0]])
    ops = factor_build.factor_ops("exponential_sphere", d2, valid, 2, nat)
    per_pair = (3 + 8) + (1 + 8)
    assert ops == 2 * per_pair + 2 * 2 * factor_build.row_ops(2)


def test_factor_bytes_and_bound():
    assert factor_build.factor_bytes(10, 6, 3, 1) == 4 * (360 + 60 + 3 + 180)
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(0, 34e12, f64=True) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)


# --- trace arithmetic ------------------------------------------------------

def _ev(name, s, e, kind="kernel"):
    return Event(name, s, e, kind)


def test_union_counts_overlaps_once():
    evs = [_ev("a", 0, 100), _ev("b", 50, 150), _ev("c", 200, 300),
           _ev("d", 210, 220)]
    assert union_s(evs) == pytest.approx(250e-9)


def test_idle_share_sees_a_stall():
    from benchmark.metrics import device_idle_pct
    from benchmark.trace import TracedRun

    evs = [_ev("a", 0, 500_000_000), _ev("b", 400_000_000, 600_000_000)]
    run_ = TracedRun(evs, 1.0, 2, {}, "exponential_sphere")
    assert device_idle_pct.read(run_) == pytest.approx(40.0)
    stalled = TracedRun(evs, 2.0, 2, {}, "exponential_sphere")
    assert device_idle_pct.read(stalled) == pytest.approx(70.0)


def test_rate_counts_the_whole_window(monkeypatch):
    """A stall inside the window lowers chain_iters_per_s: the rate is
    all chain-iterations over the wall time of whole run() calls."""
    import time as _time

    spec = tiny_spec()
    calls = {"n": 0}
    import nngp_tpu_torch as nt
    real = nt.run

    def slow(mc, **kw):
        calls["n"] += 1
        if calls["n"] == 2:             # the window's first call
            _time.sleep(1.5)
        return real(mc, **kw)

    monkeypatch.setattr(nt, "run", slow)
    out = run.run_cell(spec, 7, 0.2, False, device="cpu")
    rate = out["metrics"]["chain_iters_per_s"]["value"]
    assert out["attempted"] % (4 * 4) == 0          # whole cycles
    monkeypatch.setattr(nt, "run", real)
    calls["n"] = 0
    fast = run.run_cell(spec, 7, 0.2, False, device="cpu")
    assert rate < fast["metrics"]["chain_iters_per_s"]["value"] / 2


def test_mean_call_and_breakdown():
    evs = [_ev("void chromatic_sweeps_kernel(Inputs)", 0, 10),
           _ev("chromatic_sweeps_kernel", 20, 50),
           _ev("Memcpy HtoD", 60, 61, "memcpy")]
    assert mean_call_s(evs, "chromatic_sweeps_kernel") == pytest.approx(20e-9)
    assert mean_call_s(evs, "factor_build_kernel") is None
    b = breakdown(evs)
    assert b["device_ops"][0] == ["chromatic_sweeps_kernel", 40e-9]
    assert b["idle_gaps"][0][1] == pytest.approx(10e-9)
    assert len(b["idle_gaps"]) == 2


def test_readers_return_nothing_without_their_kernel():
    from benchmark.trace import TracedRun

    empty = TracedRun([], 1.0, 4, {}, "exponential_sphere")
    for m in registry.benchmark()["per_layer"]:
        if m["source"] == "device_trace":
            assert registry.reader(m["name"])(empty) is None


# --- discovery by name ---------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_cells_found_by_name(cell):
    spec = registry.cell(registry.benchmark(), cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["check"] == {"limits": spec["check"]["limits"]}
    assert set(spec["check"]["limits"]) == {"init_gap", "state_gap",
                                            "decision_margin", "adapt_gap"}
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    assert spec["per_layer"]


def test_every_metric_has_a_reader_and_unknown_cells_fail():
    bench = registry.benchmark()
    for m in bench["per_layer"]:
        assert callable(registry.reader(m["name"]))
    with pytest.raises(KeyError):
        registry.cell(bench, "no_such_cell")


def test_benchmark_json_keys():
    bench = registry.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]


# --- no card, no run; no JAX -------------------------------------------------

def test_measuring_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_harness_loads_no_jax():
    """A whole tiny run in a fresh process, then the guard's look at
    sys.modules by whole top-level names."""
    code = (
        "import sys, json\n"
        "from benchmark import run\n"
        "from benchmark.tests.test_bench_harness import tiny_spec\n"
        "out = run.run_cell(tiny_spec(), 3, 0.1, True, device='cpu')\n"
        "tops = {k.split('.')[0] for k in sys.modules}\n"
        "print(json.dumps({'ok': out is not None, 'tops': sorted(tops)}))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["ok"]
    assert not {"jax", "jaxlib", "flax", "nngp_tpu"} & set(got["tops"])
    assert "nngp_tpu_torch" in got["tops"]


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "nngp_tpu_torch_extra", object())
    assert run.leaked_modules() == []
    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.leaked_modules() == ["jax"]


def test_reference_imports_nothing_of_the_sampler():
    ref = os.path.join(registry.HERE, "reference")
    for fn in os.listdir(ref):
        if not fn.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, fn)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for nm in names:
                assert nm.split(".")[0] not in ("nngp_tpu_torch", "nngp_tpu",
                                                "jax", "jaxlib", "flax"), fn


# --- the reference ---------------------------------------------------------

def test_reference_bessel_matches_scipy():
    from scipy.special import kv as sp_kv

    from benchmark.reference.bessel import kv

    nu = np.linspace(0.51, 0.99, 7)[:, None]
    x = np.geomspace(1e-3, 30, 50)[None]
    got = kv(torch.tensor(nu), torch.tensor(x)).numpy()
    assert np.allclose(got, sp_kv(nu, x), rtol=1e-9, atol=0)


def test_reference_philox_known_answer():
    """Random123's known answers for Philox4x32-10."""
    from benchmark.reference.philox import philox4x32_10

    c = torch.tensor([[0, 0, 0, 0]], dtype=torch.int64)
    assert philox4x32_10(c, 0, 0).tolist() == [[0x6627E8D5, 0xE169C58D,
                                               0xBC57AC4C, 0x9B00DBD8]]
    f = 0xFFFFFFFF
    c = torch.tensor([[f, f, f, f]], dtype=torch.int64)
    assert philox4x32_10(c, f, f).tolist() == [[0x408F276D, 0x41C83B0E,
                                               0xA20BC7C6, 0x6D5451FD]]


@pytest.mark.parametrize("config", CONFIGS)
def test_tiny_run_is_correct_and_its_control_is_not(config):
    spec = tiny_spec(config=config)
    out = run.run_cell(spec, 2**31 + 7, 0.1, False, device="cpu",
                       control=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    assert set(out["checks"]) == {"setup_mismatch"} | set(
        spec["check"]["limits"])
    ctrl = out["control"]
    assert ctrl["correct"] is False, ctrl
    lim = spec["check"]["limits"]
    assert ctrl["correct"] == all(ctrl[k] <= lim[k] for k in lim)
    assert ctrl["always_accept"]["decision_margin"] > lim["decision_margin"]


def _patched_cycle(monkeypatch, iteration=None, alter=None):
    import nngp_tpu_torch.api as api
    from nngp_tpu_torch.models import gaussian

    real = gaussian.run_cycle

    def cycle(*a, **kw):
        if iteration is not None:
            kw["iteration"] = iteration
        state, recs = real(*a, **kw)
        if alter is not None:
            alter(recs)
        return state, recs

    monkeypatch.setattr(api, "run_cycle", cycle)


def _unchanged(graph, data, cfg, carry, it, start, draws):
    return carry


def _half_batch(graph, data, cfg, carry, it, start, draws):
    """The iteration on the first half of the chains; the rest keep their
    state."""
    from nngp_tpu_torch.models.gaussian import gibbs_iteration

    new = gibbs_iteration(graph, data, cfg, carry, it, start, draws)
    h = carry[0].field.shape[0] // 2
    old, st = carry[0], new[0]
    kept = {f.name: (None if getattr(st, f.name) is None else torch.cat(
        [getattr(st, f.name)[:h], getattr(old, f.name)[h:]]))
        for f in dataclasses.fields(st)}
    return (dataclasses.replace(st, **kept),) + tuple(new[1:])


def _altered(recs):
    recs["log_scale"][0, 0] += 0.05


def _patched_accept(monkeypatch, fault):
    """Every (log_scale, shape) MH decision accepted (within the support),
    or each taken the other way."""
    from nngp_tpu_torch.models import gaussian

    real = gaussian._accept

    def accept(cfg, data, state, linv, proposal, new_linv, ratio, u, **kw):
        if fault == "always_accept":
            u = u * 1e-30
        else:
            ratio = 2.0 * torch.log(u) - ratio
        return real(cfg, data, state, linv, proposal, new_linv, ratio, u,
                    **kw)

    monkeypatch.setattr(gaussian, "_accept", accept)


def _patched_adapt(monkeypatch):
    """The step-size adaptation moving by twice its step."""
    from nngp_tpu_torch.models import gaussian

    real = gaussian._adapt
    monkeypatch.setattr(gaussian, "_adapt", lambda tk, acc, z, on, step, w,
                        am: real(tk, acc, z, on, 2.0 * step, w, am))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "always_accept", "flipped", "adaptation"])
def test_planted_fault_is_not_correct(monkeypatch, fault):
    spec = tiny_spec()
    if fault == "altered":
        _patched_cycle(monkeypatch, alter=_altered)
    elif fault in ("always_accept", "flipped"):
        _patched_accept(monkeypatch, fault)
    elif fault == "adaptation":
        _patched_adapt(monkeypatch)
        spec = tiny_spec(T=25)      # a cycle that reaches an adaptation
    else:
        _patched_cycle(monkeypatch, iteration={
            "unchanged": _unchanged, "half_batch": _half_batch}[fault])
    out = run.run_cell(spec, 11, 0.1, False, device="cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.gpu
def test_tiny_run_on_the_card():
    """The harness's card path at a tiny size: the kernels, the profiler's
    device trace and the per-layer readers (run on the chip)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run.run_cell(tiny_spec(), 13, 0.5, True, device="cuda")
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert "chromatic_sweep_roofline" in out["metrics"]
    assert "launches_per_iter" in out["metrics"]
