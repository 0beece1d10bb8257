"""The port's numeric audits (nngp_tpu_torch/experiments: ratio_audit,
factor_probe, cotransform_probe, op_probe, matern_probe) against the JAX
scripts of experiments/, loaded from their files with no edits, on the CPU.

Both sides run on ``synthetic_heavy_metals(n=400)`` (each package's
``load_heavy_metals`` patched to return it) and write their records under
``tmp_path``.  Tolerances:

- every float64-oracle quantity (the oracle's ratios of each proposal, the
  conditional-variance quantiles, the proposal log-det difference in
  float64, the scale of z) within 1e-9 relative: both sides compute it in
  float64 from the same inputs;
- every float32-error figure finite, and within 10x of JAX's or below 1e-5
  absolute: each side's error of its own float32 path against float64, so
  the two errors agree in size, not in value.
"""

import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import nngp_tpu
import nngp_tpu.utils.datasets
import nngp_tpu_torch.utils.datasets
from nngp_tpu_torch.experiments import (cotransform_probe, factor_probe,
                                        matern_probe, op_probe, ratio_audit)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXPERIMENTS = ROOT / "experiments"
N_SITES = 400
ORACLE_RTOL = 1e-9
ERR_FACTOR, ERR_ATOL = 10.0, 1e-5
F32_RTOL = 1e-6


def load_script(name):
    """experiments/<name>.py as a module.  On import some scripts create a
    cache folder and set jax's compilation cache directory: the folder is
    not created, and the setting is restored."""
    spec = importlib.util.spec_from_file_location(
        f"experiments_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    before = jax.config.jax_compilation_cache_dir
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "makedirs", lambda *a, **k: None)
        try:
            spec.loader.exec_module(mod)
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
    return mod


@pytest.fixture
def small_hm(monkeypatch, tmp_path):
    """Both packages' Heavy-metals loaders return the 400-site synthetic
    workload; the working directory is ``tmp_path`` with an experiments/
    folder, where the JAX scripts write their records."""
    data = nngp_tpu_torch.utils.datasets.synthetic_heavy_metals(n=N_SITES)
    ref = nngp_tpu.utils.datasets.synthetic_heavy_metals(n=N_SITES)
    np.testing.assert_array_equal(data[0], ref[0])
    np.testing.assert_array_equal(data[1], ref[1])
    monkeypatch.setattr(nngp_tpu.utils.datasets, "load_heavy_metals",
                        lambda *a, **k: ref)
    monkeypatch.setattr(nngp_tpu_torch.utils.datasets, "load_heavy_metals",
                        lambda *a, **k: data)
    (tmp_path / "experiments").mkdir()
    monkeypatch.chdir(tmp_path)
    return tmp_path


def run_jax(name, tmp_path):
    """The JAX script's main() on the CPU; its record."""
    load_script(name).main()
    return json.loads((tmp_path / "experiments" / f"{name}_cpu.json")
                      .read_text())


def run_port(module, tmp_path, *extra):
    rec = module.main(["--device", "cpu", "--out",
                       str(tmp_path / f"port_{module.__name__}.json")]
                      + list(extra))
    assert json.loads((tmp_path / f"port_{module.__name__}.json")
                      .read_text()) == json.loads(json.dumps(rec))
    return rec


def leaves(obj, path=()):
    """(path, number) of every number in a nested record."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from leaves(v, path + (k,))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from leaves(v, path + (i,))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield path, obj


def assert_oracle_close(port, ref, where):
    assert math.isclose(port, ref, rel_tol=ORACLE_RTOL, abs_tol=0.0), \
        (where, port, ref)


def assert_errors_alike(port, ref, where=()):
    """Every number of the float32-error record ``port`` finite, and within
    ERR_FACTOR of the same number of ``ref`` or below ERR_ATOL."""
    got = dict(leaves(port))
    want = dict(leaves(ref))
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for path, v in got.items():
        assert math.isfinite(v), (where, path, v)
        assert abs(v) <= max(ERR_FACTOR * abs(want[path]), ERR_ATOL), \
            (where, path, v, want[path])


def error_part(rec, drop=()):
    """The record's entries other than ``drop`` and its labels (strings)."""
    return {k: v for k, v in rec.items()
            if k not in drop and not isinstance(v, str)}


def trace_locals(func, code_name, names):
    """Run ``func()`` and collect the values that the locals ``names`` hold
    in the frame running the code object ``code_name`` each time the last
    of them is bound anew: the per-proposal values of a loop that keeps
    them only in locals."""
    seen = []

    def local(frame, event, arg):
        v = frame.f_locals.get(names[-1])
        if v is not None and (not seen or v is not seen[-1][-1]):
            seen.append(tuple(frame.f_locals[nm] for nm in names))
        return local

    def calls(frame, event, arg):
        return local if frame.f_code.co_name == code_name else None

    sys.settrace(calls)
    try:
        func()
    finally:
        sys.settrace(None)
    return seen


def test_factor_probe_matches_jax(small_hm):
    ref = run_jax("factor_probe", small_hm)
    port = run_port(factor_probe, small_hm)
    assert port["n"] == ref["n"] == N_SITES and port["rho"] == ref["rho"]
    qs = [k for k in ref if k.startswith("d_quantiles_")]
    assert len(qs) == 2
    for k in qs:
        for q, v in ref[k].items():
            assert_oracle_close(port[k][q], v, (k, q))
    drop = qs + ["n", "rho"]
    assert_errors_alike(error_part(port, drop), error_part(ref, drop))


def test_cotransform_probe_matches_jax(small_hm):
    ref = run_jax("cotransform_probe", small_hm)
    port = run_port(cotransform_probe, small_hm)
    assert port["exp_op"] == "torch.exp"
    assert_errors_alike(error_part(port), error_part(ref))


def test_op_probe_matches_jax(small_hm):
    ref = run_jax("op_probe", small_hm)
    port = run_port(op_probe, small_hm)
    assert "sum64" in port["sum_op"]
    # z's scale and its cancellation are float64 sums over each side's own
    # float32 factors, which differ by float32 rounding (exp_acc against
    # torch.exp): they agree to a float32 ulp's share, 1e-6 relative, not
    # to 1e-9 (2e-8 apart at n = 400)
    for key, q in (("z_scale", "rms"), ("z_cancellation", "q99"),
                   ("z_cancellation", "max")):
        assert math.isclose(port[key][q], ref[key][q], rel_tol=F32_RTOL), \
            (key, q, port[key][q], ref[key][q])
    drop = ("z_scale", "z_cancellation")
    assert_errors_alike(error_part(port, drop), error_part(ref, drop))


def test_ratio_audit_matches_jax(small_hm, monkeypatch):
    n_prop = 4
    out = small_hm / "experiments" / "ratio_audit_cpu.json"
    monkeypatch.setattr(sys, "argv", ["ratio_audit.py", "--n-proposals",
                                      str(n_prop), "--out", str(out)])
    script = load_script("ratio_audit")
    oracle = trace_locals(script.main, "main", ("llr64", "gpr64"))
    ref = json.loads(out.read_text())
    port = run_port(ratio_audit, small_hm, "--n-proposals", str(n_prop))
    assert port["n"] == N_SITES and "sum64" in port["sum_op"]
    assert len(oracle) == n_prop
    for i, (llr64, gpr64) in enumerate(oracle):
        assert_oracle_close(port["oracle"]["llr64"][i], llr64, ("llr64", i))
        assert_oracle_close(port["oracle"]["gpr64"][i], gpr64, ("gpr64", i))
    assert set(port["errors"]) == set(ref["errors"]) == set(ratio_audit.KEYS)
    for k in ratio_audit.KEYS:
        assert len(port["errors"][k]) == n_prop
        assert all(math.isfinite(v) for v in port["errors"][k])
    assert_errors_alike(port["summary"], ref["summary"], "summary")


def _clustered(rng, n_base=300):
    base = rng.uniform(0, 100, size=(n_base, 2))
    jitter = base[rng.integers(0, n_base, n_base)] + rng.normal(
        size=(n_base, 2)) * 0.05
    return np.concatenate([base, jitter])


@pytest.mark.parametrize("covfun", ["matern_isotropic", "matern_sphere"])
def test_matern_probe_family_matches_jax(covfun):
    """probe_family on both sides on a small clustered layout (lon/lat
    degrees for the sphere), each graph built by its own package from the
    same maxmin order, every figure held against the JAX script as it runs,
    jitted: the factor's log-diagonal errors (``logdiag_err_vs_devK``,
    against the float64 Cholesky of the same float32 K, and
    ``logdiag_err_total``) too, since the port's factor build rounds each
    multiply-subtract once, as XLA's fusion does in nngp_tpu's."""
    from nngp_tpu.preprocess.dedupe import dedupe_and_match as jdedupe
    from nngp_tpu.preprocess.graph import build_graph as jbuild
    from nngp_tpu.preprocess.ordering import reorder_locations as jorder
    from nngp_tpu_torch.preprocess.dedupe import dedupe_and_match
    from nngp_tpu_torch.preprocess.graph import build_graph
    from nngp_tpu_torch.preprocess.ordering import reorder_locations

    locs = _clustered(np.random.default_rng(2))
    lonlat = covfun.endswith("sphere")
    if lonlat:
        locs = locs * [0.2, 0.1] + [-100.0, 35.0]
    jmaps = jdedupe(locs, perm_fn=lambda L: jorder(L, "maxmin", lonlat=lonlat))
    jgraph, jNN = jbuild(jmaps, m=5, covfun=covfun)
    maps = dedupe_and_match(
        locs, perm_fn=lambda L: reorder_locations(L, "maxmin", lonlat=lonlat))
    graph, NN = build_graph(maps, m=5, covfun=covfun)
    np.testing.assert_array_equal(NN, jNN)

    ref, port = {}, {}
    script = load_script("matern_probe")
    script.probe_family(covfun, jgraph, jNN, "x", ref)
    matern_probe.probe_family(covfun, graph, NN, "x", port, device="cpu")
    ref, port = ref["x"], port["x"]
    assert port["n"] == ref["n"] == len(NN) and port["nu"] == ref["nu"]
    assert_oracle_close(port["range"], ref["range"], "range")
    assert_oracle_close(port["proposal_logdet_diff_f64"],
                        ref["proposal_logdet_diff_f64"], "logdet f64")
    for q, v in ref["cond_var_d"].items():
        assert_oracle_close(port["cond_var_d"][q], v, ("cond_var_d", q))
    for thr, entry in ref["ratio_err_concentration"].items():
        assert port["ratio_err_concentration"][thr]["rows"] == entry["rows"]
    keys = ("K_entry_err", "proposal_logdet_diff_err", "logdiag_err_vs_devK",
            "logdiag_err_total")
    assert_errors_alike({k: port[k] for k in keys}, {k: ref[k] for k in keys})


def test_matern_probe_main_layout():
    """main()'s clustered layout is the JAX script's: the same draws from
    seed 2, in its order."""
    rng = np.random.default_rng(2)
    base = rng.uniform(0, 100, size=(20_000, 2))
    jitter = base[rng.integers(0, len(base), 20_000)] + rng.normal(
        size=(20_000, 2)) * 0.05
    np.testing.assert_array_equal(
        matern_probe.clustered_layout(np.random.default_rng(2)),
        np.concatenate([base, jitter]))


AUDITS = (ratio_audit, factor_probe, cotransform_probe, op_probe,
          matern_probe)


@pytest.mark.parametrize("module", AUDITS,
                         ids=[m.__name__.rsplit(".", 1)[1] for m in AUDITS])
def test_card_asked_for_without_one_raises(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        module.main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


@pytest.mark.parametrize("module", AUDITS,
                         ids=[m.__name__.rsplit(".", 1)[1] for m in AUDITS])
def test_default_out_outside_jax_records(module):
    """The default record path lies in the port's git-ignored out/, not in
    experiments/ beside the JAX records."""
    from nngp_tpu_torch.experiments import _common

    path = pathlib.Path(module.parse_args([]).out).resolve()
    assert path.parent == pathlib.Path(_common.OUT_DIR).resolve()
    assert path.name == module.__name__.rsplit(".", 1)[1] + ".json"


NO_JAX = """
import runpy, sys
import numpy as np
import nngp_tpu_torch.utils.datasets as ds
data = ds.synthetic_heavy_metals(n=300)
ds.load_heavy_metals = lambda *a, **k: data
sys.argv = ["op_probe"] + sys.argv[1:]
runpy.run_module("nngp_tpu_torch.experiments.op_probe", run_name="__main__")
assert "jax" not in sys.modules and "nngp_tpu" not in sys.modules
print("NO_JAX_OK")
"""


def test_python_m_imports_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = tmp_path / "op.json"
    r = subprocess.run([sys.executable, "-c", NO_JAX, "--device", "cpu",
                        "--out", str(out)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stdout
    rec = json.loads(out.read_text())
    assert rec["backend"] == "cpu" and math.isfinite(rec["sum_err"])
