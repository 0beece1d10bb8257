"""The port's examples run to their end on the CPU: vignette_toy, matern_fit
and synthetic_families through main() at tiny counts, one of them under
``python -m`` in a process that must never import jax, and the default
paths, which must not lie under examples/ or experiments/ (the JAX
scripts' records)."""

import json
import os
import subprocess
import sys

import pytest
import torch

import nngp_tpu_torch
from nngp_tpu_torch.examples import (_common, heavy_metals, heavy_metals_96,
                                     heavy_metals_analysis, matern_fit,
                                     synthetic_families, vignette_toy)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = (vignette_toy, heavy_metals, heavy_metals_96,
            heavy_metals_analysis, matern_fit, synthetic_families)


def _tree(*dirs):
    """(path, mtime) of every file under ``dirs``."""
    return {(os.path.join(d, f), os.stat(os.path.join(d, f)).st_mtime_ns)
            for top in dirs if os.path.isdir(top)
            for d, _, files in os.walk(top) for f in files}


@pytest.fixture
def isolated_out(tmp_path, monkeypatch):
    """A fresh working directory under ``tmp_path`` (returned: the --out
    directory); fails the test if the run wrote into it, into examples/,
    experiments/ or the port's default output directory."""
    watched = [os.path.join(ROOT, d) for d in ("examples", "experiments")]
    watched.append(_common.OUT_DIR)
    before = _tree(*watched)
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    yield tmp_path / "out"
    assert _tree(*watched) == before
    assert not os.listdir(cwd)


def short_runs(monkeypatch, cycles=1, iterations=6):
    """Cap every ``nngp_tpu_torch.run`` call of the examples (they call it
    through the package) at ``cycles`` x ``iterations``."""
    run = nngp_tpu_torch.run

    def short(mc, **kw):
        kw["n_cycles"] = min(kw.get("n_cycles", 1), cycles)
        kw["n_iterations_update"] = min(kw.get("n_iterations_update", 200),
                                        iterations)
        return run(mc, **kw)

    monkeypatch.setattr(nngp_tpu_torch, "run", short)


def _check(summary, out, iterations_run):
    assert _common.all_finite(summary), summary
    assert summary["iterations_run"] == iterations_run
    assert summary.get("device", summary.get("backend")) == "cpu"
    assert out.is_dir() and os.listdir(out)


def test_vignette_main(isolated_out, monkeypatch):
    short_runs(monkeypatch)
    s = vignette_toy.main(["--device", "cpu", "--quick", "--out",
                           str(isolated_out)])
    # two runs of the interweaved fit, five cycles of the X_obs control
    _check(s, isolated_out, 2 * 6 + 5 * 6)
    assert s["n_obs"] == 600 and len(s["control_rhat_V1"]) == 5
    assert set(s["covariance"]) == {"scale", "noise_variance", "range"}
    line = json.loads((isolated_out / "vignette_toy.jsonl").read_text())
    assert line["control_rhat_V1"] == s["control_rhat_V1"]


def test_matern_quick(isolated_out):
    s = matern_fit.main(["--device", "cpu", "--quick", "--cycles", "1",
                         "--iters", "6", "--out", str(isolated_out)])
    _check(s, isolated_out, 6)
    assert s["n"] == 400 and s["n_chains"] == 6
    assert "smoothness" in s["posterior"]
    lines = (isolated_out / "matern_fit.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["cycle"] == 1          # the cycle log
    assert json.loads(lines[-1])["summary"]["iterations"] == 6


def test_matern_full_run_keeps_its_assertion(isolated_out):
    """Without --quick a fit that has not converged fails, as in JAX."""
    with pytest.raises(AssertionError, match="did not converge"):
        matern_fit.main(["--device", "cpu", "--n", "200", "--cycles", "1",
                         "--iters", "6", "--out", str(isolated_out)])


def test_families_quick(isolated_out, monkeypatch):
    monkeypatch.setattr(synthetic_families, "QUICK",
                        dict(n=200, n_cycles=1, n_iterations=6))
    s = synthetic_families.main(["--device", "cpu", "--quick", "--out",
                                 str(isolated_out)])
    _check(s, isolated_out, 12)
    assert [e["family"] for e in s["fits"]] == [
        "exponential_scaledim", "exponential_spacetime"]
    for e in s["fits"]:
        assert set(e["ci_covers_truth"]) == {
            "microergodic_scale_over_range1",
            "anisotropy_range1_over_range2", "noise_variance"}
    lines = (isolated_out / "families_fits.jsonl").read_text().splitlines()
    assert [json.loads(l)["label"] for l in lines] == ["scaledim",
                                                       "spacetime"]


# runs the example as `python -m` does (runpy) with every run capped, then
# fails unless the process got through without importing jax
NO_JAX = """
import runpy, sys
import nngp_tpu_torch
run = nngp_tpu_torch.run
def short(mc, **kw):
    kw["n_cycles"], kw["n_iterations_update"] = 1, 6
    return run(mc, **kw)
nngp_tpu_torch.run = short
sys.argv = ["vignette_toy"] + sys.argv[1:]
runpy.run_module("nngp_tpu_torch.examples.vignette_toy", run_name="__main__",
                 alter_sys=True)
assert "jax" not in sys.modules, "an example imported jax"
print("NO_JAX_OK")
"""


def test_python_m_imports_no_jax(tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-c", NO_JAX, "--device", "cpu", "--quick", "--out",
         str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stdout
    assert "=== negative control: X_obs (interweaving disabled) ===" in r.stdout
    assert (out / "vignette_toy.jsonl").exists()


@pytest.mark.parametrize("module", EXAMPLES,
                         ids=[m.__name__.rsplit(".", 1)[1] for m in EXAMPLES])
def test_default_paths_outside_jax_records(module):
    args = vars(module.parse_args(["--device", "cpu"]))
    assert args["out"] == _common.OUT_DIR
    for key in ("out", "log", "save"):
        if args.get(key) is not None:
            path = os.path.abspath(args[key])
            for d in ("examples", "experiments"):
                assert not path.startswith(os.path.join(ROOT, d) + os.sep), \
                    (key, path)


@pytest.mark.parametrize("module", EXAMPLES,
                         ids=[m.__name__.rsplit(".", 1)[1] for m in EXAMPLES])
def test_card_asked_for_without_one_raises(module, isolated_out):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        module.main(["--out", str(isolated_out)])
