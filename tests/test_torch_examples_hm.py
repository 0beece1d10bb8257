"""The port's Heavy-metals examples run to their end on the CPU:
heavy_metals with --quick at one short cycle, heavy_metals_analysis on the
fit it saved (2 deg grid, with and without --figures), heavy_metals_96 at
96 chains on the first 1,500 synthetic sites."""

import builtins
import json
import os

import numpy as np
import pytest
import torch

from nngp_tpu_torch.examples import (_common, heavy_metals, heavy_metals_96,
                                     heavy_metals_analysis)
from nngp_tpu_torch.utils.datasets import synthetic_heavy_metals
from test_torch_examples_run import isolated_out  # noqa: F401 (fixture)

torch.set_num_threads(1)


@pytest.fixture
def fit(isolated_out):  # noqa: F811
    """heavy_metals --quick (8,000 sites), 1 cycle x 6 iterations, saved."""
    path = str(isolated_out.parent / "hm_fit.pkl")
    s = heavy_metals.main(["--device", "cpu", "--quick", "--cycles", "1",
                           "--iters", "6", "--save", path, "--out",
                           str(isolated_out)])
    return s, path, isolated_out


def test_heavy_metals_quick(fit):
    s, path, out = fit
    assert _common.all_finite(s) and s["iterations_run"] == 6
    assert s["n_obs"] == 8000 and s["n_chains"] == 3 and s["device"] == "cpu"
    assert set(s["covariance_km"]) == {"scale", "noise_variance", "range"}
    assert os.path.exists(path)
    assert json.loads((out / "heavy_metals.jsonl").read_text()) == \
        json.loads(json.dumps(s))


def test_analysis_on_saved_fit(fit):
    _, path, out = fit
    s = heavy_metals_analysis.main([path, "2", "--device", "cpu", "--out",
                                    str(out)])
    assert _common.all_finite(s) and s["iterations_run"] == 0
    assert s["pollution_surfaces"] == []        # the synthetic data has none
    z = np.load(out / "heavy_metals_analysis.npz")
    assert z["prediction_table"].shape == (s["grid_sites"], 5)
    assert z["grid_sites"].shape == (s["grid_sites"], 2)
    assert np.isfinite(z["prediction_table"]).all()
    assert z["grb_rhat"].shape == (1, len(z["grb_names"]))
    assert not list(out.glob("*.png"))          # no figures unless asked


def test_analysis_figures(fit):
    _, path, out = fit
    pytest.importorskip("matplotlib")
    heavy_metals_analysis.main([path, "4", "--device", "cpu", "--figures",
                                "--out", str(out)])
    assert {p.name for p in out.glob("*.png")} == {
        "hm_grb_trajectories.png", "hm_prediction_mean.png",
        "hm_prediction_sd.png"}


def test_analysis_figures_without_matplotlib(fit, monkeypatch):
    _, path, out = fit
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="--figures needs matplotlib"):
        heavy_metals_analysis.main([path, "4", "--device", "cpu",
                                    "--figures", "--out", str(out)])


def test_heavy_metals_96(isolated_out, monkeypatch):  # noqa: F811
    locs, y, X = synthetic_heavy_metals()
    k = 1500
    monkeypatch.setattr(heavy_metals_96, "load_heavy_metals", lambda: (
        locs[:k], y[:k], {n: v[:k] for n, v in X.items()}))
    s = heavy_metals_96.main(["--device", "cpu", "--cycles", "1", "--iters",
                              "4", "--out", str(isolated_out)])
    assert _common.all_finite(s) and s["iterations_run"] == 4
    assert s["n_chains"] == 96 and s["n_sites"] == k
    assert s["log"] == os.path.join(str(isolated_out),
                                    heavy_metals_96.LOG_NAME)
    cycle = json.loads((isolated_out / heavy_metals_96.LOG_NAME).read_text())
    assert cycle["cycle"] == 1 and cycle["iteration"] == 4
