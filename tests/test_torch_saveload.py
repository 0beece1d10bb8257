"""save/load and resume across both packages, and run's per-cycle outputs
(save_name, log_jsonl, plot_trace).

A fit file is nngp_tpu.save's pickle, key for key; the port reads and
writes it without importing jax (nngp_tpu_torch/interop.py).  States and
records come back bit for bit; a port fit resumed from its file follows
the uninterrupted run bit for bit on the CPU (the cycle's random stream is
a function of (seed, first iteration)).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import nngp_tpu
import nngp_tpu_torch
from nngp_tpu_torch import api as tapi

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE_FIELDS = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
                "field", "tk_ancillary", "tk_sufficient", "prop_mean",
                "prop_m2", "prop_count")
RUN = dict(n_iterations_update=10, verbose=False, field_thinning=0.5,
           Gelman_Rubin_Brooks_stop=(0.0, 0.0))


def _data(seed=1, n=150):
    rng = np.random.default_rng(seed)
    locs = rng.uniform(size=(n, 2))
    locs = np.concatenate([locs, locs[:10]])        # repeated sites
    X = {"a": rng.normal(size=len(locs))}
    y = rng.normal(size=len(locs)) + locs[:, 0] + X["a"]
    return locs, y, dict(X_locs=X, m=4, n_chains=2, seed=seed,
                         stationary_covfun="exponential_isotropic")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_fit(a, b):
    """States, records, NNarray, observation maps and colours equal."""
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(_np(getattr(a.states, f)),
                                      _np(getattr(b.states, f)), err_msg=f)
    assert a.iterations == b.iterations
    for ra, rb in zip(a.records, b.records):
        assert ra.keys() == rb.keys()
        for k, v in rb.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(ra[k], v, err_msg=k)
            else:
                assert ra[k] == v, k
    np.testing.assert_array_equal(a.NNarray, b.NNarray)
    for name in ("locs_match", "hctam_scol_1", "obs_per_loc"):
        np.testing.assert_array_equal(_np(getattr(a.graph, name)),
                                      _np(getattr(b.graph, name)))
    assert a.field_record_columns == b.field_record_columns


def _colours(graph):
    """Sites by colour, from either package's graph."""
    if hasattr(graph, "colors_idx"):
        idx = np.asarray(graph.colors_idx)
        return [row[row < graph.n].tolist() for row in idx]
    ptr, sites = _np(graph.color_ptr), _np(graph.color_sites)
    return [sites[ptr[c]:ptr[c + 1]].tolist() for c in range(len(ptr) - 1)]


def test_resume_bit_identical(tmp_path):
    locs, y, kw = _data()
    whole = nngp_tpu_torch.initialize(locs, y, device="cpu", verbose=False,
                                      **kw)
    whole = nngp_tpu_torch.run(whole, n_cycles=2, **RUN)
    half = nngp_tpu_torch.initialize(locs, y, device="cpu", verbose=False,
                                     **kw)
    half = nngp_tpu_torch.run(half, n_cycles=1, **RUN)
    path = os.path.join(tmp_path, "fit.pkl")
    nngp_tpu_torch.save(half, path)
    loaded = nngp_tpu_torch.load(path, device="cpu")
    _assert_same_fit(loaded, half)
    assert _colours(loaded.graph) == _colours(half.graph)
    resumed = nngp_tpu_torch.run(loaded, n_cycles=1, **RUN)
    assert resumed.iterations == whole.iterations == 20
    for f in STATE_FIELDS:
        assert torch.equal(getattr(resumed.states, f),
                           getattr(whole.states, f)), f
    for ra, rb in zip(resumed.records, whole.records):
        for k in ("beta_0", "beta", "log_scale", "shape", "field",
                  "saved_field"):
            np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)


def test_jax_save_port_load(tmp_path):
    locs, y, kw = _data(seed=2)
    ref = nngp_tpu.run(nngp_tpu.initialize(locs, y, **kw), n_cycles=1, **RUN)
    path = os.path.join(tmp_path, "fit.pkl")
    nngp_tpu.save(ref, path)
    mc = nngp_tpu_torch.load(path, device="cpu")
    _assert_same_fit(mc, ref)
    assert _colours(mc.graph) == _colours(ref.graph)
    assert mc.design.names == ref.design.names
    mc = nngp_tpu_torch.run(mc, n_cycles=1, **RUN)
    assert mc.iterations == 20
    assert np.isfinite(mc.states.field.numpy()).all()
    assert len(mc.diagnostics["Gelman_Rubin_Brooks"]) == 2


def test_port_save_jax_load(tmp_path):
    locs, y, kw = _data(seed=3)
    mc = nngp_tpu_torch.initialize(locs, y, device="cpu", verbose=False,
                                   **{**kw, "stationary_covfun":
                                      "matern_isotropic"})
    mc = nngp_tpu_torch.run(mc, n_cycles=1, **RUN)
    path = os.path.join(tmp_path, "fit.pkl")
    nngp_tpu_torch.save(mc, path)
    ref = nngp_tpu.load(path)
    assert type(ref.states).__module__ == "nngp_tpu.models.gaussian"
    assert type(ref.design).__module__ == "nngp_tpu.preprocess.design"
    _assert_same_fit(ref, mc)
    assert _colours(ref.graph) == _colours(mc.graph)
    ref = nngp_tpu.run(ref, n_cycles=1, **RUN)
    assert ref.iterations == 20
    assert np.isfinite(np.asarray(ref.states.field)).all()


def test_port_loads_jax_file_without_jax(tmp_path):
    """The port reads nngp_tpu's file in a process where importing jax
    fails, and resumes the fit there."""
    locs, y, kw = _data(seed=4)
    ref = nngp_tpu.run(nngp_tpu.initialize(locs, y, **kw), n_cycles=1, **RUN)
    path = os.path.join(tmp_path, "fit.pkl")
    nngp_tpu.save(ref, path)
    code = f"""
import sys
sys.modules["jax"] = None
import nngp_tpu_torch
mc = nngp_tpu_torch.load({path!r}, device="cpu")
assert mc.iterations == 10, mc.iterations
mc = nngp_tpu_torch.run(mc, n_iterations_update=5, verbose=False)
assert mc.iterations == 15
assert not any(m == "nngp_tpu" or m.startswith(("nngp_tpu.", "jax."))
               for m in sys.modules), sorted(sys.modules)
print("loaded without jax")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "loaded without jax" in out.stdout


def test_field_record_columns_round_trip(tmp_path):
    locs, y, kw = _data(seed=5)
    cols = (3, 17, 41)
    mc = nngp_tpu_torch.initialize(locs, y, device="cpu", verbose=False,
                                   **kw)
    mc = nngp_tpu_torch.run(mc, n_cycles=1, field_record_columns=cols, **RUN)
    path = os.path.join(tmp_path, "fit.pkl")
    nngp_tpu_torch.save(mc, path)
    for loaded in (nngp_tpu_torch.load(path, device="cpu"),
                   nngp_tpu.load(path)):
        assert tuple(loaded.field_record_columns) == cols
        assert loaded.records[0]["field"].shape == (5, len(cols))
        np.testing.assert_array_equal(loaded.records[0]["field_columns"], cols)
    back = nngp_tpu_torch.load(path, device="cpu")
    with pytest.raises(ValueError, match="column-subsampled"):
        nngp_tpu_torch.predict_field(back, locs[:3])
    with pytest.raises(ValueError, match="mid-chain"):
        nngp_tpu_torch.run(back, n_cycles=1, **RUN)
    back = nngp_tpu_torch.run(back, n_cycles=1, field_record_columns=cols,
                              **RUN)
    assert back.records[0]["field"].shape == (10, len(cols))


def test_save_name_and_log_jsonl(tmp_path, monkeypatch):
    """save_name is written after every cycle; log_jsonl gets one line per
    cycle with nngp_tpu's keys."""
    locs, y, kw = _data(seed=6)
    saves = []
    real_save = tapi.save

    def counting_save(mc, path):
        saves.append(mc.iterations)
        real_save(mc, path)

    monkeypatch.setattr(tapi, "save", counting_save)
    fit, log = (os.path.join(tmp_path, f) for f in ("fit.pkl", "log.jsonl"))
    mc = nngp_tpu_torch.initialize(locs, y, device="cpu", verbose=False,
                                   **kw)
    mc = nngp_tpu_torch.run(mc, n_cycles=2, save_name=fit, log_jsonl=log,
                            **RUN)
    assert saves == [10, 20]
    assert nngp_tpu_torch.load(fit, device="cpu").iterations == 20
    lines = [json.loads(line) for line in open(log)]
    assert [e["cycle"] for e in lines] == [1, 2]
    assert [e["iteration"] for e in lines] == [10, 20]

    jlog = os.path.join(tmp_path, "jax.jsonl")
    ref = nngp_tpu.initialize(locs, y, **kw)
    nngp_tpu.run(ref, n_cycles=1, log_jsonl=jlog, **RUN)
    want = json.loads(open(jlog).readline())
    assert lines[0].keys() == want.keys()
    assert lines[0]["R_hat"].keys() == want["R_hat"].keys()


def test_plot_trace_writes_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    locs, y, kw = _data(seed=7)
    out = os.path.join(tmp_path, "plots")
    mc = nngp_tpu_torch.initialize(locs, y, device="cpu", verbose=False,
                                   **kw)
    nngp_tpu_torch.run(mc, n_cycles=1, plot_trace=out, plot_beta=True, **RUN)
    for name in ("trace_covparms.png", "trace_beta.png"):
        with open(os.path.join(out, name), "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_interop_refuses_other_jax_classes(tmp_path):
    """A file naming a jax class is refused with a clear error, without
    importing jax's modules."""
    path = os.path.join(tmp_path, "bad.pkl")
    import pickle

    with open(path, "wb") as f:
        pickle.dump({"x": jax.numpy.zeros(2)}, f)
    with pytest.raises(pickle.UnpicklingError, match="without jax"):
        nngp_tpu_torch.load(path, device="cpu")
