"""The port's prediction (nngp_tpu_torch/prediction.py) against nngp_tpu's.

- the joint graph's tables: bit-identical (the same NumPy code);
- conditional draws: the same retained samples and the same normals z,
  drawn with jax from nngp_tpu's keys; atol 1e-4 * max(1, |w|_inf)
  (float32 factor build and level solve; torch.exp against exp_acc);
- the dense-GP oracle of tests/test_predict.py: with m = n_joint - 1 the
  Vecchia conditional simulation is the exact GP conditional, its mean and
  covariance within 1e-3 * max(1, scale);
- predict_fixed_effects: exact (the same NumPy code on the same records).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

import nngp_tpu
import nngp_tpu_torch
from nngp_tpu.prediction import _joint_graph as jax_joint_graph
from nngp_tpu_torch import prediction as P

torch.set_num_threads(1)

RUN = dict(n_cycles=1, verbose=False, field_thinning=0.5,
           Gelman_Rubin_Brooks_stop=(0.0, 0.0))


def _fit(family, seed=4, n=150, iters=20):
    """A short nngp_tpu fit with a location covariate (``iters`` = 0: the
    initialized one), and new sites."""
    rng = np.random.default_rng(seed)
    if "sphere" in family:
        locs = np.stack([rng.uniform(-100, -80, n), rng.uniform(30, 45, n)], 1)
        new = np.stack([rng.uniform(-100, -80, 30), rng.uniform(30, 45, 30)], 1)
    else:
        locs = rng.uniform(size=(n, 2)) * 5
        new = rng.uniform(size=(30, 2)) * 5
    X = {"a": rng.normal(size=n)}
    y = rng.normal(size=n) + 1.0 + X["a"]
    ref = nngp_tpu.initialize(locs, y, X_locs=X, m=4, n_chains=2, seed=seed,
                              stationary_covfun=family)
    if iters:
        ref = nngp_tpu.run(ref, n_iterations_update=iters, **RUN)
    return ref, new


def _port(ref, tmp_path):
    path = os.path.join(tmp_path, "fit.pkl")
    nngp_tpu.save(ref, path)
    return nngp_tpu_torch.load(path, device="cpu")


@pytest.mark.parametrize("family", ["exponential_isotropic", "matern_sphere"])
def test_joint_graph_bit_identical(family):
    ref, new = _fit(family, iters=0)
    want = jax_joint_graph(ref, new, 6)
    got = P._joint_graph(ref, new, 6)
    for name in ("kernel_coords", "nn_dist2", "NNarray", "nn_mask"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert len(got.level_segs) == len(want.level_segs)
    for a, b in zip(got.level_segs, want.level_segs):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (got.covfun, got.d_floor) == (want.covfun, want.d_floor)
    assert got.n == ref.graph.n + len(new)


@pytest.mark.parametrize("family", ["exponential_isotropic", "matern_isotropic"])
def test_conditional_draws_match_jax(family, tmp_path):
    ref, new = _fit(family)
    m = 6
    want = nngp_tpu.predict_field(ref, new, m=m, sample_chunk=64)
    mc = _port(ref, tmp_path)
    g = P._joint_graph(mc, new, m).to("cpu")
    names = list(mc.space_time_model["covfun"]["shape_params"])
    stored = P._stored_idx(mc, 0.5)
    key = jax.random.key(ref.seed + 777)
    for ci, rec in enumerate(mc.records):
        z = jax.random.normal(jax.random.fold_in(key, ci * 100003),
                              (len(stored), len(new)), dtype=jnp.float32)
        got = P.conditional_field(g, names, mc.graph.n,
                                  *P.retained_samples(rec, stored, "cpu"),
                                  torch.tensor(np.asarray(z))).numpy()
        w = want["predicted_field_samples"][ci]
        assert got.shape == w.shape == (len(stored), len(new))
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(w).max()))
    # the public call: same shapes, finite, its own seeded normals
    out = nngp_tpu_torch.predict_field(mc, new, m=m)
    again = nngp_tpu_torch.predict_field(mc, new, m=m)
    for a, b, w in zip(out["predicted_field_samples"],
                       again["predicted_field_samples"],
                       want["predicted_field_samples"]):
        assert a.shape == w.shape and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
    assert out["predicted_field_summary"]["table"].shape == (len(new), 5)


def _matern_corr(d, nu):
    safe = np.maximum(d, 1e-10)
    K = 2.0 ** (1 - nu) / scipy.special.gamma(nu) * safe ** nu \
        * scipy.special.kv(nu, safe)
    return np.where(d <= 1e-10, 1.0, K)


class _FakeMC:
    pass


@pytest.mark.parametrize("family", ["exponential_isotropic", "matern_isotropic"])
def test_conditional_simulation_matches_dense_gp(family, rng):
    """With m = n_joint - 1 the conditional simulation is the exact GP
    conditional (tests/test_predict.py's oracle).  The draw is affine in z,
    so z = 0 gives its mean and z = e_i the columns of its covariance
    factor: mean and covariance are checked exactly, to float32 rounding
    (atol 1e-3 * max(1, scale))."""
    n, n_pred = 25, 8
    locs = rng.uniform(size=(n, 2)) * 4
    pred_locs = rng.uniform(size=(n_pred, 2)) * 4
    names = ["log_range"] + (["qlogis_smoothness"] if "matern" in family
                             else [])
    mc = _FakeMC()
    mc.locs = locs
    mc.space_time_model = {"covfun": {"stationary_covfun": family,
                                      "shape_params": names}}
    g = P._joint_graph(mc, pred_locs, m=n + n_pred - 1).to("cpu")
    rho, s, log_scale, beta_0 = 0.9, 0.0, np.log(2.5), 0.6   # nu = 0.75
    w_obs = rng.normal(size=n).astype(np.float32) + beta_0
    S = n_pred + 1
    full = lambda v: torch.full((S,), v, dtype=torch.float32)  # noqa: E731
    z = torch.cat([torch.zeros(1, n_pred), torch.eye(n_pred)])
    out = P.conditional_field(
        g, names, n,
        torch.tensor([np.log(rho), s][:len(names)]).expand(S, -1),
        full(log_scale), full(beta_0), torch.as_tensor(w_obs).expand(S, -1),
        z).double().numpy()
    mean, factor = out[0], (out[1:] - out[0]).T

    joint = np.concatenate([locs, pred_locs], 0)
    d = np.sqrt(((joint[:, None] - joint[None]) ** 2).sum(-1)) / rho
    K = (_matern_corr(d, 0.75) if "matern" in family else np.exp(-d)) \
        * np.exp(log_scale)
    Koo, Kpo, Kpp = K[:n, :n], K[n:, :n], K[n:, n:]
    mean_ref = Kpo @ np.linalg.solve(Koo, (w_obs - beta_0).astype(np.float64))
    cov_ref = Kpp - Kpo @ np.linalg.solve(Koo, Kpo.T)
    tol = 1e-3 * max(1.0, np.exp(log_scale))
    np.testing.assert_allclose(mean, mean_ref, rtol=0, atol=tol)
    np.testing.assert_allclose(factor @ factor.T, cov_ref, rtol=0, atol=tol)


def test_predict_fixed_effects_exact(tmp_path):
    ref, _ = _fit("exponential_isotropic")
    mc = _port(ref, tmp_path)
    Xp = {"a": np.random.default_rng(2).normal(size=12)}
    for kw in (dict(add_intercept=True), dict(match_field_thinning=False)):
        want = nngp_tpu.predict_fixed_effects(ref, Xp, **kw)
        got = nngp_tpu_torch.predict_fixed_effects(mc, Xp, **kw)
        for a, b in zip(got["predicted_fixed_effects_samples"],
                        want["predicted_fixed_effects_samples"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            got["predicted_fixed_effects_summary"]["table"],
            want["predicted_fixed_effects_summary"]["table"])
    with pytest.raises(ValueError, match="not among fitted effects"):
        nngp_tpu_torch.predict_fixed_effects(mc, {"b": np.ones(3)})


def test_predict_field_refuses_column_records():
    rng = np.random.default_rng(3)
    locs = rng.uniform(size=(80, 2))
    mc = nngp_tpu_torch.initialize(locs, rng.normal(size=80), m=4,
                                   n_chains=2, seed=1, device="cpu",
                                   verbose=False)
    mc = nngp_tpu_torch.run(mc, n_iterations_update=6,
                            field_record_columns=[2, 11], **RUN)
    with pytest.raises(ValueError, match="column-subsampled"):
        nngp_tpu_torch.predict_field(mc, locs[:3])
