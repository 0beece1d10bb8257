"""The statistical goldens of tests/test_statistical_golden.py run through
the port, and one fast comparison of the port's posterior with nngp_tpu's.

Whole chains of the two packages cannot be compared draw for draw (JAX
draws from threefry keys), only in distribution:
1. the interweaving negative control (Vignette.md:1148-1184) and
2. the GRB trajectory band on the vignette toy (Vignette.md:560-...),
   the same toy, seeds and bands as the originals, slow-marked like them;
3. fast: both packages fit the same small toy from the same seed, and the
   port's posterior means (``estimate``) must agree with nngp_tpu's within
   4 times their combined Monte Carlo error.
"""

import numpy as np
import pytest
import torch

import nngp_tpu
import nngp_tpu_torch
from nngp_tpu_torch.diagnostics.ess import effective_size

torch.set_num_threads(1)


def _simulate_vignette(rng, n_obs=900):
    """Vignette.rmd:24-49 scaled down: 1-D exponential GP (scale 10,
    range 5, noise 5) with duplicated sites, spatially coherent regressor
    (the coordinate) + white-noise regressor."""
    locs_1d = rng.uniform(0, 100, int(n_obs * 0.75))
    locs_1d = np.concatenate(
        [locs_1d, rng.choice(locs_1d, n_obs - len(locs_1d))]
    )
    u = np.unique(locs_1d)
    d = np.abs(u[:, None] - u[None, :])
    K = 10.0 * np.exp(-d / 5.0)
    w_u = np.linalg.cholesky(K + 1e-10 * np.eye(len(u))) @ rng.normal(
        size=len(u)
    )
    w = w_u[np.searchsorted(u, locs_1d)]
    X = np.stack([locs_1d, rng.normal(size=n_obs)], axis=1)
    y = 2.0 + w + X @ np.array([0.01, -1.6]) + rng.normal(size=n_obs) * np.sqrt(5.0)
    locs = np.stack([locs_1d, np.zeros(n_obs)], axis=1)
    return locs, y, X


def _init(locs, y, seed, **kw):
    return nngp_tpu_torch.initialize(
        locs, y, m=5, n_chains=3, stationary_covfun="exponential_isotropic",
        seed=seed, device="cpu", verbose=False, **kw)


@pytest.mark.slow
def test_interweaving_negative_control(rng):
    """X_obs (interweaving off) must leave the spatially coherent slope
    with a far worse R-hat than X_locs (interweaving on) at equal budget —
    the reference's deliberate failure demonstration
    (Vignette.md:1131-1184)."""
    locs, y, X = _simulate_vignette(rng)
    budget = dict(n_cycles=1, n_iterations_update=300, verbose=False,
                  Gelman_Rubin_Brooks_stop=(0.0, 0.0))

    mc_locs = nngp_tpu_torch.run(_init(locs, y, 3, X_locs=X), **budget)
    grb_l = mc_locs.diagnostics["Gelman_Rubin_Brooks"][-1]
    rhat_locs = float(grb_l["R_hat"][grb_l["names"].index("V1")])

    mc_obs = nngp_tpu_torch.run(_init(locs, y, 3, X_obs=X), **budget)
    grb_o = mc_obs.diagnostics["Gelman_Rubin_Brooks"][-1]
    rhat_obs = float(grb_o["R_hat"][grb_o["names"].index("V1")])

    # the white-noise regressor is fine either way (control of the control)
    rhat_obs_wn = float(grb_o["R_hat"][grb_o["names"].index("V2")])

    assert rhat_locs < 1.5, f"interweaved slope R-hat {rhat_locs}"
    assert rhat_obs > 3.0, (
        f"X_obs slope R-hat {rhat_obs} — negative control did not fail "
        "(interweaving may be silently active for X_obs columns)"
    )
    assert rhat_obs > 2 * rhat_locs
    assert rhat_obs_wn < 1.5, f"white-noise regressor R-hat {rhat_obs_wn}"


@pytest.mark.slow
def test_grb_trajectory_converges_within_band(rng):
    """GRB trajectory band on the vignette toy at a 5x200 + 6x100 budget:
    the worst univariate R-hat at least halves its excess over 1 from the
    first diagnostic cycle and ends under 1.2, the multivariate under 2,
    and the noise variance's interval covers the truth loosely."""
    locs, y, X = _simulate_vignette(rng)
    mc = _init(locs, y, 4, X_locs=X)
    mc = nngp_tpu_torch.run(mc, n_cycles=5, n_iterations_update=200,
                            Gelman_Rubin_Brooks_stop=(1.10, 1.05),
                            verbose=False)
    mc = nngp_tpu_torch.run(mc, n_cycles=6, n_iterations_update=100,
                            Gelman_Rubin_Brooks_stop=(1.05, 1.03),
                            verbose=False)
    traj = [float(np.max(g["R_hat"][1:]))
            for g in mc.diagnostics["Gelman_Rubin_Brooks"]]
    final_uni = traj[-1]
    final_multi = float(mc.diagnostics["Gelman_Rubin_Brooks"][-1]["R_hat"][0])
    assert final_uni - 1 < 0.5 * (traj[0] - 1) + 1e-6, traj
    assert final_uni < 1.2, traj
    assert final_multi < 2.0, (final_multi, traj)
    est = nngp_tpu_torch.estimate(mc)
    gp = est["covariance_params"]["GpGp_covparams"]
    noise_row = gp["table"][gp["names"].index("noise_variance")]
    assert noise_row[1] < 5.0 < noise_row[3] * 1.5, noise_row


# (record key, column) of each compared parameter -> estimate's row name
COMPARED = {("beta_0", None): "beta_0", ("beta", 0): "V1",
            ("beta", 1): "V2", ("log_scale", None): "log_scale",
            ("log_noise_variance", None): "log_noise_variance",
            ("shape", 0): "log_range"}


def _mc_error(records, key, col, burn_in=0.5):
    """Monte Carlo standard error of the pooled posterior mean: the pooled
    sd over the square root of the ESS summed over chains."""
    T = records[0][key].shape[0]
    lo = max(int(np.floor(burn_in * T)) - 1, 0)
    series = [np.asarray(r[key])[lo:] for r in records]
    if col is not None:
        series = [s[:, col] for s in series]
    ess = sum(effective_size(s) for s in series)
    return float(np.std(np.concatenate(series), ddof=1) / np.sqrt(ess))


def _means(est):
    out = {}
    for block in (est["covariance_params"]["sampled_covparams"],
                  est["fixed_effects"]):
        out.update(zip(block["names"], block["table"][:, 0]))
    return out


def test_posterior_means_match_nngp_tpu():
    """Both packages fit a 300-observation vignette toy (X_locs, 3 chains,
    seed 3, 600 iterations, burn-in 0.5).  For every fixed effect and
    covariance parameter, |mean_port - mean_nngp_tpu| <= 4 * sqrt(se_port^2
    + se_nngp_tpu^2), se the Monte Carlo error of each mean (pooled sd /
    sqrt(ESS summed over chains))."""
    locs, y, X = _simulate_vignette(np.random.default_rng(2024), n_obs=300)
    run = dict(n_cycles=1, n_iterations_update=600, verbose=False,
               field_thinning=0.1, Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    port = nngp_tpu_torch.run(_init(locs, y, 3, X_locs=X), **run)
    ref = nngp_tpu.run(nngp_tpu.initialize(
        locs, y, X_locs=X, m=5, n_chains=3,
        stationary_covfun="exponential_isotropic", seed=3), **run)
    got, want = _means(nngp_tpu_torch.estimate(port)), _means(
        nngp_tpu.estimate(ref))
    for (key, col), name in COMPARED.items():
        se = np.hypot(_mc_error(port.records, key, col),
                      _mc_error(ref.records, key, col))
        assert abs(got[name] - want[name]) <= 4 * se, (
            name, got[name], want[name], se)
