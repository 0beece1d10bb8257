"""Posterior summaries in three parametrizations.

Parity with mcmc_nngp_estimate (Scripts/mcmc_nngp_estimate.R): summaries
(mean, q0.025, median, q0.975, sd) of covariance parameters on the sampled
(log/logit) scale, the GpGp natural scale, and the INLA scale; de-centered
fixed effects with a significance flag; latent-field summaries with beta_0
subtracted sample-wise.
"""

from __future__ import annotations

import numpy as np


def get_summary(samples: np.ndarray, names=None) -> dict:
    """mean/q0.025/median/q0.975/sd per column (mcmc_nngp_estimate.R:1-6)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    out = np.stack(
        [
            samples.mean(axis=0),
            np.quantile(samples, 0.025, axis=0),
            np.quantile(samples, 0.5, axis=0),
            np.quantile(samples, 0.975, axis=0),
            samples.std(axis=0, ddof=1),
        ],
        axis=1,
    )
    return {
        "names": list(names) if names is not None else None,
        "columns": ["mean", "q0.025", "median", "q0.975", "sd"],
        "table": out,
    }


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def mcmc_nngp_estimate(mc, burn_in: float = 0.5):
    """mcmc_nngp_estimate.R:9-96."""
    T = mc.iterations
    lo = max(int(np.floor(burn_in * T)) - 1, 0)
    covfun = mc.space_time_model["covfun"]["stationary_covfun"]
    shape_names = mc.space_time_model["covfun"]["shape_params"]
    res = {"covariance_params": {}}

    # ---- covariance parameters (ref :17-65) ----
    cov_names = ["log_scale", "log_noise_variance"] + list(shape_names)
    blocks = []
    for rec in mc.records:
        mat = np.concatenate(
            [
                rec["log_scale"][lo:T, None],
                rec["log_noise_variance"][lo:T, None],
                rec["shape"][lo:T],
            ],
            axis=1,
        )
        blocks.append(mat)
    samples = np.concatenate(blocks, axis=0)
    res["covariance_params"]["sampled_covparams"] = get_summary(samples, cov_names)

    # GpGp parametrization: exp for log_*, 1.5*sigmoid for qlogis_* (ref :37-46)
    gp = samples.copy()
    gp_names = []
    for j, nm in enumerate(cov_names):
        if nm.startswith("log_"):
            gp[:, j] = np.exp(gp[:, j])
            gp_names.append(nm[4:])
        elif nm.startswith("qlogis_"):
            gp[:, j] = 1.5 * _sigmoid(gp[:, j])
            gp_names.append(nm[7:])
        else:
            gp_names.append(nm)
    res["covariance_params"]["GpGp_covparams"] = get_summary(gp, gp_names)

    # INLA parametrization (ref :49-65)
    inla = gp.copy()
    inla_names = list(gp_names)
    range_cols = [j for j, nm in enumerate(inla_names) if "range" in nm]
    smooth_cols = [j for j, nm in enumerate(inla_names) if "smoothness" in nm]
    if "exponential" in covfun:
        for j in range_cols:
            inla[:, j] = inla[:, j] * 2.0
    if "matern" in covfun and smooth_cols:
        s = inla[:, smooth_cols[0]]
        for j in range_cols:
            inla[:, j] = inla[:, j] * np.sqrt(8.0 * s)
        keep = [j for j in range(inla.shape[1]) if j not in smooth_cols]
        inla = inla[:, keep]
        inla_names = [inla_names[j] for j in keep]
    for j, nm in enumerate(inla_names):
        if "noise" in nm:
            inla[:, j] = 1.0 / inla[:, j]
            inla_names[j] = "precision_of_Gaussian_obs"
        elif "scale" in nm:
            inla[:, j] = np.sqrt(inla[:, j])
            inla_names[j] = "sd_for_spatial"
    res["covariance_params"]["INLA_covparams"] = get_summary(inla, inla_names)

    # ---- fixed effects (ref :71-81) ----
    beta_blocks = []
    for rec in mc.records:
        b0 = rec["beta_0"][lo:T, None]
        if rec["beta"] is not None and rec["beta"].shape[1] > 0:
            b = rec["beta"][lo:T]
            # de-center the intercept through the stored column means (:76)
            b0 = b0 - b @ mc.design.X_mean[:, None]
            mat = np.concatenate([b0, b], axis=1)
        else:
            mat = b0
        beta_blocks.append(mat)
    beta_samples = np.concatenate(beta_blocks, axis=0)
    beta_names = ["beta_0"] + (list(mc.design.names) if mc.design.p else [])
    fe = get_summary(beta_samples, beta_names)
    tab = fe["table"]
    fe["zero_out_of_ci"] = (np.sign(tab[:, 1]) * np.sign(tab[:, 3])) > 0
    res["fixed_effects"] = fe

    # ---- latent field (ref :88-94), beta_0 subtracted sample-wise ----
    field_blocks = []
    for rec in mc.records:
        sf = rec["saved_field"]
        keep = sf > T * burn_in
        f = rec["field"][keep]
        b0 = rec["beta_0"][sf[keep] - 1]
        field_blocks.append(f - b0[:, None])
    field_samples = np.concatenate(field_blocks, axis=0)
    # lean records (run(field_record_columns=...)) hold only a column subset
    # of each field snapshot: label the summary rows by their global site
    # index so they cannot be mistaken for the full field
    field_cols = getattr(mc, "field_record_columns", None)
    if field_cols is not None:
        import warnings

        warnings.warn(
            "records are column-subsampled (run(field_record_columns=...)): "
            f"the field summary covers {len(field_cols)} of "
            f"{mc.graph.n} sites, labeled by site index",
            stacklevel=2,
        )
        res["field"] = get_summary(
            field_samples, names=[f"site_{c}" for c in field_cols]
        )
        res["field"]["site_columns"] = np.asarray(field_cols, dtype=np.int64)
    else:
        res["field"] = get_summary(field_samples)
    return res
