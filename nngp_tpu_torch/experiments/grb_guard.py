"""The GRB spectral-floor guard against the reference's exact MPSRF
semantics on identical inputs (port of experiments/grb_guard.py; the same
record keys).

    python -m nngp_tpu_torch.experiments.grb_guard [--device cpu]

The reference computes (Scripts/mcmc_nngp_diagnose.R:18)

    MPSRF = (n-1)/n + (m+1)/m * svd(solve(W, tol=rcond(W)) %*% B)$d[1]

R's ``solve(a, b, tol=...)`` uses ``tol`` only to decide when to raise
"system is computationally singular"; ``tol = rcond(W)`` switches that off
and leaves a plain LAPACK inverse, so a near-singular W blows the MPSRF up
by 1/eps along its near-null directions.  ``diagnostics/grb.py`` floors
W's eigenvalues at 1e-8 of its largest before inverting.  Three cases on
AR(1) chains (host float64 NumPy; the device is only recorded):

  A. well-conditioned records: both agree to ~1e-10 (floor inactive);
  B. a near-collinear parameter pair (kappa(W) up to ~1e13): the
     reference's MPSRF grows as 1/eps^2, the floored one stays finite;
  C. 3 stationary chains, p > m - 1 parameters: B has rank 2, and the
     MPSRF sits above 1 while every univariate PSRF is ~1.

``principal_direction`` (the eigenvector of W^-1 B carrying lambda_max,
loadings scaled by within-chain sd) serves ``hm_mpsrf``.
"""

from __future__ import annotations

import json

import numpy as np

from nngp_tpu_torch.diagnostics.grb import Gelman_Rubin_Brooks
from nngp_tpu_torch.experiments import _common


def mpsrf_reference(chains):
    """Exact R semantics: plain solve (no regularization), top singular
    value.  chains: list of [T, p] arrays (post burn-in slices, as
    diagnose.R:4-9).  Returns (MPSRF, W, B)."""
    m = len(chains)
    n = chains[0].shape[0]
    W = sum(np.cov(c.T) for c in chains) / m
    means = np.stack([c.mean(axis=0) for c in chains], axis=1)
    B = np.cov(means)
    lam = np.linalg.svd(np.linalg.solve(W, B), compute_uv=False)[0]
    return (n - 1) / n + (m + 1) / m * lam, W, B


def principal_direction(chains, names=None):
    """Eigen-direction of W^-1 B carrying lambda_max (eig of solve(W) @ B,
    an unsymmetric problem), each parameter's loading scaled by its
    within-chain sd and normalised to the largest, ordered by size."""
    m = len(chains)
    W = sum(np.cov(c.T) for c in chains) / m
    means = np.stack([c.mean(axis=0) for c in chains], axis=1)
    B = np.cov(means)
    A = np.linalg.solve(W, B)
    ew, ev = np.linalg.eig(A)
    k = int(np.argmax(ew.real))
    v = ev[:, k].real
    sd = np.sqrt(np.diag(W))
    load = v * sd
    load = load / np.max(np.abs(load))
    order = np.argsort(-np.abs(load))
    return {
        "lambda_max": float(ew.real[k]),
        "loadings": [
            {"param": names[i] if names is not None else f"p{i}",
             "loading": round(float(load[i]), 4)}
            for i in order
        ],
        "cond_W": float(np.linalg.cond(W)),
    }


def _records_from_chains(chains):
    """[T, p] chain matrices as records of beta_0 and beta only, the
    columns GRB stacks first."""
    return [{"beta_0": c[:, 0], "beta": c[:, 1:]} for c in chains]


def simulate(m=3, T=400, p=8, eps=None, seed=0, mean_shift=0.0):
    """AR(1) chains; optional near-duplicate parameter pair with gap eps;
    optional per-chain mean shift along a random direction."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=p)
    dirs /= np.linalg.norm(dirs)
    chains = []
    for ci in range(m):
        z = np.zeros((T, p))
        x = rng.normal(size=p)
        for t in range(T):
            x = 0.6 * x + rng.normal(size=p)
            z[t] = x
        if eps is not None:
            # column 1 := column 0 + eps * noise  -> W nearly singular
            z[:, 1] = z[:, 0] + eps * rng.normal(size=T)
        z += mean_shift * dirs * (ci - (m - 1) / 2)
        chains.append(z)
    return chains


def cases() -> dict:
    """Cases A, B and C, keyed as the JAX script's record."""
    out = {}
    chains = simulate(eps=None, mean_shift=0.15)
    ref, W, B = mpsrf_reference(chains)
    ours = Gelman_Rubin_Brooks(_records_from_chains(chains), burn_in=0.0)
    out["A_well_conditioned"] = {
        "mpsrf_reference_semantics": float(ref),
        "mpsrf_ours": float(ours["R_hat"][0]),
        "abs_diff": float(abs(ref - ours["R_hat"][0])),
        "cond_W": float(np.linalg.cond(W)),
    }

    rows = []
    for eps in (1e-2, 1e-4, 1e-6):
        chains = simulate(eps=eps, mean_shift=0.15)
        ref, W, _ = mpsrf_reference(chains)
        ours = Gelman_Rubin_Brooks(_records_from_chains(chains), burn_in=0.0)
        rows.append({
            "eps": eps,
            "cond_W": float(np.linalg.cond(W)),
            "mpsrf_reference_semantics": float(ref),
            "mpsrf_ours": float(ours["R_hat"][0]),
            "max_univariate": float(np.max(ours["R_hat"][1:])),
        })
    out["B_near_collinear"] = rows

    chains = simulate(eps=None, mean_shift=0.0, T=400)
    ref, W, B = mpsrf_reference(chains)
    ours = Gelman_Rubin_Brooks(_records_from_chains(chains), burn_in=0.0)
    out["C_stationary_rank_deficient_B"] = {
        "rank_B": int(np.linalg.matrix_rank(B)),
        "mpsrf_reference_semantics": float(ref),
        "mpsrf_ours": float(ours["R_hat"][0]),
        "max_univariate": float(np.max(ours["R_hat"][1:])),
    }
    return out


def parse_args(argv=None):
    return _common.parser(__doc__, "grb_guard.json").parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    _, out = _common.setup(args)
    out.update(cases())
    print(json.dumps(out, indent=1))
    _common.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
