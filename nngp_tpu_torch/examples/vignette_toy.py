"""Vignette walkthrough: the reference's executable-doc toy example.

Port of ``examples/vignette_toy.py``.  Mirrors Vignette.rmd:24-235 of the
reference: a 1-D Gaussian process with known truth (scale 10, range 5,
noise variance 5), duplicated observation sites, a spatially-coherent
regressor (the coordinate itself) plus a white noise regressor, the
multi-stage run protocol with Gelman-Rubin-Brooks early stopping,
estimation, and prediction.  Also reproduces the interweaving negative
control (Vignette.md:1131-1184): passing the regressors as X_obs disables
the interweaved beta update and the spatially-coherent regressor mixes
catastrophically.

Run:  python -m nngp_tpu_torch.examples.vignette_toy [--quick]
          [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import time

import numpy as np

import nngp_tpu_torch
from nngp_tpu_torch.examples import _common

INIT = dict(m=5, n_chains=3, stationary_covfun="exponential_isotropic",
            seed=1)


def simulate(rng, n_obs=2000):
    """Vignette.rmd:24-49: locations on [0,100] with duplicates, exponential
    kernel, scale 10, range 5, noise 5; regressors = coordinate slope +
    white noise."""
    locs_1d = rng.uniform(0, 100, int(n_obs * 0.75))
    locs_1d = np.concatenate(
        [locs_1d, rng.choice(locs_1d, n_obs - len(locs_1d))]
    )
    u = np.unique(locs_1d)
    d = np.abs(u[:, None] - u[None, :])
    K = 10.0 * np.exp(-d / 5.0)
    w_u = np.linalg.cholesky(K + 1e-10 * np.eye(len(u))) @ rng.normal(size=len(u))
    w = w_u[np.searchsorted(u, locs_1d)]
    X = np.stack([locs_1d, rng.normal(size=n_obs)], axis=1)
    beta = np.array([0.01, -1.6])
    beta_0 = 2.0
    y = beta_0 + w + X @ beta + rng.normal(size=n_obs) * np.sqrt(5.0)
    locs = np.stack([locs_1d, np.zeros(n_obs)], axis=1)
    return locs, y, X, w, (beta_0, beta)


def parse_args(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--quick", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, label = _common.setup(args)
    rng = np.random.default_rng(1)
    n_obs = 600 if args.quick else 2000
    locs, y, X, w, truth = simulate(rng, n_obs)

    print("=== interweaved fit (X_locs) ===")
    t0 = time.time()
    mc = nngp_tpu_torch.initialize(locs, y, X_locs=X, device=device, **INIT)
    t_run = time.time()
    # three-stage protocol (Vignette.rmd:219-235): big cycles, then smaller
    mc = nngp_tpu_torch.run(mc, n_cycles=5, n_iterations_update=200,
                            Gelman_Rubin_Brooks_stop=(1.10, 1.05),
                            verbose=True)
    mc = nngp_tpu_torch.run(mc, n_cycles=26 if not args.quick else 6,
                            n_iterations_update=100,
                            Gelman_Rubin_Brooks_stop=(1.05, 1.03),
                            verbose=False)
    run_s = time.time() - t_run
    wall = time.time() - t0
    print(f"fit took {wall:.1f}s, {mc.iterations} iterations/chain")

    est = nngp_tpu_torch.estimate(mc)
    gp = est["covariance_params"]["GpGp_covparams"]
    print("truth: scale=10 range=5 noise=5")
    for nm, row in zip(gp["names"], gp["table"]):
        print(f"  {nm:16s} mean={row[0]:8.3f}  CI=[{row[1]:8.3f}, {row[3]:8.3f}]")
    fe = est["fixed_effects"]
    print("truth: beta_0=2.0 slope=0.01 white=-1.6")
    for nm, row, sig in zip(fe["names"], fe["table"], fe["zero_out_of_ci"]):
        print(f"  {nm:16s} mean={row[0]:8.4f}  CI=[{row[1]:8.4f}, {row[3]:8.4f}]"
              f"  significant={bool(sig)}")

    # prediction on a grid (Vignette-style)
    grid = np.stack([np.linspace(0, 100, 50), np.zeros(50)], axis=1)
    pred = nngp_tpu_torch.predict_field(mc, grid, m=8)
    tab = pred["predicted_field_summary"]["table"]
    print("prediction grid summary (first 3 rows):")
    print(np.round(tab[:3], 3))

    print("\n=== negative control: X_obs (interweaving disabled) ===")
    mc2 = nngp_tpu_torch.initialize(locs, y, X_obs=X, device=device, **INIT)
    trail = []
    for cycle in range(5):
        mc2 = nngp_tpu_torch.run(mc2, n_cycles=1, n_iterations_update=200,
                                 Gelman_Rubin_Brooks_stop=(0.0, 0.0),
                                 verbose=False)
        grb = mc2.diagnostics["Gelman_Rubin_Brooks"][-1]
        slope_idx = grb["names"].index("V1")
        trail.append(float(grb["R_hat"][slope_idx]))
        print(f"  cycle {cycle+1}: R-hat of the spatially-coherent regressor ="
              f" {trail[-1]:.2f}")
    print("(compare Vignette.md:1148-1184: 61.6 -> 7.4 -> 6.9 -> 1.9 -> 1.1)")

    summary = {
        "example": "vignette_toy", "device": label, "n_obs": n_obs,
        "n_chains": mc.n_chains, "iterations": mc.iterations,
        "wall_s": wall, "run_s": run_s,
        "ms_per_iteration": 1e3 * run_s / mc.iterations,
        "final_rhat": _common.rhat(mc.diagnostics["Gelman_Rubin_Brooks"][-1]),
        "truth": {"scale": 10.0, "range": 5.0, "noise_variance": 5.0,
                  "beta_0": truth[0], "beta": truth[1].tolist()},
        "covariance": _common.ci_table(gp["names"], gp["table"]),
        "fixed_effects": _common.ci_table(fe["names"], fe["table"]),
        "prediction_first_rows": tab[:3].tolist(),
        "control_rhat_V1": trail,
        "iterations_run": mc.iterations + mc2.iterations,
    }
    _common.write_summary(args.out, "vignette_toy", summary)
    return summary


if __name__ == "__main__":
    main()
