"""Post-fit analysis of the Heavy-metals workload.

Port of ``examples/heavy_metals_analysis.py``.  Mirrors the analysis
outputs of Heavy_metals/Results_analysis.R of the reference:
- Gelman-Rubin-Brooks R-hat trajectories vs iteration (:17-60)
- covariance estimates with ranges scaled by the Earth radius (:133-142)
- a gridded US prediction map of the latent field (:150-197)
- fixed-effect (pollution covariate) surfaces (:200-226)

The reference's 5-km covariate grids (Heavy_metals/usgrids5km/*.asc,
Results_analysis.R:155-162) are not shipped in the reference repo, so the
fixed-effect surfaces are evaluated at the 64,274 observation sites (where
the fitted covariate values exist) instead of on the unavailable grid.  The
synthetic stand-in of the data has no pollution covariates (dairp, dTRI),
so there the surfaces are skipped.

The numbers always go to ``<out>/heavy_metals_analysis.npz`` (trajectories,
estimates, the grid and its prediction table, the surfaces) and one JSON
line of ``<out>/heavy_metals_analysis.jsonl``; ``--figures`` also draws the
maps as PNGs with matplotlib (and raises ImportError without it).

Run after heavy_metals with --save FIT:
  python -m nngp_tpu_torch.examples.heavy_metals_analysis FIT [GRID_DEG]
      [--figures] [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import os
import time

import numpy as np

import nngp_tpu_torch
from nngp_tpu_torch.examples import _common
from nngp_tpu_torch.examples._common import EARTH_RADIUS_KM
from nngp_tpu_torch.utils.datasets import load_heavy_metals


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or a clear ImportError."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("--figures needs matplotlib, which is not "
                          "installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def parse_args(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("path", nargs="?", default="hm_fit.pkl")
    ap.add_argument("grid_deg", nargs="?", type=float, default=0.25)
    ap.add_argument("--figures", action="store_true",
                    help="draw the maps as PNGs (needs matplotlib)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, label = _common.setup(args)
    plt = _pyplot() if args.figures else None
    outdir, grid_deg = args.out, args.grid_deg
    arrays = {}

    def savefig(fig, name):
        p = os.path.join(outdir, name)
        fig.savefig(p, dpi=120)
        plt.close(fig)
        print(f"wrote {p}", flush=True)

    mc = nngp_tpu_torch.load(args.path, device=device)

    # --- R-hat vs iteration (Results_analysis.R:17-60) ---
    grbs = mc.diagnostics["Gelman_Rubin_Brooks"]
    if grbs:
        names = grbs[0]["names"]
        iters = np.linspace(
            mc.iterations / len(grbs), mc.iterations, len(grbs)
        )
        arrays["grb_iterations"] = iters
        arrays["grb_names"] = np.asarray(names)
        arrays["grb_rhat"] = np.stack([g["R_hat"] for g in grbs])
        if plt is not None:
            fig, ax = plt.subplots(figsize=(7, 4))
            for j, nm in enumerate(names):
                ax.plot(iters, [g["R_hat"][j] for g in grbs], label=nm, lw=1)
            ax.axhline(1.05, color="k", ls="--", lw=0.8)
            ax.set_xlabel("iteration")
            ax.set_ylabel("R-hat")
            ax.set_yscale("log")
            ax.legend(fontsize=7)
            fig.tight_layout()
            savefig(fig, "hm_grb_trajectories.png")

    # --- estimates (Results_analysis.R:133-142) ---
    est = nngp_tpu_torch.estimate(mc)
    gp = est["covariance_params"]["GpGp_covparams"]
    print("covariance estimates (range scaled to km):")
    for nm, row in zip(gp["names"], gp["table"]):
        s = EARTH_RADIUS_KM if nm == "range" else 1.0
        print(f"  {nm:16s} {row[0]*s:10.3f}  [{row[1]*s:10.3f}, {row[3]*s:10.3f}]")
    km = np.array([EARTH_RADIUS_KM if nm == "range" else 1.0
                   for nm in gp["names"]])
    arrays["covariance_names"] = np.asarray(gp["names"])
    arrays["covariance_km"] = np.asarray(gp["table"]) * km[:, None]

    # --- gridded prediction map (Results_analysis.R:150-197): posterior
    # mean and sd of the latent field on a regular lon/lat grid clipped to
    # cells near an observation (the reference clips to the US polygon;
    # without the geo stack, "within ~1 deg of a site" is the same effect)
    lon = np.arange(-125, -66, grid_deg)
    lat = np.arange(25, 50, grid_deg)
    grid = np.stack(
        [np.meshgrid(lon, lat)[0].ravel(), np.meshgrid(lon, lat)[1].ravel()],
        axis=-1,
    )
    obs = mc.observed_locs
    cell = np.round(obs / 1.0).astype(np.int64)
    occupied = set(map(tuple, cell))
    near = np.array(
        [tuple(c) in occupied for c in np.round(grid / 1.0).astype(np.int64)]
    )
    grid_us = grid[near]
    n_kept = int((mc.records[0]["saved_field"] > 0.5 * mc.iterations).sum())
    print(f"predicting latent field at {len(grid_us)} grid sites "
          f"({grid_deg} deg spacing) from {n_kept}"
          f" retained samples x {mc.n_chains} chains ...")
    t0 = time.time()
    pred = nngp_tpu_torch.predict_field(mc, grid_us, burn_in=0.5, m=8)
    predict_s = time.time() - t0
    print(f"predict_field: {predict_s:.1f}s")
    tab = pred["predicted_field_summary"]["table"]
    arrays.update(grid_lon=lon, grid_lat=lat, grid_sites=grid_us,
                  grid_near=near, prediction_table=tab,
                  prediction_columns=np.asarray(
                      pred["predicted_field_summary"]["columns"]))
    if plt is not None:
        for stat, col, cmap in (("mean", 0, "viridis"), ("sd", 4, "magma")):
            full = np.full(len(grid), np.nan)
            full[near] = tab[:, col]
            img = full.reshape(len(lat), len(lon))
            fig, ax = plt.subplots(figsize=(9, 5))
            im = ax.pcolormesh(lon, lat, img, shading="auto", cmap=cmap)
            ax.scatter(obs[::100, 0], obs[::100, 1], s=0.3, c="k", alpha=0.25)
            fig.colorbar(im, label=f"posterior {stat} latent field")
            ax.set_xlabel("longitude")
            ax.set_ylabel("latitude")
            fig.tight_layout()
            savefig(fig, f"hm_prediction_{stat}.png")

    # --- pollution fixed-effect surfaces (Results_analysis.R:200-226):
    # dairp + dTRI joint contribution, evaluated at the observation sites
    # (the reference's 5-km covariate grids are not shipped)
    _, _, X = load_heavy_metals()
    pol_names = [nm for nm in ("dairp", "dTRI") if nm in X]
    if pol_names:
        Xp = {nm: np.asarray(X[nm]) for nm in pol_names}
        pfe = nngp_tpu_torch.predict_fixed_effects(
            mc, Xp, burn_in=0.5, add_intercept=False
        )
        ptab = pfe["predicted_fixed_effects_summary"]["table"]
        arrays["pollution_table"] = ptab
        if plt is not None:
            for stat, col, cmap in (("mean", 0, "coolwarm"),
                                    ("sd", 4, "magma")):
                fig, ax = plt.subplots(figsize=(9, 5))
                sc = ax.scatter(obs[:, 0], obs[:, 1], c=ptab[:, col], s=1.2,
                                cmap=cmap, linewidths=0)
                fig.colorbar(
                    sc, label=f"pollution effect ({'+'.join(pol_names)}) "
                              f"{stat}"
                )
                ax.set_xlabel("longitude")
                ax.set_ylabel("latitude")
                fig.tight_layout()
                savefig(fig, f"hm_pollution_effect_{stat}.png")

    npz = os.path.join(outdir, "heavy_metals_analysis.npz")
    np.savez(npz, **arrays)
    summary = {
        "example": "heavy_metals_analysis", "device": label,
        "fit": os.path.abspath(args.path), "iterations": mc.iterations,
        "n_chains": mc.n_chains, "grid_deg": grid_deg,
        "grid_sites": int(len(grid_us)), "retained_samples": n_kept,
        "predict_s": predict_s,
        "prediction_mean_range": [float(tab[:, 0].min()),
                                  float(tab[:, 0].max())],
        "prediction_sd_range": [float(tab[:, 4].min()),
                                float(tab[:, 4].max())],
        "covariance_km": _common.ci_table(gp["names"], gp["table"],
                                          {"range": EARTH_RADIUS_KM}),
        "final_rhat": _common.rhat(grbs[-1]) if grbs else None,
        "pollution_surfaces": pol_names, "npz": npz,
        "iterations_run": 0,
    }
    _common.write_summary(outdir, "heavy_metals_analysis", summary)
    return summary


if __name__ == "__main__":
    main()
