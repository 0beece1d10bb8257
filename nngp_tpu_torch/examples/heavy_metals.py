"""Heavy-metals workload: the reference's real-data application.

Port of ``examples/heavy_metals.py``.  Mirrors Heavy_metals/run_script.R of
the reference — US lead measurements at 64,274 lon/lat sites, 14
covariates, exponential_sphere kernel, m=5, 3 chains, field_thinning 0.5,
up to 20 cycles x 200 iterations with Gelman-Rubin-Brooks stopping at
(1.00, 1.00) — and the headline outputs of Results_analysis.R (estimates
with ranges scaled to km by the Earth radius, Results_analysis.R:139).
Without the reference's processed_data.RDS the data are the synthetic
stand-in of ``utils/datasets.py`` (same shapes, no spatial signal).

Run:  python -m nngp_tpu_torch.examples.heavy_metals [--cycles N] [--quick]
          [--save FIT] [--log LOG] [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import time

import nngp_tpu_torch
from nngp_tpu_torch.examples import _common
from nngp_tpu_torch.examples._common import EARTH_RADIUS_KM
from nngp_tpu_torch.utils.datasets import load_heavy_metals

INIT = dict(m=5, stationary_covfun="exponential_sphere", n_chains=3, seed=1)


def parse_args(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--save", default=None)
    ap.add_argument("--log", default=None, help="jsonl cycle log path")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, label = _common.setup(args)

    locs, y, X = load_heavy_metals()
    if args.quick:
        k = 8000
        locs, y = locs[:k], y[:k]
        X = {n: v[:k] for n, v in X.items()}
        args.cycles = min(args.cycles, 3)

    t0 = time.time()
    mc = nngp_tpu_torch.initialize(locs, y, X_locs=X, device=device, **INIT)
    t_run = time.time()
    mc = nngp_tpu_torch.run(
        mc,
        n_cycles=args.cycles,
        n_iterations_update=args.iters,
        field_thinning=0.5,
        Gelman_Rubin_Brooks_stop=(1.00, 1.00),
        save_name=args.save,
        verbose=True,
        log_jsonl=args.log,
    )
    run_s = time.time() - t_run
    print(f"total fit time: {time.time() - t0:.1f}s "
          f"({mc.iterations} iterations/chain)")

    est = nngp_tpu_torch.estimate(mc)
    gp = est["covariance_params"]["GpGp_covparams"]
    print("covariance parameters (GpGp parametrization; range in km):")
    for nm, row in zip(gp["names"], gp["table"]):
        scale = EARTH_RADIUS_KM if nm == "range" else 1.0
        unit = " km" if nm == "range" else ""
        print(f"  {nm:16s} mean={row[0]*scale:10.3f}{unit}  "
              f"CI=[{row[1]*scale:10.3f}, {row[3]*scale:10.3f}]")
    fe = est["fixed_effects"]
    print("significant fixed effects (zero outside 95% CI):")
    for nm, row, sig in zip(fe["names"], fe["table"], fe["zero_out_of_ci"]):
        if sig:
            print(f"  {nm:16s} mean={row[0]:9.4f}  "
                  f"CI=[{row[1]:9.4f}, {row[3]:9.4f}]")

    summary = {
        "example": "heavy_metals", "device": label, "n_obs": len(y),
        "n_sites": mc.graph.n, "n_chains": mc.n_chains,
        "iterations": mc.iterations, "initialize_s": t_run - t0,
        "run_s": run_s, "ms_per_iteration": 1e3 * run_s / mc.iterations,
        "final_rhat": _common.rhat(mc.diagnostics["Gelman_Rubin_Brooks"][-1]),
        "covariance_km": _common.ci_table(gp["names"], gp["table"],
                                          {"range": EARTH_RADIUS_KM}),
        "significant_fixed_effects": _common.ci_table(
            [nm for nm, sig in zip(fe["names"], fe["zero_out_of_ci"]) if sig],
            fe["table"][fe["zero_out_of_ci"]]),
        "iterations_run": mc.iterations,
    }
    _common.write_summary(args.out, "heavy_metals", summary)
    return summary


if __name__ == "__main__":
    main()
