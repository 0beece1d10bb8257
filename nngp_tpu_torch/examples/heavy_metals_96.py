"""Heavy-metals 20x200 protocol at 96 chains on one card.

Port of ``examples/heavy_metals_96.py``.  Same per-chain budget as the
reference protocol (Heavy_metals/run_script.R:15: 20 cycles x 200
iterations), but 96 batched chains instead of 3 forked ones — the
configuration where the multivariate-PSRF criterion is actually
estimable: with 3 chains the between matrix has rank 2 and lambda_max
maximizes over 18 dimensions, so a direction with IACT ~100 fails
MPSRF < 1.1 ~40% of the time even for a perfect sampler
(experiments/mpsrf_estimator_sim.json); 96 chains remove that estimator
noise without touching the per-chain budget.

Field records are column-subsampled (64 monitored sites) to keep the
per-cycle device->host pull small at 96 chains; the GRB/MPSRF criterion
uses the scalar records only.  The cycle log goes to
``<out>/hm_convergence_96.jsonl`` unless ``--log`` names another file.

Run:  python -m nngp_tpu_torch.examples.heavy_metals_96 [--chains 96]
          [--cycles 20] [--iters 200] [--covparams-steps K] [--log LOG]
          [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import os
import time

import numpy as np

import nngp_tpu_torch
from nngp_tpu_torch.examples import _common
from nngp_tpu_torch.utils.datasets import load_heavy_metals

INIT = dict(m=5, stationary_covfun="exponential_sphere", seed=1)
LOG_NAME = "hm_convergence_96.jsonl"


def parse_args(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--chains", type=int, default=96)
    ap.add_argument("--covparams-steps", type=int, default=1)
    ap.add_argument("--log", default=None,
                    help=f"jsonl cycle log (default <out>/{LOG_NAME})")
    args = ap.parse_args(argv)
    if args.log is None:
        args.log = os.path.join(args.out, LOG_NAME)
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, label = _common.setup(args)

    locs, y, X = load_heavy_metals()
    t0 = time.time()
    mc = nngp_tpu_torch.initialize(locs, y, X_locs=X, n_chains=args.chains,
                                   device=device, **INIT)
    t_run = time.time()
    rng = np.random.default_rng(0)
    cols = np.sort(rng.choice(mc.graph.n, size=64, replace=False))
    knobs = dict(
        n_iterations_update=args.iters,
        field_thinning=0.05,
        Gelman_Rubin_Brooks_stop=(1.00, 1.00),
        verbose=True,
        log_jsonl=args.log,
        field_record_columns=cols,
    )
    if args.covparams_steps > 1:
        # two-phase: K=1 through the adaptation window (extra ASIS moves
        # per iteration during step-size adaptation destabilize burn-in —
        # a from-the-start K=3 run diverged, experiments/hm_96_K3_run.log),
        # then K ASIS pairs per iteration for the sampling half.  The
        # per-chain iteration budget is unchanged and the burn_in=0.5
        # MPSRF window covers exactly the K-phase.
        half = int(os.environ.get("HM96_PHASE1_CYCLES", str(args.cycles // 2)))
        mc = nngp_tpu_torch.run(mc, n_cycles=half, **knobs)
        mc = nngp_tpu_torch.run(mc, n_cycles=args.cycles - half,
                                covparams_steps=args.covparams_steps, **knobs)
    else:
        mc = nngp_tpu_torch.run(mc, n_cycles=args.cycles, **knobs)
    run_s = time.time() - t_run
    print(f"total fit time: {time.time() - t0:.1f}s "
          f"({mc.iterations} iterations/chain, {args.chains} chains)")
    grb = mc.diagnostics["Gelman_Rubin_Brooks"][-1]
    print("final R-hat:", dict(zip(grb["names"], np.round(grb["R_hat"], 4))))

    summary = {
        "example": "heavy_metals_96", "device": label, "n_obs": len(y),
        "n_sites": mc.graph.n, "n_chains": mc.n_chains,
        "covparams_steps": args.covparams_steps,
        "iterations": mc.iterations, "initialize_s": t_run - t0,
        "run_s": run_s, "ms_per_iteration": 1e3 * run_s / mc.iterations,
        "final_rhat": _common.rhat(grb), "log": args.log,
        "iterations_run": mc.iterations,
    }
    _common.write_summary(args.out, "heavy_metals_96", summary)
    return summary


if __name__ == "__main__":
    main()
