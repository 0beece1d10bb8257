"""The adaptive-covariance (AM) proposal against the reference's isotropic
proposal on the Heavy-metals 8k subset, 3 chains, the 20 x 200 protocol
(counterpart of experiments/am_ab_cpu.py, run on the card; the same record
keys).

    python -m nngp_tpu_torch.experiments.am_ab [--seeds 1] [--cycles 20]
        [--iters 200] [--arms am,isotropic,am_k3] [--device cpu]

Arms:
  am         the AM proposal (the default ``initialize``);
  isotropic  ``initialize(..., adaptive_proposal=False)``: no AM moments,
             exactly the reference's proposal (the JAX script strips
             ``prop_*`` to None);
  am_k3      AM with K = 1 through the first half of the cycles, then 3
             ASIS pairs an iteration (the heavy_metals_96.py protocol).

Per arm and seed, one JSON line appended to ``--out``: the final MPSRF,
the worst univariate R-hat and its parameter, the R-hats of log_scale,
log_range and log_noise_variance, and the mean over chains of the
second-half IACT of log_scale, log_range and log_noise; with this
package's wall time, device and kernel launch counts.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from nngp_tpu_torch.experiments import _common

ARMS = ("am", "isotropic", "am_k3")
SITES = 8000


def iact(x):
    """Integrated autocorrelation time: 1 + 2 sum of the autocorrelations
    up to the first at or below 0.05 (FFT, lags < n/2)."""
    x = np.asarray(x, np.float64)
    x = x - x.mean()
    n = len(x)
    f = np.fft.rfft(x, 2 * n)
    acov = np.fft.irfft(f * np.conj(f))[: n // 2] / n
    rho = acov / acov[0]
    tau = 1.0
    for k in range(1, n // 2):
        if rho[k] <= 0.05:
            break
        tau += 2 * rho[k]
    return float(tau)


def arm_fit(arm: str, seed: int, device):
    """``initialize`` of one arm on the first SITES Heavy-metals
    observations."""
    import nngp_tpu_torch
    from nngp_tpu_torch.utils.datasets import load_heavy_metals

    if arm not in ARMS:
        raise ValueError(f"arm {arm!r} is not one of {ARMS}")
    locs, y, X = load_heavy_metals()
    locs, y = locs[:SITES], y[:SITES]
    X = {n: v[:SITES] for n, v in X.items()}
    return nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=3, seed=seed, device=device, verbose=False,
        adaptive_proposal=arm != "isotropic")


def run_arm(arm, seed, cycles, iters, device):
    import nngp_tpu_torch
    from nngp_tpu_torch.ops import sweep
    from nngp_tpu_torch.ops.vecchia import vecchia_linv

    mc = arm_fit(arm, seed, device)
    knobs = dict(n_iterations_update=iters, field_thinning=0.05,
                 verbose=False, Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    sweep.chromatic_sweeps.launches = vecchia_linv.launches = 0
    t0 = time.time()
    if arm == "am_k3":
        mc = nngp_tpu_torch.run(mc, n_cycles=cycles // 2, **knobs)
        mc = nngp_tpu_torch.run(mc, n_cycles=cycles - cycles // 2,
                                covparams_steps=3, **knobs)
    else:
        mc = nngp_tpu_torch.run(mc, n_cycles=cycles, **knobs)
    wall = time.time() - t0
    grb = mc.diagnostics["Gelman_Rubin_Brooks"][-1]
    uni = dict(zip(grb["names"][1:], grb["R_hat"][1:]))
    T = mc.iterations
    lo = T // 2
    taus = {}
    for key, get in (("log_scale", lambda r: r["log_scale"]),
                     ("log_range", lambda r: r["shape"][:, 0]),
                     ("log_noise", lambda r: r["log_noise_variance"])):
        taus[key] = round(float(np.mean(
            [iact(get(r)[lo:T]) for r in mc.records])), 1)
    return {
        "arm": arm, "seed": seed, "iterations": T,
        "wall_s": round(wall, 1),
        "mpsrf": round(float(grb["R_hat"][0]), 3),
        "worst_uni": round(float(max(uni.values())), 3),
        "worst_uni_name": max(uni, key=uni.get),
        "rhat_ls": round(float(uni["log_scale"]), 3),
        "rhat_lr": round(float(uni["log_range"]), 3),
        "rhat_lnv": round(float(uni["log_noise_variance"]), 3),
        "iact_2nd_half": taus,
        "sites": int(mc.graph.n),
        "ms_per_iteration": 1e3 * wall / max(T, 1),
        "kernel_launches": {"chromatic_sweeps": sweep.chromatic_sweeps.launches,
                            "factor_build": vecchia_linv.launches},
    }


def parse_args(argv=None):
    ap = _common.parser(__doc__, "am_ab.jsonl")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--arms", default=",".join(ARMS))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, dev_fields = _common.setup(args)
    rows = []
    for seed in range(1, args.seeds + 1):
        for arm in args.arms.split(","):
            row = {**run_arm(arm, seed, args.cycles, args.iters, device),
                   **dev_fields}
            print(json.dumps(row), flush=True)
            rows.append(row)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"appended {len(rows)} lines to {args.out}", flush=True)
    return {**dev_fields, "rows": rows}


if __name__ == "__main__":
    main()
