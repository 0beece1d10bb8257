"""Cross-validate the engine's Heavy-metals posterior against an
independent float64 fit (port of experiments/hm_crossval.py; the same
record keys; the reference's idiom is the spNNGP cross-check,
Results_analysis.R:7-9).

    python -m nngp_tpu_torch.experiments.hm_crossval [--n 700]
        [--engine-cycles 40] [--iters 2500] [--device cpu]

Two fits of one 700-site subsample (seed 42) of the Heavy-metals data,
kept apart:

- the engine: ``initialize``/``run`` on the device (``exponential_sphere``,
  m = 5, 3 chains, seed 7), ``--engine-cycles`` cycles of
  ``--engine-iters`` iterations until every univariate R-hat <= 1.1 (the
  reference's own stop, mcmc_nngp_run.R:2); moments of the second half;
- the oracle: a *collapsed* sampler in float64 NumPy on the host, the
  latent field integrated out analytically (y ~ N(X1 b, scale * C_v +
  nv * I), C_v the Vecchia covariance of the SAME m = 5 neighbour array),
  beta integrated out of the theta ratio under its flat prior, theta =
  (log_scale, log_range, log_nv) by adaptive random-walk MH with the
  engine's var(y) cap; the JAX script's sampler as it is.

Same model, different augmentation, precision and code: the posterior
moments must agree within joint Monte-Carlo error (or 0.15 sd).  The JAX
script's environment variables CROSSVAL_N, CROSSVAL_ENGINE_CYCLES and
CROSSVAL_ITERS are the arguments --n, --engine-cycles and --iters, with
the same defaults.
"""

from __future__ import annotations

import json
import time

import numpy as np

from nngp_tpu_torch.experiments import _common

KEYS = ("log_scale", "log_range", "log_noise_variance", "beta_0")


def mcse(x):
    """Monte-Carlo SE via batch means."""
    x = np.asarray(x, dtype=np.float64)
    bm = np.array([b.mean() for b in np.array_split(x, 20)])
    return float(bm.std(ddof=1) / np.sqrt(len(bm)))


def subsample(n_sub: int):
    """(locs, y, X, var(y)) of ``n_sub`` Heavy-metals observations drawn
    without replacement from seed 42."""
    from nngp_tpu_torch.utils.datasets import load_heavy_metals

    locs, y, X = load_heavy_metals()
    rng = np.random.default_rng(42)
    idx = rng.choice(len(y), size=n_sub, replace=False)
    return (locs[idx], y[idx], {k: v[idx] for k, v in X.items()},
            float(np.var(y[idx], ddof=1)))


def engine(locs, y, X, cycles: int, iters: int, device):
    """The engine's fit and its second-half (mean, mcse, sd) of each of
    KEYS; returns (mc, moments)."""
    import nngp_tpu_torch

    mc = nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=3, seed=7, device=device, verbose=False)
    mc = nngp_tpu_torch.run(mc, n_cycles=cycles, n_iterations_update=iters,
                            field_thinning=0.1, verbose=False,
                            Gelman_Rubin_Brooks_stop=(0.0, 1.1))
    lo = mc.iterations // 2
    get = {"log_scale": lambda r: r["log_scale"],
           "log_noise_variance": lambda r: r["log_noise_variance"],
           "log_range": lambda r: r["shape"][:, 0],
           "beta_0": lambda r: r["beta_0"]}
    eng = {}
    for k in KEYS:
        per = [get[k](rec)[lo:] for rec in mc.records]
        s = np.concatenate(per)
        eng[k] = (float(s.mean()),
                  float(np.mean([mcse(p) for p in per]) / np.sqrt(len(per))),
                  float(s.std()))
    return mc, eng


def oracle_inputs(mc) -> dict:
    """What the collapsed sampler reads of the engine's fit, on the host in
    float64: the unique sites' unit-sphere coordinates, the neighbour
    array, the observation-to-site map, the covariates and y."""
    from nngp_tpu_torch.preprocess.ordering import lonlat_to_xyz

    return {"coords64": lonlat_to_xyz(np.asarray(mc.locs, np.float64)),
            "NN": np.asarray(mc.NNarray),
            "covfun": mc.graph.covfun,
            "lm": mc.graph.locs_match.cpu().numpy(),
            "Xcols": _common.host(mc.data.X),
            "y64": np.asarray(mc.observed_field, np.float64)}


def collapsed_sampler(inputs: dict, var_y: float, n_iters: int) -> dict:
    """The float64 collapsed MH sampler (rng seed 123) for ``n_iters``
    iterations: every iteration's (log_scale, log_range,
    log_noise_variance, beta_0)."""
    from nngp_tpu_torch.ops.numpy_ref import np_sparse_L, np_vecchia_linv

    coords64, NN, covfun = inputs["coords64"], inputs["NN"], inputs["covfun"]
    lm, Xcols, y64 = inputs["lm"], inputs["Xcols"], inputs["y64"]

    def integrated(theta):
        ls, lr, lnv = theta
        if np.exp(ls) >= var_y or np.exp(lnv) >= var_y:
            return -np.inf, None
        linv = np_vecchia_linv(coords64, NN, covfun, np.array([np.exp(lr)]))
        L = np_sparse_L(linv, NN).toarray()
        Cv = np.linalg.inv(L.T @ L)
        Sig = np.exp(ls) * Cv[lm][:, lm] + np.exp(lnv) * np.eye(len(lm))
        cf = np.linalg.cholesky(Sig)
        X1 = np.concatenate([np.ones((len(lm), 1)), Xcols], axis=1)
        Si_y = np.linalg.solve(cf.T, np.linalg.solve(cf, y64))
        Si_X = np.linalg.solve(cf.T, np.linalg.solve(cf, X1))
        A = X1.T @ Si_X
        cA = np.linalg.cholesky(A)
        bhat = np.linalg.solve(cA.T, np.linalg.solve(cA, X1.T @ Si_y))
        quad = y64 @ Si_y - (X1.T @ Si_y) @ bhat
        ll = (-np.log(np.diag(cf)).sum() - np.log(np.diag(cA)).sum()
              - 0.5 * quad)
        return ll, (bhat, cA)

    rng_o = np.random.default_rng(123)
    theta = np.array([np.log(0.5 * var_y), np.log(0.02),
                      np.log(0.4 * var_y)])
    ll, aux = integrated(theta)
    step = np.array([0.2, 0.2, 0.12])
    samples = {k: [] for k in ("log_scale", "log_range",
                               "log_noise_variance", "beta_0")}
    acc = 0
    t0 = time.time()
    for it in range(n_iters):
        prop = theta + step * rng_o.normal(size=3)
        llp, auxp = integrated(prop)
        if llp - ll > np.log(rng_o.uniform()):
            theta, ll, aux = prop, llp, auxp
            acc += 1
        if (it + 1) % 50 == 0 and it < n_iters // 3:
            rate = acc / 50.0
            acc = 0
            step *= 1.3 if rate > 0.3 else (0.75 if rate < 0.15 else 1.0)
        bhat, cA = aux
        beta = bhat + np.linalg.solve(cA.T, rng_o.normal(size=cA.shape[0]))
        samples["log_scale"].append(theta[0])
        samples["log_range"].append(theta[1])
        samples["log_noise_variance"].append(theta[2])
        samples["beta_0"].append(beta[0])
        if (it + 1) % 250 == 0:
            print(f"  oracle {it+1}/{n_iters} ({time.time()-t0:.0f}s) "
                  f"theta={theta.round(3)}", flush=True)
    return samples


def compare(eng: dict, samples: dict, n_iters: int) -> tuple[dict, bool]:
    """Per parameter: both sides' second-half mean, mcse and sd, their z
    and whether they agree within 3 joint mcse or 0.15 sd."""
    lo_o = n_iters // 2
    params, ok_all = {}, True
    for k in KEYS:
        o = np.asarray(samples[k][lo_o:])
        om, ose, osd = float(o.mean()), mcse(o), float(o.std())
        em, ese, esd = eng[k]
        z = abs(em - om) / np.sqrt(ese ** 2 + ose ** 2 + 1e-12)
        ok = abs(em - om) < max(3 * np.sqrt(ese ** 2 + ose ** 2),
                                0.15 * max(esd, osd))
        ok_all &= ok
        params[k] = {
            "engine_mean": round(em, 4), "engine_mcse": round(ese, 4),
            "engine_sd": round(esd, 4),
            "oracle_mean": round(om, 4), "oracle_mcse": round(ose, 4),
            "oracle_sd": round(osd, 4), "z": round(float(z), 2),
            "ok": bool(ok),
        }
        print(f"{k:20s} engine {em:+.4f}±{ese:.4f} (sd {esd:.3f})  "
              f"oracle {om:+.4f}±{ose:.4f} (sd {osd:.3f})  z={z:.2f} "
              f"{'OK' if ok else 'MISMATCH'}", flush=True)
    return params, bool(ok_all)


def parse_args(argv=None):
    ap = _common.parser(__doc__, "hm_crossval.json")
    ap.add_argument("--n", type=int, default=700,
                    help="subsample size (CROSSVAL_N; default 700)")
    ap.add_argument("--engine-cycles", type=int, default=40,
                    help="engine cycles at most (CROSSVAL_ENGINE_CYCLES; "
                         "default 40)")
    ap.add_argument("--engine-iters", type=int, default=400,
                    help="engine iterations a cycle (default 400)")
    ap.add_argument("--iters", type=int, default=2500,
                    help="oracle iterations (CROSSVAL_ITERS; default 2500)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from nngp_tpu_torch.ops import sweep
    from nngp_tpu_torch.ops.vecchia import vecchia_linv

    args = parse_args(argv)
    device, dev_fields = _common.setup(args)
    locs, y, X, var_y = subsample(args.n)

    t0 = time.time()
    sweep.chromatic_sweeps.launches = vecchia_linv.launches = 0
    mc, eng = engine(locs, y, X, args.engine_cycles, args.engine_iters,
                     device)
    launches = {"chromatic_sweeps": sweep.chromatic_sweeps.launches,
                "factor_build": vecchia_linv.launches}
    engine_s = time.time() - t0
    grb = mc.diagnostics["Gelman_Rubin_Brooks"][-1]
    print(f"engine: {mc.iterations} iters/chain in {engine_s:.0f}s, "
          f"max univ R-hat {float(np.max(grb['R_hat'][1:])):.3f}", flush=True)

    t0 = time.time()
    samples = collapsed_sampler(oracle_inputs(mc), var_y, args.iters)
    oracle_s = time.time() - t0
    params, ok = compare(eng, samples, args.iters)
    report = {"n_sub": args.n, "n_unique": int(mc.graph.n),
              "engine_iters": int(mc.iterations), "oracle_iters": args.iters,
              "params": params, "ok": ok, **dev_fields,
              "engine_s": engine_s, "oracle_s": oracle_s,
              "kernel_launches": launches}
    _common.write_json(args.out, report)
    print("ok =", ok)
    return report


if __name__ == "__main__":
    main()
