"""Float32 error of the MH log-ratios at Heavy-metals scale (port of
experiments/ratio_audit.py; same record keys).

    python -m nngp_tpu_torch.experiments.ratio_audit [--device cpu]
        [--n-proposals 40]

Measures the device path's float32 log-ratios against a float64 NumPy
oracle (the same math on float64 coordinates, factors and solves):

  - the ancillary log-ratio: the observation log-likelihood difference
    after the field's co-transform (mcmc_nngp_update_Gaussian.R:129-133),
    through ``models/gaussian.py:_obs_sse_diff``;
  - the sufficient log-ratio: the Vecchia prior log-density difference
    (:184-186), through ``ops/vecchia.py:nngp_loglik_diff``;
  - each split into its total error and its reduction-only error (the
    float64 sum of the float32-computed residuals and factors).

Both device sums accumulate in float64 (``sum64``; the JAX package uses
double-float sums, ``ops/reductions.py``): ``sum_op`` names it.  The
record adds, per proposal, the oracle's ratios (``oracle``).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from nngp_tpu_torch.experiments import _common

SUM_OP = "ops/vecchia.py:sum64 (float64 accumulation, float32 result)"
KEYS = ("anc", "suf", "anc_reduction_only", "suf_reduction_only")


def audit(locs, y, X, n_proposals: int, device, out: dict) -> dict:
    """The audit of the fit ``initialize(locs, y, X_locs=X, m=5,
    stationary_covfun="exponential_sphere", n_chains=1, seed=1)`` on
    ``device``; fills ``out`` with ``n``, ``summary``, ``errors`` and
    ``oracle`` and returns it."""
    import nngp_tpu_torch
    from nngp_tpu_torch.models.gaussian import (
        UpdateConfig, _natural_shape, _obs_sse_diff)
    from nngp_tpu_torch.ops.numpy_ref import (
        np_shape_transform, np_solve_L, np_sparse_L, np_vecchia_linv)
    from nngp_tpu_torch.ops.trisolve import level_solve
    from nngp_tpu_torch.ops.vecchia import (linv_mult, nngp_loglik_diff,
                                            vecchia_linv)
    from nngp_tpu_torch.preprocess.coloring import dag_levels
    from nngp_tpu_torch.preprocess.ordering import lonlat_to_xyz

    mc = nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=1, seed=1, device=device, verbose=False)
    g = mc.graph
    n = g.n
    NN = np.asarray(mc.NNarray)
    levels = dag_levels(NN)
    names = mc.space_time_model["covfun"]["shape_params"]
    cfg = UpdateConfig(n_iterations=1, shape_names=tuple(names),
                       locs_cols=tuple(mc.design.locs_cols))

    # a plausible Heavy-metals state: theta near the expected posterior,
    # the field from the prior at that theta (float64 host build, then cast)
    rng = np.random.default_rng(7)
    var_y = float(np.var(y, ddof=1))
    log_scale = float(np.log(0.6 * var_y))
    log_noise = float(np.log(0.35 * var_y))
    shape0 = np.array([np.log(0.03)])  # ~190 km range on the unit sphere
    beta_0 = float(np.mean(y))

    coords64 = lonlat_to_xyz(np.asarray(mc.locs, dtype=np.float64))
    natural0 = np_shape_transform(names, shape0)
    linv0_64 = np_vecchia_linv(coords64, NN, g.covfun, natural0)
    z = rng.normal(size=n)
    field64 = beta_0 + np.sqrt(np.exp(log_scale)) * np_solve_L(
        linv0_64, NN, z, levels)

    locs_match = g.locs_match.cpu().numpy()
    y64 = np.asarray(y, dtype=np.float64)
    Xd = mc.data.X.cpu().double().numpy()
    mu64 = beta_0 + Xd @ np.zeros(Xd.shape[1])  # beta = 0: mu = beta_0

    # the device state (float32, one chain)
    f32 = torch.float32
    field32 = torch.tensor(field64[None], dtype=f32, device=device)
    shape32 = torch.tensor(shape0[None], dtype=f32, device=device)
    ls32 = torch.tensor([log_scale], dtype=f32, device=device)
    b0 = torch.tensor([beta_0], dtype=f32, device=device)
    mu32 = torch.full((1, g.n_obs), np.float32(beta_0), dtype=f32,
                      device=device)
    prec32 = torch.exp(torch.tensor(-log_noise, dtype=f32, device=device))

    def f32_ancillary(innov, field, shape, ls):
        linv = vecchia_linv(g, _natural_shape(cfg, shape))
        new_ls = ls + innov[0]
        new_shape = shape + innov[1:]
        new_linv = vecchia_linv(g, _natural_shape(cfg, new_shape))
        v = linv_mult(linv, field - b0[:, None], g)
        new_field = b0[:, None] + torch.exp(0.5 * (new_ls - ls))[:, None] * \
            level_solve(new_linv, v, g)
        llr = -0.5 * prec32 * _obs_sse_diff(mc.data, new_field, field, mu32,
                                            b0, g)
        return llr, new_field

    def f32_sufficient(innov, field, shape, ls):
        linv = vecchia_linv(g, _natural_shape(cfg, shape))
        new_ls = ls + innov[0]
        new_shape = shape + innov[1:]
        new_linv = vecchia_linv(g, _natural_shape(cfg, new_shape))
        return nngp_loglik_diff(new_linv, new_ls, linv, ls,
                                field - b0[:, None], g)

    def f64_obs_sse(field, mu):
        r = y64 - field[locs_match] - mu + beta_0
        return float(r @ r)

    def f64_loglik(linv, field, ls):
        L = np_sparse_L(linv, NN)
        zf = L @ field
        return float(np.sum(np.log(linv[:, 0])) - 0.5 * n * ls
                     - 0.5 * (zf @ zf) * np.exp(-ls))

    sse0_64 = f64_obs_sse(field64, mu64)
    print(f"n={n}  var_y={var_y:.4f}  sse0={sse0_64:.1f}  "
          f"prec={np.exp(-log_noise):.3f}", flush=True)

    tk = -2.0  # proposal log-variance at its initial value
    err = {k: [] for k in KEYS}
    oracle = {"llr64": [], "gpr64": []}
    f32f = _common.host(field32[0])
    for k in range(n_proposals):
        innov = rng.normal(size=2) * np.exp(0.5 * tk)
        innov32 = torch.tensor(innov, dtype=f32, device=device)

        # ancillary
        llr32, nf32 = f32_ancillary(innov32, field32, shape32, ls32)
        llr32 = float(llr32[0])
        nat_new = np_shape_transform(names, shape0 + innov[1:])
        linv_new64 = np_vecchia_linv(coords64, NN, g.covfun, nat_new)
        v64 = np_sparse_L(linv0_64, NN) @ (field64 - beta_0)
        nf64 = beta_0 + np.exp(0.5 * innov[0]) * np_solve_L(
            linv_new64, NN, v64, levels)
        llr64 = -0.5 * np.exp(-log_noise) * (f64_obs_sse(nf64, mu64) - sse0_64)
        err["anc"].append(llr32 - llr64)
        sse_new_red = f64_obs_sse(_common.host(nf32[0]), mu64)
        sse_old_red = f64_obs_sse(f32f, mu64)
        llr_mixed = -0.5 * np.exp(-log_noise) * (sse_new_red - sse_old_red)
        err["anc_reduction_only"].append(llr32 - llr_mixed)

        # sufficient
        gpr32 = float(f32_sufficient(innov32, field32, shape32, ls32)[0])
        gpr64 = (f64_loglik(linv_new64, field64 - beta_0, log_scale + innov[0])
                 - f64_loglik(linv0_64, field64 - beta_0, log_scale))
        err["suf"].append(gpr32 - gpr64)
        linv32o = _common.host(vecchia_linv(g, torch.exp(shape32))[0])
        linv32n = _common.host(vecchia_linv(g, torch.exp(shape32 + innov32[1:]))[0])
        gpr_mixed = (f64_loglik(linv32n, f32f - beta_0, log_scale + innov[0])
                     - f64_loglik(linv32o, f32f - beta_0, log_scale))
        err["suf_reduction_only"].append(gpr32 - gpr_mixed)
        oracle["llr64"].append(float(llr64))
        oracle["gpr64"].append(float(gpr64))

        if k < 5 or (k + 1) % 10 == 0:
            print(f"[{k+1}/{n_proposals}] anc_err={err['anc'][-1]:+.4f} "
                  f"(reduction {err['anc_reduction_only'][-1]:+.4f})  "
                  f"suf_err={err['suf'][-1]:+.4f} "
                  f"(reduction {err['suf_reduction_only'][-1]:+.4f})  "
                  f"llr64={llr64:+.3f} gpr64={gpr64:+.3f}", flush=True)

    summary = {}
    for k in KEYS:
        a = np.asarray(err[k])
        summary[k] = {"rms": float(np.sqrt(np.mean(a * a))),
                      "max_abs": float(np.max(np.abs(a))),
                      "mean": float(np.mean(a))}
    out.update(n=int(n), summary=summary,
               errors={k: list(map(float, v)) for k, v in err.items()},
               oracle=oracle, sum_op=SUM_OP)
    return out


def parse_args(argv=None):
    ap = _common.parser(__doc__, "ratio_audit.json")
    ap.add_argument("--n-proposals", type=int, default=40)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, out = _common.setup(args)
    from nngp_tpu_torch.utils import datasets

    print(f"backend: {out['backend']} {out['device']}", flush=True)
    locs, y, X = datasets.load_heavy_metals()
    t0 = time.time()
    audit(locs, y, X, args.n_proposals, device, out)
    print(json.dumps({"backend": out["backend"],
                      "elapsed_s": round(time.time() - t0, 1),
                      "summary": out["summary"]}, indent=2))
    _common.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
