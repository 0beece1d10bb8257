"""The Matérn factor build's error on the device against float64 oracles
(port of experiments/matern_probe.py; same record keys).

    python -m nngp_tpu_torch.experiments.matern_probe [--device cpu]

Two layouts: ``matern_sphere`` on the Heavy-metals geometry (maxmin on the
sphere, m = 5) and ``matern_isotropic`` on a seeded clustered layout
(20,000 uniform points in [0, 100]^2 plus 20,000 jittered copies, maxmin,
seed 2).  For each, at a range of 2.5 median neighbour distances and
nu = 0.75, and at a proposal 1.02 x range, nu 0.7525:

  1. K-entry error: ``correlation_from_sqdist`` (``ops/covariance.py:
     _matern``, ``ops/bessel.py:kv``) on the device against
     ``scipy.special.kv`` on the same float32 squared distances;
  2. the log-diagonal error of the device factor rows of the device K
     (``linv_rows_from_K``, the K-input kernel on a card) against the
     float64 Cholesky of that K, and of ``vecchia_linv`` (one fused
     ``factor_build`` launch on a card, K never written) against the
     float64 factor of the float64 K;
  3. the proposal's log-det difference sum_i dlog d_i, device against
     float64, and where its error lives (rows by conditional variance).

No fast-math anywhere: the device uses the libm/CUDA transcendentals.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from nngp_tpu_torch.experiments import _common
from nngp_tpu_torch.experiments._oracles import (f64_linv_logdiag,
                                                 f64_matern_from_d2g)


def probe_family(covfun, graph, NN, label, out, device="cuda") -> dict:
    """The probe of ``covfun`` on the host ``graph`` (NumPy leaves; NNarray
    ``NN``), the device arithmetic on ``device``; stores the entry as
    ``out[label]`` and returns it."""
    from nngp_tpu_torch.ops.covariance import correlation_from_sqdist
    from nngp_tpu_torch.ops.vecchia import linv_rows_from_K, vecchia_linv

    n = graph.n
    d2g = np.asarray(graph.nn_dist2)       # f32 host copy, f64-built
    mask = np.asarray(graph.nn_mask)
    s = d2g.sum(-1)[mask > 0]
    med_d = float(np.sqrt(np.median(s[s > 0])))
    G = d2g.shape[-1]
    rho = med_d * 2.5
    natural = np.array([rho] * G + [0.75], dtype=np.float64)
    natural_p = np.array([rho * 1.02] * G + [0.7525], dtype=np.float64)
    print(f"[{label}] n={n} median nn dist {med_d:.2e}, range {rho:.3e}, "
          f"nu 0.75", flush=True)

    g = graph.to(device)
    dev = {}
    for nm, nat in (("theta", natural), ("theta_p", natural_p)):
        nat32 = torch.tensor(nat[None], dtype=torch.float32, device=device)
        K_t = correlation_from_sqdist(covfun, g.nn_dist2, nat32)
        dev[nm] = (K_t, _common.host(vecchia_linv(g, nat32)[0]))

    K_t, linv_dev = dev["theta"]
    K_dev = _common.host(K_t[0])
    rows_devK = _common.host(linv_rows_from_K(K_t, g.nn_mask, g.d_floor)[0])
    K_f64 = f64_matern_from_d2g(d2g, natural[:G], natural[G])
    valid = (mask[:, :, None] * mask[:, None, :]) > 0
    kerr = np.abs(K_dev - K_f64)[valid]
    ld_dev = np.log(linv_dev[:, 0])
    ld_oracle_devK, _ = f64_linv_logdiag(K_dev, mask)
    ld_oracle_f64K, d_f64K = f64_linv_logdiag(K_f64, mask)
    e_chol = np.log(rows_devK[:, 0]) - ld_oracle_devK
    e_total = ld_dev - ld_oracle_f64K
    linv_dev_p = dev["theta_p"][1]
    K_f64_p = f64_matern_from_d2g(d2g, natural_p[:G], natural_p[G])
    dld_dev = np.log(linv_dev_p[:, 0]) - np.log(linv_dev[:, 0])
    ld_p64, _ = f64_linv_logdiag(K_f64_p, mask)
    dld_f64 = ld_p64 - ld_oracle_f64K
    row_err = dld_dev - dld_f64
    conc = {}
    for thr in (1e-3, 1e-4, 1e-5):
        sel = d_f64K < thr
        conc[f"d<{thr:g}"] = {
            "rows": int(sel.sum()),
            "err_sum": float(row_err[sel].sum()),
            "err_abs_sum": float(np.abs(row_err[sel]).sum()),
        }
    conc["all"] = {"rows": int(len(row_err)),
                   "err_abs_sum": float(np.abs(row_err).sum())}

    entry = {
        "covfun": covfun, "n": int(n), "range": rho, "nu": 0.75,
        "K_entry_err": {"max": float(kerr.max()),
                        "rms": float(np.sqrt((kerr**2).mean()))},
        "cond_var_d": {"min": float(d_f64K.min()),
                       "p1": float(np.percentile(d_f64K, 1)),
                       "median": float(np.median(d_f64K))},
        "logdiag_err_vs_devK": {"max": float(np.abs(e_chol).max()),
                                "sum": float(e_chol.sum())},
        "logdiag_err_total": {"max": float(np.abs(e_total).max()),
                              "sum": float(e_total.sum())},
        "proposal_logdet_diff_err": float(dld_dev.sum() - dld_f64.sum()),
        "proposal_logdet_diff_f64": float(dld_f64.sum()),
        "ratio_err_concentration": conc,
    }
    out[label] = entry
    print(json.dumps(entry, indent=1), flush=True)
    return entry


def clustered_layout(rng) -> np.ndarray:
    """20,000 uniform points in [0, 100]^2 and 20,000 copies of them
    jittered by N(0, 0.05^2), drawn from ``rng`` in the JAX script's
    order."""
    base = rng.uniform(0, 100, size=(20_000, 2))
    jitter = base[rng.integers(0, len(base), 20_000)] + rng.normal(
        size=(20_000, 2)) * 0.05
    return np.concatenate([base, jitter])


def probe(locs, device, out: dict) -> dict:
    """Both layouts: ``matern_sphere`` on the lon/lat ``locs`` (the
    Heavy-metals geometry) and ``matern_isotropic`` on
    :func:`clustered_layout`; fills and returns ``out``."""
    from nngp_tpu_torch.preprocess.dedupe import dedupe_and_match
    from nngp_tpu_torch.preprocess.graph import build_graph
    from nngp_tpu_torch.preprocess.ordering import reorder_locations

    graph, NN, _ = _common.sphere_graph(locs, "matern_sphere")
    probe_family("matern_sphere", graph, NN, "hm_matern_sphere", out, device)
    rng2 = np.random.default_rng(2)
    locs2 = clustered_layout(rng2)
    maps2 = dedupe_and_match(
        locs2, perm_fn=lambda L: reorder_locations(L, "maxmin", rng=rng2))
    graph2, NN2 = build_graph(maps2, m=5, covfun="matern_isotropic")
    probe_family("matern_isotropic", graph2, NN2, "synthetic_matern_iso", out,
                 device)
    return out


def parse_args(argv=None):
    return _common.parser(__doc__, "matern_probe.json").parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, out = _common.setup(args)
    from nngp_tpu_torch.utils import datasets

    print("backend:", out["backend"], out["device"], flush=True)
    probe(datasets.load_heavy_metals()[0], device, out)
    _common.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
