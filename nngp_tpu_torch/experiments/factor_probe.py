"""Factor-build error of the float32 device path at Heavy-metals scale,
against float64 oracles built from the same float32 ``nn_dist2`` (port of
experiments/factor_probe.py; same record keys).

    python -m nngp_tpu_torch.experiments.factor_probe [--device cpu]

For theta (range 0.03 on the unit sphere) and a proposal-sized step
theta' = theta e^0.05, ``exponential_sphere``, m = 5:

  1. K-entry error: ``correlation_from_sqdist`` on the device against the
     float64 exp of the same float32 squared distances;
  2. the Cholesky error: the device factor rows of the device K
     (``linv_rows_from_K``, the K-input kernel on a card) against the
     float64 Cholesky of the device K; the K-entry error carried through
     the Cholesky; the total: the device ``vecchia_linv`` (one fused
     ``factor_build`` launch on a card, K never written) against the
     float64 factor of the float64 K;
  3. the quantiles of the float64 conditional variances d_i;
  4. ``logdet_ratio_err``: sum_i [logd(theta') - logd(theta)], device
     against float64 (what the sufficient MH ratio consumes).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from nngp_tpu_torch.experiments import _common
from nngp_tpu_torch.experiments._oracles import f64_linv_from_K

COVFUN = "exponential_sphere"
RHO, STEP = 0.03, 0.05


def probe(graph, device, out: dict) -> dict:
    """The probe on ``graph`` (host, NumPy leaves: its ``nn_dist2`` and
    ``nn_mask`` are read there) with the device arithmetic on ``device``;
    fills and returns ``out``."""
    from nngp_tpu_torch.ops.covariance import correlation_from_sqdist
    from nngp_tpu_torch.ops.vecchia import linv_rows_from_K, vecchia_linv

    d2_f32 = np.asarray(graph.nn_dist2)            # [n, k, k, 1] f32
    mask = np.asarray(graph.nn_mask)
    g = graph.to(device)
    out.update(n=int(graph.n), rho=RHO)
    for tag, r in (("theta", RHO), ("theta_prime", RHO * np.exp(STEP))):
        nat32 = torch.tensor([[r]], dtype=torch.float32, device=device)
        K_t = correlation_from_sqdist(COVFUN, g.nn_dist2, nat32)
        K_dev = _common.host(K_t[0])
        K_64 = np.exp(-np.sqrt(np.maximum(d2_f32[..., 0].astype(np.float64),
                                          0.0)) / np.float64(np.float32(r)))
        ek = np.abs(K_dev - K_64)[mask[:, :, None] * mask[:, None, :] > 0]
        out[f"K_entry_abs_err_{tag}"] = _common.stats(ek)

        linv_dev = _common.host(vecchia_linv(g, nat32)[0])
        rows_devK = _common.host(linv_rows_from_K(K_t, g.nn_mask,
                                                  g.d_floor)[0])
        linv_from_devK, _ = f64_linv_from_K(K_dev, mask)
        linv_64, d_64 = f64_linv_from_K(K_64, mask)
        logd_dev = np.log(linv_dev[:, 0])
        logd_from_devK = np.log(linv_from_devK[:, 0])
        logd_64 = np.log(linv_64[:, 0])
        for nm, e in (("chol", np.log(rows_devK[:, 0]) - logd_from_devK),
                      ("kentry", logd_from_devK - logd_64),
                      ("total", logd_dev - logd_64)):
            out[f"logdiag_{nm}_{tag}"] = {**_common.stats(e),
                                          "sum": float(e.sum())}
        out[f"d_quantiles_{tag}"] = {
            q: float(np.quantile(d_64, qq))
            for q, qq in (("q01", 0.01), ("q10", 0.10), ("q50", 0.50),
                          ("min", 0.0))
        }
        if tag == "theta":
            logd_dev_0, logd_64_0 = logd_dev, logd_64
        else:
            out["logdet_ratio_err"] = float((logd_dev - logd_dev_0).sum()
                                            - (logd_64 - logd_64_0).sum())
    return out


def parse_args(argv=None):
    return _common.parser(__doc__, "factor_probe.json").parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, out = _common.setup(args)
    from nngp_tpu_torch.utils import datasets

    print("backend:", out["backend"], out["device"], flush=True)
    locs, _, _ = datasets.load_heavy_metals()
    graph, _, _ = _common.sphere_graph(locs, COVFUN)
    probe(graph, device, out)
    print(json.dumps(out, indent=2))
    _common.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
