"""Name the eigen-direction behind a fit's Multivariate-PSRF plateau (port
of experiments/hm_mpsrf.py; the same record keys).

    python -m nngp_tpu_torch.experiments.hm_mpsrf FIT [--device cpu]

Loads a saved fit (``nngp_tpu_torch.load``: this package's or
``nngp_tpu.save``'s file), rebuilds W (mean within-chain covariance) and B
(between-chain covariance of means) as the diagnostic does
(Scripts/mcmc_nngp_diagnose.R:13-16), and reports:

- the MPSRF under the floored inverse (``diagnostics/grb.py``) and under
  the reference's plain-solve semantics (``grb_guard.mpsrf_reference``;
  identical whenever cond(W) < 1e8);
- the principal eigenvector of W^-1 B, loadings scaled by within-chain sd
  (which parameter combination mixes slowly or disagrees across chains);
- W's most correlated parameter pairs, and the MPSRF without the
  top-loading parameter: if dropping one parameter collapses it towards 1,
  the plateau is a (near-)pairwise direction, not a diffuse one.
"""

from __future__ import annotations

import json

import numpy as np

from nngp_tpu_torch.experiments import _common
from nngp_tpu_torch.experiments.grb_guard import (mpsrf_reference,
                                                  principal_direction)


def analyse(mc, path: str) -> dict:
    """The record of a loaded fit ``mc`` (saved at ``path``)."""
    from nngp_tpu_torch.diagnostics.grb import (Gelman_Rubin_Brooks,
                                                _stack_nonfield_samples)

    chains, names = _stack_nonfield_samples(mc.records, burn_in=0.5)
    ours = Gelman_Rubin_Brooks(mc.records, burn_in=0.5)
    ref, W, B = mpsrf_reference(chains)
    pdir = principal_direction(chains, names=names)

    sd = np.sqrt(np.diag(W))
    R = W / np.outer(sd, sd)
    iu = np.triu_indices_from(R, k=1)
    order = np.argsort(-np.abs(R[iu]))[:6]
    top_corr = [
        {"pair": [names[iu[0][k]], names[iu[1][k]]],
         "corr": round(float(R[iu][k]), 4)}
        for k in order
    ]
    out = {
        "fit": path,
        "iterations": int(mc.iterations),
        "mpsrf_ours": round(float(ours["R_hat"][0]), 3),
        "mpsrf_reference_semantics": round(float(ref), 3),
        "max_univariate": round(float(np.max(ours["R_hat"][1:])), 4),
        "cond_W": float(np.linalg.cond(W)),
        "principal_direction": pdir,
        "top_W_correlations": top_corr,
    }
    lead = pdir["loadings"][0]["param"]
    keep = [j for j, nm in enumerate(names) if nm != lead]
    ref_sub, _, _ = mpsrf_reference([c[:, keep] for c in chains])
    out["mpsrf_without_top_param"] = {"dropped": lead,
                                      "mpsrf": round(float(ref_sub), 3)}
    return out


def parse_args(argv=None):
    ap = _common.parser(__doc__, "hm_mpsrf.json")
    ap.add_argument("fit", nargs="?", default="hm_fit.pkl",
                    help="a saved fit (default hm_fit.pkl)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    import nngp_tpu_torch

    args = parse_args(argv)
    device, out = _common.setup(args)
    out.update(analyse(nngp_tpu_torch.load(args.fit, device=device),
                       args.fit))
    print(json.dumps(out, indent=1, default=float))
    _common.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
