"""The ancillary co-transform's error taken apart at Heavy-metals scale
(port of experiments/cotransform_probe.py; same record keys).

    python -m nngp_tpu_torch.experiments.cotransform_probe [--device cpu]

Chain: v = L_old (w - b0)  ->  x = level_solve(L_new, v)  ->
       w' = b0 + e^{dls/2} x ;   llr = -.5 prec * [sse(w') - sse(w)]

On the device against float64 oracles built from the same float32
factors:
  a. ``torch.exp`` on the device (the JAX script measures its software
     ``exp_acc``; this package uses the libm/CUDA exp, named in
     ``exp_op``);
  b. the off-diagonal factor error against the float64 factor of the same
     float32 squared distances;
  c. the error of v (``linv_mult``) against float64 of the device factors;
  d. the solve's arithmetic: ``level_solve`` against the float64 level
     solve of the same device factors and v;
  e. x against the full float64 chain (factor error included);
  f. the llr impact of the x error, against that chain and against the
     float64 chain from float64 coordinates, as the ratio audit does.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from nngp_tpu_torch.experiments import _common
from nngp_tpu_torch.experiments._oracles import f64_linv_from_K
from nngp_tpu_torch.ops.numpy_ref import np_solve_L

COVFUN = "exponential_sphere"
RHO, DLS = 0.03, 0.05


def probe(graph, NN, locs, y, device, out: dict) -> dict:
    """The probe on the host ``graph`` (NumPy leaves) with NNarray ``NN``,
    its reordered lon/lat ``locs`` and the observations ``y``; the device
    arithmetic on ``device``.  Fills and returns ``out``."""
    from nngp_tpu_torch.ops.numpy_ref import np_vecchia_linv
    from nngp_tpu_torch.ops.trisolve import level_solve
    from nngp_tpu_torch.ops.vecchia import linv_mult, vecchia_linv
    from nngp_tpu_torch.preprocess.coloring import dag_levels
    from nngp_tpu_torch.preprocess.ordering import lonlat_to_xyz

    rng = np.random.default_rng(0)
    f32 = torch.float32

    # a. exp on the device
    xs = np.linspace(-5, 5, 100000).astype(np.float32)
    got = _common.host(torch.exp(torch.from_numpy(xs).to(device)))
    rel = np.abs(got - np.exp(xs.astype(np.float64))) / np.exp(
        xs.astype(np.float64))
    out["exp_acc_rel_max"] = float(rel.max())
    out["exp_op"] = "torch.exp"

    g = graph.to(device)
    n = graph.n
    NN = np.asarray(NN)
    levels = dag_levels(NN)
    mask = NN >= 0
    ls = float(np.log(0.6 * np.var(y)))
    beta_0 = float(np.mean(y))
    prec = float(np.exp(-np.log(0.35 * np.var(y))))
    w = (beta_0 + rng.normal(size=n) * np.exp(0.5 * ls)).astype(np.float32)
    wd = torch.from_numpy(w).to(device)[None]

    lv_old = vecchia_linv(g, torch.tensor([[RHO]], dtype=f32, device=device))
    lv_new = vecchia_linv(g, torch.tensor([[RHO * 1.02]], dtype=f32,
                                          device=device))
    lvo, lvn = _common.host(lv_old[0]), _common.host(lv_new[0])

    # b. off-diagonal factor error against float64 from the float32 d2
    d2 = np.asarray(graph.nn_dist2)[..., 0].astype(np.float64)
    lv64 = {}
    for tag, r, lv in (("old", RHO, lvo), ("new", RHO * 1.02, lvn)):
        K64 = np.exp(-np.sqrt(np.maximum(d2, 0)) / np.float64(np.float32(r)))
        lv64[tag], _ = f64_linv_from_K(K64, mask)
        err = np.abs(lv - lv64[tag]) / np.maximum(np.abs(lv64[tag]), 1e-10)
        e = err[:, 1:][mask[:, 1:]]
        out[f"factor_offdiag_rel_{tag}"] = {
            "rms": float(np.sqrt((e ** 2).mean())), "max": float(e.max())}

    # c. v error
    v_d = linv_mult(lv_old, wd - np.float32(beta_0), g)
    v_dev = _common.host(v_d[0])
    vals = np.where(mask, (w - beta_0).astype(np.float64)[np.maximum(NN, 0)], 0)
    out["v_abs_err"] = _common.stats(v_dev - (lvo * vals).sum(1))

    # d. the solve's arithmetic: the same inputs in float64
    x_dev = _common.host(level_solve(lv_new, v_d, g)[0])
    out["solve_arith_err"] = _common.stats(
        x_dev - np_solve_L(lvn, NN, v_dev, levels))

    # e. the whole chain against float64 of the float32 squared distances
    x_orac = np_solve_L(lv64["new"], NN, (lv64["old"] * vals).sum(1),
                            levels)
    out["x_total_err"] = _common.stats(x_dev - x_orac)

    # f. the llr impact of the x error
    scale_f = np.exp(0.5 * DLS)
    lm = np.asarray(graph.locs_match)
    y64 = np.asarray(y, np.float64)

    def sse(field):
        r = y64 - field[lm]
        return r @ r

    w_dev = beta_0 + scale_f * x_dev
    w_orac = beta_0 + scale_f * x_orac
    out["llr_impact_of_x_err"] = float(-0.5 * prec * (sse(w_dev) - sse(w_orac)))
    coords64 = lonlat_to_xyz(np.asarray(locs, np.float64))
    lv_old_c = np_vecchia_linv(coords64, NN, COVFUN, np.array([RHO]))
    lv_new_c = np_vecchia_linv(coords64, NN, COVFUN, np.array([RHO * 1.02]))
    vals64 = np.where(mask, (w.astype(np.float64) - beta_0)[np.maximum(NN, 0)],
                      0)
    x_full = np_solve_L(lv_new_c, NN, (lv_old_c * vals64).sum(1), levels)
    w_full = beta_0 + scale_f * x_full
    out["llr_impact_vs_full_oracle"] = float(
        -0.5 * prec * (sse(w_dev) - sse(w_full)))
    out["x_vs_full_oracle"] = _common.stats(x_dev - x_full)
    return out


def parse_args(argv=None):
    return _common.parser(__doc__, "cotransform_probe.json").parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, out = _common.setup(args)
    from nngp_tpu_torch.utils import datasets

    print("backend:", out["backend"], out["device"], flush=True)
    locs, y, _ = datasets.load_heavy_metals()
    graph, NN, maps = _common.sphere_graph(locs, COVFUN)
    probe(graph, NN, maps.locs, y, device, out)
    print(json.dumps(out, indent=2))
    _common.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
