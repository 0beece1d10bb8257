"""The device's basic float32 ops, the cancellation in z = L w and the
error of the per-term sufficient log-ratio at Heavy-metals scale (port of
experiments/op_probe.py; same record keys).

    python -m nngp_tpu_torch.experiments.op_probe [--device cpu]

The JAX script sums the per-term ratio with ``ops/reductions.py``'s
double-float ``pairwise_df_sum``; this package sums with
``ops/vecchia.py:sum64`` (float64 accumulation, float32 result), as its
``nngp_loglik_diff`` does, and names it in ``sum_op``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from nngp_tpu_torch.experiments import _common

COVFUN = "exponential_sphere"
RHO, STEP = 0.03, 0.05
SUM_OP = "ops/vecchia.py:sum64 (float64 accumulation, float32 result)"


def op_accuracy(rng, device, out: dict) -> dict:
    """div, sqrt, rsqrt, log on |N(0, 1)| * 300 + 1e-4 and log1p on
    N(0, 0.02^2), 200,000 float32 values each, against float64."""
    x = np.abs(rng.normal(size=200000)).astype(np.float32) * 300 + 1e-4
    xd = torch.from_numpy(x).to(device)
    for name, dev, ora in [
        ("div", lambda a: 1.0 / a, lambda a: 1.0 / a),
        ("sqrt", torch.sqrt, np.sqrt),
        ("rsqrt", torch.rsqrt, lambda a: 1.0 / np.sqrt(a)),
        ("log", torch.log, np.log),
    ]:
        got = _common.host(dev(xd))
        want = ora(x.astype(np.float64))
        rel = np.abs(got - want) / np.abs(want)
        out[f"op_{name}_rel"] = {"max": float(rel.max()),
                                 "rms": float(np.sqrt((rel**2).mean()))}
    u = (rng.normal(size=200000) * 0.02).astype(np.float32)
    got = _common.host(torch.log1p(torch.from_numpy(u).to(device)))
    err = np.abs(got - np.log1p(u.astype(np.float64)))
    out["op_log1p_abs"] = {"max": float(err.max())}
    return out


def probe(graph, NN, y, rng, device, out: dict) -> dict:
    """z = L w and the per-term sufficient ratio on the host ``graph``
    (NumPy leaves) with NNarray ``NN``, the field drawn from ``rng`` after
    :func:`op_accuracy`'s draws; fills and returns ``out``."""
    from nngp_tpu_torch.ops.vecchia import linv_mult, sum64, vecchia_linv

    g = graph.to(device)
    n = graph.n
    NN = np.asarray(NN)
    mask = NN >= 0
    ls = float(np.log(0.6 * np.var(y)))
    w = (rng.normal(size=n) * np.exp(0.5 * ls)).astype(np.float32)
    wd = torch.from_numpy(w).to(device)[None]
    f32 = torch.float32
    lv_old = vecchia_linv(g, torch.tensor([[RHO]], dtype=f32, device=device))
    lv_new = vecchia_linv(g, torch.tensor([[RHO * np.exp(STEP)]], dtype=f32,
                                          device=device))
    lv_old_h, lv_new_h = _common.host(lv_old[0]), _common.host(lv_new[0])

    zo = linv_mult(lv_old, wd, g)
    z_dev = _common.host(zo[0])
    vals = np.where(mask, w.astype(np.float64)[np.maximum(NN, 0)], 0.0)
    z_64 = (lv_old_h * vals).sum(axis=1)
    out["z_abs_err"] = _common.stats(z_dev - z_64)
    out["z_scale"] = {"rms": float(np.sqrt((z_64**2).mean()))}
    canc = np.abs(lv_old_h * vals).sum(axis=1)
    out["z_cancellation"] = {"q99": float(np.quantile(canc, 0.99)),
                             "max": float(canc.max())}

    # the per-term sufficient ratio, device against float64 of the device
    # factors and field
    c_old = np.exp(-ls)
    c_new = np.exp(-(ls + STEP))
    zn = linv_mult(lv_new, wd, g)
    a, b = lv_new[..., 0], lv_old[..., 0]
    terms = (torch.log1p((a - b) / b)
             - 0.5 * (zn * zn * float(np.float32(c_new))
                      - zo * zo * float(np.float32(c_old))))
    s_dev = float(sum64(terms)[0])
    terms_dev = _common.host(terms[0])
    z_new_64 = (lv_new_h * vals).sum(axis=1)
    terms_64 = (np.log(lv_new_h[:, 0] / lv_old_h[:, 0])
                - 0.5 * (z_new_64**2 * c_new - z_64**2 * c_old))
    dt = terms_dev - terms_64
    out["terms_abs_err"] = {**_common.stats(dt), "sum": float(dt.sum())}
    out["sum_err"] = float(s_dev - terms_64.sum())
    out["sum_op"] = SUM_OP
    return out


def parse_args(argv=None):
    return _common.parser(__doc__, "op_probe.json").parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, out = _common.setup(args)
    from nngp_tpu_torch.utils import datasets

    print("backend:", out["backend"], out["device"], flush=True)
    rng = np.random.default_rng(0)
    op_accuracy(rng, device, out)
    print(json.dumps({k: v for k, v in out.items() if k.startswith("op_")},
                     indent=2), flush=True)
    locs, y, _ = datasets.load_heavy_metals()
    graph, NN, _ = _common.sphere_graph(locs, COVFUN)
    probe(graph, NN, y, rng, device, out)
    print(json.dumps(out, indent=2))
    _common.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
