"""The plain reference of the fit's set-up: what ``initialize`` derives from
the raw data, worked out again.

- the dedupe map: unique locations in first-occurrence order, the
  observation -> location map (mcmc_nngp_initialize.R:26-91);
- the maxmin ordering: first the site nearest the centroid, then each site
  farthest (chordal, on the unit sphere) from those already taken (GpGp's
  order_maxmin);
- the ordered neighbour sets: the m nearest earlier sites, by brute force;
- the moralized graph and its first-fit greedy colouring in site order
  (Scripts/Coloring.R:2-20);
- the DAG levels of the triangular solve;
- the centred design and its factors, the support box, and the
  overdispersed initial states (mcmc_nngp_initialize.R:116-209), drawn
  from the fit's seed in the recipe's order.

Plain NumPy and PyTorch; the heavy loops run on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model


def lonlat_to_xyz(locs):
    lon, lat = np.deg2rad(locs[:, 0]), np.deg2rad(locs[:, 1])
    cl = np.cos(lat)
    return np.stack([cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)], 1)


def dedupe(observed_locs):
    """(unique locations in first-occurrence order [n0, 2], the unique
    index of each observation [n_obs])."""
    obs = np.asarray(observed_locs, dtype=np.float64)
    _, first, inverse = np.unique(obs, axis=0, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return obs[first[order]], rank[inverse.reshape(-1)]


def maxmin_order(x, device):
    """The exact maxmin permutation of points x [n, d] (float64)."""
    xt = torch.as_tensor(x, dtype=torch.float64, device=device)
    n = xt.shape[0]

    def sqdist(p):
        d = xt - p
        return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]

    centroid = torch.as_tensor(np.asarray(x).mean(0), device=device)
    first = torch.argmin(sqdist(centroid))
    perm = torch.empty(n, dtype=torch.int64, device=device)
    perm[0] = first
    mind = sqdist(xt[first])
    mind[first] = -torch.inf
    for k in range(1, n):
        nxt = torch.argmax(mind)
        perm[k] = nxt
        torch.minimum(mind, sqdist(xt[nxt]), out=mind)
        mind[nxt] = -torch.inf
    return perm.cpu().numpy()


def ordered_neighbours(x, m, device, block=512):
    """[n, m+1] rows [i, the m nearest earlier sites nearest first] (-1
    padding), by brute force over the prefix."""
    xt = torch.as_tensor(x, dtype=torch.float64, device=device)
    n = xt.shape[0]
    NN = torch.full((n, m + 1), -1, dtype=torch.int64, device=device)
    NN[:, 0] = torch.arange(n, device=device)
    for lo in range(1, n, block):
        hi = min(lo + block, n)
        diff = xt[lo:hi, None, :] - xt[None, :hi, :]
        d = (diff * diff).sum(-1)
        later = (torch.arange(hi, device=device)[None]
                 >= torch.arange(lo, hi, device=device)[:, None])
        d[later] = torch.inf
        k = min(m, hi - 1)
        val, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
        idx[torch.isinf(val)] = -1
        NN[lo:hi, 1:1 + k] = idx
    return NN.cpu().numpy()


def moral_edges(NN):
    """Sorted unique undirected edges (r < c) [E, 2] of the moralized DAG:
    every pair of a row's valid entries."""
    n, k = NN.shape
    a, b = np.triu_indices(k, 1)
    r, c = NN[:, a].ravel(), NN[:, b].ravel()
    ok = (r >= 0) & (c >= 0)
    lo, hi = np.minimum(r[ok], c[ok]), np.maximum(r[ok], c[ok])
    key = np.unique(lo.astype(np.int64) * n + hi)
    return np.stack([key // n, key % n], 1)


def greedy_colours(n, edges):
    """First-fit colour of each site in site order."""
    r = np.concatenate([edges[:, 0], edges[:, 1]])
    c = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(r, kind="stable")
    ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    nbr = c[order].tolist()
    ptr = ptr.tolist()
    colours = [-1] * n
    for i in range(n):
        used = {colours[j] for j in nbr[ptr[i]:ptr[i + 1]] if j < i}
        col = 0
        while col in used:
            col += 1
        colours[i] = col
    return np.asarray(colours, dtype=np.int64)


def dag_levels(NN):
    """Depth of each site in the DAG of its parents."""
    parents = NN[:, 1:]
    valid = parents >= 0
    safe = np.maximum(parents, 0)
    level = np.zeros(NN.shape[0], dtype=np.int64)
    while True:
        new = np.maximum(np.where(valid, level[safe], -1).max(1) + 1, 0)
        if np.array_equal(new, level):
            return level
        level = new


def design(X_cols):
    """Centred design [n_obs, p], solve([1 X]'[1 X]) and its lower
    Cholesky factor."""
    X = np.stack(X_cols, 1)
    X = X - X.mean(0)
    X1 = np.concatenate([np.ones((len(X), 1)), X], 1)
    s = np.linalg.inv(X1.T @ X1)
    return X, s, np.linalg.cholesky(s)


def derive(data: dict, covfun: str, m: int, device) -> dict:
    """Everything the reference derives from the raw data before a single
    iteration: the ordering, maps, neighbour sets, colours, levels, design
    and the model's tables (``model.Model``)."""
    locs0, match0 = dedupe(data["observed_locs"])
    xyz0 = lonlat_to_xyz(locs0)
    perm = maxmin_order(xyz0, device)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    locs = locs0[perm]
    locs_match = inv[match0]
    xyz = xyz0[perm]
    NN = ordered_neighbours(xyz, m, device)
    edges = moral_edges(NN)
    colours = greedy_colours(len(locs), edges)
    y = np.asarray(data["observed_field"], dtype=np.float64)
    X, s1, c1 = design([np.asarray(v, dtype=np.float64)
                        for v in data["X_locs"].values()])
    n_obs = len(y)
    first_obs = np.full(len(locs), n_obs, dtype=np.int64)
    np.minimum.at(first_obs, locs_match, np.arange(n_obs))
    mdl = model.Model.build(
        covfun=covfun, xyz=xyz, NN=NN, edges=edges, colours=colours,
        levels=dag_levels(NN), locs_match=locs_match, y=y, X=X,
        X_locs_u=X[first_obs], solve_1XT1X=s1, chol_1XT1X=c1, device=device)
    return {"locs": locs, "locs_match": locs_match, "NN": NN,
            "colours": colours, "model": mdl, "X": X}


def initial_states(derived: dict, data: dict, covfun: str, seed: int,
                   chains, device, mdl=None):
    """The recipe's initial states of ``chains`` (sorted chain ids):
    {leaf: [len(chains), ...]} (mcmc_nngp_initialize.R:143-209; the
    port's and nngp_tpu's random stream: one NumPy generator of the fit's
    seed, chain by chain)."""
    mdl = derived["model"] if mdl is None else mdl
    X = derived["X"]
    y = np.asarray(data["observed_field"], dtype=np.float64)
    rng = np.random.default_rng(seed)
    X1 = np.concatenate([np.ones((len(y), 1)), X], 1)
    coef, *_ = np.linalg.lstsq(X1, y, rcond=None)
    resid = y - X1 @ coef
    sigma2 = float(resid @ resid) / max(len(y) - X1.shape[1], 1)
    vchol = np.linalg.cholesky(sigma2 * np.linalg.inv(X1.T @ X1))
    var_resid = float(np.var(resid, ddof=1))
    kc = derived["model"].xyz_np[:100]
    maxd = np.sqrt(((kc[:, None] - kc[None]) ** 2).sum(-1)).max()
    names = model.shape_names(covfun)
    out, want = [], set(int(c) for c in chains)
    for c in range(max(want) + 1):
        shape = [rng.normal() if nm.startswith("qlogis")
                 else np.log(maxd) - np.log(rng.integers(20, 201))
                 for nm in names]
        perturb = vchol @ rng.normal(size=X1.shape[1])
        ls = float(np.log(rng.beta(10, 10) * var_resid))
        lnv = float(np.log(rng.beta(10, 10) * var_resid))
        z = rng.normal(size=mdl.n)
        if c in want:
            out.append(dict(beta_0=coef[0] + perturb[0],
                            beta=coef[1:] + perturb[1:], log_scale=ls,
                            log_noise_variance=lnv, shape=np.asarray(shape),
                            z=z))
    st = {k: torch.as_tensor(np.stack([np.asarray(o[k]) for o in out]),
                             device=device).to(mdl.dtype)
          for k in out[0]}
    linv = mdl.factor(model.natural(covfun, st["shape"]))
    st["field"] = mdl.store_field(st["beta_0"][:, None] + torch.sqrt(
        torch.exp(st["log_scale"]))[:, None] * mdl.solve(linv, st.pop("z")))
    return st
