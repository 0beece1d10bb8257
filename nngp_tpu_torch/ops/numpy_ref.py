"""NumPy reference implementations of the core kernels.

Host copy of ``nngp_tpu/ops/numpy_ref.py``, used for the one-shot
per-chain prior field simulation at initialize time
(mcmc_nngp_initialize.R:196-208).  Mirrors ops/covariance.py and
ops/vecchia.py semantics.
"""

from __future__ import annotations

import numpy as np
import scipy.special
from scipy import sparse


def np_shape_transform(names, sampled):
    out = []
    for j, nm in enumerate(names):
        if nm.startswith("log"):
            out.append(np.exp(sampled[j]))
        elif nm.startswith("qlogis"):
            out.append(0.5 + 0.5 / (1.0 + np.exp(-sampled[j])))
        else:
            raise ValueError(nm)
    return np.asarray(out)


def np_correlation(covfun, coords, natural):
    """[..., k, d'] -> [..., k, k] correlation, matching ops.covariance."""
    kind = covfun.split("_", 1)[1]
    is_matern = covfun.startswith("matern")
    x = np.asarray(coords, dtype=np.float64)
    if kind in ("isotropic", "sphere"):
        scaled = x / natural[0]
        nu = natural[1] if is_matern else None
    elif kind == "scaledim":
        nd = x.shape[-1]
        scaled = x / natural[:nd]
        nu = natural[nd] if is_matern else None
    elif kind == "spacetime":
        r = np.concatenate([np.full(x.shape[-1] - 1, natural[0]), [natural[1]]])
        scaled = x / r
        nu = natural[2] if is_matern else None
    else:
        raise ValueError(kind)
    diff = scaled[..., :, None, :] - scaled[..., None, :, :]
    d = np.sqrt(np.maximum((diff * diff).sum(-1), 0.0))
    if is_matern:
        safe = np.maximum(d, 1e-10)
        K = (
            2.0 ** (1 - nu)
            / scipy.special.gamma(nu)
            * safe**nu
            * scipy.special.kv(nu, safe)
        )
        return np.where(d <= 1e-10, 1.0, K)
    return np.exp(-d)


def np_vecchia_linv(coords, NN, covfun, natural):
    """Batched compressed factor build (BLAS path), rows [n, m+1]."""
    NN = np.asarray(NN)
    mask = NN >= 0
    k = NN.shape[1]
    safe = np.maximum(NN, 0)
    pts = np.asarray(coords, dtype=np.float64)[safe]
    K = np_correlation(covfun, pts, natural)
    if k == 1:
        return np.ones((NN.shape[0], 1))
    return np_linv_rows_from_K(
        K, mask, 1e-5 if covfun.startswith("matern") else 1e-12)[0]


def np_linv_rows_from_K(K, mask, d_floor):
    """(rows [n, m+1], conditional variances d [n]) from neighbour-set
    correlations K [n, m+1, m+1] and the validity mask [n, m+1] (bool or
    0/1): the float64 twin of ops/vecchia.py:linv_rows_from_K."""
    mask = np.asarray(mask) > 0
    k = K.shape[-1]
    valid = mask[:, :, None] & mask[:, None, :]
    K = np.where(valid, K, np.eye(k)[None])
    Knn = K[:, 1:, 1:]
    kni = K[:, 1:, 0]
    L = np.linalg.cholesky(Knn)
    u = np.linalg.solve(L, kni[..., None])[..., 0]
    d = np.maximum(K[:, 0, 0] - (u * u).sum(-1), d_floor)
    b = np.linalg.solve(np.transpose(L, (0, 2, 1)), u[..., None])[..., 0]
    out = np.concatenate([1 / np.sqrt(d)[:, None], -b / np.sqrt(d)[:, None]], 1)
    return out * mask, d


def np_sparse_L(linv, NN):
    NN = np.asarray(NN)
    mask = NN >= 0
    n = NN.shape[0]
    rows = np.repeat(np.arange(n), mask.sum(1))
    return sparse.csr_matrix(
        (np.asarray(linv)[mask], (rows, NN[mask])), shape=(n, n)
    )


def np_solve_L(linv, NN, v, levels=None):
    """x = L^-1 v by the same level-scheduled substitution as the device
    kernel (ops/trisolve.py) — vectorized NumPy per DAG level.  (SuperLU on
    the triangular factor is ~1000x slower: full symbolic analysis.)"""
    from nngp_tpu_torch.preprocess.coloring import dag_levels

    NN = np.asarray(NN)
    linv = np.asarray(linv, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    n = NN.shape[0]
    if levels is None:
        levels = dag_levels(NN)
    mask = (NN[:, 1:] >= 0)
    parents = np.maximum(NN[:, 1:], 0)
    x = np.zeros(n)
    order = np.argsort(levels, kind="stable")
    bounds = np.searchsorted(levels[order], np.arange(levels.max() + 1))
    bounds = np.append(bounds, n)
    for l in range(levels.max() + 1):
        rows = order[bounds[l] : bounds[l + 1]]
        acc = (linv[rows, 1:] * mask[rows] * x[parents[rows]]).sum(axis=1)
        x[rows] = (v[rows] - acc) / linv[rows, 0]
    return x
