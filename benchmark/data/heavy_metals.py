"""Synthetic stand-in for the Heavy-metals data, made in memory from a seed.

The real data (64,274 lead measurements at 58,097 lon/lat sites over the
United States, 14 location covariates; Heavy_metals/run_script.R:8-15) is
not public in this repository.  This generator keeps its shapes:

- sites: ``n_sites`` unique lon/lat points, uniform over the configured
  extent, from the configuration's fixed ``geometry_seed`` (so the ordering,
  the neighbour sets, the colours and the level rows are the same in every
  run);
- observations: one at every site, and ``n_obs - n_sites`` more on sites
  already drawn (duplicated locations, as in the real data), in an order
  shuffled by the geometry seed;
- covariates: ``n_covariates`` standard normal location covariates a site,
  repeated for each observation there;
- a latent field drawn from an ``exponential_sphere`` Vecchia prior (random
  ordering, up to ``m`` earlier neighbours among each site's 64 nearest,
  chordal distance on the unit sphere)
  with the configured truth: scale, range (km over the Earth's radius),
  noise variance and intercept;
- y = field + X beta + noise.

The covariates, beta, the field's normals, the noise and the fit's seed
come from the run's seed.  Nothing is written to disk.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.sparse.linalg import spsolve_triangular
from scipy.spatial import cKDTree

EARTH_RADIUS_KM = 6371.0


def lonlat_to_xyz(locs):
    """(lon, lat) in degrees -> points on the unit sphere."""
    lon, lat = np.deg2rad(locs[:, 0]), np.deg2rad(locs[:, 1])
    cl = np.cos(lat)
    return np.stack([cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)], 1)


def _stream(seed: int, name: str) -> np.random.Generator:
    """An independent generator for one use of one seed."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed), sum(map(ord, name)), len(name)]))


def geometry(cfg: dict):
    """(unique site lon/lat [n_sites, 2], the site of each observation
    [n_obs]) from the configuration's geometry seed."""
    g = cfg["generator"]
    rng = np.random.default_rng(int(g["geometry_seed"]))
    n_sites, n_obs = int(cfg["n_sites"]), int(cfg["n_obs"])
    lon = rng.uniform(*g["lon_range"], n_sites)
    lat = rng.uniform(*g["lat_range"], n_sites)
    site_of_obs = np.concatenate(
        [np.arange(n_sites), rng.integers(0, n_sites, n_obs - n_sites)])
    rng.shuffle(site_of_obs)
    return np.stack([lon, lat], 1), site_of_obs


def _earlier_neighbours(x, m, k=64):
    """[n, m] indices of up to m earlier points among each point's k
    nearest, nearest first (-1 where there are fewer): a valid conditioning
    set of a Vecchia DAG, found with one k-d tree query."""
    n = len(x)
    _, j = cKDTree(x).query(x, k=min(k, n))
    earlier = j < np.arange(n)[:, None]
    pos = np.cumsum(earlier, 1)
    sel = earlier & (pos <= m)
    rows, cols = np.nonzero(sel)
    nn = np.full((n, m), -1, dtype=np.int64)
    nn[rows, pos[rows, cols] - 1] = j[rows, cols]
    return nn


def vecchia_field(xyz, rng_order, z, scale, rng_range, m):
    """A zero-mean exponential Vecchia field: L x = z with L the inverse
    Cholesky factor under a random ordering (its permutation from
    ``rng_order``), scaled by sqrt(scale)."""
    n = len(xyz)
    perm = rng_order.permutation(n)
    x = xyz[perm]
    nn = _earlier_neighbours(x, m)
    idx = np.concatenate([np.arange(n)[:, None], nn], 1)        # [n, m+1]
    valid = idx >= 0
    pts = x[np.maximum(idx, 0)]
    d = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1))
    K = np.exp(-d / rng_range)
    vv = valid[:, :, None] & valid[:, None, :]
    K = np.where(vv, K, np.eye(m + 1)[None])
    Lc = np.linalg.cholesky(K[:, 1:, 1:])
    u = np.linalg.solve(Lc, K[:, 1:, :1])[..., 0]
    dvar = np.maximum(1.0 - (u * u).sum(1), 1e-12)
    b = np.linalg.solve(np.transpose(Lc, (0, 2, 1)), u[..., None])[..., 0]
    rows = np.concatenate([np.ones((n, 1)), -b], 1) / np.sqrt(dvar)[:, None]
    L = sparse.csr_matrix((rows[valid], (np.repeat(np.arange(n), valid.sum(1)),
                                         idx[valid])), shape=(n, n))
    w = spsolve_triangular(L, z, lower=True)
    out = np.empty(n)
    out[perm] = np.sqrt(scale) * w
    return out


def make(cfg: dict, seed: int) -> dict:
    """The run's data: observed_locs [n_obs, 2], observed_field [n_obs],
    X_locs {name: [n_obs]}, and the truth it was drawn from."""
    g = cfg["generator"]
    locs, site_of_obs = geometry(cfg)
    n_sites, p = len(locs), int(cfg["n_covariates"])
    X_site = _stream(seed, "covariates").normal(size=(n_sites, p))
    beta = _stream(seed, "beta").normal(size=p) * float(g["beta_sd"])
    truth = g["truth"]
    rng_range = float(truth["range_km"]) / EARTH_RADIUS_KM
    field = vecchia_field(lonlat_to_xyz(locs), _stream(g["geometry_seed"],
                                                       "field order"),
                          _stream(seed, "field").normal(size=n_sites),
                          float(truth["scale"]), rng_range, int(g["field_m"]))
    noise = _stream(seed, "noise").normal(size=len(site_of_obs)) * np.sqrt(
        float(truth["noise_variance"]))
    X = X_site[site_of_obs]
    y = float(truth["beta_0"]) + field[site_of_obs] + X @ beta + noise
    return {
        "observed_locs": locs[site_of_obs],
        "observed_field": y,
        "X_locs": {f"x{j + 1}": X[:, j] for j in range(p)},
        "beta": beta,
    }
