"""Workload loaders (copy of ``nngp_tpu.utils.datasets``).

- ``load_heavy_metals``: the reference's real-data workload — US heavy-metal
  (lead) measurements at 64,274 lon/lat sites with 14 covariates
  (Heavy_metals/processed_data.RDS of the reference repository, consumed by
  Heavy_metals/run_script.R:8-15), parsed from the RDS binary by
  ``nngp_tpu_torch.utils.rds``; falls back to ``synthetic_heavy_metals`` if
  the file is absent.
- ``synthetic_heavy_metals``: the same-shape stand-in (64,274 unique lon/lat
  sites over the US extent, 14 covariates).  Its y carries no spatial
  signal.
"""

from __future__ import annotations

import os

import numpy as np

# the reference repository checked out as reference/ beside the packages
DEFAULT_RDS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "reference", "Heavy_metals", "processed_data.RDS")


def load_heavy_metals(path: str = DEFAULT_RDS, allow_synthetic: bool = True):
    """Returns (observed_locs [n,2] lon/lat, observed_field [n], X_locs dict)."""
    if os.path.exists(path):
        from nngp_tpu_torch.utils.rds import read_rds

        d = read_rds(path)
        locs = d["observed_locs"]
        if isinstance(locs, dict) and "__matrix__" in locs:
            locs = locs["__matrix__"]
        y = np.asarray(d["observed_field"], dtype=np.float64)
        X = {
            k: v
            for k, v in d["X_locs"].items()
            if k != "__data.frame__"
        }
        return np.asarray(locs, dtype=np.float64), y, X
    if not allow_synthetic:
        raise FileNotFoundError(path)
    return synthetic_heavy_metals()


def synthetic_heavy_metals(n: int = 64274, p: int = 14, seed: int = 0):
    """Same-shape synthetic workload (US-extent lon/lat, p covariates)."""
    rng = np.random.default_rng(seed)
    lon = rng.uniform(-125, -67, n)
    lat = rng.uniform(25, 49, n)
    locs = np.stack([lon, lat], axis=1)
    X = {f"x{j}": rng.normal(size=n) for j in range(p)}
    beta = rng.normal(size=p) * 0.3
    xsum = sum(b * X[f"x{j}"] for j, b in enumerate(beta))
    y = 2.0 + xsum + rng.normal(size=n) * 0.8
    return locs, y, X
