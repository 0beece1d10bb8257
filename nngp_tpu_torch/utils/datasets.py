"""Workloads the port can generate on its own.

``synthetic_heavy_metals`` is a copy of ``nngp_tpu.utils.datasets``'s: the
same-shape stand-in for the Heavy-metals data (64,274 unique lon/lat sites
over the US extent, 14 covariates).  Its y carries no spatial signal.
"""

from __future__ import annotations

import numpy as np


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
