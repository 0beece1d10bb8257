"""Float64 host oracles shared by the numeric audits (NumPy/SciPy).

Copies of the oracles that the JAX audit scripts define for themselves,
built on this package's ``ops/numpy_ref.py``:

- ``f64_linv_from_K`` (experiments/factor_probe.py:38): the factor rows
  and conditional variances of given correlations, d floored at 1e-12;
- ``f64_matern_from_d2g``, ``f64_linv_logdiag``
  (experiments/matern_probe.py:43-70): the Matérn correlation of the
  graph's squared distances by ``scipy.special.kv``, and the factor's
  log-diagonal with the Matérn floor d >= 1e-5.

The JAX scripts' ``np_solve_L_f64`` (experiments/cotransform_probe.py:33)
is ``ops/numpy_ref.py:np_solve_L``, used as it is.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gamma as sp_gamma, kv as sp_kv

from nngp_tpu_torch.ops.numpy_ref import np_linv_rows_from_K


def f64_linv_from_K(K, mask):
    """Float64 oracle of ``linv_rows_from_K``: (rows [n, m+1], d [n])."""
    return np_linv_rows_from_K(np.asarray(K, dtype=np.float64), mask, 1e-12)


def f64_matern_from_d2g(d2g, ranges, nu):
    """Float64 oracle of ``correlation_from_sqdist`` for a Matérn family:
    d2g [n, k, k, G] (the graph's float32 squared distances), the G
    ranges and the smoothness nu."""
    d2 = (d2g.astype(np.float64) / (np.asarray(ranges, np.float64) ** 2)).sum(-1)
    d = np.sqrt(np.maximum(d2, 0.0))
    safe = np.maximum(d, 1e-8)
    val = (2.0 ** (1.0 - nu) / sp_gamma(nu)) * safe**nu * sp_kv(nu, safe)
    return np.where(d <= 1e-8, 1.0, val)


def f64_linv_logdiag(K, mask, d_floor=1e-5):
    """(log-diagonal -0.5 log d [n], d [n]) of the factor of K in float64,
    with the device build's family-aware floor on d (``VecchiaGraph.d_floor``
    of the Matérn families)."""
    _, d = np_linv_rows_from_K(np.asarray(K, dtype=np.float64), mask, d_floor)
    return -0.5 * np.log(d), d
