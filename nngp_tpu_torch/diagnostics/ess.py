"""Effective sample size, coda-parity.

Reference: ESS() at Scripts/mcmc_nngp_diagnose.R:107-118, which applies
coda::effectiveSize per chain per parameter and appends the column sums.
coda computes ESS = n * var(x) / spec0 where spec0 is the spectral density
at frequency zero from an AR(p) fit (R's ar(): Yule-Walker with AIC order
selection, order.max = min(n-1, floor(10*log10(n)))).  Reimplemented here
with Levinson-Durbin on host NumPy.
"""

from __future__ import annotations

import numpy as np


def _spectrum0_ar(x: np.ndarray) -> float:
    """Spectral density at frequency 0 via AIC-selected Yule-Walker AR fit."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 3 or np.var(x) == 0:
        return float(np.var(x))
    xc = x - x.mean()
    order_max = int(min(n - 1, np.floor(10 * np.log10(n))))
    # sample autocovariances, denominator n (R convention)
    acov = np.array(
        [np.dot(xc[: n - k], xc[k:]) / n for k in range(order_max + 1)]
    )
    if acov[0] <= 0:
        return float(acov[0])
    # Levinson-Durbin
    v = acov[0]
    best_order, best_aic = 0, n * np.log(v)
    best_phi_sum = 0.0
    phi = np.zeros(order_max + 1)
    prev = np.zeros(order_max + 1)
    for k in range(1, order_max + 1):
        acc = acov[k] - np.dot(prev[1:k], acov[1:k][::-1])
        refl = acc / v
        phi[k] = refl
        phi[1:k] = prev[1:k] - refl * prev[1:k][::-1]
        v = v * (1.0 - refl * refl)
        if v <= 0:
            break
        aic = n * np.log(v) + 2 * k
        if aic < best_aic:
            best_aic = aic
            best_order = k
            best_phi_sum = phi[1 : k + 1].sum()
        prev[: k + 1] = phi[: k + 1]
    if best_order == 0:
        return float(acov[0])
    # refit variance at the selected order is tracked implicitly above; redo
    v = acov[0]
    prev = np.zeros(best_order + 1)
    phi = np.zeros(best_order + 1)
    for k in range(1, best_order + 1):
        acc = acov[k] - np.dot(prev[1:k], acov[1:k][::-1])
        refl = acc / v
        phi[k] = refl
        phi[1:k] = prev[1:k] - refl * prev[1:k][::-1]
        v = v * (1.0 - refl * refl)
        prev[: k + 1] = phi[: k + 1]
    denom = (1.0 - phi[1 : best_order + 1].sum()) ** 2
    if denom <= 0:
        return float("inf")
    return float(v / denom)


def effective_size(x: np.ndarray) -> float:
    """coda::effectiveSize for a single series."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    var = np.var(x, ddof=1) if n > 1 else 0.0
    if var == 0:
        return 0.0
    spec0 = _spectrum0_ar(x)
    if not np.isfinite(spec0) or spec0 <= 0:
        return 0.0
    return float(n * var / spec0)


def ESS(records, burn_in: float = 0.5):
    """Per-chain-per-parameter ESS matrix + column sums
    (mcmc_nngp_diagnose.R:107-118)."""
    from nngp_tpu_torch.diagnostics.grb import _stack_nonfield_samples

    chains, names = _stack_nonfield_samples(records, burn_in)
    ess = np.array(
        [[effective_size(c[:, j]) for j in range(c.shape[1])] for c in chains]
    )
    ess = np.vstack([ess, ess.sum(axis=0)])
    return {"ESS": ess, "names": names}
