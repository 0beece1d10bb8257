"""Stationary covariance families and the shape-parameter transform.

Port of ``nngp_tpu/ops/covariance.py`` for the exponential families
(reference registry: mcmc_nngp_initialize.R:62-69).  Every family returns a
*correlation*: the variance is exp(log_scale) outside the kernel and the
nugget is log_noise_variance.

  exponential_isotropic   exp(-d / range)
  exponential_sphere      exp(-d / range), d = chordal distance on the unit
                          sphere (lon/lat degrees embedded in R^3)
  exponential_scaledim    exp(-||Delta x / ranges||)
  exponential_spacetime   exp(-||(Delta s / r1, Delta t / r2)||)

The Matérn families are not ported yet (ROADMAP M8) and raise
NotImplementedError.  ``nngp_tpu`` computes e^x with a software ``exp_acc``
because the TPU's builtin is inaccurate; here ``torch.exp`` is the
correctly rounded libm/CUDA exp, which is what that function emulates.
"""

from __future__ import annotations

import numpy as np
import torch

EXPONENTIAL_FAMILIES = (
    "exponential_isotropic",
    "exponential_sphere",
    "exponential_scaledim",
    "exponential_spacetime",
)


def require_supported(covfun: str) -> None:
    """Raise unless ``covfun`` is a family the port implements."""
    if covfun.startswith("matern"):
        raise NotImplementedError(
            f"{covfun}: the Matérn families are not ported to PyTorch yet "
            "(ROADMAP M8); use an exponential_* family")
    if covfun not in EXPONENTIAL_FAMILIES:
        raise ValueError(f"unknown covariance family {covfun!r}")


def shape_param_names(covfun: str, n_dims: int) -> list[str]:
    """Sampled-scale shape parameter names (mcmc_nngp_initialize.R:62-69).

    ``n_dims`` is the dimension of the *raw* location array (before any
    sphere embedding)."""
    require_supported(covfun)
    if covfun in ("exponential_isotropic", "exponential_sphere"):
        return ["log_range"]
    if covfun == "exponential_scaledim":
        return [f"log_range_{j+1}" for j in range(n_dims)]
    return ["log_range_1", "log_range_2"]


def shape_transform(names, sampled: torch.Tensor) -> torch.Tensor:
    """Sampled shape params [..., n_shape] -> natural scale: log_* -> exp
    (mcmc_nngp_update_Gaussian.R:67-71)."""
    for name in names:
        if not name.startswith("log"):
            raise NotImplementedError(
                f"shape parameter {name!r} belongs to a Matérn family "
                "(ROADMAP M8)")
    return torch.exp(sampled)


def n_range_groups(covfun: str, n_dims_embed: int) -> int:
    """Number of independently-ranged distance groups for ``covfun``:
    isotropic/sphere 1, scaledim one per coordinate, spacetime 2."""
    kind = covfun.split("_", 1)[1]
    if kind in ("isotropic", "sphere"):
        return 1
    if kind == "scaledim":
        return n_dims_embed
    if kind == "spacetime":
        return 2
    raise ValueError(kind)


def group_sqdist(coords: np.ndarray, covfun: str) -> np.ndarray:
    """Per-range-group squared distances [..., k, k, G] from coords
    [..., k, d'] — the host float64 precompute of the graph's
    ``nn_dist2`` (same layout as nngp_tpu's)."""
    kind = covfun.split("_", 1)[1]
    diff = coords[..., :, None, :] - coords[..., None, :, :]
    d2 = diff * diff                                   # [..., k, k, d']
    if kind in ("isotropic", "sphere"):
        return np.sum(d2, axis=-1)[..., None]
    if kind == "scaledim":
        return d2
    if kind == "spacetime":
        return np.concatenate(
            [np.sum(d2[..., :-1], axis=-1)[..., None], d2[..., -1:]], axis=-1
        )
    raise ValueError(kind)


def correlation_from_sqdist(covfun: str, d2g: torch.Tensor,
                            shape: torch.Tensor) -> torch.Tensor:
    """Correlations [C, n, k, k] from the graph's per-group squared
    distances d2g [n, k, k, G] and natural shape params [C, n_shape]."""
    require_supported(covfun)
    G = d2g.shape[-1]
    ranges = shape[:, :G]
    d2 = torch.sum(d2g / (ranges * ranges)[:, None, None, None, :], dim=-1)
    return torch.exp(-torch.sqrt(torch.clamp_min(d2, 0.0)))
