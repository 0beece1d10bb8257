"""Stationary covariance families and the shape-parameter transform.

Port of ``nngp_tpu/ops/covariance.py`` (reference registry:
mcmc_nngp_initialize.R:62-69).  Every family returns a *correlation*: the
variance is exp(log_scale) outside the kernel and the nugget is
log_noise_variance.

  exponential_isotropic   exp(-d / range)
  exponential_sphere      exp(-d / range), d = chordal distance on the unit
                          sphere (lon/lat degrees embedded in R^3)
  exponential_scaledim    exp(-||Delta x / ranges||)
  exponential_spacetime   exp(-||(Delta s / r1, Delta t / r2)||)
  matern_isotropic        2^(1-nu)/Gamma(nu) (d/r)^nu K_nu(d/r)
  matern_sphere           same, chordal sphere distance
  matern_scaledim         matern on ||Delta x / ranges||
  matern_spacetime        matern on ||(Delta s/r1, Delta t/r2)||

Shape transforms: "log_*" parameters enter through exp(); the Matérn
"qlogis_smoothness" through nu = 0.5 + 0.5*sigmoid(s), the sampling-time
transform of the reference (mcmc_nngp_update_Gaussian.R:70), used for all
internal computation as in ``nngp_tpu``.

``nngp_tpu`` computes e^x with a software ``exp_acc`` because the TPU's
builtin is inaccurate; here ``torch.exp`` is the correctly rounded
libm/CUDA exp, which is what that function emulates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nngp_tpu_torch.ops.bessel import _beschb, kv

COVFUN_FAMILIES = (
    "exponential_isotropic",
    "exponential_sphere",
    "exponential_scaledim",
    "exponential_spacetime",
    "matern_isotropic",
    "matern_sphere",
    "matern_scaledim",
    "matern_spacetime",
)


def require_supported(covfun: str) -> None:
    """Raise ValueError unless ``covfun`` is a known family."""
    if covfun not in COVFUN_FAMILIES:
        raise ValueError(f"unknown covariance family {covfun!r}")


def shape_param_names(covfun: str, n_dims: int) -> list[str]:
    """Sampled-scale shape parameter names (mcmc_nngp_initialize.R:62-69).

    ``n_dims`` is the dimension of the *raw* location array (before any
    sphere embedding)."""
    require_supported(covfun)
    family, kind = covfun.split("_", 1)
    if kind in ("isotropic", "sphere"):
        names = ["log_range"]
    elif kind == "scaledim":
        names = [f"log_range_{j+1}" for j in range(n_dims)]
    else:
        names = ["log_range_1", "log_range_2"]
    return names + (["qlogis_smoothness"] if family == "matern" else [])


def shape_transform(names, sampled: torch.Tensor) -> torch.Tensor:
    """Sampled shape params [..., n_shape] -> natural scale: log_* -> exp,
    qlogis_* -> 0.5 + 0.5 sigmoid (mcmc_nngp_update_Gaussian.R:67-71)."""
    out = []
    for j, name in enumerate(names):
        if name.startswith("log"):
            out.append(torch.exp(sampled[..., j]))
        elif name.startswith("qlogis"):
            out.append(0.5 + 0.5 * torch.sigmoid(sampled[..., j]))
        else:
            raise ValueError(name)
    return torch.stack(out, dim=-1)


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
    distances d2g [n, k, k, G] and natural shape params [C, n_shape]: the
    G ranges first, then (Matérn) the smoothness nu = shape[:, G]."""
    require_supported(covfun)
    G = d2g.shape[-1]
    ranges = shape[:, :G]
    d2 = torch.sum(d2g / (ranges * ranges)[:, None, None, None, :], dim=-1)
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    if covfun.startswith("matern"):
        return _matern(d, shape[:, G][:, None, None, None])
    return torch.exp(-d)


_MATERN_SMALL_X = 0.29
_MATERN_SERIES_K = 6


def _matern_comp_small(x: torch.Tensor, nu) -> torch.Tensor:
    """1 - C(x) for the Matérn correlation at small scaled distance x by the
    ascending power series, accurate relative to its own small size (the
    product x^nu K_nu(x) is accurate only to an absolute ulp, which the
    Vecchia conditional variance amplifies; see nngp_tpu's
    ``_matern_comp_small``).  From K_nu = pi/(2 sin(pi nu)) [I_{-nu} - I_nu]:

      1 - C(x) = g (x/2)^{2 nu} S2(x) - S1(x),  g = Gamma(1-nu)/Gamma(1+nu),
      S2 = sum_{k>=0} t2_k,  t2_0 = 1,  t2_k = t2_{k-1} x^2/(4 k (k+nu)),
      S1 = sum_{k>=1} t1_k,  t1_1 = x^2/(4 (1-nu)),
                             t1_k = t1_{k-1} x^2/(4 k (k-nu)),

    with g from the Chebyshev Gamma ratios of the Bessel Temme series (no
    lgamma cancellation).  Valid for nu in (0.5, 1), the sampler's band."""
    mu = 1.0 - nu                       # in (0, 0.5)
    _, _, gampl, gammi = _beschb(mu)    # 1/Gamma(1+mu), 1/Gamma(1-mu)
    g = gammi / (mu * (1.0 - mu) * gampl)
    q = 0.25 * x * x
    t2 = torch.ones_like(x)
    S2 = t2
    t1 = q / (1.0 - nu)
    S1 = t1
    for k in range(1, _MATERN_SERIES_K):
        t2 = t2 * q / (k * (k + nu))
        S2 = S2 + t2
        if k >= 2:
            t1 = t1 * q / (k * (k - nu))
            S1 = S1 + t1
    xh = torch.clamp_min(0.5 * x, 1e-30)
    return g * torch.exp(2.0 * nu * torch.log(xh)) * S2 - S1


def _matern(d: torch.Tensor, nu) -> torch.Tensor:
    """Matérn correlation at scaled distance d (range already applied):
    the complementary series for d <= 0.29, the 2^{1-nu}/Gamma(nu) d^nu
    K_nu(d) product beyond, and exactly 1 at d <= 1e-8 (the diagonal)."""
    nu = torch.as_tensor(nu, dtype=d.dtype, device=d.device)
    safe_d = torch.clamp_min(d, 1e-8)
    lognorm = (1.0 - nu) * math.log(2.0) - torch.lgamma(nu)
    val_big = torch.exp(lognorm + nu * torch.log(safe_d)) * kv(nu, safe_d)
    x_small = torch.clamp_max(safe_d, _MATERN_SMALL_X)
    val_small = 1.0 - _matern_comp_small(x_small, nu)
    val = torch.where(safe_d <= _MATERN_SMALL_X, val_small, val_big)
    return torch.where(d <= 1e-8, torch.ones_like(val), val)
