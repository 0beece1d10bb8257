"""Modified Bessel function of the second kind K_nu in plain PyTorch, for
the Matérn correlation of the reference: Temme's series for x <= 2 (Temme
1975, J. Comp. Phys. 19) with Chebyshev Gamma ratios, Steed's continued
fraction CF2 beyond (Thompson & Barnett 1987), then the upward recurrence
to nu = mu + l.  A frozen copy of the sampler's plain twin; the tests hold
it to scipy.special.kv in float64.
"""

from __future__ import annotations

import math

import torch

_SERIES_ITERS = 20
_CF2_ITERS = 40

# Chebyshev coefficients (Numerical-Recipes "beschb" fits) for
#   gam1(mu) = [1/Gamma(1-mu) - 1/Gamma(1+mu)] / (2 mu)
#   gam2(mu) = [1/Gamma(1-mu) + 1/Gamma(1+mu)] / 2
# as functions of xx = 8 mu^2 - 1 on [-1, 1], valid for |mu| <= 1/2.
_C1 = (
    -1.142022680371168e0, 6.5165112670737e-3, 3.087090173086e-4,
    -3.4706269649e-6, 6.9437664e-9, 3.67795e-11, -1.356e-13,
)
_C2 = (
    1.843740587300905e0, -7.68528408447867e-2, 1.2719271366546e-3,
    -4.9717367042e-6, -3.31261198e-8, 2.423096e-10, -1.702e-13, -1.49e-15,
)


def _chebev(coeffs, x):
    """Clenshaw evaluation of a Chebyshev series on [-1, 1]."""
    d = torch.zeros_like(x)
    dd = torch.zeros_like(x)
    for c in coeffs[:0:-1]:
        d, dd = 2.0 * x * d - dd + c, d
    return x * d - dd + 0.5 * coeffs[0]


def _beschb(mu):
    """(gam1, gam2, 1/Gamma(1+mu), 1/Gamma(1-mu)) for |mu| <= 1/2."""
    xx = 8.0 * mu * mu - 1.0
    gam1 = _chebev(_C1, xx)
    gam2 = _chebev(_C2, xx)
    return gam1, gam2, gam2 - mu * gam1, gam2 + mu * gam1


def _temme_small_x(x, mu):
    """K_mu(x), K_{mu+1}(x) for x <= 2 via Temme's series."""
    eps = 1e-12
    x2 = 0.5 * x
    pimu = math.pi * mu
    fact = torch.where(pimu.abs() < eps, torch.ones_like(pimu),
                       pimu / torch.sin(pimu))
    d = -torch.log(x2)
    e = mu * d
    fact2 = torch.where(e.abs() < eps, torch.ones_like(e), torch.sinh(e) / e)
    gam1, gam2, gampl, gammi = _beschb(mu)
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    total = ff
    e = torch.exp(e)
    p = 0.5 * e / gampl
    q = 0.5 / (e * gammi)
    c = torch.ones_like(x)
    d2 = x2 * x2
    total1 = p
    for i in range(1, _SERIES_ITERS + 1):
        fi = float(i)
        ff = (fi * ff + p + q) / (fi * fi - mu * mu)
        c = c * d2 / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        total = total + c * ff
        total1 = total1 + c * (p - fi * ff)
    return total, total1 * (2.0 / x)


def _cf2_large_x(x, mu):
    """K_mu(x), K_{mu+1}(x) for x > 2 via Steed's continued fraction.

    Fixed iteration count; the unnormalized 3-term recurrence (q1, q2) is
    renormalized every step so that running past convergence cannot
    overflow."""
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = torch.zeros_like(x)
    q2 = torch.ones_like(x)
    a1 = 0.25 - mu * mu
    q = a1.clone()
    c = a1.clone()
    a = -a1
    s = 1.0 + q * delh
    eps = 1e-10 if x.dtype == torch.float64 else 1e-8
    done = torch.zeros_like(x, dtype=torch.bool)
    for i in range(2, _CF2_ITERS + 2):
        a = a - 2.0 * (i - 1)
        c = -a * c / i
        qnew = (q1 - b * q2) / a
        q1 = torch.where(done, q1, q2)
        q2 = torch.where(done, q2, qnew)
        q = torch.where(done, q, q + c * qnew)
        # renormalize: keep |c| ~ 1, folding its magnitude into (q1, q2);
        # qnew is linear in (q1, q2), so the increment c*qnew is invariant
        r = torch.clamp_min(c.abs(), 1e-30)
        c = c / r
        q1 = q1 * r
        q2 = q2 * r
        b = b + 2.0
        denom = b + a * d
        denom = torch.where(denom.abs() < 1e-30,
                            torch.full_like(denom, 1e-30), denom)
        d = torch.where(done, d, 1.0 / denom)
        delh_new = (b * d - 1.0) * delh
        dels = q * delh_new
        delh = torch.where(done, delh, delh_new)
        h = torch.where(done, h, h + delh_new)
        s_new = s + dels
        # freeze each lane once its series increment is negligible
        done_new = done | (dels.abs() < eps * s_new.abs())
        s = torch.where(done, s, s_new)
        done = done_new
    h = a1 * h
    k_mu = torch.sqrt(math.pi / (2.0 * x)) * torch.exp(-x) / s
    return k_mu, k_mu * (mu + x + 0.5 - h) / x


def kv(nu, x) -> torch.Tensor:
    """K_nu(x) for nu in (0, 3.5], x > 0, elementwise with broadcasting.

    The result is float64 if either input is, else float32.  x == 0 gives
    +inf (the Matérn kernels guard zero distance separately)."""
    nu = torch.as_tensor(nu)
    x = torch.as_tensor(x, device=nu.device)
    dtype = (torch.float64 if torch.float64 in (nu.dtype, x.dtype)
             else torch.float32)
    nu, x = torch.broadcast_tensors(nu.to(dtype), x.to(dtype))
    # split nu = mu + l with |mu| <= 1/2
    l = torch.floor(nu + 0.5)
    mu = nu - l
    x_small = torch.clamp_max(x, 2.0)
    x_big = torch.clamp_min(x, 2.0)
    ks_mu, ks_mu1 = _temme_small_x(torch.clamp_min(x_small, 1e-30), mu)
    kb_mu, kb_mu1 = _cf2_large_x(x_big, mu)
    small = x <= 2.0
    ks = [torch.where(small, ks_mu, kb_mu), torch.where(small, ks_mu1, kb_mu1)]
    # upward recurrence K_{m+1} = K_{m-1} + 2 m / x K_m, l in {0, 1, 2, 3}
    for j in range(1, 4):
        ks.append(ks[-2] + 2.0 * (mu + j) / x * ks[-1])
    out = ks[0]
    for j in range(1, 4):
        out = torch.where(l == j, ks[j], out)
    return torch.where(x <= 0.0, torch.full_like(out, math.inf), out)
