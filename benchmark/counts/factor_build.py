"""Bytes and operations of one call of the factor build (all chains' rows of
the Vecchia factor), frozen from the sampler's smoke
(``chip_smoke.py:factor_build_ops``).

It counts the work of today's algorithm: each chain's valid strictly-lower
pairs of every row by the branch their distance takes (and, beyond 2, by
the continued-fraction steps this data needs), then the unrolled row body.
+ - x / max each count 1, an fma 2.  The exponential build runs in float32
(expf and sqrtf on the SFU, 8 each); the Matérn build in float64 (a double
exp, log, sinh or cosh 20, a double square root 8).  A Bessel algorithm
that takes other branches or steps would be counted by these same pieces.
"""

from __future__ import annotations

import torch

SFU = 8
F64_TRANS, F64_SQRT = 20, 8
# (operations, transcendentals, square roots) of each piece
PIECES = {
    "dist": (3, 0, 1),          # d2 / r^2, max, sqrt; then K v
    "exp": (1, 1, 0),           # expf(-d)
    "series": (58, 2, 0),       # d <= 0.29: the complementary series
    "temme": (360, 4, 0),       # 0.29 < d <= 2: Temme's set-up, 20 terms
    "cf2": (19, 1, 1),          # d > 2: CF2's set-up and end
    "cf2_step": (30, 0, 0),     # one CF2 step
    "big": (4, 2, 0),           # exp(lognorm + nu log x) K_nu
    "recur": (5, 0, 0),         # one upward recurrence step
}


def _ops(piece, f64):
    ops, trans, roots = PIECES[piece]
    return ops + trans * (F64_TRANS if f64 else SFU) + roots * (
        F64_SQRT if f64 else SFU)


def row_ops(m, f64=False):
    """Operations of the unrolled row body at m neighbours."""
    root = F64_SQRT if f64 else SFU
    chol = sum(2 * j + 2 + root + 2 * j * (m - j - 1) + (m - j - 1)
               for j in range(m))
    solves = sum(2 * i + 1 for i in range(m)) * 2
    return chol + solves + 2 * m + 1 + root + 1 + 2 * m


def cf2_steps(x, mu):
    """Steps the continued fraction runs at each x > 2 before it freezes
    (at most 40), in x's dtype (frozen at 1e-10 in float64, 1e-8 in
    float32)."""
    eps = 1e-10 if x.dtype == torch.float64 else 1e-8
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    delh = d
    q1, q2 = torch.zeros_like(x), torch.ones_like(x)
    a1 = 0.25 - mu * mu
    q, c, a = a1.clone(), a1.clone(), -a1
    s = 1.0 + q * delh
    steps = torch.full_like(x, 40)
    live = torch.ones_like(x, dtype=torch.bool)
    for i in range(2, 42):
        a = a - 2.0 * (i - 1)
        c = -a * c / i
        qnew = (q1 - b * q2) / a
        q1, q2 = q2, qnew
        q = q + c * qnew
        r = torch.clamp_min(c.abs(), 1e-30)
        c, q1, q2 = c / r, q1 * r, q2 * r
        b = b + 2.0
        denom = b + a * d
        d = 1.0 / torch.where(denom.abs() < 1e-30,
                              torch.full_like(denom, 1e-30), denom)
        delh = (b * d - 1.0) * delh
        dels = q * delh
        s = s + dels
        stop = live & (dels.abs() < eps * s.abs())
        steps[stop] = i - 1
        live &= ~stop
    return steps


def factor_ops(covfun, d2_pairs, pair_valid, m, nat):
    """Operations of one build for natural shapes nat [C, ns] over rows
    with squared pair distances d2_pairs [n, P] and their validity
    pair_valid [n, P] (P = m (m + 1) / 2 position pairs)."""
    f64 = covfun.startswith("matern")
    dt = torch.float64 if f64 else torch.float32
    nat = nat.to(dt)
    rr = nat[:, 0] * nat[:, 0]
    ops = 0.0
    for c in range(nat.shape[0]):          # a chain at a time bounds memory
        d = torch.sqrt(torch.clamp_min(d2_pairs.to(dt) / rr[c], 0.0))
        live = pair_valid > 0
        ops += float(live.sum()) * _ops("dist", f64)
        if not f64:
            ops += float(live.sum()) * _ops("exp", f64)
            continue
        live = live & (d > 1e-8)
        x = torch.clamp_min(d, 1e-8)
        l = torch.floor(nat[c, 1] + 0.5).expand_as(x)
        mu = (nat[c, 1] - l)
        series, big = live & (x <= 0.29), live & (x > 0.29)
        cf2 = big & (x > 2.0)
        ops += (float(series.sum()) * _ops("series", f64)
                + float((big & ~cf2).sum()) * _ops("temme", f64)
                + float(cf2.sum()) * _ops("cf2", f64)
                + float(cf2_steps(x[cf2], mu[cf2]).sum())
                * _ops("cf2_step", f64)
                + float(big.sum()) * _ops("big", f64)
                + float(l[big].sum()) * _ops("recur", f64))
    return ops + nat.shape[0] * d2_pairs.shape[0] * row_ops(m, f64)


def factor_bytes(n, k, C, ns):
    """The call's inputs and output, each once: the rows' squared
    distances [n, k, k] and mask [n, k] in float32, the natural shapes, and
    the float32 rows [C, n, k] out."""
    return 4 * (n * k * k + n * k + C * ns + C * n * k)
