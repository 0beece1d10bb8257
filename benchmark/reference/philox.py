"""The random numbers of one Gibbs iteration, as plain integer arithmetic.

Philox4x32-10 (Salmon et al., SC'11) under per-chain counters: number
``e`` of field ``f`` for chain ``c`` at iteration ``it`` of the cycle that
starts at ``cycle_start`` is word ``e % 4`` of

    philox4x32_10(counter = (e // 4, cycle_start, c, f << 20 | it),
                  key     = (seed mod 2^32, seed >> 32))

Uniforms are ((x >> 9) + 0.5) 2^-23 in float32; normals are Box-Muller in
float64 from two words, (r cos 2 pi u2, r sin 2 pi u2) with r = sqrt(-2 log
u1), u = (word + 0.5) 2^-32, each rounded once to float32: one call gives
two pairs, from words (0, 1) and (2, 3).  This is the sampler's stated
stream (a frozen copy of the plain twin), so the reference draws the same
numbers the sampler consumes.
"""

from __future__ import annotations

import math

import torch

NORMAL, UNIFORM = "normal", "uniform"
FIELDS = {
    "anc_z": (0, NORMAL), "anc_u": (1, UNIFORM), "suf_z": (2, NORMAL),
    "suf_u": (3, UNIFORM), "adapt_z": (4, NORMAL), "beta0_z": (5, NORMAL),
    "beta_z": (6, NORMAL), "locs_z": (7, NORMAL), "sweep_z": (8, NORMAL),
    "noise_z": (9, NORMAL), "noise_u": (10, UNIFORM),
}
MASK32 = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)
_IT_BITS = 20


def _mulhilo(m, x):
    p_lo = (m & 0xFFFF) * x
    t = (m >> 16) * x + (p_lo >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(counter, k0, k1):
    """Four output words (int64 holding uint32) of int64 counters [..., 4]
    under the key (k0, k1)."""
    c0, c1, c2, c3 = counter.unbind(-1)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W[0]) & MASK32, (k1 + _W[1]) & MASK32
        hi0, lo0 = _mulhilo(_M[0], c0)
        hi1, lo1 = _mulhilo(_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), dim=-1)


def _normals(a, b):
    u1 = (a.double() + 0.5) * 2.0**-32
    u2 = (b.double() + 0.5) * 2.0**-32
    r = torch.sqrt(-2.0 * torch.log(u1))
    t = (2.0 * math.pi) * u2
    return (r * torch.cos(t)).float(), (r * torch.sin(t)).float()


def field_values(seed, cycle_start, chains, it, name, count):
    """float32 [C, count]: the first ``count`` numbers of field ``name``."""
    fid, kind = FIELDS[name]
    blocks = torch.arange(-(-count // 4), dtype=torch.int64,
                          device=chains.device)[None]
    counter = torch.stack(torch.broadcast_tensors(
        blocks, torch.full_like(blocks, cycle_start), chains[:, None],
        torch.full_like(blocks, fid << _IT_BITS | it)), dim=-1)
    w = philox4x32_10(counter, seed & MASK32, seed >> 32)
    if kind == UNIFORM:
        v = ((w >> 9).float() + 0.5) * 2.0**-23
    else:
        z0, z1 = _normals(w[..., 0], w[..., 1])
        z2, z3 = _normals(w[..., 2], w[..., 3])
        v = torch.stack([z0, z1, z2, z3], dim=-1)
    return v.flatten(1)[:, :count]


def iteration_draws(seed, cycle_start, chains, it, K, d, p, p_locs, S, n,
                    noise_steps):
    """{field: float32 [C, *shape]} of iteration ``it`` (the sampler's
    IterationDraws layout, chains leading)."""
    layout = {"anc_z": (K, d), "anc_u": (K,), "suf_z": (K, d),
              "suf_u": (K,), "adapt_z": (2,), "beta0_z": (),
              "beta_z": (p + 1,), "locs_z": (p_locs + 1,),
              "sweep_z": (S, n), "noise_z": (noise_steps,),
              "noise_u": (noise_steps,)}
    C = chains.shape[0]
    return {k: field_values(seed, cycle_start, chains, it, k,
                            math.prod(s)).reshape((C,) + s)
            for k, s in layout.items()}
