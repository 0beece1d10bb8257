"""Gelman-Rubin-Brooks R-hat over chains sharded across ranks (K8).

Port of ``nngp_tpu/parallel/collectives.py``.  The stopping rule needs the
within-chain and between-chain covariances (mcmc_nngp_diagnose.R:12-21).
With chains on several ranks, each rank reduces its own chains to p x p
moments and only those cross the group: the mean within-chain covariance
and the mean of the chain means are ``all_reduce``d and divided by the
world size (``nngp_tpu``'s ``pmean``), the sum of the between-chain outer
products is ``all_reduce``d (its ``psum``).  The moments are float64.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _grb_from_moments(W, B, n, m):
    """R-hat formulas with the reference's df constants
    (mcmc_nngp_diagnose.R:18-21): [multivariate, univariate...]."""
    lam = torch.linalg.svdvals(torch.linalg.solve(W, B))[0]
    mpsrf = (n - 1) / n + (m + 1) / m * lam
    ind = (((m + 1) / m) * ((n - 1) / n) * (torch.diagonal(B) / torch.diagonal(W))
           + (n + 1) / n)
    return torch.cat([mpsrf[None], ind])


def on_wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where ``group``'s collectives take it: on the host for gloo
    (whose all_gather takes no CUDA tensor), on this rank's card for NCCL
    (which takes no host tensor)."""
    return (t.cpu() if "gloo" in dist.get_backend(group)
            else t.cuda()).contiguous()


def _all_reduce(t, group):
    """Sum ``t`` over ``group`` and return it on ``t``'s device."""
    wire = on_wire(t, group)
    dist.all_reduce(wire, group=group)
    return wire.to(t.device)


def collective_grb(samples: torch.Tensor, n_chains_total: int, group=None):
    """R-hat from this rank's chains' samples.

    ``samples`` [local_chains, T, p]: the non-field parameters of each of
    this rank's chains after burn-in.  Every rank of ``group`` (default: the
    whole group) calls it with the same T and p.  Returns the float64
    [1 + p] R-hat vector, the same on every rank."""
    x = samples.to(torch.float64)
    T, p = x.shape[1], x.shape[2]
    m = n_chains_total
    world = dist.get_world_size(group)
    means = x.mean(dim=1)                                   # [lc, p]
    centered = x - means[:, None, :]
    covs = torch.einsum("ctp,ctq->cpq", centered, centered) / (T - 1)
    # within = average of per-chain covariances (diagnose.R:13-14), and the
    # mean of the chain means: one all_reduce for both
    both = _all_reduce(torch.cat([covs.mean(dim=0).flatten(),
                                  means.mean(dim=0)]), group) / world
    W, mean_of_means = both[:p * p].reshape(p, p), both[p * p:]
    # between = covariance of the chain means (diagnose.R:15-16): the sum of
    # every chain's deviation outer product / (m - 1)
    dev = means - mean_of_means
    B = _all_reduce(torch.einsum("cp,cq->pq", dev, dev), group) / (m - 1)
    return _grb_from_moments(W, B, T, m)


def make_collective_grb_fn(mesh, n_chains_total: int):
    """``fn(samples)``: ``collective_grb`` over ``mesh``'s group, for this
    rank's [local_chains, T, p] samples."""

    def fn(samples):
        return collective_grb(samples, n_chains_total, group=mesh.get_group())

    return fn
