"""The Gibbs iteration sharded by sites: ``run(mc, mesh=...)`` over a
``("chains", "sites")`` ``DeviceMesh``.

Port of ``nngp_tpu/parallel/halo_gibbs.py``.  Rank (i, j) of the mesh
advances chains block i (``local_chain_slice``) over sites part j of a
``HaloPlan`` (``parallel/halo.py``).  Each block of
``models/gaussian.py:gibbs_iteration`` runs in the same order, with the
work that scales with n sharded by owner and every O(n) or O(n_obs) sum an
owned-rows (owned-observations) partial summed over the "sites" group:

- factor build: the need rows only (owned + halo), the rows any of the
  rank's consumers read; zeros elsewhere;
- ancillary co-transform: the right-hand side at owned rows, the halo level
  solve, the observation SSE difference over owned observations;
- sufficient ratio: per-owned-row log-density differences;
- beta: owned-row partial crossproducts;
- chromatic sweeps: Q's diagonal and edges from the need rows (exact at
  every owned site and owned-incident edge, since every row that adds to
  them is in the need set), Q gathered in the owned sub-plan's order, one
  sweep-kernel launch a colour step, a halo exchange after each, one
  reconcile;
- noise MH: owned-observation SSE.

The sums that the unsharded port accumulates in float64
(``ops/vecchia.py:sum64``) stay float64 up to the cross-rank sum.  The
cross-rank sum (``psum``) gathers every rank's partials and adds them in
rank order, so every rank gets the same bits whatever the backend's
reduction order: the scalar blocks, which every sites rank computes from
the same draws (``IterationDraws`` of the chains block's keys), then
take the same MH decisions on every rank.  With one sites rank every
partial is the whole sum and each step is the unsharded step.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

from nngp_tpu_torch.models.gaussian import (
    _accept,
    _adapt_and_am,
    _noise_mh,
    _propose,
    _proposal_chol,
    run_cycle,
)
from nngp_tpu_torch.ops.vecchia import (loglik_diff_terms, ordered_sum,
                                        vecchia_linv)
from nngp_tpu_torch.parallel.chains import make_sharded_cycle_fn
from nngp_tpu_torch.parallel.collectives import on_wire
from nngp_tpu_torch.parallel.halo import (
    SITES_AXIS,
    LocalPlan,
    RankTables,
    halo_chromatic_sweeps,
    halo_level_solve,
)


@dataclass(frozen=True)
class Shard:
    """One sites rank's part of the problem: its part of the plan (on the
    device), the sites group, and the observation data at its owned
    observations."""

    plan: LocalPlan
    group: object
    y: torch.Tensor               # [n_obs_d]
    X: torch.Tensor               # [n_obs_d, p]
    lm: torch.Tensor              # [n_obs_d] locs_match at those

    @property
    def rank(self) -> RankTables:
        return self.plan.rank


def local_shard(graph, data, plan: LocalPlan, group) -> Shard:
    """This rank's ``plan`` (on the data's device) with its observations."""
    obs = plan.rank.obs
    return Shard(plan, group, data.y[obs], data.X[obs], graph.locs_match[obs])


def psum(parts, group):
    """The sums over ``group`` of each rank's partials ``parts`` (tensors of
    one dtype): one ``all_gather`` (``on_wire``), then the ranks' values
    added in rank order, so every rank gets the same bits."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    wire = on_wire(flat, group)
    got = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(got, wire, group=group)
    total = torch.stack(got).sum(0).to(flat.device)
    out, at = [], 0
    for p in parts:
        out.append(total[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return out


def psum64(terms, group):
    """``ops/vecchia.py:sum64`` of each [C, k] tensor of ``terms`` over the
    rows of every rank: float64 partials, ``psum``, back to the terms'
    dtype."""
    totals = psum([t.double().sum(-1) for t in terms], group)
    return [s.to(t.dtype) for s, t in zip(totals, terms)]


def halo_vecchia_linv(graph, natural, shard: Shard):
    """The factor [C, n, m+1] at this rank's need rows
    (``ops/vecchia.py:vecchia_linv`` at those rows: one ``factor_build``
    launch on a card), zeros elsewhere."""
    rows = shard.rank.need
    vals = vecchia_linv(graph, natural, rows)
    out = vals.new_zeros((vals.shape[0], graph.n, vals.shape[-1]))
    out[:, rows] = vals
    return out


def rows_linv_mult(linv, x, graph, rows):
    """(L x) at ``rows`` (``ops/vecchia.py:linv_mult``'s arithmetic): x
    [C, n] -> [C, len(rows)], or [C, n, c] -> [C, len(rows), c]; x fresh at
    the rows' neighbour sets."""
    nn = torch.clamp_min(graph.NNarray[rows], 0)
    mask = graph.nn_mask[rows]
    if x.dim() == 2:
        return torch.sum(linv[:, rows] * (x[:, nn] * mask), dim=-1)
    return torch.sum(linv[:, rows][..., None] * (x[:, nn] * mask[..., None]),
                     dim=-2)


def halo_q_assembly(linv, graph, shard: Shard):
    """(pdiag [C, n], q_edges [C, E+1]) from this rank's need rows
    (``ops/vecchia.py:precision_diag_and_q_edges``): exact at owned sites
    and at edges with an owned end."""
    C = linv.shape[0]
    rows = shard.rank.need
    masked = linv[:, rows] * graph.nn_mask[rows]
    pdiag = ordered_sum((masked * masked).reshape(C, -1), shard.rank.nn_sum)
    prods = masked[:, :, graph.pair_a] * masked[:, :, graph.pair_b]
    q_edges = ordered_sum(prods.reshape(C, -1), shard.rank.pair_sum)
    return pdiag, q_edges


def _mu_own(state, shard: Shard):
    """mu = beta_0 + X beta at the owned observations, [C, n_obs_d]."""
    if shard.X.shape[1] > 0:
        return state.beta_0[:, None] + state.beta @ shard.X.T
    return state.beta_0[:, None].expand(-1, shard.y.shape[0])


def halo_sweep_inputs(graph, shard: Shard, state, linv, mu):
    """``models/gaussian.py:sweep_inputs`` for this rank: (q_plan [C,
    nnz_d] in the owned sub-plan's order, P [C, n], rs [C, n], scal [C, 3]),
    P and rs exact at the owned sites."""
    pdiag, q_edges = halo_q_assembly(linv, graph, shard)
    q_plan = q_edges.index_select(1, shard.rank.sub.plan_edge)
    rs = ordered_sum(shard.y - mu, shard.rank.obs_sum)
    inv_scale = torch.exp(-state.log_scale)
    inv_noise = torch.exp(-state.log_noise_variance)
    P = inv_scale[:, None] * pdiag + inv_noise[:, None] * graph.obs_per_loc
    scal = torch.stack([state.beta_0, inv_scale, inv_noise], dim=1)
    return q_plan, P, rs, scal


def halo_chromatic_sweeps_local(graph, shard: Shard, state, linv, mu, noise):
    """Block 4: the sweeps on this rank's sub-plan, a halo exchange after
    each colour step, the field reconciled at the end."""
    q_plan, P, rs, scal = halo_sweep_inputs(graph, shard, state, linv, mu)
    w = state.field.clone(memory_format=torch.contiguous_format)
    return replace(state, field=halo_chromatic_sweeps(
        w, q_plan, P, rs, noise, scal, shard.plan, shard.group))


def _halo_ancillary(graph, cfg, data, shard: Shard, state, linv, mu, z, u,
                    C=None):
    """Block 1 (``_ancillary_step``): need-rows factor, owned-rows
    right-hand side, halo level solve, owned-observation SSE difference."""
    proposal = _propose(cfg, state, state.tk_ancillary, C, z)
    new_ls, _, natural_new = proposal
    new_linv = halo_vecchia_linv(graph, natural_new, shard)
    owned = shard.rank.owned
    v = torch.zeros_like(state.field)
    v[:, owned] = rows_linv_mult(linv, state.field - state.beta_0[:, None],
                                 graph, owned)
    new_field = state.beta_0[:, None] + torch.exp(
        0.5 * (new_ls - state.log_scale))[:, None] * halo_level_solve(
            graph, shard.plan, new_linv, v, shard.group)
    prec = torch.exp(-state.log_noise_variance)
    delta = (new_field - state.field)[:, shard.lm]
    r_old = shard.y - state.field[:, shard.lm] - mu + state.beta_0[:, None]
    sse_diff, = psum64([delta * (delta - 2.0 * r_old)], shard.group)
    return _accept(cfg, data, state, linv, proposal, new_linv,
                   -0.5 * prec * sse_diff, u, new_field=new_field)


def _halo_sufficient(graph, cfg, data, shard: Shard, state, linv, z, u,
                     C=None):
    """Block 2 (``_sufficient_step``): the log-density difference
    (``ops/vecchia.py:nngp_loglik_diff``) as owned-row terms."""
    proposal = _propose(cfg, state, state.tk_sufficient, C, z)
    new_ls, _, natural_new = proposal
    new_linv = halo_vecchia_linv(graph, natural_new, shard)
    w0 = state.field - state.beta_0[:, None]
    terms = loglik_diff_terms(new_linv, new_ls, linv, state.log_scale, w0,
                              graph, shard.rank.owned)
    total, = psum64([terms], shard.group)
    gp_ratio = total - 0.5 * graph.n * (new_ls.double()
                                        - state.log_scale.double())
    return _accept(cfg, data, state, linv, proposal, new_linv, gp_ratio, u)


def _halo_beta(graph, cfg, data, shard: Shard, state, linv, draws):
    """Block 3 (``_beta_step``): owned-row and owned-observation partial
    crossproducts, summed over the sites group; the draws and the algebra
    on the sums are every rank's."""
    p = state.beta.shape[1]
    p_locs = len(cfg.locs_cols)
    beta_0, beta, field = state.beta_0, state.beta, state.field
    C, n = field.shape
    owned = shard.rank.owned

    if p_locs == 0 or p == 0:
        ones = torch.ones(1, n, dtype=field.dtype, device=field.device)
        L1 = rows_linv_mult(linv, ones.expand(C, n), graph, owned)
        Lw = rows_linv_mult(linv, field, graph, owned)
        s11, s1w = psum64([L1 * L1, Lw * L1], shard.group)
        cov = torch.exp(state.log_scale) / s11
        beta_0 = s1w / s11 + torch.sqrt(cov) * draws.beta0_z

    if p > 0:
        if p_locs > 0 and tuple(cfg.locs_cols) != tuple(range(p_locs)):
            raise ValueError("location covariates must be the leading "
                             f"design columns, got {cfg.locs_cols}")
        r = shard.y - field[:, shard.lm] + beta_0[:, None]
        parts = [torch.cat([r.sum(-1, keepdim=True), r @ shard.X], dim=1)]
        if p_locs > 0:
            X1l = torch.cat([torch.ones(n, 1, dtype=field.dtype,
                                        device=field.device),
                             data.X_locs_u], dim=1)                  # [n, pl+1]
            LX = rows_linv_mult(linv, X1l.expand(C, n, p_locs + 1), graph,
                                owned)
            parts.append(LX.transpose(1, 2) @ LX)
        sums = psum(parts, shard.group)
        bmean = sums[0] @ data.solve_1XT1X
        innov = bmean + torch.exp(0.5 * state.log_noise_variance)[:, None] * (
            draws.beta_z @ data.chol_solve_1XT1X_lower.T)
        field = field - beta_0[:, None] + innov[:, :1]
        beta_0 = innov[:, 0]
        beta = innov[:, 1:]

        if p_locs > 0:
            lc = slice(0, p_locs)
            cL, _ = torch.linalg.cholesky_ex(sums[1])
            other = field + beta[:, lc] @ data.X_locs_u.T            # [C, n]
            t, = psum([LX.transpose(1, 2) @ rows_linv_mult(
                linv, other, graph, owned)[..., None]], shard.group)
            mean = torch.cholesky_solve(t, cL)[..., 0]
            noise = torch.linalg.solve_triangular(
                cL.transpose(1, 2), draws.locs_z[..., None], upper=True)[..., 0]
            innov = mean + torch.exp(0.5 * state.log_scale)[:, None] * noise
            beta_0 = innov[:, 0]
            beta = beta.clone()
            beta[:, lc] = innov[:, 1:]
            field = other - innov[:, 1:] @ data.X_locs_u.T

    return replace(state, beta_0=beta_0, beta=beta, field=field)


def halo_gibbs_iteration(graph, data, cfg, carry, it: int, iter_start: int,
                         draws, shard: Shard):
    """One Gibbs iteration of this chains block over this sites rank:
    ``models/gaussian.py:gibbs_iteration``'s blocks, sharded."""
    state, linv, acc_anc, acc_suf = carry
    mu = _mu_own(state, shard)
    C = _proposal_chol(state)
    for rep in range(max(1, cfg.covparams_steps)):
        if cfg.ancillary:
            state, linv, a = _halo_ancillary(
                graph, cfg, data, shard, state, linv, mu, draws.anc_z[rep],
                draws.anc_u[rep], C=C)
            acc_anc = acc_anc + a
        state, linv, a = _halo_sufficient(
            graph, cfg, data, shard, state, linv, draws.suf_z[rep],
            draws.suf_u[rep], C=C)
        acc_suf = acc_suf + a
    state, acc_anc, acc_suf = _adapt_and_am(cfg, state, acc_anc, acc_suf, it,
                                            iter_start, draws.adapt_z)

    state = _halo_beta(graph, cfg, data, shard, state, linv, draws)
    mu = _mu_own(state, shard)
    state = halo_chromatic_sweeps_local(graph, shard, state, linv, mu,
                                        draws.sweep_z)
    # block 5: the noise moves on the owned-observation SSE
    r = shard.y - state.field[:, shard.lm] - mu + state.beta_0[:, None]
    sse, = psum64([r * r], shard.group)
    state = _noise_mh(data, cfg, state, sse, graph.n_obs, draws.noise_z,
                      draws.noise_u)
    return (state, linv, acc_anc, acc_suf)


def make_halo_cycle_fn(graph, data, cfg, mesh, plan: LocalPlan):
    """``models/gaussian.py:run_cycle`` with the chains sharded over
    ``mesh["chains"]`` and the sites over ``mesh["sites"]``: ``call(states,
    key, iter_start, saved_slots=None)`` as ``chains.make_sharded_cycle_fn``
    gives it, every rank leaving with every chain.  ``plan`` is this sites
    rank's part (``HaloPlan.for_rank``), on the data's device."""
    group = mesh[SITES_AXIS].get_group()
    shard = local_shard(graph, data, plan, group)
    # the sites group's first collective, before any rank's first
    # point-to-point exchange (which NCCL needs every rank to reach)
    psum([torch.zeros(1, device=data.y.device)], group)
    cycle = functools.partial(
        run_cycle,
        iteration=functools.partial(halo_gibbs_iteration, shard=shard),
        factor=functools.partial(halo_vecchia_linv, shard=shard))
    return make_sharded_cycle_fn(graph, data, cfg, mesh, cycle=cycle)
