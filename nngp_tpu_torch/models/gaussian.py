"""Gaussian-response Gibbs iteration, chains as the leading tensor dimension.

Port of ``nngp_tpu/models/gaussian.py`` (the reference:
mcmc_nngp_update_Gaussian.R).  One iteration composes, in the reference's
order:

  1. ancillary MH on (log_scale, shape), field co-transformed (ref :108-157)
  2. sufficient MH on (log_scale, shape), field fixed          (ref :160-213)
     -- ``covparams_steps`` (ancillary, sufficient) pairs --
  3. conjugate Gibbs for (beta_0, beta) + centered interweaving redraw of
     the location-indexed coefficients                        (ref :214-250)
  4. n_chromatic chromatic sweeps of the latent field (the CUDA kernel,
     ops/sweep.py)                                             (ref :254-275)
  5. ten small MH steps on log_noise_variance                  (ref :277-293)

plus the adaptive step sizes and the adaptive-covariance (AM) proposal of
``nngp_tpu``, with the same support box.

Every block takes its random numbers as tensors (``IterationDraws``), so a
test can inject the exact draws of ``nngp_tpu``; ``run_cycle`` draws them
from the cycle's ``DrawKey`` (``ops/draws.py``): per-chain Philox
counters, so a chain's numbers depend on (seed, cycle start, its global
id, iteration, field, element) only, as ``nngp_tpu`` keys each chain, and
one launch of the ``chain_draws`` kernel a card iteration writes them all.
Inside an iteration no value goes to the host: accepts are
``torch.where``, and Python branches only on host integers (iteration
index, config).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from nngp_tpu_torch.ops.covariance import shape_transform
from nngp_tpu_torch.ops.draws import DrawKey
from nngp_tpu_torch.ops.sweep import chromatic_sweeps
from nngp_tpu_torch.ops.trisolve import level_solve
from nngp_tpu_torch.ops.vecchia import (
    linv_mult,
    nngp_loglik_diff,
    ordered_sum,
    precision_diag_and_q_edges,
    sum64,
    vecchia_linv,
)
from nngp_tpu_torch.tracing import span


def _to(obj, device):
    """Dataclass of tensors (or None) moved to ``device``."""
    return replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in fields(obj) if isinstance(getattr(obj, f.name), torch.Tensor)
    })


@dataclass(frozen=True)
class ChainState:
    """Per-chain sampler state, chains leading (nngp_tpu's ChainState,
    stacked)."""

    beta_0: torch.Tensor              # [C]
    beta: torch.Tensor                # [C, p] (p may be 0)
    log_scale: torch.Tensor           # [C]
    log_noise_variance: torch.Tensor  # [C]
    shape: torch.Tensor               # [C, n_shape], sampled scale
    field: torch.Tensor               # [C, n], centered (includes beta_0)
    tk_ancillary: torch.Tensor        # [C] log-variance of the proposal
    tk_sufficient: torch.Tensor       # [C]
    # adaptive-covariance (Welford) proposal accumulators of the
    # (log_scale, shape) vector; None => the reference's isotropic proposal
    prop_mean: torch.Tensor | None = None   # [C, 1 + n_shape]
    prop_m2: torch.Tensor | None = None     # [C, 1 + n_shape, 1 + n_shape]
    prop_count: torch.Tensor | None = None  # [C]

    def to(self, device) -> "ChainState":
        return _to(self, device)


@dataclass(frozen=True)
class ModelData:
    """Observation-side data (see nngp_tpu's ModelData for the support
    rationale of range_cap / range_floor)."""

    y: torch.Tensor                   # [n_obs]
    X: torch.Tensor                   # [n_obs, p] centered design
    X_locs_u: torch.Tensor            # [n, p_locs] location covariates
    solve_1XT1X: torch.Tensor         # [p+1, p+1]
    chol_solve_1XT1X_lower: torch.Tensor  # [p+1, p+1]
    var_y: torch.Tensor               # []
    range_cap: torch.Tensor           # []
    range_floor: torch.Tensor | None = None  # [G]

    def to(self, device) -> "ModelData":
        return _to(self, device)


@dataclass(frozen=True)
class UpdateConfig:
    """Static sampler knobs (mcmc_nngp_run.R:1-5)."""

    n_iterations: int
    shape_names: tuple
    locs_cols: tuple                 # location-indexed beta columns
    n_chromatic: int = 10
    ancillary: bool = True
    noise_steps: int = 10
    covparams_steps: int = 1         # (ancillary, sufficient) pairs
    adapt_until: int = 2000          # adapt while iter_start <= this
    adapt_window: int = 25
    # field snapshots one cycle records (-1 = every iteration)
    n_saved: int = -1
    # record only these field columns (None = the full field)
    field_cols: tuple | None = None


@dataclass(frozen=True)
class IterationDraws:
    """Every random number one iteration consumes (C chains, K =
    covparams_steps, d = 1 + n_shape)."""

    anc_z: torch.Tensor      # [K, C, d]  ancillary proposal normals
    anc_u: torch.Tensor      # [K, C]     ancillary accept uniforms
    suf_z: torch.Tensor      # [K, C, d]
    suf_u: torch.Tensor      # [K, C]
    adapt_z: torch.Tensor    # [C, 2]     step-size adaptation normals
    beta0_z: torch.Tensor    # [C]        beta_0 draw (no location covariates)
    beta_z: torch.Tensor     # [C, p+1]   non-centered (beta_0, beta) draw
    locs_z: torch.Tensor     # [C, p_locs+1] interweaved redraw
    sweep_z: torch.Tensor    # [C, S, n]  chromatic sweep normals by site
    noise_z: torch.Tensor    # [C, noise_steps]
    noise_u: torch.Tensor    # [C, noise_steps]

    @staticmethod
    def layout(cfg: UpdateConfig, n: int, p: int) -> dict:
        """{field: per-chain shape} of one iteration's draws, chains
        leading (``ops/draws.py:chain_draws``'s layout)."""
        K = max(1, cfg.covparams_steps)
        d = 1 + len(cfg.shape_names)
        return {"anc_z": (K, d), "anc_u": (K,), "suf_z": (K, d),
                "suf_u": (K,), "adapt_z": (2,), "beta0_z": (),
                "beta_z": (p + 1,), "locs_z": (len(cfg.locs_cols) + 1,),
                "sweep_z": (cfg.n_chromatic, n),
                "noise_z": (cfg.noise_steps,), "noise_u": (cfg.noise_steps,)}

    @classmethod
    def draw(cls, key: DrawKey, it: int, cfg: UpdateConfig, n: int, p: int,
             dtype=torch.float32) -> "IterationDraws":
        """Iteration ``it``'s draws for ``key``'s chains on their device:
        one ``chain_draws`` launch on a card, its twin on the CPU."""
        z = key.draws(it, cls.layout(cfg, n, p))
        z = {k: v.to(dtype) for k, v in z.items()}
        return cls(
            anc_z=z["anc_z"].transpose(0, 1),
            anc_u=z["anc_u"].T,
            suf_z=z["suf_z"].transpose(0, 1),
            suf_u=z["suf_u"].T,
            adapt_z=z["adapt_z"],
            beta0_z=z["beta0_z"],
            beta_z=z["beta_z"],
            locs_z=z["locs_z"],
            sweep_z=z["sweep_z"],
            noise_z=z["noise_z"],
            noise_u=z["noise_u"],
        )

    def to(self, device) -> "IterationDraws":
        return _to(self, device)


def _natural_shape(cfg: UpdateConfig, sampled: torch.Tensor) -> torch.Tensor:
    """The natural shape params of ``sampled`` [C, n_shape]: float64 for the
    Matérn families (a smoothness name), whose factor build runs in float64
    from them (an ulp of a float32 nu moves a collapsed chain's sufficient
    log ratio by units), in ``sampled``'s dtype otherwise."""
    if any(name.startswith("qlogis") for name in cfg.shape_names):
        sampled = sampled.double()
    return shape_transform(cfg.shape_names, sampled)


def _obs_sse(data, field, mu, beta_0, graph):
    """sum (y - field[locs_match] - mu + beta_0)^2 per chain (ref :281),
    accumulated in float64."""
    r = data.y - field[:, graph.locs_match] - mu + beta_0[:, None]
    return sum64(r * r)


def _obs_sse_diff(data, field_new, field_old, mu, beta_0, graph):
    """sse(field_new) - sse(field_old) as one float64 sum of per-observation
    differences delta * (delta - 2 r_old): no big-total cancellation in the
    ancillary MH ratio (ref :129-133)."""
    delta = (field_new - field_old)[:, graph.locs_match]
    r_old = data.y - field_old[:, graph.locs_match] - mu + beta_0[:, None]
    return sum64(delta * (delta - 2.0 * r_old))


def _scale_support(data, new_ls):
    """exp(log_scale) > 1e-8 var(y): the floor mirroring the reference's
    exp(log_scale) < var(y) cap (ref :167)."""
    return new_ls > torch.log(data.var_y) - 18.42  # log(1e-8)


def _range_support(cfg, data, natural, sampled):
    """Per chain: every natural range within [range_floor[g], range_cap]
    (g counts the range parameters), and every qlogis_* (Matérn
    smoothness) within |s| <= 6 on the sampled scale.  Beyond |s| ~ 6 the
    transform nu = .5 + .5 sigmoid(s) saturates, the likelihood is flat in
    s and a flat-prior chain drifts along the tail (nngp_tpu's
    ``_range_support``); |s| <= 6 spans nu in [0.5012, 0.9988]."""
    ok = torch.ones(natural.shape[0], dtype=torch.bool, device=natural.device)
    g = 0
    for j, nm in enumerate(cfg.shape_names):
        if nm.startswith("log"):
            ok = ok & (natural[:, j] <= data.range_cap)
            if data.range_floor is not None:
                ok = ok & (natural[:, j] >= data.range_floor[g])
            g += 1
        elif nm.startswith("qlogis"):
            ok = ok & (sampled[:, j].abs() <= 6.0)
    return ok


# AM proposal activates once this many adaptation samples have been seen
_AM_MIN_COUNT = 100.0


def _proposal_chol(state: ChainState):
    """Lower Cholesky factor [C, d, d] of the AM proposal shape (the
    correlation of the running (log_scale, shape) moments shrunk 15% toward
    identity), identity until _AM_MIN_COUNT samples or where the factor is
    not finite; None for the isotropic proposal."""
    if state.prop_mean is None:
        return None
    d = state.prop_mean.shape[1]
    eye = torch.eye(d, dtype=state.prop_mean.dtype,
                    device=state.prop_mean.device)
    count = state.prop_count[:, None, None]
    cov = state.prop_m2 / torch.clamp_min(count - 1.0, 1.0)
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)[:, None, None] / d
    covn = 0.85 * (cov / torch.clamp_min(tr, 1e-30)) + 0.15 * eye
    L, info = torch.linalg.cholesky_ex(covn)
    use = ((state.prop_count >= _AM_MIN_COUNT) & (info == 0)
           & torch.isfinite(L).all(-1).all(-1))
    return torch.where(use[:, None, None], L, eye)


def _mh_innovation(tk, C, z):
    """Joint (log_scale, shape) proposal innovation exp(tk/2) C z, [C, d]."""
    if C is not None:
        z = (C @ z[..., None])[..., 0]
    return z * torch.exp(0.5 * tk)[:, None]


def _am_update(state: ChainState, reset: bool) -> ChainState:
    """Welford update of the AM moments with the current (log_scale, shape);
    ``reset`` restarts them at the current value."""
    if state.prop_mean is None:
        return state
    x = torch.cat([state.log_scale[:, None], state.shape], dim=1)
    if reset:
        return replace(state, prop_mean=x, prop_m2=torch.zeros_like(state.prop_m2),
                       prop_count=torch.ones_like(state.prop_count))
    cnt = state.prop_count + 1.0
    delta = x - state.prop_mean
    mean = state.prop_mean + delta / cnt[:, None]
    m2 = state.prop_m2 + delta[:, :, None] * (x - mean)[:, None, :]
    return replace(state, prop_mean=mean, prop_m2=m2, prop_count=cnt)


def _where(accept, new, old):
    """Per-chain select: accept [C] against tensors [C, ...]."""
    return torch.where(accept.reshape(accept.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _propose(cfg, state, tk, C, z):
    """The joint (log_scale, shape) proposal with step sizes ``tk``:
    (new log_scale, new sampled shape, new natural shape)."""
    innov = _mh_innovation(tk, C, z)
    new_ls = state.log_scale + innov[:, 0]
    new_shape = state.shape + innov[:, 1:]
    return new_ls, new_shape, _natural_shape(cfg, new_shape)


def _accept(cfg, data, state, linv, proposal, new_linv, ratio, u,
            new_field=None):
    """The MH decision on a (log_scale, shape) ``proposal``: accepted where
    the log ratio beats log(u) inside the full support box, var(y) cap
    included (ref :167); returns (state, linv, accept as 0/1), the field
    moved to ``new_field`` where accepted when one is given."""
    new_ls, new_shape, natural_new = proposal
    accept = (_range_support(cfg, data, natural_new, new_shape)
              & _scale_support(data, new_ls)
              & (torch.exp(new_ls) < data.var_y)
              & (ratio > torch.log(u)))
    moved = {} if new_field is None else {
        "field": _where(accept, new_field, state.field)}
    state = replace(
        state,
        log_scale=_where(accept, new_ls, state.log_scale),
        shape=_where(accept, new_shape, state.shape),
        **moved,
    )
    return state, _where(accept, new_linv, linv), accept.to(linv.dtype)


def _ancillary_step(graph, data, cfg, state, linv, mu, z, u, C=None):
    """Block 1: joint MH on (log_scale, shape) with the whitened field held
    fixed: w_new = beta_0 + e^{(ls'-ls)/2} L_new^-1 L_old (w - beta_0)
    (ref :127); the ratio is the observation log-likelihood difference
    (ref :129-133).  Subject to the full support box, var(y) cap included."""
    proposal = _propose(cfg, state, state.tk_ancillary, C, z)
    new_ls, _, natural_new = proposal
    new_linv = vecchia_linv(graph, natural_new)
    v = linv_mult(linv, state.field - state.beta_0[:, None], graph)
    new_field = state.beta_0[:, None] + torch.exp(
        0.5 * (new_ls - state.log_scale))[:, None] * level_solve(new_linv, v, graph)
    prec = torch.exp(-state.log_noise_variance)
    llr = -0.5 * prec * _obs_sse_diff(data, new_field, state.field, mu,
                                      state.beta_0, graph)
    return _accept(cfg, data, state, linv, proposal, new_linv, llr, u,
                   new_field=new_field)


def _sufficient_step(graph, data, cfg, state, linv, z, u, C=None):
    """Block 2: joint MH on (log_scale, shape) with the field fixed; the
    ratio is the Vecchia prior log-density difference (ref :160-213),
    subject to exp(log_scale') < var(y) (ref :167) and the support box."""
    proposal = _propose(cfg, state, state.tk_sufficient, C, z)
    new_ls, _, natural_new = proposal
    new_linv = vecchia_linv(graph, natural_new)
    w0 = state.field - state.beta_0[:, None]
    gp_ratio = nngp_loglik_diff(new_linv, new_ls, linv, state.log_scale, w0,
                                graph)
    return _accept(cfg, data, state, linv, proposal, new_linv, gp_ratio, u)


def _beta_step(graph, data, cfg, state, linv, draws: IterationDraws):
    """Block 3: regression coefficients (ref :214-250).

    - no location covariates: conjugate beta_0 draw from the GP prior of the
      centered field (ref :219-224); no field shift.
    - any covariates: non-centered conjugate draw of (beta_0, beta) from the
      observation residuals, field shifted by the beta_0 innovation
      (ref :226-235).
    - location covariates: interweaved centered redraw of
      (beta_0, beta[locs]) from the GP prior of field + X_locs beta_locs
      (ref :237-246).
    """
    p = state.beta.shape[1]
    p_locs = len(cfg.locs_cols)
    beta_0, beta, field = state.beta_0, state.beta, state.field
    C, n = field.shape

    if p_locs == 0 or p == 0:
        ones = torch.ones(1, n, dtype=field.dtype, device=field.device)
        L1 = linv_mult(linv, ones.expand(C, n), graph)
        s11 = sum64(L1 * L1)
        cov = torch.exp(state.log_scale) / s11
        Lw = linv_mult(linv, field, graph)
        # (1'Q w)/(1'Q 1): the exp(+-log_scale) factors cancel exactly
        mean = sum64(Lw * L1) / s11
        beta_0 = mean + torch.sqrt(cov) * draws.beta0_z

    if p > 0:
        r = data.y - field[:, graph.locs_match] + beta_0[:, None]   # [C, n_obs]
        rX1 = torch.cat([r.sum(-1, keepdim=True), r @ data.X], dim=1)
        bmean = rX1 @ data.solve_1XT1X
        innov = bmean + torch.exp(0.5 * state.log_noise_variance)[:, None] * (
            draws.beta_z @ data.chol_solve_1XT1X_lower.T)
        field = field - beta_0[:, None] + innov[:, :1]
        beta_0 = innov[:, 0]
        beta = innov[:, 1:]

        if p_locs > 0:
            # build_design puts the location covariates first; a slice keeps
            # the index off the host->device path
            if tuple(cfg.locs_cols) != tuple(range(p_locs)):
                raise ValueError("location covariates must be the leading "
                                 f"design columns, got {cfg.locs_cols}")
            lc = slice(0, p_locs)
            X1l = torch.cat([torch.ones(n, 1, dtype=field.dtype,
                                        device=field.device),
                             data.X_locs_u], dim=1)                  # [n, pl+1]
            LX = linv_mult(linv, X1l.expand(C, n, p_locs + 1), graph)
            P_iw = LX.transpose(1, 2) @ LX                           # [C, pl+1, pl+1]
            # cholesky the precision and solve (no explicit inverse)
            cL, _ = torch.linalg.cholesky_ex(P_iw)
            other = field + beta[:, lc] @ data.X_locs_u.T            # [C, n]
            t = (LX.transpose(1, 2) @ linv_mult(linv, other, graph)[..., None])
            mean = torch.cholesky_solve(t, cL)[..., 0]
            noise = torch.linalg.solve_triangular(
                cL.transpose(1, 2), draws.locs_z[..., None], upper=True)[..., 0]
            innov = mean + torch.exp(0.5 * state.log_scale)[:, None] * noise
            beta_0 = innov[:, 0]
            beta = beta.clone()
            beta[:, lc] = innov[:, 1:]
            field = other - innov[:, 1:] @ data.X_locs_u.T

    return replace(state, beta_0=beta_0, beta=beta, field=field)


def sweep_inputs(graph, data, state, linv, mu):
    """Iteration constants of the chromatic sweeps: (q_edges [C, E+1], the
    same values in the sweep plan's order q_plan = q_edges[:, plan_edge]
    [C, 2E] (one gather an iteration: Q is fixed across the sweeps),
    posterior precision P [C, n], residual sums rs [C, n], scal [C, 3] =
    (beta_0, e^-log_scale, e^-log_noise_variance))."""
    pdiag, q_edges = precision_diag_and_q_edges(linv, graph)
    q_plan = q_edges.index_select(1, graph.plan_edge)
    # residual sums by site in locs_match order (ref :260), independent of
    # the field
    rs = ordered_sum(data.y - mu, graph.obs_sum)
    inv_scale = torch.exp(-state.log_scale)
    inv_noise = torch.exp(-state.log_noise_variance)
    P = inv_scale[:, None] * pdiag + inv_noise[:, None] * graph.obs_per_loc
    scal = torch.stack([state.beta_0, inv_scale, inv_noise], dim=1)
    return q_edges, q_plan, P, rs, scal


def _chromatic_sweeps(graph, data, state, linv, mu, noise):
    """Block 4: one chromatic Gibbs sweep of the field per noise slice
    noise[:, s] (ref :254-275), all in one call of ops/sweep.py.  Per colour, each site
    s draws from N(beta_0 - P_s^-1 (e^-ls sum_{j~s} Q_sj (w_j - beta_0)
    - e^-lnv rs_s), P_s^-1)."""
    _, q_plan, P, rs, scal = sweep_inputs(graph, data, state, linv, mu)
    w = state.field.clone(memory_format=torch.contiguous_format)
    chromatic_sweeps(w, q_plan, P, rs, noise.contiguous(), scal,
                     graph.color_ptr, graph.plan_sites, graph.plan_ptr,
                     graph.plan_nbr)
    return replace(state, field=w)


def _noise_steps(graph, data, cfg, state, mu, z, u):
    """Block 5: cfg.noise_steps MH moves on log_noise_variance with proposal
    sd 0.01 and support exp(.) < var(y) (ref :277-293)."""
    sse = _obs_sse(data, state.field, mu, state.beta_0, graph)
    return _noise_mh(data, cfg, state, sse, graph.n_obs, z, u)


def _noise_mh(data, cfg, state, sse, n_obs, z, u):
    """The noise MH moves given the observation SSE [C]."""
    lnv = state.log_noise_variance
    for i in range(cfg.noise_steps):
        innov = z[:, i] * 0.01
        # expm1 form of exp(-lnv-innov) - exp(-lnv)
        ratio = (-0.5 * n_obs * innov
                 - 0.5 * sse * torch.exp(-lnv) * torch.expm1(-innov))
        ok = (torch.exp(lnv + innov) < data.var_y) & (ratio > torch.log(u[:, i]))
        lnv = torch.where(ok, lnv + innov, lnv)
    return replace(state, log_noise_variance=lnv)


def _adapt(tk, acc_count, z, enabled, mean_step, window, am_active):
    """Adaptive step size (ref :153-157, :209-213): acceptance below the
    band shrinks the proposal log-variance by N(mean_step, .05), above it
    grows it; band [.05, .15], or [.15, .35] while AM is active; clamped to
    [-30, 6]."""
    if not enabled:
        return tk
    rate = acc_count / window
    lo = torch.where(am_active, 0.15, 0.05)
    hi = torch.where(am_active, 0.35, 0.15)
    step = mean_step + 0.05 * z
    new_tk = torch.where(rate < lo, tk - step,
                         torch.where(rate > hi, tk + step, tk))
    return torch.clamp(new_tk, -30.0, 6.0)


def _mu_obs(data, state, graph):
    """Per-observation fixed-effect mean mu = beta_0 + X beta, [C, n_obs]."""
    if data.X.shape[1] > 0:
        return state.beta_0[:, None] + state.beta @ data.X.T
    return state.beta_0[:, None].expand(-1, graph.n_obs)


def gibbs_iteration(graph, data, cfg: UpdateConfig, carry, it: int,
                    iter_start: int, draws: IterationDraws):
    """One full Gibbs iteration of every chain.  carry = (state, linv,
    acc_anc, acc_suf); ``it`` is the iteration's index in the cycle and
    ``iter_start`` the global iteration the cycle started at."""
    state, linv, acc_anc, acc_suf = carry
    mu = _mu_obs(data, state, graph)
    C = _proposal_chol(state)
    for rep in range(max(1, cfg.covparams_steps)):
        if cfg.ancillary:
            with span("ancillary"):
                state, linv, a = _ancillary_step(
                    graph, data, cfg, state, linv, mu, draws.anc_z[rep],
                    draws.anc_u[rep], C=C)
            acc_anc = acc_anc + a
        with span("sufficient"):
            state, linv, a = _sufficient_step(
                graph, data, cfg, state, linv, draws.suf_z[rep],
                draws.suf_u[rep], C=C)
        acc_suf = acc_suf + a
    with span("adapt"):
        state, acc_anc, acc_suf = _adapt_and_am(cfg, state, acc_anc, acc_suf,
                                                it, iter_start, draws.adapt_z)
    with span("beta"):
        state = _beta_step(graph, data, cfg, state, linv, draws)
    mu = _mu_obs(data, state, graph)
    with span("sweeps"):
        state = _chromatic_sweeps(graph, data, state, linv, mu, draws.sweep_z)
    with span("noise"):
        state = _noise_steps(graph, data, cfg, state, mu, draws.noise_z,
                             draws.noise_u)
    return (state, linv, acc_anc, acc_suf)


def _adapt_and_am(cfg, state, acc_anc, acc_suf, it, iter_start, adapt_z):
    """The step-size adaptation and the AM moments after the MH pairs of
    iteration ``it``: (state, acc_anc, acc_suf)."""
    # AM is active from the moments the iteration started with (only
    # _am_update, below, changes them)
    am_active = (torch.zeros_like(state.log_scale, dtype=torch.bool)
                 if state.prop_mean is None
                 else state.prop_count >= _AM_MIN_COUNT)
    # adaptation every adapt_window iterations while the cycle starts early
    # enough (ref :153); acceptance counts covparams_steps moves/iteration
    if (it + 1) % cfg.adapt_window == 0:
        window = cfg.adapt_window * max(1, cfg.covparams_steps)
        enabled = iter_start <= cfg.adapt_until
        state = replace(
            state,
            tk_ancillary=_adapt(state.tk_ancillary, acc_anc, adapt_z[:, 0],
                                enabled, 0.4, window, am_active),
            tk_sufficient=_adapt(state.tk_sufficient, acc_suf, adapt_z[:, 1],
                                 enabled, 0.2, window, am_active),
        )
        acc_anc = torch.zeros_like(acc_anc)
        acc_suf = torch.zeros_like(acc_suf)
    # AM moments accumulate from the start and restart at adapt_until/2 and
    # at adapt_until (see nngp_tpu's _pre_chromatic)
    gi = iter_start + it
    state = _am_update(state, reset=gi in (cfg.adapt_until // 2,
                                           cfg.adapt_until))
    return state, acc_anc, acc_suf


RECORD_KEYS = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape")


def run_cycle(graph, data, cfg: UpdateConfig, state: ChainState,
              key: DrawKey, iter_start: int, saved_slots=None,
              iteration=gibbs_iteration, factor=vecchia_linv):
    """cfg.n_iterations iterations of every chain (one mclapply worker body
    per chain, ref :27-315): returns (state, records) with the records on
    the device, iterations leading ([T, C, ...]; "field" [n_saved, C, w]).
    ``key`` is the cycle's draw key for ``state``'s chains (row c of the
    state is chain ``key.chains[c]``).

    ``saved_slots`` (host ints [n_iterations], values in [0, cfg.n_saved])
    routes each iteration's field snapshot to a record row; the value
    cfg.n_saved drops it.  None records every iteration.  The Vecchia
    factor is rebuilt from the current state at cycle start (ref :67-74).
    ``iteration`` and ``factor`` (signatures of ``gibbs_iteration`` and
    ``vecchia_linv``) are the iteration and the factor build: halo mode
    passes its sharded ones."""
    T = cfg.n_iterations
    C, n = state.field.shape
    p = state.beta.shape[1]
    dev, dt = state.field.device, state.field.dtype
    n_saved = T if cfg.n_saved < 0 else cfg.n_saved
    if tuple(key.chains.shape) != (C,) or key.chains.device != dev:
        raise ValueError(f"the draw key holds {tuple(key.chains.shape)} "
                         f"chain ids on {key.chains.device}, the state {C} "
                         f"chains on {dev}")
    if saved_slots is None:
        saved_slots = np.arange(T)
    rec = {k: torch.empty((T,) + tuple(getattr(state, k).shape), dtype=dt,
                          device=dev) for k in RECORD_KEYS}
    cols = (None if cfg.field_cols is None
            else torch.as_tensor(cfg.field_cols, dtype=torch.int64, device=dev))
    width = n if cols is None else len(cfg.field_cols)
    fbuf = torch.empty(n_saved, C, width, dtype=dt, device=dev)

    linv = factor(graph, _natural_shape(cfg, state.shape))
    zero = torch.zeros_like(state.log_scale)
    carry = (state, linv, zero, zero)
    for it in range(T):
        with span("iteration", index=it):
            with span("draws"):
                draws = IterationDraws.draw(key, it, cfg, n, p, dt)
            carry = iteration(graph, data, cfg, carry, it, iter_start, draws)
            state = carry[0]
            with span("record"):
                for k in RECORD_KEYS:
                    rec[k][it] = getattr(state, k)
                slot = int(saved_slots[it])
                if slot < n_saved:
                    fbuf[slot] = (state.field if cols is None
                                  else state.field[:, cols])
    rec["field"] = fbuf
    return carry[0], rec
