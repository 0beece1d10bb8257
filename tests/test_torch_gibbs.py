"""The port's Gibbs iteration and run loop against nngp_tpu's.

Each port block takes its random numbers as tensors, so the test replays
nngp_tpu's key splits (models/gaussian.py: _pre_chromatic's split(key, 6)
and fold_in per ASIS pair, _ancillary/_sufficient_step's split, _beta_step's
split(key, 3), the flat sweep's fold_in per (sweep, block), _noise_steps'
fold_in + split) and injects exactly the draws nngp_tpu makes.  Then every
accept decision must agree and fields and parameters agree to atol 1e-4
(float32 rounding: torch.exp against exp_acc, float64 against double-float
sums, summation order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nngp_tpu
import nngp_tpu_torch
from nngp_tpu.models.gaussian import (
    UpdateConfig as JaxConfig,
    gibbs_iteration as jax_gibbs,
)
from nngp_tpu.ops.covariance import shape_transform as jax_shape_transform
from nngp_tpu.ops.vecchia import vecchia_linv as jax_linv
from nngp_tpu_torch.interop import from_numpy, states_to_numpy
from nngp_tpu_torch.models import gaussian as tg

torch.set_num_threads(1)

C = 2
F32 = jnp.float32
STATE_FIELDS = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
                "field", "tk_ancillary", "tk_sufficient", "prop_mean",
                "prop_m2", "prop_count")


def _problem(p_locs, seed=3, n=300, family="exponential_isotropic"):
    rng = np.random.default_rng(seed)
    locs = rng.uniform(size=(n, 2))
    X = ({f"x{j}": rng.normal(size=n) for j in range(p_locs)}
         if p_locs else None)
    y = rng.normal(size=n) + locs[:, 0]
    mc = nngp_tpu.initialize(locs, y, X_locs=X, m=5, n_chains=C, seed=seed,
                             stationary_covfun=family)
    return mc


def replay_draws(key, cfg: JaxConfig, graph, p, n_shape):
    """The draws nngp_tpu's flat-schedule gibbs_iteration makes from
    ``key``, as the port's per-chain draw arrays."""
    keys = jax.random.split(key, 6)
    d = 1 + n_shape
    out = {k: [] for k in ("anc_z", "anc_u", "suf_z", "suf_u")}
    for rep in range(max(1, cfg.covparams_steps)):
        for name, base in (("anc", keys[0]), ("suf", keys[1])):
            k1, k2 = jax.random.split(jax.random.fold_in(base, rep))
            out[name + "_z"].append(jax.random.normal(k1, (d,), dtype=F32))
            out[name + "_u"].append(jax.random.uniform(k2, dtype=F32))
    ka1, ka2 = jax.random.split(keys[2])
    out["adapt_z"] = [jax.random.normal(ka1, dtype=F32),
                      jax.random.normal(ka2, dtype=F32)]
    k1, k2, k3 = jax.random.split(keys[3], 3)
    out["beta0_z"] = jax.random.normal(k1, dtype=F32)
    out["beta_z"] = jax.random.normal(k2, (p + 1,), dtype=F32)
    out["locs_z"] = jax.random.normal(k3, (len(cfg.locs_cols) + 1,), dtype=F32)
    blocks = np.asarray(graph.chrom_blocks)
    n = graph.n
    sweep = np.zeros((cfg.n_chromatic, n), dtype=np.float32)
    for s in range(cfg.n_chromatic):
        for b, sites in enumerate(blocks):
            kc = jax.random.fold_in(keys[4], s * 1_000_003 + b)
            z = np.asarray(jax.random.normal(kc, sites.shape, dtype=F32))
            sweep[s, sites[sites < n]] = z[sites < n]
    out["sweep_z"] = sweep
    nz, nu = [], []
    for i in range(cfg.noise_steps):
        k1, k2 = jax.random.split(jax.random.fold_in(keys[5], i))
        nz.append(jax.random.normal(k1, dtype=F32))
        nu.append(jax.random.uniform(k2, dtype=F32))
    out["noise_z"], out["noise_u"] = nz, nu
    return {k: np.asarray(v, dtype=np.float32) for k, v in out.items()}


def port_draws(per_chain):
    """Stack per-chain replayed draws into the port's IterationDraws."""
    st = {k: torch.as_tensor(np.stack([d[k] for d in per_chain]))
          for k in per_chain[0]}
    return tg.IterationDraws(
        anc_z=st["anc_z"].transpose(0, 1), anc_u=st["anc_u"].T,
        suf_z=st["suf_z"].transpose(0, 1), suf_u=st["suf_u"].T,
        adapt_z=st["adapt_z"], beta0_z=st["beta0_z"], beta_z=st["beta_z"],
        locs_z=st["locs_z"], sweep_z=st["sweep_z"], noise_z=st["noise_z"],
        noise_u=st["noise_u"])


def _am_warm(mc, rng):
    """States whose AM accumulators are past the activation count, so the
    proposal is the correlation-shaped one and the [.15, .35] band applies."""
    s = mc.states
    d = s.prop_mean.shape[1]
    A = rng.normal(size=(C, d, d)) * 0.3
    m2 = (A @ A.transpose(0, 2, 1) + np.eye(d)) * 150.0
    return type(s)(**{**{f: getattr(s, f) for f in STATE_FIELDS},
                      "prop_m2": m2.astype(np.float32),
                      "prop_count": np.full(C, 150.0, np.float32)})


def _compare(port_state, jax_states, acc_port, acc_jax, label):
    ps = states_to_numpy(port_state)
    for f in STATE_FIELDS:
        want = np.stack([np.asarray(getattr(js, f)) for js in jax_states])
        np.testing.assert_allclose(ps[f], want, atol=1e-4, rtol=1e-5,
                                   err_msg=f"{label}: {f}")
    for a_p, a_j in zip(acc_port, acc_jax):
        np.testing.assert_array_equal(a_p.numpy(),
                                      np.stack([np.asarray(a) for a in a_j]),
                                      err_msg=f"{label}: accept counts")


def _run_both(mc, its, iter_start, am_warm=False, states=None):
    g = mc.graph
    names = tuple(mc.space_time_model["covfun"]["shape_params"])
    locs_cols = tuple(int(c) for c in mc.design.locs_cols)
    jcfg = JaxConfig(n_iterations=len(its), shape_names=names,
                     locs_cols=locs_cols, chromatic_schedule="flat")
    tcfg = tg.UpdateConfig(n_iterations=len(its), shape_names=names,
                           locs_cols=locs_cols)
    if states is None:
        states = (_am_warm(mc, np.random.default_rng(0)) if am_warm
                  else mc.states)
    g_t, data_t, state_t = from_numpy(g, mc.data, states, device="cpu")
    jstates = [jax.tree.map(lambda x: jnp.asarray(x)[c], states)
               for c in range(C)]
    jlinv = [jax_linv(g, jax_shape_transform(list(names), s.shape))
             for s in jstates]
    zero = jnp.zeros((), F32)
    jcarry = [(s, l, zero, zero) for s, l in zip(jstates, jlinv)]
    tcarry = (state_t, torch.as_tensor(np.stack([np.asarray(l) for l in jlinv])),
              torch.zeros(C), torch.zeros(C))
    step = jax.jit(lambda carry, key, it, ist: jax_gibbs(
        g, mc.data, jcfg, carry, (key, it, ist))[0])
    p = np.asarray(mc.states.beta).shape[1]
    n_accepts = 0
    for it in its:
        keys = [jax.random.fold_in(jax.random.key(40 + c), it) for c in range(C)]
        draws = port_draws([replay_draws(k, jcfg, g, p, len(names))
                            for k in keys])
        jcarry = [step(jc, k, it, iter_start) for jc, k in zip(jcarry, keys)]
        tcarry = tg.gibbs_iteration(g_t, data_t, tcfg, tcarry, it, iter_start,
                                    draws)
        _compare(tcarry[0], [jc[0] for jc in jcarry], tcarry[2:],
                 ([jc[2] for jc in jcarry], [jc[3] for jc in jcarry]),
                 f"iteration {it}")
        n_accepts += int(tcarry[2].sum() + tcarry[3].sum())
    return n_accepts


@pytest.mark.parametrize("p_locs", [0, 2])
def test_one_iteration_matches_jax(p_locs):
    _run_both(_problem(p_locs), its=[0], iter_start=0)


@pytest.mark.parametrize("p_locs,am_warm,iter_start",
                         [(0, False, 978), (2, True, 0)])
def test_five_iterations_match_jax(p_locs, am_warm, iter_start):
    """Five chained iterations ending on an adaptation step (it = 24):
    without location covariates the AM accumulators restart at global
    iteration adapt_until/2 = 1000; with them the AM proposal is active
    throughout, so the adaptation uses its [.15, .35] band."""
    n_accepts = _run_both(_problem(p_locs), its=range(20, 25),
                          iter_start=iter_start, am_warm=am_warm)
    assert n_accepts > 0   # the accept parity covered accepted moves too


@pytest.mark.parametrize("p_locs", [0, 2])
def test_matern_one_iteration_matches_jax(p_locs):
    """matern_isotropic: the Bessel/series factor build inside both MH
    blocks, same draws, same accept decisions, atol 1e-4."""
    _run_both(_problem(p_locs, family="matern_isotropic"), its=[0],
              iter_start=0)


def test_matern_five_iterations_match_jax():
    n_accepts = _run_both(_problem(0, family="matern_isotropic"),
                          its=range(20, 25), iter_start=0)
    assert n_accepts > 0


def test_matern_smoothness_bound_rejects_in_both():
    """Chains at s = 6 - 1e-4 on the sampled smoothness: a proposal with
    s' > 6 must be rejected by the |s| <= 6 support bound of both packages,
    even though the likelihood is flat there."""
    mc = _problem(0, family="matern_isotropic")
    names = tuple(mc.space_time_model["covfun"]["shape_params"])
    s0 = np.asarray(mc.states.shape).copy()
    s0[:, -1] = 6.0 - 1e-4
    states = type(mc.states)(**{**{f: getattr(mc.states, f)
                                   for f in STATE_FIELDS},
                                "shape": s0.astype(np.float32)})
    # the smoothness innovations the iteration will propose (identity AM
    # factor at prop_count 0): at least one crosses s = 6
    cfg = JaxConfig(n_iterations=1, shape_names=names, locs_cols=(),
                    chromatic_schedule="flat")
    p = np.asarray(mc.states.beta).shape[1]
    crossing = []
    for c in range(C):
        d = replay_draws(jax.random.fold_in(jax.random.key(40 + c), 0), cfg,
                         mc.graph, p, len(names))
        tk = np.asarray(states.tk_ancillary)[c]
        crossing += [z[-1] * np.exp(0.5 * tk) > 1e-4
                     for z in (d["anc_z"][0], d["suf_z"][0])]
    assert any(crossing)
    _run_both(mc, its=[0], iter_start=0, states=states)
    # the bound alone rejects s' = 6 + eps, in both packages
    cfg_t = tg.UpdateConfig(n_iterations=1, shape_names=names, locs_cols=())
    from nngp_tpu.models.gaussian import _range_support as jax_support
    _, data_t, _ = from_numpy(mc.graph, mc.data, states, device="cpu")
    for s in (6.0 + 1e-3, -6.0 - 1e-3, 5.99):
        sampled = np.array([[-1.0, s]], np.float32)
        natural = np.exp(sampled)
        got = tg._range_support(cfg_t, data_t, torch.as_tensor(natural),
                                torch.as_tensor(sampled))
        want = jax_support(cfg, mc.data, jnp.asarray(natural[0]),
                           jnp.asarray(sampled[0]))
        assert bool(got[0]) == bool(want) == (abs(s) <= 6.0)


def test_run_records_match_jax_bookkeeping():
    rng = np.random.default_rng(8)
    n = 250
    locs = rng.uniform(size=(n, 2))
    y = rng.normal(size=n)
    X = {"a": rng.normal(size=n)}
    kw = dict(X_locs=X, m=4, n_chains=C, seed=2,
              stationary_covfun="exponential_isotropic")
    run_kw = dict(n_cycles=1, n_iterations_update=25, field_thinning=0.5,
                  verbose=False, Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    ref = nngp_tpu.run(nngp_tpu.initialize(locs, y, **kw),
                       chromatic_schedule="flat", **run_kw)
    mc = nngp_tpu_torch.run(nngp_tpu_torch.initialize(locs, y, device="cpu",
                                                      verbose=False,
                                                      **kw), **run_kw)
    assert mc.iterations == ref.iterations == 25
    for f in STATE_FIELDS:
        assert np.isfinite(getattr(mc.states, f).numpy()).all(), f
    for rec, rrec in zip(mc.records, ref.records):
        assert rec.keys() == rrec.keys()
        for k, v in rrec.items():
            if isinstance(v, np.ndarray):
                assert rec[k].shape == v.shape, k
        np.testing.assert_array_equal(rec["saved_field"], rrec["saved_field"])
        assert [it for it, _ in rec["iterations"]] == \
            [it for it, _ in rrec["iterations"]]
    assert len(mc.diagnostics["Gelman_Rubin_Brooks"]) == 1
    est, rest = nngp_tpu_torch.estimate(mc), nngp_tpu.estimate(ref)
    for group in ("sampled_covparams", "GpGp_covparams", "INLA_covparams"):
        assert (est["covariance_params"][group]["names"]
                == rest["covariance_params"][group]["names"])
    assert est["fixed_effects"]["names"] == rest["fixed_effects"]["names"]
    assert est["field"]["table"].shape == rest["field"]["table"].shape
