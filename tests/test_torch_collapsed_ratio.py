"""The port's sufficient log ratio (``models/gaussian.py:_sufficient_step``
through ``ops/vecchia.py:nngp_loglik_diff``) against the float64 ratio of
the benchmark's plain reference (``benchmark/reference/model.py``:
``Model.factor``, ``lmult`` and the ratio in ``Model.sufficient``), on the
CPU, for ``matern_sphere`` and ``exponential_sphere`` at a benign state and
at a collapsed one.

The benign state is ``initialize``'s.  The collapsed state is the one a
Matérn chain of the Heavy-metals fit reached: log_scale -16.93, a range at
which most sites sit at the Matérn floor d = 1e-5 of the conditional
variance (for the exponential family, whose float32 build does not reach
that floor soundly, a range of e^-2), and a float32 field of beta_0 plus
white noise of sd exp(log_scale / 2).  That field is off the prior: its
quadratic form z'z exp(-log_scale) is ~1e7-1e8, so a float32 rounding of z
or of exp(-log_scale) moves the ratio by whole units.  The proposals are
tiny, so the true ratio stays within a few hundred.  Each proposal is a
float32 point reached exactly (step size tk 0, the identity AM factor), so
both sides rate the same (log_scale, shape).

Tolerance: 0.5 in the log ratio, half the benchmark's ``decision_margin``
limit of 1, above the ~0.25 that the float32 rounding of the stored rows
and of the natural shape (range, smoothness) alone leave at this size.

A 1 x 1 halo mesh (``parallel/halo_gibbs.py:_halo_sufficient``, one gloo
rank) gives ``_sufficient_step``'s ratio bit for bit at the collapsed state.

Imports nothing of ``nngp_tpu`` and no JAX.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

import nngp_tpu_torch
from benchmark.data import heavy_metals
from benchmark.reference import model as M
from benchmark.reference import setup
from nngp_tpu_torch.models import gaussian as G
from nngp_tpu_torch.ops.vecchia import vecchia_linv
from nngp_tpu_torch.parallel.distributed import launch_local

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 0.5
N_SITES = 3000
C = 2
COLLAPSED_LOG_SCALE = -16.93
# log range of the collapsed state: Matérn at its d floor at most sites
COLLAPSED_LOG_RANGE = {"matern_sphere": 4.0, "exponential_sphere": -2.0}
# (log_scale step, shape steps): the true ratio stays within a few hundred
STEPS = {"collapsed": [(3e-6, (2e-6, 1e-6)), (4e-6, (0.0, 0.0))],
         "benign": [(0.05, (0.03, -0.04)), (-0.04, (0.0, 0.05))]}


def problem(covfun, n_sites=N_SITES, device="cpu"):
    """(data, the port's fit of it on ``device``) at Heavy-metals' shapes
    cut to ``n_sites`` sites over the whole extent, 3 covariates."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "hm_matern.json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg.update(n_sites=n_sites, n_obs=n_sites + n_sites // 10,
               n_covariates=3)
    data = heavy_metals.make(cfg, 2210000029)
    mc = nngp_tpu_torch.initialize(
        data["observed_locs"], data["observed_field"], X_locs=data["X_locs"],
        m=5, stationary_covfun=covfun, n_chains=C, seed=1, device=device,
        verbose=False)
    return data, mc


def update_config(mc):
    return G.UpdateConfig(1, tuple(mc.space_time_model["covfun"][
        "shape_params"]), tuple(mc.design.locs_cols))


def chain_state(mc, kind):
    """The chains' state of ``kind`` ("benign" or "collapsed") with step
    size tk 0 on both proposals."""
    s = mc.states
    zero = torch.zeros_like(s.log_scale)
    if kind == "benign":
        return G.replace(s, tk_ancillary=zero, tk_sufficient=zero)
    covfun = mc.graph.covfun
    shape = torch.full_like(s.shape, 0.3)
    shape[:, 0] = COLLAPSED_LOG_RANGE[covfun]
    rng = np.random.default_rng(5)
    noise = torch.as_tensor(rng.normal(size=tuple(s.field.shape)))
    field = (s.beta_0.double().cpu()[:, None] + noise * np.exp(
        COLLAPSED_LOG_SCALE / 2)).to(s.field)
    return G.replace(s, log_scale=torch.full_like(s.log_scale,
                                                  COLLAPSED_LOG_SCALE),
                     shape=shape, field=field, tk_ancillary=zero,
                     tk_sufficient=zero)


def proposal_z(state, step):
    """The innovation [C, d] that moves ``state`` to the float32 point
    (log_scale + dls, shape + dsh) exactly: with tk 0 and the identity AM
    factor the innovation is z itself, and both differences are exact."""
    dls, dsh = step
    ls, shape = state.log_scale, state.shape
    new_ls = ls + dls
    new_shape = shape + torch.tensor(dsh[:shape.shape[1]], dtype=shape.dtype,
                                     device=shape.device)
    return torch.cat([(new_ls - ls)[:, None], new_shape - shape], 1)


def port_ratio(mc, state, z, monkeypatch):
    """``_sufficient_step``'s log ratio [C] (float64) at ``z``."""
    seen = []
    accept = G._accept

    def spy(*args, **kwargs):
        seen.append(args[6])
        return accept(*args, **kwargs)

    monkeypatch.setattr(G, "_accept", spy)
    g = mc.graph
    linv = vecchia_linv(g, G._natural_shape(update_config(mc), state.shape))
    u = torch.full_like(state.log_scale, 0.5)
    G._sufficient_step(g, mc.data, update_config(mc), state, linv, z, u)
    monkeypatch.undo()
    return seen[0].double().cpu()


def reference_ratio(mdl, state, z, monkeypatch):
    """The float64 ratio of ``Model.sufficient`` [C] from the same state
    and innovation."""
    seen = []
    decide = M.Model.decide

    def spy(self, rows, cand, ratio, *args, **kwargs):
        seen.append(ratio)
        return decide(self, rows, cand, ratio, *args, **kwargs)

    monkeypatch.setattr(M.Model, "decide", spy)
    host = {k: None if getattr(state, k) is None
            else getattr(state, k).double().cpu().numpy()
            for k in M.STATE_KEYS}
    rows = mdl.rows_of(host, "cpu")
    mdl.sufficient(rows, z.double().cpu(), torch.full((C,), 0.5,
                                                      dtype=torch.float64),
                   0.0, False, 0)
    monkeypatch.undo()
    return seen[0]


@pytest.fixture(scope="module", params=["matern_sphere",
                                        "exponential_sphere"])
def fit(request):
    covfun = request.param
    data, mc = problem(covfun)
    derived = setup.derive(data, covfun, 5, "cpu")
    assert np.array_equal(np.asarray(mc.locs), derived["locs"])
    assert np.array_equal(np.sort(np.asarray(mc.NNarray)[:, 1:], 1),
                          np.sort(derived["NN"][:, 1:], 1))
    return mc, derived["model"]


@pytest.mark.parametrize("kind", ["benign", "collapsed"])
def test_sufficient_ratio_matches_float64_reference(fit, kind, monkeypatch):
    mc, mdl = fit
    state = chain_state(mc, kind)
    if kind == "collapsed" and mc.graph.covfun.startswith("matern"):
        linv = vecchia_linv(mc.graph, G._natural_shape(update_config(mc),
                                                       state.shape))
        floored = (linv[..., 0] > 0.99 / np.sqrt(mc.graph.d_floor)).float()
        assert floored.mean() > 0.9          # most sites at the d floor
    for step in STEPS[kind]:
        z = proposal_z(state, step)
        got = port_ratio(mc, state, z, monkeypatch)
        want = reference_ratio(mdl, state, z, monkeypatch)
        assert torch.isfinite(want).all() and want.abs().max() < 5e3
        gap = (got - want).abs().max().item()
        assert gap < TOL, (kind, step, got.tolist(), want.tolist())


HALO_RANK = r"""
import json, sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
import test_torch_collapsed_ratio as T
from nngp_tpu_torch.models import gaussian as G
from nngp_tpu_torch.ops.vecchia import vecchia_linv
from nngp_tpu_torch.parallel import halo_gibbs as H
from nngp_tpu_torch.parallel import initialize_distributed
from nngp_tpu_torch.parallel.halo import build_halo_plan

torch.set_num_threads(1)
initialize_distributed(device_type="cpu")
_, mc = T.problem("matern_sphere")
g, cfg = mc.graph, T.update_config(mc)
state = T.chain_state(mc, "collapsed")
linv = vecchia_linv(g, G._natural_shape(cfg, state.shape))
plan = build_halo_plan(g, 1).for_rank(0).to("cpu")
shard = H.local_shard(g, mc.data, plan, dist.group.WORLD)
seen = []
accept = G._accept
def spy(*args, **kwargs):
    seen.append(args[6])
    return accept(*args, **kwargs)
G._accept = H._accept = spy
u = torch.full_like(state.log_scale, 0.5)
out = []
for step in T.STEPS["collapsed"]:
    z = T.proposal_z(state, step)
    G._sufficient_step(g, mc.data, cfg, state, linv, z, u)
    H._halo_sufficient(g, cfg, mc.data, shard, state, linv, z, u)
    out.append([seen[-2].tolist(), seen[-1].tolist(), str(seen[-1].dtype)])
print(json.dumps(out))
dist.destroy_process_group()
"""


def test_one_by_one_halo_sufficient_equals_sufficient_step():
    lines = launch_local(["-c", HALO_RANK, os.path.join(ROOT, "tests")], 1,
                         timeout=300, env={"OMP_NUM_THREADS": "1"})
    out = json.loads(lines[0].strip().splitlines()[-1])
    assert len(out) == len(STEPS["collapsed"])
    for plain, halo, dtype in out:
        assert dtype == "torch.float64"
        assert halo == plain
