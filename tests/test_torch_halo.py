"""Halo mode's parts (nngp_tpu_torch/parallel/halo.py, the sub-plan step of
ops/sweep.py) on the CPU, against nngp_tpu/parallel/halo.py.

- ``build_halo_plan``: ``owner``, ``need_rows``, ``owned_rows`` and
  ``obs_owner`` equal ``nngp_tpu``'s for D = 2, 3 (prime: 1-D stripes), 4
  and an adversarial ``owner=``; the owned sub-plans split every colour
  step, keep the plan's order and their rows; the send lists hold what the
  other ranks' need sets hold;
- ``chromatic_sweep_step`` on sub-plans, colour by colour, gives the
  unsharded plain sweep's bits;
- over gloo ranks (one ``launch_local`` of 4 local processes: a pair for
  D = 2, all four for D = 4; the ranks write their results to a file):
  ``halo_level_solve`` within 1e-6 of the port's ``level_solve`` and of
  ``nngp_tpu``'s ``halo_level_solve`` on the 4 virtual devices of
  tests/conftest.py (tests/test_halo.py's tolerance); halo sweeps with
  injected and zero noise differ from the port's unsharded plain sweep in
  0 elements, and with zero noise are within 2e-6 of ``nngp_tpu``'s flat
  sweep (``zero_sweep_noise``).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from nngp_tpu.models.gaussian import (
    UpdateConfig as JaxConfig,
    _chromatic_sweeps as jax_sweeps,
    _mu_obs as jax_mu,
)
from nngp_tpu.ops.vecchia import vecchia_linv as jax_linv
from nngp_tpu.parallel.halo import build_halo_plan as jax_plan
from nngp_tpu.parallel.halo import halo_level_solve as jax_halo_level_solve
from nngp_tpu_torch.interop import graph_from_numpy
from nngp_tpu_torch.models import gaussian as tg
from nngp_tpu_torch.ops import sweep
from nngp_tpu_torch.ops.trisolve import level_solve
from nngp_tpu_torch.parallel.distributed import launch_local
from nngp_tpu_torch.parallel.halo import build_halo_plan
from nngp_tpu_torch.preprocess.graph import PLAN_FIELDS

from tests.test_gibbs import build_problem, make_state

torch.set_num_threads(1)
S = 3                       # sweeps
C = 2                       # chains
PLAN_KEYS = ("owner", "need_rows", "owned_rows", "obs_owner")


@pytest.fixture(scope="module")
def problem():
    """tests/test_halo.py's problem (150 sites, 220 observations), both
    packages' graphs, two chains' factors, a right-hand side and the
    sweeps' inputs."""
    rng = np.random.default_rng(12345)
    g, NN, data, maps = build_problem(rng, n_unique=150, n_obs=220)
    states = [make_state(g, 0, rng, beta_0=b0, log_scale=ls, lnv=lnv,
                         log_range=lr)
              for b0, ls, lnv, lr in ((0.7, 0.3, -0.5, -0.2),
                                      (-0.3, 0.1, -0.2, 0.1))]
    linv = np.stack([np.asarray(jax_linv(g, jnp.exp(s.shape)))
                     for s in states])
    host = graph_from_numpy(g)
    gt = host.to("cpu")
    st = tg.ChainState(**{
        k: torch.as_tensor(np.stack([np.asarray(getattr(s, k))
                                     for s in states]))
        for k in ("beta_0", "beta", "log_scale", "log_noise_variance",
                  "shape", "field", "tk_ancillary", "tk_sufficient")})
    dt = tg.ModelData(**{k: torch.as_tensor(np.array(getattr(data, k)))
                         for k in ("y", "X", "X_locs_u", "solve_1XT1X",
                                   "chol_solve_1XT1X_lower", "var_y",
                                   "range_cap")})
    mu = tg._mu_obs(dt, st, gt)
    q_edges, _, Pp, rs, scal = tg.sweep_inputs(gt, dt, st,
                                               torch.as_tensor(linv), mu)
    noise = np.random.default_rng(3).normal(size=(C, S, g.n)).astype(
        np.float32)
    v = rng.normal(size=(C, g.n)).astype(np.float32)
    return dict(g=g, data=data, states=states, host=host, gt=gt, st=st,
                dt=dt, linv=linv, v=v, noise=noise, q_edges=q_edges, P=Pp,
                rs=rs, scal=scal)


def _twin(problem, noise):
    """The port's unsharded plain sweeps on the problem's inputs."""
    gt, st = problem["gt"], problem["st"]
    w = st.field.clone()
    sweep.chromatic_sweeps_reference(
        w, problem["q_edges"].index_select(1, gt.plan_edge), problem["P"],
        problem["rs"], torch.as_tensor(noise), problem["scal"], gt.color_ptr,
        gt.plan_sites, gt.plan_ptr, gt.plan_nbr)
    return w.numpy()


# --- the plan ---------------------------------------------------------------

def _owner(case, n):
    if case == "adversarial":        # every site to a random rank of 3
        return 3, np.random.default_rng(0).integers(0, 3, n).astype(np.int32)
    return case, None


@pytest.mark.parametrize("case", [2, 3, 4, "adversarial"])
def test_plan_matches_nngp_tpu(problem, case):
    D, owner = _owner(case, problem["host"].n)
    got = build_halo_plan(problem["host"], D, owner=owner)
    want = jax_plan(problem["g"], D, owner=owner)
    assert got.D == want.D == D
    for k in PLAN_KEYS:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)


@pytest.mark.parametrize("case", [2, 3, "adversarial"])
def test_sub_plans_split_every_colour_step(problem, case):
    """Each colour step's sites go to exactly one rank, their owner; each
    sub-plan is the plan's positions of its sites in the plan's order, with
    their CSR rows, so each colour stays sorted by degree; the level rows
    split the same way; each send list is what the receiver's need set
    holds of the sender's step."""
    host = problem["host"]
    n = host.n
    D, owner = _owner(case, n)
    plan = build_halo_plan(host, D, owner=owner)
    own = np.asarray(plan.owner)
    cptr, sites, ptr, nbr, edge = (np.asarray(host.color_ptr),
                                   *(np.asarray(getattr(host, k))
                                     for k in PLAN_FIELDS))
    rows = [(sites[t], nbr[ptr[t]:ptr[t + 1]], edge[ptr[t]:ptr[t + 1]])
            for t in range(n)]
    for c in range(len(cptr) - 1):
        seen = []
        for d, rk in enumerate(plan.ranks):
            sub = rk.sub
            b = sub.bounds
            for t in range(b[c], b[c + 1]):
                s = int(sub.plan_sites[t])
                assert own[s] == d
                seen.append(s)
            got = np.asarray(sub.plan_sites[b[c]:b[c + 1]])
            want = [r[0] for r in rows[cptr[c]:cptr[c + 1]] if own[r[0]] == d]
            np.testing.assert_array_equal(got, want)
            deg = np.diff(np.asarray(sub.plan_ptr))[b[c]:b[c + 1]]
            assert (np.diff(deg) <= 0).all()
        assert sorted(seen) == sorted(sites[cptr[c]:cptr[c + 1]].tolist())
    for rk in plan.ranks:
        sub = rk.sub
        where = {s: t for t, s in enumerate(sites)}
        for t, s in enumerate(np.asarray(sub.plan_sites)):
            _, nb, ed = rows[where[s]]
            p0, p1 = sub.plan_ptr[t], sub.plan_ptr[t + 1]
            np.testing.assert_array_equal(sub.plan_nbr[p0:p1], nb)
            np.testing.assert_array_equal(sub.plan_edge[p0:p1], ed)
    need = np.zeros((D, n), dtype=bool)
    for d, r in enumerate(plan.need_rows):
        need[d, r[r < n]] = True

    def sweep_step(rk, t):
        return rk.sub.plan_sites[rk.sub.bounds[t]:rk.sub.bounds[t + 1]]

    def level_step(rk, t):
        return rk.level_rows[rk.level_ptr[t]:rk.level_ptr[t + 1]]

    parts = [plan.for_rank(d) for d in range(D)]
    for sched, at, name in ((plan.sweep, sweep_step, "sweep"),
                            (plan.level, level_step, "level")):
        T = (len(cptr) - 1 if name == "sweep"
             else len(plan.ranks[0].level_ptr) - 1)
        for t in range(T):
            step = [np.asarray(at(rk, t)) for rk in plan.ranks]
            for d in range(D):
                assert (own[step[d]] == d).all()
                x = getattr(parts[d], name)
                for j, k in enumerate(sched.dists):
                    got = np.asarray(x.send[j][x.send_ptr[j][t]:
                                               x.send_ptr[j][t + 1]])
                    want = step[d][need[(d + k) % D, step[d]]]
                    np.testing.assert_array_equal(got, want)
                    # what d + k receives from d is what d sends
                    y = getattr(parts[(d + k) % D], name)
                    np.testing.assert_array_equal(
                        np.asarray(y.recv[j][y.recv_ptr[j][t]:
                                             y.recv_ptr[j][t + 1]]), want)
    assert sum(len(rk.level_rows) for rk in plan.ranks) == n


@pytest.mark.parametrize("D", [1, 2])
def test_steps_on_sub_plans_equal_the_plain_sweep(problem, D):
    """Every rank's colour step on one mirror, colour by colour: the
    unsharded plain sweep's bits (no exchange needed on one mirror)."""
    gt = problem["gt"]
    plan = build_halo_plan(problem["host"], D)
    subs = [plan.for_rank(d).to("cpu").rank.sub for d in range(D)]
    w = problem["st"].field.clone()
    before = sweep.chromatic_sweeps.launches
    for s in range(S):
        z = torch.as_tensor(problem["noise"][:, s:s + 1]).contiguous()
        for c in range(gt.n_colors):
            for sub in subs:
                q_plan = problem["q_edges"].index_select(1, sub.plan_edge)
                sweep.chromatic_sweep_step(w, q_plan, problem["P"],
                                           problem["rs"], z, problem["scal"],
                                           sub, c)
    assert sweep.chromatic_sweeps.launches == before
    np.testing.assert_array_equal(w.numpy(), _twin(problem, problem["noise"]))


# --- over gloo ranks ----------------------------------------------------------

RANK = r"""
import pickle, sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from nngp_tpu_torch.parallel import initialize_distributed
from nngp_tpu_torch.parallel.halo import (build_halo_plan,
                                          halo_chromatic_sweeps,
                                          halo_level_solve)
torch.set_num_threads(1)
assert initialize_distributed(device_type="cpu")
with open(sys.argv[1], "rb") as f:
    p = pickle.load(f)
g = p["host"].to("cpu")
pairs = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pair", "sites"))
out = {}
for D, group in ((2, pairs["sites"].get_group()), (4, dist.group.WORLD)):
    d = dist.get_rank(group)
    plan = build_halo_plan(p["host"], D).for_rank(d).to("cpu")
    out[f"level{D}"] = halo_level_solve(
        g, plan, torch.as_tensor(p["linv"]), torch.as_tensor(p["v"]),
        group).numpy()
    q_plan = p["q_edges"].index_select(1, plan.rank.sub.plan_edge)
    for name, noise in (("zero", np.zeros_like(p["noise"])),
                        ("injected", p["noise"])):
        w = p["field"].clone()
        out[f"sweep{D}_{name}"] = halo_chromatic_sweeps(
            w, q_plan, p["P"], p["rs"], torch.as_tensor(noise), p["scal"],
            plan, group).numpy()
with open(sys.argv[2] + f".{dist.get_rank()}", "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    """Every rank's results: D = 2 on the pairs (0, 1) and (2, 3), D = 4 on
    all four."""
    d = tmp_path_factory.mktemp("halo_ranks")
    keys = ("host", "linv", "v", "noise", "q_edges", "P", "rs", "scal")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(dict({k: problem[k] for k in keys},
                         field=problem["st"].field), f)
    launch_local(["-c", RANK, str(d / "in.pkl"), str(d / "out")], 4,
                 timeout=240, env={"OMP_NUM_THREADS": "1"})
    out = []
    for r in range(4):
        with open(d / f"out.{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


def _jax_halo_level_solve(problem, D=4):
    g = problem["g"]
    plan = jax_plan(g, D)
    mesh = Mesh(np.array(jax.devices()[:D]), ("sites",))
    fn = jax.jit(jax.shard_map(
        lambda linv_, v_: jax_halo_level_solve(g, plan, linv_, v_),
        mesh=mesh, in_specs=(P(), P()), out_specs=P()))
    return np.stack([np.asarray(fn(jnp.asarray(problem["linv"][c]),
                                   jnp.asarray(problem["v"][c])))
                     for c in range(C)])


@pytest.mark.parametrize("D", [2, 4])
def test_halo_level_solve(problem, ranks, D):
    want = level_solve(torch.as_tensor(problem["linv"]),
                       torch.as_tensor(problem["v"]), problem["gt"]).numpy()
    got = [r[f"level{D}"] for r in ranks]
    for x in got:                     # reconciled: the same on every rank
        np.testing.assert_array_equal(x, got[0])
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], _jax_halo_level_solve(problem),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("noise", ["zero", "injected"])
@pytest.mark.parametrize("D", [2, 4])
def test_halo_sweeps_equal_the_plain_sweep(problem, ranks, D, noise):
    z = problem["noise"] if noise == "injected" else np.zeros_like(
        problem["noise"])
    want = _twin(problem, z)
    for r in ranks:
        got = r[f"sweep{D}_{noise}"]
        assert int((got != want).sum()) == 0


def test_halo_sweeps_near_nngp_tpu_flat_zero_noise(problem, ranks):
    g, data = problem["g"], problem["data"]
    cfg = JaxConfig(n_iterations=1, shape_names=("log_range",), locs_cols=(),
                    n_chromatic=S, chromatic_schedule="flat",
                    zero_sweep_noise=True)
    want = np.stack([np.asarray(jax_sweeps(
        g, data, cfg, s, jnp.asarray(problem["linv"][c]), jax_mu(data, s, g),
        jax.random.key(0)).field) for c, s in enumerate(problem["states"])])
    for D in (2, 4):
        np.testing.assert_allclose(ranks[0][f"sweep{D}_zero"],
                                   want, rtol=0, atol=2e-6)
