"""The chromatic sweep module (nngp_tpu_torch/ops/sweep.py): its plain
PyTorch version against nngp_tpu's sweeps, and its dispatcher.  The CUDA
kernel against the plain version is in tests/test_torch_cuda.py, which
imports no jax so that it runs on the card's machine.

Same-colour sites are never moralized neighbours, so any order of the sites
within a colour gives the same result; the port, nngp_tpu's flat schedule
and its Pallas kernel all walk the colours in the same order.  Tolerance
atol/rtol 2e-5, as tests/test_pallas_sweep.py uses: float32 summation
order of the neighbour sums, and torch.exp against exp_acc.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nngp_tpu
from nngp_tpu.models.gaussian import (
    UpdateConfig as JaxConfig,
    _chromatic_sweeps as jax_sweeps,
    _chromatic_sweeps_pallas as jax_sweeps_pallas,
    _mu_obs as jax_mu,
)
from nngp_tpu.ops.vecchia import vecchia_linv as jax_linv
from nngp_tpu.preprocess.sweep_plan import build_sweep_plan
import nngp_tpu_torch
from nngp_tpu_torch.interop import chain_state, from_numpy, graph_from_numpy
from nngp_tpu_torch.models import gaussian as tg
from nngp_tpu_torch.ops import _build, sweep
from nngp_tpu_torch.preprocess.coloring import sweep_plan
from nngp_tpu_torch.preprocess.graph import PLAN_FIELDS

torch.set_num_threads(1)

C = 2


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(4)
    n = 360
    locs = rng.uniform(size=(n, 2))
    mc = nngp_tpu.initialize(locs, rng.normal(size=n), m=4, n_chains=C,
                             seed=5, stationary_covfun="exponential_isotropic")
    g_t, data_t, states_t = from_numpy(mc.graph, mc.data, mc.states,
                                       device="cpu")
    names = tuple(mc.space_time_model["covfun"]["shape_params"])
    states = [jax.tree.map(lambda x: jnp.asarray(x)[c], mc.states)
              for c in range(C)]
    linv = np.stack([np.asarray(jax_linv(mc.graph, jnp.exp(s.shape)))
                     for s in states])
    return mc, g_t, data_t, states_t, names, states, linv


def _port_sweep(problem, noise):
    mc, g_t, data_t, states_t, names, _, linv = problem
    mu = tg._mu_obs(data_t, states_t, g_t)
    out = tg._chromatic_sweeps(g_t, data_t, states_t, torch.as_tensor(linv),
                               mu, torch.as_tensor(noise, dtype=torch.float32))
    return out.field.numpy()


def test_plain_sweep_matches_pallas_interpret_injected_noise(problem):
    mc, g_t, data_t, states_t, names, states, linv = problem
    g = mc.graph
    S = 3
    colors = np.zeros(g.n, dtype=np.int64)
    for c, row in enumerate(np.asarray(g.colors_idx)):
        colors[row[row < g.n]] = c
    plan = build_sweep_plan(
        colors, np.asarray(g.nbr_sites), np.asarray(g.nbr_edge),
        np.asarray(g.nbr_mask), n_edges=g.n_edges, L_max=512, G=16, K=2,
    )
    cfg = JaxConfig(n_iterations=1, shape_names=names, locs_cols=(),
                    n_chromatic=S, chromatic_schedule="pallas",
                    pallas_interpret=True)
    sites = np.asarray(plan.sites_nat)
    real = np.asarray(plan.wmask) > 0
    noise = np.zeros((C, S, g.n), dtype=np.float32)
    want = []
    for c in range(C):
        key = jax.random.key(100 + c)
        # the normals _chromatic_sweeps_pallas draws, moved to site order
        z = np.asarray(jax.random.normal(key, (S, plan.n_blocks, plan.G, 128),
                                         dtype=jnp.float32))
        for s in range(S):
            noise[c, s, sites[real]] = z[s][real]
        st = states[c]
        out = jax_sweeps_pallas(g, mc.data, cfg, st, jnp.asarray(linv[c]),
                                jax_mu(mc.data, st, g), key, plan)
        want.append(np.asarray(out.field))
    got = _port_sweep(problem, noise)
    np.testing.assert_allclose(got, np.stack(want), atol=2e-5, rtol=2e-5)


def test_plain_sweep_matches_flat_zero_noise(problem):
    mc, g_t, data_t, states_t, names, states, linv = problem
    S = 4
    cfg = JaxConfig(n_iterations=1, shape_names=names, locs_cols=(),
                    n_chromatic=S, chromatic_schedule="flat",
                    zero_sweep_noise=True)
    want = np.stack([
        np.asarray(jax_sweeps(mc.graph, mc.data, cfg, st, jnp.asarray(linv[c]),
                              jax_mu(mc.data, st, mc.graph),
                              jax.random.key(0)).field)
        for c, st in enumerate(states)])
    got = _port_sweep(problem, np.zeros((C, S, g_t.n)))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_cuda_branch_raises_without_kernel(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with the build disabled
    (no nvcc) the dispatcher's CUDA branch fails loudly, never falling back
    to the plain version."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    _build.cuda_library.cache_clear()
    sweep._library.cache_clear()
    fake_w = types.SimpleNamespace(device=torch.device("cuda"))
    calls = []
    monkeypatch.setattr(sweep, "chromatic_sweeps_reference",
                        lambda *a: calls.append(a))
    before = sweep.chromatic_sweeps.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        sweep.chromatic_sweeps(fake_w, *([None] * 9))
    assert not calls and sweep.chromatic_sweeps.launches == before


def test_cpu_tensor_uses_plain_version():
    rng = np.random.default_rng(0)
    # two colours on a 3-site path 0 - 1 - 2: colour 0 = {0, 2}, 1 = {1};
    # padded lists (pad site 3, pad edge 2) and the plan built from them
    nbr_sites = np.array([[1, 3], [0, 2], [1, 3]], dtype=np.int32)
    nbr_edge = np.array([[0, 2], [0, 1], [1, 2]], dtype=np.int32)
    color_ptr, color_sites = np.array([0, 2, 3]), np.array([0, 2, 1])
    plan = sweep_plan(color_ptr, color_sites, nbr_sites, nbr_edge)
    q_edges = torch.tensor([[-0.5, -0.25]])
    args = dict(
        q_plan=q_edges[:, plan[3]],
        P=torch.tensor([[2.0, 3.0, 1.5]]), rs=torch.tensor([[0.1, 0.2, 0.3]]),
        noise=torch.as_tensor(rng.normal(size=(1, 2, 3)), dtype=torch.float32),
        scal=torch.tensor([[0.3, 1.2, 0.8]]),
        color_ptr=torch.tensor(color_ptr, dtype=torch.int32),
        **{k: torch.as_tensor(v) for k, v in zip(PLAN_FIELDS[:3], plan)})
    w = torch.tensor([[1.0, -1.0, 0.5]])
    before = sweep.chromatic_sweeps.launches
    got = sweep.chromatic_sweeps(w.clone(), **args)[0].numpy().astype(np.float64)
    assert sweep.chromatic_sweeps.launches == before
    # scalar loop oracle on the padded lists
    q = q_edges[0].numpy().astype(np.float64)
    P, rs = args["P"][0].numpy(), args["rs"][0].numpy()
    b0, isc, ino = args["scal"][0].numpy()
    z = args["noise"][0].numpy()
    x = w[0].numpy().astype(np.float64)
    for s in range(2):
        for i in (0, 2, 1):
            prior = sum(q[e] * (x[j] - b0)
                        for j, e in zip(nbr_sites[i], nbr_edge[i]) if j < 3)
            x[i] = b0 - (isc * prior - ino * rs[i]) / P[i] + z[s, i] / np.sqrt(P[i])
    np.testing.assert_allclose(got, x, rtol=1e-5, atol=1e-6)


# --- the sweep plan (preprocess/coloring.py:sweep_plan) ----------------------

def _plan_of(g):
    return [np.asarray(getattr(g, k)) for k in PLAN_FIELDS]


def test_sweep_plan_sorts_each_colour_by_degree(problem):
    g = from_numpy(problem[0].graph, problem[0].data, problem[0].states,
                   device="cpu")[0]
    nbr = g.nbr_sites.numpy()
    n = g.n
    deg = (nbr < n).sum(1)
    ptr, sites = g.color_ptr.numpy(), g.color_sites.numpy()
    plan_sites, plan_ptr, plan_nbr, plan_edge = _plan_of(g)[:4]
    assert plan_ptr[0] == 0 and plan_ptr[-1] == plan_nbr.size == 2 * g.n_edges
    assert int(deg.sum()) == 2 * g.n_edges
    np.testing.assert_array_equal(np.diff(plan_ptr), deg[plan_sites])
    for c in range(len(ptr) - 1):
        got = plan_sites[ptr[c]:ptr[c + 1]]
        want = sites[ptr[c]:ptr[c + 1]]
        assert sorted(got.tolist()) == sorted(want.tolist())
        d = deg[got]
        assert (np.diff(d) <= 0).all()
        for k in np.unique(d):                        # ties in site order
            assert (np.diff(got[d == k]) > 0).all()
    assert len(np.unique(plan_sites)) == n


def test_sweep_plan_rows_are_the_padded_rows(problem):
    g = from_numpy(problem[0].graph, problem[0].data, problem[0].states,
                   device="cpu")[0]
    nbr, edge = g.nbr_sites.numpy(), g.nbr_edge.numpy()
    plan_sites, plan_ptr, plan_nbr, plan_edge = _plan_of(g)[:4]
    for t, i in enumerate(plan_sites):
        real = nbr[i] < g.n
        np.testing.assert_array_equal(plan_nbr[plan_ptr[t]:plan_ptr[t + 1]],
                                      nbr[i][real])
        np.testing.assert_array_equal(plan_edge[plan_ptr[t]:plan_ptr[t + 1]],
                                      edge[i][real])


# --- the kernel's lane table (ops/sweep.py:lane_table, lanes) ---------------

@pytest.mark.parametrize("per_lane", [1, 5, 12])
def test_lane_map_covers_each_site_once(problem, per_lane):
    """Every plan position of a colour owns a group of lanes in a row, as
    wide as the least power of two, at most 32, that holds its degree at
    ``per_lane`` entries a lane; the group starts at a multiple of its width
    (so none crosses a warp), inside its colour's slots, which are a
    multiple of 32; the rest are idle."""
    g = from_numpy(problem[0].graph, problem[0].data, problem[0].states,
                   device="cpu")[0]
    color_ptr, plan_ptr = g.color_ptr.numpy(), g.plan_ptr.numpy()
    plan_sites = g.plan_sites.numpy()
    lane_ptr, lane_tab = sweep.lane_table(color_ptr, plan_sites, plan_ptr,
                                          per_lane)
    deg = np.diff(plan_ptr)
    widths = np.array([next((p for p in (1, 2, 4, 8, 16) if p * per_lane >= d),
                            32) for d in deg])
    assert (np.diff(lane_ptr) % 32 == 0).all()
    assert lane_tab.shape == (4, lane_ptr[-1])
    for c in range(len(color_ptr) - 1):
        tab = lane_tab[:, lane_ptr[c]:lane_ptr[c + 1]]
        t = np.repeat(np.arange(color_ptr[c], color_ptr[c + 1]),
                      widths[color_ptr[c]:color_ptr[c + 1]])
        starts = np.flatnonzero(np.diff(np.concatenate([[-2], t])))
        assert (starts % widths[t[starts]] == 0).all()
        u = np.arange(len(t)) - np.repeat(starts, widths[t[starts]])
        np.testing.assert_array_equal(
            tab[:, :len(t)], np.stack([plan_sites[t], plan_ptr[t] + u,
                                       plan_ptr[t + 1], widths[t]]))
        assert (tab[0, len(t):] == -1).all() and (tab[3, len(t):] == 1).all()


def test_lane_table_refuses_growing_groups():
    """Lane groups must not widen along a colour: a plan not sorted by
    degree is refused."""
    with pytest.raises(ValueError, match="sort each colour"):
        sweep.lane_table([0, 2], [0, 1], [0, 1, 9], per_lane=1)


def test_lanes_built_once_per_plan(monkeypatch):
    """``lanes`` builds the table with the kernel's entries a lane the
    first time it sees a ``plan_ptr`` tensor, returns the same tensors
    after, and drops them with the tensor."""
    monkeypatch.setattr(sweep, "_library", lambda: types.SimpleNamespace(
        chromatic_sweeps_lane_entries=lambda: 5))
    built = []
    real = sweep.lane_table
    monkeypatch.setattr(sweep, "lane_table",
                        lambda *a: built.append(a[-1]) or real(*a))
    color_ptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    plan_sites = torch.tensor([0, 2, 1], dtype=torch.int32)
    plan_ptr = torch.tensor([0, 1, 2, 4], dtype=torch.int32)
    first = sweep.lanes(color_ptr, plan_sites, plan_ptr)
    again = sweep.lanes(color_ptr, plan_sites, plan_ptr)
    assert built == [5] and all(a is b for a, b in zip(first, again))
    want = real(color_ptr.numpy(), plan_sites.numpy(), plan_ptr.numpy(), 5)
    for got, w in zip(first, want):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), w)
    key = id(plan_ptr)
    del plan_ptr
    assert key not in sweep._LANES
    sweep.lanes(color_ptr, plan_sites, torch.tensor([0, 1, 2, 4],
                                                    dtype=torch.int32))
    assert built == [5, 5]


def test_q_plan_is_q_on_the_padded_rows(problem):
    mc, g_t, data_t, states_t, names, _, linv = problem
    mu = tg._mu_obs(data_t, states_t, g_t)
    q_edges, q_plan, *_ = tg.sweep_inputs(g_t, data_t, states_t,
                                          torch.as_tensor(linv), mu)
    nbr, edge = g_t.nbr_sites.numpy(), g_t.nbr_edge.numpy()
    plan_sites, plan_ptr = _plan_of(g_t)[:2]
    want = np.concatenate([edge[i][nbr[i] < g_t.n] for i in plan_sites])
    assert q_plan.shape == (C, 2 * g_t.n_edges)
    np.testing.assert_array_equal(q_plan.numpy(), q_edges.numpy()[:, want])


def test_build_graph_and_interop_give_equal_plans():
    rng = np.random.default_rng(12)
    locs = rng.uniform(size=(260, 2))
    y = rng.normal(size=260)
    kw = dict(m=5, n_chains=2, seed=3,
              stationary_covfun="exponential_isotropic")
    ref = nngp_tpu.initialize(locs, y, **kw)
    mc = nngp_tpu_torch.initialize(locs, y, device="cpu", verbose=False, **kw)
    for a, b, name in zip(_plan_of(graph_from_numpy(ref.graph)),
                          _plan_of(mc.graph), PLAN_FIELDS):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert getattr(mc.graph, name).dtype == torch.int32, name


def test_entry_points_need_a_card_by_default(tmp_path, monkeypatch):
    """initialize, load, from_numpy and chain_state run on the card unless
    asked for the CPU: with no card they raise, never falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(1)
    locs, y = rng.uniform(size=(60, 2)), rng.normal(size=60)
    with pytest.raises(RuntimeError, match="CUDA"):
        nngp_tpu_torch.initialize(locs, y, m=4, n_chains=2, verbose=False)
    mc = nngp_tpu_torch.initialize(locs, y, m=4, n_chains=2, device="cpu",
                                   verbose=False)
    path = str(tmp_path / "fit.pkl")
    nngp_tpu_torch.save(mc, path)
    with pytest.raises(RuntimeError, match="CUDA"):
        nngp_tpu_torch.load(path)
    assert nngp_tpu_torch.load(path, device="cpu").device.type == "cpu"
    ref = nngp_tpu.initialize(locs, y, m=4, n_chains=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_numpy(ref.graph, ref.data, ref.states)
    with pytest.raises(RuntimeError, match="CUDA"):
        chain_state(ref.states)
