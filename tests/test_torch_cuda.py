"""Tests that need a CUDA card (marker ``gpu``; each skips without one).

This file imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures jax).  The CPU path these
tests compare the card with is held against nngp_tpu by the other
tests/test_torch_*.py files.
"""

import functools

import numpy as np
import pytest
import torch

import nngp_tpu_torch
from nngp_tpu_torch.experiments import (data, gather_bench, gather_ops,
                                        gather_probe, gather_probe2)
from nngp_tpu_torch.models import gaussian as G
from nngp_tpu_torch.ops import draws, sweep, trisolve
from nngp_tpu_torch.ops.covariance import shape_transform
from nngp_tpu_torch.ops.draws import DrawKey
from nngp_tpu_torch.ops.vecchia import vecchia_linv
from nngp_tpu_torch.utils.datasets import synthetic_heavy_metals

C = 2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _mc(device):
    locs, y, X = synthetic_heavy_metals(n=500, p=2, seed=9)
    return nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=C, seed=4, device=device, verbose=False)


def _tiled(mc, C_run):
    """(state, linv, mu) of ``mc``'s states tiled to ``C_run`` chains."""
    from nngp_tpu_torch.experiments.sweep_bench import tile_states

    st = tile_states(mc.states, C_run)
    names = mc.space_time_model["covfun"]["shape_params"]
    return (st, vecchia_linv(mc.graph, shape_transform(names, st.shape)),
            G._mu_obs(mc.data, st, mc.graph))


def _sweep_inputs(mc, C_run, S=6, zero_noise=False):
    """The kernel's arguments on ``mc``'s graph with its states tiled to
    ``C_run`` chains: (w0, args after w)."""
    g = mc.graph
    st, linv, mu = _tiled(mc, C_run)
    _, q_plan, P, rs, scal = G.sweep_inputs(g, mc.data, st, linv, mu)
    dev = st.field.device
    noise = torch.randn(C_run, S, g.n, device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    if zero_noise:
        noise.zero_()
    return st.field.clone(), (q_plan, P, rs, noise, scal, g.color_ptr,
                              g.plan_sites, g.plan_ptr, g.plan_nbr)


def _held(got, want):
    """Kernel against plain version: 2e-3 * max(1, |w|_inf) (float32
    neighbour sums in another order)."""
    assert torch.isfinite(got).all()
    tol = 2e-3 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("chains", [1, 3, 24])
@pytest.mark.parametrize("zero_noise", [True, False])
def test_kernel_matches_plain(zero_noise, chains):
    """Kernel against plain version on the same inputs, one launch a call."""
    dev = _card()
    w0, args = _sweep_inputs(_mc(dev), chains, zero_noise=zero_noise)
    before = sweep.chromatic_sweeps.launches
    got = sweep.chromatic_sweeps(w0.clone(), *args)
    want = sweep.chromatic_sweeps_reference(w0.clone(), *args)
    torch.cuda.synchronize()
    assert sweep.chromatic_sweeps.launches == before + 1
    _held(got, want)


def _hub_problem(dev, C_run=3, S=4, leaves=40):
    """A graph with a site of degree ``leaves`` in a colour of its own
    (fewer sites than one lane group), beside a path of 30 sites."""
    from nngp_tpu_torch.preprocess.coloring import (color_csr,
                                                    site_neighbor_lists,
                                                    sweep_plan)

    n = hub = 30 + leaves
    n += 1
    edges = [(i, i + 1) for i in range(29)]            # path 0..29
    edges += [(j, hub) for j in range(30, hub)]        # the hub's leaves
    edges = np.array(edges, dtype=np.int32)
    nbr_sites, nbr_edge, _ = site_neighbor_lists(n, edges)
    colors = np.zeros(n, dtype=np.int64)
    colors[1:30:2] = 1
    colors[hub] = 2
    color_ptr, color_sites = color_csr(colors)
    plan = sweep_plan(color_ptr, color_sites, nbr_sites, nbr_edge)
    rng = np.random.default_rng(2)
    q_edges = -rng.uniform(0.05, 0.2, size=(C_run, len(edges)))

    def t(a, dtype=np.float32):
        return torch.tensor(np.ascontiguousarray(a, dtype), device=dev)

    tables = (color_ptr, *plan[:3])
    args = (t(q_edges[:, plan[3]]), t(rng.uniform(2, 4, (C_run, n))),
            t(rng.normal(size=(C_run, n))),
            t(rng.normal(size=(C_run, S, n))),
            t(np.stack([rng.normal(size=C_run), rng.uniform(.5, 2, C_run),
                        rng.uniform(.5, 2, C_run)], 1)),
            *(t(a, np.int32) for a in tables))
    assert int(np.diff(plan[1]).max()) == leaves
    return t(rng.normal(size=(C_run, n))), args


@pytest.mark.gpu
@pytest.mark.parametrize("leaves", [40, 250])
def test_kernel_high_degree_and_small_colour(leaves):
    """A site of degree 40 (more than one lane group of 8 holds) or 250
    (more than 32 lanes hold in one round), in a colour of one site,
    against the plain version."""
    dev = _card()
    w0, args = _hub_problem(dev, leaves=leaves)
    got = sweep.chromatic_sweeps_cuda(w0.clone(), *args)
    want = sweep.chromatic_sweeps_reference(w0.clone(), *args)
    torch.cuda.synchronize()
    _held(got, want)


@pytest.mark.gpu
def test_kernel_repeat_calls_bit_identical():
    """No atomics in the sums: two calls on the same inputs give the same
    bits."""
    dev = _card()
    w0, args = _sweep_inputs(_mc(dev), 3)
    first = sweep.chromatic_sweeps(w0.clone(), *args)
    second = sweep.chromatic_sweeps(w0.clone(), *args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_kernel_lane_table_is_the_plans():
    """The kernel walks ``lane_table`` of the graph's plan at the kernel's
    own entries a lane, built once per plan."""
    dev = _card()
    g = _mc(dev).graph
    got = sweep.lanes(g.color_ptr, g.plan_sites, g.plan_ptr)
    assert all(a is b for a, b in zip(
        got, sweep.lanes(g.color_ptr, g.plan_sites, g.plan_ptr)))
    want = sweep.lane_table(
        g.color_ptr.cpu().numpy(), g.plan_sites.cpu().numpy(),
        g.plan_ptr.cpu().numpy(),
        sweep._library().chromatic_sweeps_lane_entries())
    for a, b in zip(got, want):
        assert a.device == dev and a.dtype == torch.int32
        np.testing.assert_array_equal(a.cpu().numpy(), b)


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs():
    dev = _card()
    w = torch.zeros(1, 3, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    # three sites on a path 0 - 1 - 2: colour 0 = {0, 2}, colour 1 = {1}
    ok = dict(q_plan=torch.zeros(1, 4, device=dev),
              P=torch.ones(1, 3, device=dev), rs=torch.zeros(1, 3, device=dev),
              noise=torch.zeros(1, 1, 3, device=dev),
              scal=torch.zeros(1, 3, device=dev),
              color_ptr=torch.tensor([0, 2, 3], **i32),
              plan_sites=torch.tensor([0, 2, 1], **i32),
              plan_ptr=torch.tensor([0, 1, 2, 4], **i32),
              plan_nbr=torch.tensor([1, 1, 0, 2], **i32))
    sweep.chromatic_sweeps(w, **ok)
    torch.cuda.synchronize()
    with pytest.raises(TypeError):
        sweep.chromatic_sweeps(w, **{**ok, "plan_nbr": ok["plan_nbr"].long()})
    with pytest.raises(ValueError):
        sweep.chromatic_sweeps(w, **{**ok, "P": ok["P"].cpu()})
    with pytest.raises(ValueError):
        sweep.chromatic_sweeps(w, **{**ok, "rs": torch.zeros(1, 4, device=dev)})
    with pytest.raises(ValueError):
        sweep.chromatic_sweeps(w, **{**ok, "q_plan": torch.zeros(1, 3,
                                                                 device=dev)})
    with pytest.raises(ValueError):
        sweep.chromatic_sweeps(w, **{**ok, "plan_ptr": ok["plan_ptr"][:3]})
    with pytest.raises(TypeError):
        sweep.chromatic_sweeps(w, **{**ok, "color_ptr": ok["color_ptr"].long()})
    with pytest.raises(ValueError):
        sweep.chromatic_sweeps(w, **{**ok, "plan_sites": ok["plan_sites"][:2]})


@pytest.mark.gpu
def test_gibbs_iterations_card_match_cpu():
    """Three full iterations on the card against the CPU with the same
    draws: equal accept decisions, states within 1e-3 * max(1, |x|)."""
    dev = _card()
    out = {}
    for d in ("cpu", dev):
        mc = _mc(d)
        cfg = G.UpdateConfig(
            n_iterations=3,
            shape_names=tuple(mc.space_time_model["covfun"]["shape_params"]),
            locs_cols=tuple(int(c) for c in mc.design.locs_cols))
        key = DrawKey.of(3, 0, 0, C, "cpu")
        st = mc.states
        carry = (st, vecchia_linv(mc.graph, shape_transform(cfg.shape_names,
                                                            st.shape)),
                 torch.zeros(C, device=d), torch.zeros(C, device=d))
        for it in range(3):
            draws = G.IterationDraws.draw(key, it, cfg, mc.graph.n,
                                          st.beta.shape[1])
            carry = G.gibbs_iteration(mc.graph, mc.data, cfg, carry, it, 0,
                                      draws.to(d))
        out[str(d)] = carry
    cpu, card = out["cpu"], out[str(dev)]
    for a, b in zip(cpu[2:], card[2:]):
        np.testing.assert_array_equal(a.numpy(), b.cpu().numpy())
    for f in ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
              "field"):
        a = getattr(cpu[0], f).numpy()
        b = getattr(card[0], f).cpu().numpy()
        np.testing.assert_allclose(b, a, atol=1e-3 * max(1.0, np.abs(a).max()),
                                   err_msg=f)


# --- the draws kernel ------------------------------------------------------------

DRAW_SITES = 20_000


def _draw_layout():
    """The main path's fields (K = 1, one shape parameter, 14 covariates,
    10 sweeps) at DRAW_SITES sites."""
    cfg = G.UpdateConfig(n_iterations=1, shape_names=("log_range",),
                         locs_cols=tuple(range(14)))
    return G.IterationDraws.layout(cfg, DRAW_SITES, 14)


def _draws_held_to_twins(ids, key, layout):
    """One chain_draws launch for ``ids`` against its twin run on the card:
    every field bit for bit, one launch counted, a repeat call bit for bit.
    Against the twin on the CPU: the Philox words and the uniforms bit for
    bit, the normals equal but for at most 1 in 1e6, each within 1
    float32 ulp (the card's float64 libm against the CPU's)."""
    chains = ids.numel()
    draws.chain_draws.launches = 0
    got = draws.chain_draws(key[0], key[1], ids, key[2], layout)
    assert draws.chain_draws.launches == 1
    again = draws.chain_draws(key[0], key[1], ids, key[2], layout)
    twin = draws.chain_draws_reference(key[0], key[1], ids, key[2], layout)
    cpu = draws.chain_draws_reference(key[0], key[1], ids.cpu(), key[2],
                                      layout)
    torch.cuda.synchronize()
    differ = total = 0
    for name, shape in layout.items():
        assert got[name].shape == (chains,) + shape
        assert torch.equal(got[name], twin[name]), name
        assert torch.equal(got[name], again[name]), name
        count = int(np.prod(shape))
        np.testing.assert_array_equal(
            draws.chain_words(key[0], key[1], ids, key[2], name,
                              count).cpu().numpy(),
            draws.chain_words(key[0], key[1], ids.cpu(), key[2], name,
                              count).numpy(), err_msg=name)
        a, b = got[name].cpu(), cpu[name]
        if draws.FIELDS[name][1] == draws.UNIFORM:
            assert torch.equal(a, b), name
            continue
        diff = a != b
        differ += int(diff.sum())
        total += a.numel()
        ulps = (a[diff].view(torch.int32).long()
                - b[diff].view(torch.int32).long()).abs()
        assert (ulps <= 1).all(), name
    assert differ * 1e6 <= total, (differ, total)
    assert draws.chain_draws.launches == 2


@pytest.mark.gpu
@pytest.mark.parametrize("chains", [1, 3, 96])
def test_chain_draws_kernel_matches_twins(chains):
    """csrc/chain_draws.cu at the main path's layout against its twins
    (``_draws_held_to_twins``)."""
    dev = _card()
    _draws_held_to_twins(torch.arange(7, 7 + chains, device=dev),
                         (2**40 + 5, 300, 11), _draw_layout())


def _ragged_layout(name):
    """The main path's fields with the sweep normals at 20,001 sites
    (200,010 numbers a chain, not a multiple of 4: no row after the first
    starts 16-byte aligned), or every field at k numbers a chain."""
    if name == "sweep-20001":
        cfg = G.UpdateConfig(n_iterations=1, shape_names=("log_range",),
                             locs_cols=tuple(range(14)))
        return G.IterationDraws.layout(cfg, 20_001, 14)
    k = int(name.split("-")[1])
    return {field: (k,) for field in draws.FIELDS}


@pytest.mark.gpu
@pytest.mark.parametrize("chains", [1, 3, 96, 97])
@pytest.mark.parametrize("layout", ["sweep-20001", "every-0", "every-1",
                                    "every-3", "every-5", "every-7"])
def test_chain_draws_ragged_layouts_match_twins(layout, chains):
    """Rows that start off a 16-byte boundary, ragged last calls, fields
    of 0 to 7 numbers a chain (no tile, or a tile with one live warp), an
    odd chain count, and both tiles (four calls a thread at 96 and 97
    chains of the 20,001-site layout, else one): the kernel against its
    twins."""
    dev = _card()
    _draws_held_to_twins(torch.arange(3, 3 + chains, device=dev),
                         (2**33 + 17, 1_000, 5), _ragged_layout(layout))


@pytest.mark.gpu
def test_sincos_gives_cos_and_sin_at_every_angle():
    """The kernel takes cos and sin of each normal pair's angle from one
    sincos: over all 2^32 words the card's sincos gives the same two
    doubles as its cos and sin alone (as the twin's torch.cos and
    torch.sin compute them)."""
    assert draws.sincos_differ(_card()) == 0


@pytest.mark.gpu
def test_chain_draws_refuses_what_it_does_not_take():
    dev = _card()
    ids = torch.arange(3, device=dev)
    with pytest.raises(TypeError):
        draws.chain_draws(1, 0, ids.float(), 0, {"anc_u": (2,)})
    with pytest.raises(ValueError):
        draws.chain_draws(1, 0, ids, 0, {"z": (2,)})
    with pytest.raises(ValueError):
        draws.chain_draws(1, 0, ids, 2**20, {"anc_u": (2,)})


@pytest.mark.gpu
def test_run_launches_chain_draws_once_an_iteration():
    """On the card every iteration's numbers come from one chain_draws
    launch, and the chains are those of the CPU run (the same keys) within
    test_gibbs_iterations_card_match_cpu's 1e-3 * max(1, |x|)."""
    dev = _card()
    runs = {}
    for d in ("cpu", dev):
        draws.chain_draws.launches = 0
        runs[str(d)] = nngp_tpu_torch.run(
            _mc(d), n_iterations_update=3, verbose=False,
            Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    assert draws.chain_draws.launches == 3
    cpu, card = runs["cpu"], runs[str(dev)]
    for a, b in zip(cpu.records, card.records):
        for k in ("beta_0", "log_scale", "log_noise_variance", "shape"):
            np.testing.assert_allclose(
                b[k], a[k], atol=1e-3 * max(1.0, np.abs(a[k]).max()),
                err_msg=k)


# --- the factor rows kernel ---------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("m", list(range(17)))
def test_factor_rows_kernel_matches_twin(m):
    """csrc/factor_rows.cu at every instantiated m against its plain twin
    on random SPD blocks with padded slots: max |a - b| / (|b| + 1e-3) at
    most 1e-4 (both round each multiply-subtract once), one launch counted
    a call, repeat calls bit for bit, padded slots exactly 0."""
    from nngp_tpu_torch.ops import vecchia as V

    dev = _card()
    k, R = m + 1, 1000
    rng = np.random.default_rng(m)
    A = rng.normal(size=(3, R, k, k + 2)).astype(np.float32)
    K = torch.as_tensor(A @ A.transpose(0, 1, 3, 2) / (k + 2)).to(dev)
    mask = torch.as_tensor(rng.uniform(size=(R, k)) > 0.2).float().to(dev)
    mask[:, 0] = 1
    before = V.linv_rows_from_K.launches
    got = V.linv_rows_from_K(K, mask, 1e-5)
    again = V.linv_rows_from_K(K, mask, 1e-5)
    torch.cuda.synchronize()
    assert V.linv_rows_from_K.launches == before + 2
    assert torch.equal(got, again)
    want = V.linv_rows_reference(K, mask, 1e-5)
    rel = ((got - want).abs() / (want.abs() + 1e-3)).max().item()
    assert rel <= 1e-4, rel
    assert torch.all(got[..., mask == 0] == 0)


@pytest.mark.gpu
def test_factor_rows_kernel_refuses_what_it_does_not_take():
    from nngp_tpu_torch.ops import vecchia as V

    dev = _card()
    K = torch.eye(6, device=dev).expand(2, 10, 6, 6)
    mask = torch.ones(10, 6, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        V.linv_rows_cuda(K, mask)
    with pytest.raises(TypeError, match="float32"):
        V.linv_rows_cuda(K.contiguous(), mask.double())
    K18 = torch.eye(18, device=dev).expand(1, 4, 18, 18).contiguous()
    with pytest.raises(ValueError, match="at most 16"):
        V.linv_rows_from_K(K18, torch.ones(4, 18, device=dev))


# --- the fused factor build -------------------------------------------------

# the fused build against its twin: |a - b| / (|b| + 1e-3) (chip_smoke.py's
# FACTOR_TOL_REL; Matérn's rows are built in float64 by both and rounded
# once)
BUILD_TOL = 1e-4


@functools.cache
def _build_geometry(family, m, n=300):
    """(nn_dist2, nn_mask, d_floor) of a port graph of ``n`` seeded sites
    for ``family`` at ``m`` neighbours (lon/lat for the sphere, 3-D for
    space-time; m = 0 is the m = 1 graph's first slot), on the host."""
    from nngp_tpu_torch.preprocess.dedupe import dedupe_and_match
    from nngp_tpu_torch.preprocess.graph import build_graph
    from nngp_tpu_torch.preprocess.ordering import reorder_locations

    rng = np.random.default_rng(m)
    lonlat = family.endswith("sphere")
    locs = rng.uniform(size=(n, 3 if family.endswith("spacetime") else 2))
    if lonlat:
        locs = locs * [20.0, 15.0] + [-100.0, 30.0]
    maps = dedupe_and_match(
        locs, perm_fn=lambda L: reorder_locations(L, "maxmin", lonlat=lonlat))
    graph, _ = build_graph(maps, m=max(m, 1), covfun=family)
    k = m + 1
    return (np.ascontiguousarray(graph.nn_dist2[:, :k, :k]),
            np.ascontiguousarray(graph.nn_mask[:, :k]), graph.d_floor)


def _build_case(family, m, chains, dev):
    """(graph view on the card, natural [chains, n_shape]): each chain's
    ranges at 0.5-2x the median neighbour distance of the m = 5 geometry,
    Matérn's nu in (0.5, 1) (the sampler's band) and, every third chain,
    in (1, 3.4) (the recurrence's l = 1..3)."""
    from types import SimpleNamespace

    d2g, mask, d_floor = _build_geometry(family, m)
    ref = _build_geometry(family, 5)[0]
    med = [np.sqrt(np.median(ref[..., j][ref[..., j] > 0]))
           for j in range(ref.shape[-1])]
    rng = np.random.default_rng(chains)
    nat = np.asarray(med)[None] * rng.uniform(0.5, 2, (chains, len(med)))
    if family.startswith("matern"):
        nu = rng.uniform(0.5, 1.0, chains)
        nu[2::3] = rng.uniform(1.0, 3.4, len(nu[2::3]))
        nat = np.concatenate([nat, nu[:, None]], 1)
    g = SimpleNamespace(covfun=family, d_floor=d_floor, n=mask.shape[0],
                        nn_dist2=torch.tensor(d2g, device=dev),
                        nn_mask=torch.tensor(mask, device=dev))
    return g, torch.tensor(nat, dtype=torch.float32, device=dev)


def _rel(got, want):
    return ((got - want).abs() / (want.abs() + 1e-3)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("chains", [1, 3, 96])
@pytest.mark.parametrize("m", [0, 1, 5, 16])
@pytest.mark.parametrize("family", ["exponential_isotropic",
                                    "exponential_sphere",
                                    "exponential_scaledim",
                                    "exponential_spacetime",
                                    "matern_isotropic", "matern_sphere",
                                    "matern_scaledim", "matern_spacetime"])
def test_factor_build_kernel_matches_twin(family, m, chains):
    """factor_build against vecchia_linv_reference on the card, 300 sites
    (ragged last block): one launch a call, repeat calls bit for bit, rows
    within BUILD_TOL.  In the sampler's band (every exponential chain,
    Matérn's nu < 1) the rows are finite with padded slots exactly 0.
    Beyond it, where ``_matern_comp_small``'s series no longer holds and a
    block need not be positive definite, the kernel's non-finite entries
    are the twin's."""
    from nngp_tpu_torch.ops import vecchia as V

    g, nat = _build_case(family, m, chains, _card())
    before = V.vecchia_linv.launches
    got = V.vecchia_linv(g, nat)
    again = V.vecchia_linv(g, nat)
    torch.cuda.synchronize()
    assert V.vecchia_linv.launches == before + 2
    assert got.shape == (chains, g.n, m + 1)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    band = (nat[:, -1] < 1 if family.startswith("matern")
            else torch.ones(chains, dtype=torch.bool, device=nat.device))
    assert torch.isfinite(got[band]).all()
    assert torch.all(got[band][..., g.nn_mask == 0] == 0)
    want = V.vecchia_linv_reference(family, g.nn_dist2, g.nn_mask, nat,
                                    g.d_floor)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    rel = _rel(got[finite], want[finite])
    assert rel <= BUILD_TOL, rel


@functools.cache
def _branch_geometry(n=300):
    """(nn_dist2 [n, 6, 6, 1], nn_mask [n, 6]) of m = 5 neighbour sets with
    every pairwise distance in [0.9, 2.13]: each row's site at the origin,
    its five neighbours at radius 0.9-1.1 near the pentagon's corners; the
    first five rows keep that many neighbours, as a graph's do."""
    rng = np.random.default_rng(5)
    ang = 2 * np.pi / 5 * np.arange(5) + rng.uniform(-0.1, 0.1, (n, 5))
    rad = rng.uniform(0.9, 1.1, (n, 5))
    pts = np.concatenate([np.zeros((n, 1, 2)), np.stack(
        [rad * np.cos(ang), rad * np.sin(ang)], -1)], 1)
    d2 = ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)[..., None]
    mask = np.ones((n, 6), np.float32)
    for r in range(5):
        mask[r, 1 + r:] = 0
    return d2.astype(np.float32), mask


@pytest.mark.gpu
@pytest.mark.parametrize("nu_band", [(0.5, 1.0), (1.0, 3.4)])
@pytest.mark.parametrize("branch", ["temme", "series"])
def test_factor_build_matern_branch_matches_twin(branch, nu_band):
    """The Matérn build with every valid pair in one branch of the
    evaluation, Temme's series (0.29 < d <= 2) or the complementary series
    (d <= 0.29), each chain's range chosen from the geometry's least and
    greatest distance: 96 chains at m = 5, nu in ``nu_band`` (above 1 the
    upward recurrence runs too).  Rows within BUILD_TOL of the twin's,
    repeat calls bit for bit, each call counted in
    ``factor_build_cuda.matern_launches``."""
    from types import SimpleNamespace

    from nngp_tpu_torch.ops import vecchia as V

    dev = _card()
    d2g, mask = _branch_geometry()
    d = np.sqrt(d2g[..., 0])
    pairs = (mask[:, :, None] * mask[:, None, :] > 0) & ~np.eye(6, dtype=bool)
    lo, hi = d[pairs].min(), d[pairs].max()
    rng = np.random.default_rng(96)
    ranges = (rng.uniform(hi / 2 * 1.01, lo / 0.29 * 0.99, 96)
              if branch == "temme"
              else rng.uniform(hi / 0.29 * 1.01, hi / 0.29 * 3, 96))
    nat = np.stack([ranges, rng.uniform(*nu_band, 96)], 1).astype(np.float32)
    scaled = d[None] / nat[:, :1, None, None].astype(np.float64)
    inside = ((scaled > 0.29) & (scaled <= 2.0) if branch == "temme"
              else scaled <= 0.29)
    assert inside[:, pairs].all()
    g = SimpleNamespace(covfun="matern_isotropic", d_floor=1e-5, n=len(mask),
                        nn_dist2=torch.tensor(d2g, device=dev),
                        nn_mask=torch.tensor(mask, device=dev))
    nat = torch.tensor(nat, device=dev)
    before = V.factor_build_cuda.matern_launches
    got = V.vecchia_linv(g, nat)
    again = V.vecchia_linv(g, nat)
    torch.cuda.synchronize()
    assert V.factor_build_cuda.matern_launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = V.vecchia_linv_reference(g.covfun, g.nn_dist2, g.nn_mask, nat,
                                    g.d_floor)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    if nu_band[1] <= 1.0:
        assert finite.all()
    assert _rel(got[finite], want[finite]) <= BUILD_TOL


def _near_singular_fit(family, device, n=300):
    """The port's fit of tests/test_torch_matern.py's layout for ``family``
    (seed 11, m = 5, 2 chains) and its natural shape params near singular:
    every range at 2.5 median neighbour distances, nu 0.54 and 0.98."""
    rng = np.random.default_rng(11)
    if "sphere" in family:
        locs = np.stack([rng.uniform(-100, -80, n), rng.uniform(30, 45, n)],
                        1)
    elif "spacetime" in family:
        locs = rng.uniform(size=(n, 3))
    else:
        locs = rng.uniform(size=(n, 2))
    mc = nngp_tpu_torch.initialize(locs, rng.normal(size=n), m=5, n_chains=2,
                                   seed=2, stationary_covfun=family,
                                   device=device, verbose=False)
    d2g = mc.graph.nn_dist2.cpu().numpy()
    med = [np.median(np.sqrt(d2g[..., j][d2g[..., j] > 0]))
           for j in range(d2g.shape[-1])]
    sampled = np.array([list(np.log(2.5 * np.asarray(med))) + [s]
                        for s in (-2.5, 3.0)], np.float32)
    names = mc.space_time_model["covfun"]["shape_params"]
    return mc, shape_transform(names, torch.as_tensor(sampled,
                                                      device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["matern_isotropic", "matern_sphere",
                                    "matern_scaledim", "matern_spacetime"])
def test_factor_build_near_singular_on_card(family):
    """The fused Matérn build near singular on the card (the port's
    initialize, no JAX): each chain's log-determinant within 1e-5 of the
    float64 oracle's, the rows within BUILD_TOL of the twin's."""
    from nngp_tpu_torch.ops import vecchia as V
    from nngp_tpu_torch.ops.numpy_ref import np_vecchia_linv
    from nngp_tpu_torch.preprocess.ordering import lonlat_to_xyz

    mc, nat = _near_singular_fit(family, _card())
    g = mc.graph
    before = V.vecchia_linv.launches
    got = V.vecchia_linv(g, nat)
    torch.cuda.synchronize()
    assert V.vecchia_linv.launches == before + 1
    want = V.vecchia_linv_reference(family, g.nn_dist2, g.nn_mask, nat,
                                    g.d_floor)
    assert _rel(got, want) <= BUILD_TOL
    coords = lonlat_to_xyz(mc.locs) if "sphere" in family else mc.locs
    rows = got.double().cpu().numpy()
    for c, nat64 in enumerate(nat.cpu().numpy().astype(np.float64)):
        oracle = np_vecchia_linv(coords, mc.NNarray, family, nat64)
        err = np.log(rows[c, :, 0]).sum() - np.log(oracle[:, 0]).sum()
        assert abs(err) <= 1e-5, (c, err)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["exponential_sphere", "matern_spacetime"])
def test_factor_build_rows_subset_on_card(family):
    """A non-contiguous, unsorted row list (int64 and int32) gives the
    whole build's rows bit for bit, and halo_vecchia_linv puts them in
    place, one launch each."""
    from types import SimpleNamespace

    from nngp_tpu_torch.ops import vecchia as V
    from nngp_tpu_torch.parallel.halo_gibbs import halo_vecchia_linv

    dev = _card()
    g, nat = _build_case(family, 5, 3, dev)
    whole = V.vecchia_linv(g, nat)
    rows = torch.randperm(g.n, generator=torch.Generator().manual_seed(1))
    rows = rows[: g.n // 3].to(dev)
    for idx in (rows, rows.int()):
        before = V.vecchia_linv.launches
        got = V.vecchia_linv(g, nat, idx)
        full = halo_vecchia_linv(g, nat, SimpleNamespace(
            rank=SimpleNamespace(need=idx)))
        torch.cuda.synchronize()
        assert V.vecchia_linv.launches == before + 2
        assert torch.equal(got, whole[:, rows])
        assert torch.equal(full[:, rows], whole[:, rows])
        rest = torch.ones(g.n, dtype=torch.bool, device=dev)
        rest[rows] = False
        assert torch.all(full[:, rest] == 0)


@pytest.mark.gpu
def test_factor_build_refuses_what_it_does_not_take():
    from types import SimpleNamespace

    from nngp_tpu_torch.ops import vecchia as V

    dev = _card()
    g, nat = _build_case("matern_sphere", 5, 3, dev)
    ge, nate = _build_case("exponential_sphere", 5, 3, dev)
    with pytest.raises(TypeError, match="float32"):
        V.factor_build_cuda(ge, nate.double())
    # the Matérn build takes float64 natural params; a float32 one is
    # widened exactly, so the same values give the same rows
    assert torch.equal(V.factor_build_cuda(g, nat.double()),
                       V.factor_build_cuda(g, nat))
    with pytest.raises(ValueError, match="expected"):
        V.factor_build_cuda(g, nat[:, :1].contiguous())
    with pytest.raises(ValueError, match="rows holds"):
        V.factor_build_cuda(g, nat, torch.tensor([0, g.n], device=dev))
    big = SimpleNamespace(covfun="exponential_sphere", d_floor=1e-12,
                          nn_dist2=torch.zeros(4, 18, 18, 1, device=dev),
                          nn_mask=torch.ones(4, 18, device=dev))
    with pytest.raises(ValueError, match="at most 16"):
        V.vecchia_linv(big, nat[:, :1].contiguous())
    # float64 on the card runs the twin, no launch
    before = V.vecchia_linv.launches
    assert V.vecchia_linv(ge, nate.double()).dtype == torch.float64
    assert V.vecchia_linv.launches == before


# --- the level solve -------------------------------------------------------

# Kernel against float64: each x_i is rounded once to float32 from a float64
# sum of exact products, and carries its parents' rounding (~1e-7 of
# max(1, |x|_inf) on these graphs, the NumPy emulation on the CPU); 1e-5
# leaves room for its growth over the DAG's levels.
SOLVE_F64_TOL = 1e-5


@functools.cache
def _solve_graph(kind):
    """(graph on the card, the fit it came from): "narrow" is the 500-site
    problem (levels under 128 sites, one row of level_segs each), "wide"
    20,000 Heavy-metals-like sites (levels wider than 512, several rows
    each), "joint" prediction's joint graph over the 500 sites and 300 new
    ones (m = 10, pad = n_joint)."""
    from nngp_tpu_torch import prediction as P

    dev = _card()
    if kind == "wide":
        locs, y, X = synthetic_heavy_metals(n=20000, p=2, seed=9)
        mc = nngp_tpu_torch.initialize(
            locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
            n_chains=1, seed=4, device=dev, verbose=False)
        return mc.graph, mc
    mc = _mc(dev)
    if kind == "joint":
        new = synthetic_heavy_metals(n=300, p=0, seed=3)[0]
        return P._joint_graph(mc, new, 10).to(dev), mc
    return mc.graph, mc


def _solve_inputs(kind, chains):
    """(graph, linv, v): the fit's shape params tiled to ``chains`` and
    moved apart by 0.3 standard normals a chain, v standard normal."""
    g, mc = _solve_graph(kind)
    dev = g.NNarray.device
    gen = torch.Generator(dev).manual_seed(chains)
    shape = mc.states.shape[:1].repeat(chains, 1)
    shape = shape + 0.3 * torch.randn(shape.shape, device=dev, generator=gen)
    names = mc.space_time_model["covfun"]["shape_params"]
    linv = vecchia_linv(g, shape_transform(names, shape))
    v = torch.randn(chains, g.n, device=dev, generator=gen)
    return g, linv, v


@pytest.mark.gpu
@pytest.mark.parametrize("chains", [1, 3, 96])
@pytest.mark.parametrize("kind", ["narrow", "wide", "joint"])
def test_level_solve_kernel_matches_twin_and_float64(kind, chains):
    """The kernel against its twin and the twin in float64 on the same
    inputs: the twin's bits (it has the kernel's arithmetic on a card),
    the same bits between two calls; one launch a call."""
    g, linv, v = _solve_inputs(kind, chains)
    assert max(int(t.max()) for t in g.level_segs) == g.n   # padded lanes
    before = trisolve.level_solve.launches
    x = trisolve.level_solve(linv, v, g)
    again = trisolve.level_solve(linv, v, g)
    assert trisolve.level_solve.launches == before + 2
    twin = trisolve.level_solve_reference(linv, v, g)
    f64 = trisolve.level_solve_reference(linv.double(), v.double(), g)
    torch.cuda.synchronize()
    assert torch.isfinite(x).all()
    assert torch.equal(x, again)
    scale = max(1.0, f64.abs().max().item())
    assert (x.double() - f64).abs().max().item() <= SOLVE_F64_TOL * scale
    assert torch.equal(x, twin)


@pytest.mark.gpu
def test_level_solve_dense_back_substitution():
    """The kernel on the 500-site graph against a float64 dense
    back-substitution of the same factor rows."""
    g, linv, v = _solve_inputs("narrow", 3)
    x = trisolve.level_solve(linv, v, g).double().cpu().numpy()
    NN = g.NNarray.cpu().numpy()
    lv, vv = linv.double().cpu().numpy(), v.double().cpu().numpy()
    for c in range(3):
        L = np.zeros((g.n, g.n))
        for j in range(NN.shape[1]):
            ok = NN[:, j] >= 0
            L[np.arange(g.n)[ok], NN[ok, j]] = lv[c, ok, j]
        want = np.linalg.solve(L, vv[c])
        assert np.abs(x[c] - want).max() <= SOLVE_F64_TOL * max(
            1.0, np.abs(want).max())


@pytest.mark.gpu
def test_level_solve_refuses_what_the_kernel_does_not_take():
    g, linv, v = _solve_inputs("narrow", 3)
    with pytest.raises(TypeError, match="float32"):
        trisolve.level_solve(linv.double(), v.double(), g)
    with pytest.raises(ValueError, match="expected"):
        trisolve.level_solve_cuda(linv[:, :-1].contiguous(), v, g)
    with pytest.raises(ValueError, match="contiguous"):
        trisolve.level_solve_cuda(linv, v.t().contiguous().t(), g)
    cpu_graph = g.to("cpu")
    with pytest.raises(TypeError, match="level steps are torch.int32 on cpu"):
        trisolve.level_solve_cuda(linv, v, cpu_graph)


@pytest.mark.gpu
def test_run_launches_the_level_solve_kernel_once_a_solve():
    """K = 2 ASIS pairs for 10 iterations: 20 solves, 20 launches."""
    dev = _card()
    mc = _mc(dev)
    before = trisolve.level_solve.launches
    nngp_tpu_torch.run(mc, covparams_steps=2, **RUN)
    assert trisolve.level_solve.launches - before == 2 * 10


# --- Matérn, prediction, save/load on the card -------------------------------

@pytest.mark.gpu
def test_matern_vecchia_linv_card_matches_cpu():
    """The Matérn factor on the card and on the CPU at 2.5x the median
    neighbour distance, nu 0.75: both within 1e-3 of the float64 oracle's
    log-determinant, the card's rows within 2x the CPU's error."""
    from nngp_tpu_torch.ops.numpy_ref import np_vecchia_linv
    from nngp_tpu_torch.preprocess.ordering import lonlat_to_xyz

    dev = _card()
    locs, y, X = synthetic_heavy_metals(n=500, p=2, seed=9)
    mc = nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="matern_sphere",
        n_chains=C, seed=4, device="cpu", verbose=False)
    d2 = mc.graph.nn_dist2[..., 0]
    rho = 2.5 * float(torch.sqrt(d2[d2 > 0]).median())
    nat = torch.tensor([[rho, 0.75]])
    cpu = vecchia_linv(mc.graph, nat)[0].double().numpy()
    card = vecchia_linv(mc.graph.to(dev), nat.to(dev))[0].double().cpu().numpy()
    oracle = np_vecchia_linv(lonlat_to_xyz(mc.locs), mc.NNarray,
                             "matern_sphere", np.array([rho, 0.75]))
    for got in (cpu, card):
        assert np.isfinite(got).all()
        assert abs(np.log(got[:, 0]).sum() - np.log(oracle[:, 0]).sum()) < 1e-3
    assert np.abs(card - oracle).max() <= 2 * np.abs(cpu - oracle).max() + 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["matern_sphere", "exponential_sphere"])
def test_collapsed_sufficient_ratio_on_card(family, monkeypatch):
    """tests/test_torch_collapsed_ratio.py's collapsed state through the
    card's ``factor_build`` against the float64 reference, within its 0.5
    in the log ratio."""
    import test_torch_collapsed_ratio as T
    from benchmark.reference import setup

    dev = _card()
    data, mc = T.problem(family, device=dev)
    mdl = setup.derive(data, family, 5, "cpu")["model"]
    state = T.chain_state(mc, "collapsed")
    before = vecchia_linv.launches
    for step in T.STEPS["collapsed"]:
        z = T.proposal_z(state, step)
        got = T.port_ratio(mc, state, z, monkeypatch)
        want = T.reference_ratio(mdl, state, z, monkeypatch)
        assert (got - want).abs().max().item() < T.TOL, (step, got, want)
    assert vecchia_linv.launches - before == 2 * len(T.STEPS["collapsed"])


@pytest.mark.gpu
def test_predict_field_card_matches_cpu(tmp_path):
    """Conditional draws on the card and the CPU from one saved fit, the
    same retained samples and normals: within 1e-3 * max(1, |w|_inf)."""
    from nngp_tpu_torch import prediction as P

    dev = _card()
    mc = nngp_tpu_torch.run(_mc("cpu"), n_iterations_update=10,
                            field_thinning=0.5, verbose=False,
                            Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    path = str(tmp_path / "fit.pkl")
    nngp_tpu_torch.save(mc, path)
    new = synthetic_heavy_metals(n=60, p=0, seed=3)[0]
    names = list(mc.space_time_model["covfun"]["shape_params"])
    stored = P._stored_idx(mc, 0.5)
    z = torch.randn(len(stored), len(new),
                    generator=torch.Generator().manual_seed(5))
    out = {}
    for d in ("cpu", dev):
        fit = nngp_tpu_torch.load(path, device=d)
        g = P._joint_graph(fit, new, 10).to(d)
        out[str(d)] = P.conditional_field(
            g, names, fit.graph.n,
            *P.retained_samples(fit.records[1], stored, d), z.to(d)).cpu()
    cpu, card = out["cpu"], out[str(dev)]
    assert torch.isfinite(card).all()
    tol = 1e-3 * max(1.0, cpu.abs().max().item())
    assert (cpu - card).abs().max().item() <= tol
    pred = nngp_tpu_torch.predict_field(nngp_tpu_torch.load(path, device=dev),
                                        new)
    assert all(np.isfinite(s).all() and s.shape == (len(stored), len(new))
               for s in pred["predicted_field_samples"])


@pytest.mark.gpu
def test_save_and_load_on_card(tmp_path):
    dev = _card()
    mc = nngp_tpu_torch.run(_mc(dev), n_iterations_update=5, verbose=False,
                            Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    path = str(tmp_path / "fit.pkl")
    nngp_tpu_torch.save(mc, path)
    back = nngp_tpu_torch.load(path, device=dev)
    for f in ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
              "field", "tk_ancillary", "tk_sufficient", "prop_mean",
              "prop_m2", "prop_count"):
        a, b = getattr(mc.states, f), getattr(back.states, f)
        assert b.device == a.device and torch.equal(a, b), f
    for ra, rb in zip(mc.records, back.records):
        np.testing.assert_array_equal(ra["field"], rb["field"])
        np.testing.assert_array_equal(ra["log_scale"], rb["log_scale"])
    back = nngp_tpu_torch.run(back, n_iterations_update=5, verbose=False)
    assert back.iterations == 10
    assert torch.isfinite(back.states.field).all()


# --- reproducibility from a seed, and the bench's preflight ------------------

STATE_FIELDS = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
                "field", "tk_ancillary", "tk_sufficient", "prop_mean",
                "prop_m2", "prop_count")
RUN = dict(n_iterations_update=10, verbose=False, field_thinning=0.5,
           Gelman_Rubin_Brooks_stop=(0.0, 0.0))


def _assert_same_run(a, b):
    """States and records equal, bit for bit."""
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a.states, f), getattr(b.states, f)), f
    for ra, rb in zip(a.records, b.records):
        for k in ("beta_0", "beta", "log_scale", "log_noise_variance",
                  "shape", "field", "saved_field"):
            np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)


@pytest.mark.gpu
def test_same_seed_same_chain_on_card():
    """25 iterations twice from one seed: the sums of an iteration add in a
    fixed order (no atomics), so the two runs agree bit for bit."""
    dev = _card()
    a, b = (nngp_tpu_torch.run(_mc(dev), **{**RUN, "n_iterations_update": 25})
            for _ in range(2))
    assert a.iterations == b.iterations == 25
    _assert_same_run(a, b)


@pytest.mark.gpu
def test_resume_bit_identical_on_card(tmp_path):
    """The card twin of test_torch_saveload.py::test_resume_bit_identical:
    a fit saved after one cycle, loaded on the card and resumed follows the
    uninterrupted two-cycle run bit for bit."""
    dev = _card()
    whole = nngp_tpu_torch.run(_mc(dev), n_cycles=2, **RUN)
    half = nngp_tpu_torch.run(_mc(dev), n_cycles=1, **RUN)
    path = str(tmp_path / "fit.pkl")
    nngp_tpu_torch.save(half, path)
    resumed = nngp_tpu_torch.run(nngp_tpu_torch.load(path, device=dev),
                                 n_cycles=1, **RUN)
    assert resumed.iterations == whole.iterations == 20
    _assert_same_run(resumed, whole)


@pytest.mark.gpu
def test_recording_spans_leaves_the_card_run_bit_identical():
    """The same fit run with ``tracing.record()`` on and off: the spans
    launch nothing and never synchronise, so the runs agree bit for bit."""
    from nngp_tpu_torch import tracing

    dev = _card()
    a = nngp_tpu_torch.run(_mc(dev), covparams_steps=2, **RUN)
    with tracing.record() as spans:
        b = nngp_tpu_torch.run(_mc(dev), covparams_steps=2, **RUN)
    assert sum(s.name == "level_solve" for s in spans) == 2 * 10
    _assert_same_run(a, b)


@pytest.mark.gpu
def test_span_encloses_its_kernel_on_the_cards_clock():
    """A kernel launched and waited for inside a span lies inside it on
    torch.profiler's CUDA-only trace, within 0.1 ms: the spans and the
    card's events share one clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nngp_tpu_torch import tracing

    _card()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            tracing.record() as spans:
        with tracing.span("outer"):
            with tracing.span("sleep"):
                torch.cuda._sleep(4_000_000)       # ~2 ms of clock cycles
                torch.cuda.synchronize()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    assert len(ops) == 1                   # torch.cuda._sleep's spin kernel
    start = ops[0].start_ns()
    end = start + ops[0].duration_ns()
    s = spans[1]
    assert s.name == "sleep" and end - start > 500_000
    assert s.start_ns - 100_000 <= start and end <= s.end_ns + 100_000


@pytest.mark.gpu
def test_one_rank_nccl_mesh_run_equals_run(tmp_path):
    """run(mc, mesh=...) on a one-rank NCCL chains mesh follows run(mc) on
    the card bit for bit (chip_smoke.py's small-parity problem, 2 chains)."""
    import torch.distributed as dist

    from nngp_tpu_torch.parallel import chains_mesh, initialize_distributed

    dev = _card()
    locs, y, X = synthetic_heavy_metals(n=400, p=2, seed=5)

    def fit():
        return nngp_tpu_torch.initialize(
            locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
            n_chains=2, seed=3, device=dev, verbose=False)

    assert initialize_distributed(f"file://{tmp_path / 'rdzv'}", 1, 0,
                                  device_type="cuda")
    try:
        mesh = chains_mesh()
        assert (mesh.device_type, dist.get_backend()) == ("cuda", "nccl")
        a = nngp_tpu_torch.run(fit(), mesh=mesh, **RUN)
    finally:
        dist.destroy_process_group()
    b = nngp_tpu_torch.run(fit(), **RUN)
    assert a.iterations == b.iterations == 10
    _assert_same_run(a, b)


@pytest.mark.gpu
def test_one_by_one_nccl_halo_run_equals_run(tmp_path):
    """run(mc, mesh=...) on a 1 x 1 ("chains", "sites") NCCL mesh (halo
    mode: one sweep-kernel launch a colour step on the whole plan) follows
    run(mc) on the card bit for bit, 400 sites, 2 chains."""
    import torch.distributed as dist

    from nngp_tpu_torch.parallel import halo_mesh, initialize_distributed

    dev = _card()
    locs, y, X = synthetic_heavy_metals(n=400, p=2, seed=5)

    def fit():
        return nngp_tpu_torch.initialize(
            locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
            n_chains=2, seed=3, device=dev, verbose=False)

    assert initialize_distributed(f"file://{tmp_path / 'rdzv'}", 1, 0,
                                  device_type="cuda")
    try:
        mesh = halo_mesh(1)
        assert (mesh.device_type, dist.get_backend()) == ("cuda", "nccl")
        a = fit()
        before = sweep.chromatic_sweeps.launches
        a = nngp_tpu_torch.run(a, mesh=mesh, **RUN)
        torch.cuda.synchronize()
        launches = sweep.chromatic_sweeps.launches - before
    finally:
        dist.destroy_process_group()
    b = nngp_tpu_torch.run(fit(), **RUN)
    assert a.iterations == b.iterations == 10
    assert launches == 10 * 10 * a.graph.n_colors
    _assert_same_run(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("chains", [1, 3])
def test_sub_plan_steps_equal_the_full_launch(chains):
    """The kernel launched once a colour step on owned sub-plans (halo mode,
    2 ranks' sub-plans on one field, in turn) gives the bits of one launch
    of every sweep on the whole plan; one step on one rank's sub-plan gives
    the whole plan's step at that rank's sites and leaves the others."""
    from nngp_tpu_torch.parallel.halo import build_halo_plan

    dev = _card()
    mc = _mc(dev)
    g = mc.graph
    w0, args = _sweep_inputs(mc, chains, S=3)
    q_plan, P, rs, noise, scal = args[:5]
    want = sweep.chromatic_sweeps(w0.clone(), *args)
    plan = build_halo_plan(g, 2)
    subs = [plan.for_rank(d).to(dev).rank.sub for d in range(2)]
    full = build_halo_plan(g, 1).for_rank(0).to(dev).rank.sub
    q_edges = G.sweep_inputs(g, mc.data, *_tiled(mc, chains))[0]
    qs = [q_edges.index_select(1, sub.plan_edge) for sub in subs]
    w = w0.clone()
    before = sweep.chromatic_sweeps.launches
    for s in range(noise.shape[1]):
        z = noise[:, s:s + 1].contiguous()
        for c in range(g.n_colors):
            for sub, q in zip(subs, qs):
                sweep.chromatic_sweep_step(w, q, P, rs, z, scal, sub, c)
    torch.cuda.synchronize()
    steps = sum(b1 > b0 for sub in subs
                for b0, b1 in zip(sub.bounds, sub.bounds[1:]))
    assert sweep.chromatic_sweeps.launches == before + noise.shape[1] * steps
    assert torch.equal(w, want)
    # one colour step: rank 1's sub-plan against the whole plan's
    z = noise[:, :1].contiguous()
    c = 1
    one, whole = w0.clone(), w0.clone()
    sweep.chromatic_sweep_step(one, qs[1], P, rs, z, scal, subs[1], c)
    sweep.chromatic_sweep_step(whole, q_edges.index_select(
        1, full.plan_edge), P, rs, z, scal, full, c)
    sub = subs[1]
    sites = sub.plan_sites[sub.bounds[c]:sub.bounds[c + 1]].long()
    changed = torch.zeros(g.n, dtype=torch.bool, device=dev)
    changed[sites] = True
    assert torch.equal(one[:, changed], whole[:, changed])
    assert torch.equal(one[:, ~changed], w0[:, ~changed])


@pytest.mark.gpu
@pytest.mark.parametrize("sites", [2, 4])
def test_halo_over_cards_matches_run(tmp_path, sites):
    """Halo mode over NCCL, one card a sites rank (the exchange on the
    cards): the Heavy-metals fit at full width (3 chains) resumed for 2
    cycles of 10 iterations by ``parallel.resume --sites D`` on a 1 x D
    mesh, against run() of the same fit: every state element within 1e-3
    * max(1, |x|_inf) (only the cross-rank sums add in another order).
    Prints the ranks' JSON lines (ms per iteration, each cycle's seconds:
    the first builds NCCL's communicators, exchanges, bytes sent)."""
    import json

    from nngp_tpu_torch.parallel.distributed import launch_local

    dev = _card()
    if torch.cuda.device_count() < sites:
        pytest.skip(f"needs {sites} CUDA cards")
    locs, y, X = synthetic_heavy_metals()
    fit, out = str(tmp_path / "fit.pkl"), str(tmp_path / "halo.pkl")
    nngp_tpu_torch.save(nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=3, seed=1, device=dev, verbose=False), fit)
    lines = [json.loads(t.strip().splitlines()[-1]) for t in launch_local(
        ["-m", "nngp_tpu_torch.parallel.resume", fit, "--iterations", "10",
         "--cycles", "2", "--sites", str(sites), "--save", out], sites,
        timeout=600)]
    for r in lines:
        print(json.dumps({k: v for k, v in r.items() if k != "r_hat"}))
    assert len({r["digest"] for r in lines}) == 1
    assert all(r["exchanges_per_iteration"] > 0 for r in lines)
    a = nngp_tpu_torch.load(out, device=dev)
    b = nngp_tpu_torch.run(nngp_tpu_torch.load(fit, device=dev),
                           n_iterations_update=10, n_cycles=2, verbose=False)
    assert a.iterations == b.iterations == 20
    for f in STATE_FIELDS:
        x, z = getattr(a.states, f), getattr(b.states, f)
        assert torch.isfinite(x).all(), f
        assert (x - z).abs().max().item() <= 1e-3 * max(
            1.0, z.abs().max().item()), f


@pytest.mark.gpu
def test_dryrun_multichip_one_nccl_rank(capsys):
    """dryrun_multichip(1) starts one rank that runs the sharded cycle and
    the collective R-hat over NCCL on the card."""
    from nngp_tpu_torch.entry import dryrun_multichip

    _card()
    dryrun_multichip(1)
    assert "dryrun_multichip OK: 1 x 2 chains (cuda" in capsys.readouterr().out


@pytest.mark.gpu
def test_vignette_example_on_card(tmp_path):
    """python -m nngp_tpu_torch.examples.vignette_toy --quick, through
    main(), on the card: one sweep kernel launch an iteration of both fits,
    a finite summary that names the card."""
    from nngp_tpu_torch.examples import _common, vignette_toy

    _card()
    sweep.chromatic_sweeps.launches = 0
    s = vignette_toy.main(["--quick", "--out", str(tmp_path)])
    assert s["iterations_run"] > 0
    assert sweep.chromatic_sweeps.launches == s["iterations_run"]
    assert _common.all_finite(s)
    assert s["device"].startswith(torch.cuda.get_device_name(0))
    assert len(s["control_rhat_V1"]) == 5


@pytest.mark.gpu
def test_sweep_parity_preflight_on_card():
    """The bench's preflight at 3 chains: the kernel's zero-noise sweeps of
    chain 0 against the twin's within 2e-3 * max(1, |f|_inf)."""
    from nngp_tpu_torch.diagnostics.preflight import chromatic_sweep_parity

    dev = _card()
    locs, y, X = synthetic_heavy_metals(n=500, p=2, seed=9)
    mc = nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=3, seed=4, device=dev, verbose=False)
    out = chromatic_sweep_parity(mc)
    assert out["ok"], out
    assert out["device"] == torch.cuda.get_device_name(dev)
    assert out["rel_tol_used"] == 2e-3
    assert 0.0 <= out["rms_diff"] <= out["max_abs_diff"]


# --- the gather probes' kernels (nngp_tpu_torch/experiments) ---------------

@pytest.mark.gpu
@pytest.mark.parametrize("cluster", gather_ops.CLUSTERS)
def test_gather_sweeps_matches_plain(cluster):
    """X1's DSMEM kernel against its plain twin at the script's shapes;
    tolerance 1e-5 * max(1, |w|_inf) (float32 sums in another order through
    600 dependent steps of a map whose field grows to ~6e14)."""
    dev = _card()
    t = gather_bench.inputs(dev)
    args = gather_bench.sweep_args(t)
    before = gather_ops.gather_sweeps.launches
    got = gather_ops.gather_sweeps(t["w0"].clone(), *args, cluster=cluster)
    want = gather_ops.gather_sweeps_reference(t["w0"].clone(), *args)
    torch.cuda.synchronize()
    assert gather_ops.gather_sweeps.launches == before + 1
    assert torch.isfinite(got).all()
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


def _ragged_sweeps(case, dev, seed=0):
    """X1 inputs off the script's shapes, as (w0, sites, nbrs, q, P, noise,
    keep) on ``dev``: "ragged" has n and B multiples of no cluster size,
    "repeats" a block step in which most sites repeat."""
    rng = np.random.default_rng(seed)
    n, NB, B, S = (1003, 4, 37, 3) if case == "ragged" else (997, 3, 300, 2)
    sites = rng.integers(0, n, size=(NB, B))
    if case == "repeats":
        sites[1] = rng.integers(0, 7, size=B)
    arrays = [rng.normal(size=n), sites, rng.integers(0, n, size=(NB, B, 16)),
              0.1 * rng.normal(size=(NB, B, 16)),
              rng.uniform(1.0, 2.0, size=(NB, B)), rng.normal(size=(S, NB, B))]
    t = [torch.from_numpy(a.astype(np.int32 if a.dtype.kind == "i"
                                   else np.float32)).to(dev) for a in arrays]
    return (*t, gather_ops.last_occurrence(t[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", gather_ops.CLUSTERS)
@pytest.mark.parametrize("case", ["ragged", "repeats"])
def test_gather_sweeps_ragged_matches_plain(case, cluster):
    """X1 where B and n are multiples of no cluster size, and where most
    sites of a block step repeat: within 1e-5 * max(1, |w|_inf) of plain."""
    dev = _card()
    w0, *args = _ragged_sweeps(case, dev)
    got = gather_ops.gather_sweeps(w0.clone(), *args, cluster=cluster)
    want = gather_ops.gather_sweeps_reference(w0.clone(), *args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", gather_ops.CLUSTERS)
def test_gather_sweeps_repeat_calls_bit_identical(cluster):
    """Products formed on the neighbour's rank and summed in neighbour
    order: two calls with one plan give the same bits, one launch each."""
    dev = _card()
    t = gather_bench.inputs(dev)
    args = gather_bench.sweep_args(t)
    plan = gather_ops.gather_sweeps_plan(t["sites"], t["nbrs"], t["q"],
                                         t["keep"], cluster)
    before = gather_ops.gather_sweeps.launches
    first = gather_ops.gather_sweeps(t["w0"].clone(), *args, cluster=cluster,
                                     plan=plan)
    assert gather_ops.gather_sweeps.launches == before + 1
    second = gather_ops.gather_sweeps(t["w0"].clone(), *args, cluster=cluster,
                                      plan=plan)
    torch.cuda.synchronize()
    assert gather_ops.gather_sweeps.launches == before + 2
    assert torch.equal(first, second)


# chains of one to four stages over every kind, at sizes that are
# multiples of neither 4 nor 32
CHAINS = [("rows",), ("cols",), ("roll",), ("trans",), ("rows", "cols"),
          ("trans", "rows"), ("cols", "roll"), ("roll", "trans", "cols"),
          ("cols", "rows", "cols"), ("rows", "trans", "roll", "cols"),
          ("trans", "cols", "trans", "rows"), ("roll", "roll", "rows", "trans")]


def _ragged_chain(kinds, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols = 37, 29
    src = (rng.integers(-99, 99, size=(rows, cols)) if dtype == torch.int32
           else rng.normal(size=(rows, cols)))
    stages = []
    for kind in kinds:
        if kind == "rows":
            new = int(rng.choice([5, 33, 61]))
            idx = rng.integers(0, rows, size=(new, cols))
            rows = new
        elif kind == "cols":
            new = int(rng.choice([3, 36, 67]))
            idx = rng.integers(0, cols, size=(rows, new))
            cols = new
        if kind in ("rows", "cols"):
            stages.append((kind, torch.from_numpy(idx.astype(np.int32)).to(dev)))
        elif kind == "roll":
            stages.append(("roll", int(rng.integers(-50, 50))))
        else:
            stages.append(("trans",))
            rows, cols = cols, rows
    return torch.from_numpy(src).to(dtype).to(dev), stages


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32],
                         ids=["f32", "i32"])
@pytest.mark.parametrize("kinds", CHAINS, ids=["-".join(c) for c in CHAINS])
def test_staged_gather_ragged_chains_exact(kinds, dtype):
    """Chains of 1-4 stages on ragged shapes equal the plain version."""
    dev = _card()
    src, stages = _ragged_chain(kinds, dtype, dev)
    before = gather_ops.staged_gather.launches
    got = gather_ops.staged_gather(src, stages)
    want = gather_ops.staged_gather_reference(src, stages)
    torch.cuda.synchronize()
    assert gather_ops.staged_gather.launches == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "script,index", [("probe", i) for i in range(5)]
    + [("probe2", i) for i in range(7)])
def test_probe_kernel_matches_plain(monkeypatch, script, index):
    """Gathers, roll, transpose and scatter exactly; the matmul within
    1e-5 * max(1, |C|_inf) of the FP32 product (TF32 off)."""
    dev = _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    mod, make = {"probe": (gather_probe, data.probe_arrays),
                 "probe2": (gather_probe2, data.probe2_arrays)}[script]
    p = mod.probes(data.to_device(make(), dev))[index]
    before = p.op.launches
    got = p.op(*p.args)
    want = p.plain(*p.args)
    torch.cuda.synchronize()
    assert p.op.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    if p.op is gather_ops.matmul_f32:
        tol = 1e-5 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol
    else:
        assert torch.equal(got, want)


# shapes (M, K, N) that cross every tile edge of the matmul kernel: 64
# rows, 128 columns, 32 of depth, and the depth split's slices; and an
# empty depth (C = 0)
MM_SHAPES = [(1, 4, 4), (65, 1028, 132), (512, 1024, 128), (130, 36, 260),
             (2048, 512, 2048), (4, 0, 4)]
MM_IDS = ["x".join(map(str, s)) for s in MM_SHAPES]


def _mm_operands(M, K, N, dev, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", MM_SHAPES, ids=MM_IDS)
def test_matmul_matches_plain_at_ragged_shapes(monkeypatch, M, K, N):
    """The 3xTF32 kernel against ``a @ b`` with TF32 off, within
    1e-5 * max(1, |C|_inf); one launch per call."""
    dev = _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    a, b = _mm_operands(M, K, N, dev)
    before = gather_ops.matmul_f32.launches
    got = gather_ops.matmul_f32(a, b)
    want = gather_ops.matmul_f32_reference(a, b)
    torch.cuda.synchronize()
    assert gather_ops.matmul_f32.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(512, 1024, 128), (65, 1028, 132)],
                         ids=["512x1024x128", "65x1028x132"])
def test_matmul_repeat_calls_bit_identical(M, K, N):
    """The depth split's partial tiles are added in rank order, so two
    calls give the same bits."""
    dev = _card()
    a, b = _mm_operands(M, K, N, dev, seed=1)
    first = gather_ops.matmul_f32(a, b)
    second = gather_ops.matmul_f32(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_matmul_split_matches_python():
    """The depth split the kernel takes is the one the CPU tests check."""
    _card()
    lib = gather_ops._probe_library()
    for M, K, N in MM_SHAPES + [(64, 8192, 128), (4096, 64, 4096)]:
        assert lib.matmul_f32_split(M, N, K) == gather_ops.matmul_split_k(M, N, K)


# column_scatter at ragged sizes: the CPU tests' sizes (n_in, n_rows, cols,
# pattern of idx's column 0) and 2^18 indices into one wave of blocks
SCATTER_CASES = (
    [(n, r, c, "random") for n in (0, 1, 7, 1024, 4097)
     for r in (1, 31, 512, 513) for c in (1, 3, 4, 128, 131)]
    + [(n, r, c, p) for n, r, c, p in [
        (7, 513, 4, "one row"), (4097, 31, 128, "one row"),
        (4097, 513, 131, "one row"), (7, 31, 131, "distinct"),
        (512, 513, 128, "distinct"), (2**18, 512, 128, "random"),
        (2**18, 513, 131, "one row")]])


def _scatter_case(n_in, n_rows, cols, pattern, dev, seed=0):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(n_in, cols)).astype(np.float32)
    idx = rng.integers(0, n_rows, size=(n_in, cols)).astype(np.int32)
    if pattern == "one row":
        idx[:, 0] = rng.integers(0, n_rows)
    elif pattern == "distinct":
        idx[:, 0] = rng.permutation(n_rows)[:n_in]
    return torch.from_numpy(val).to(dev), torch.from_numpy(idx).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n_in,n_rows,cols,pattern", SCATTER_CASES,
                         ids=["-".join(map(str, c)).replace(" ", "")
                              for c in SCATTER_CASES])
def test_column_scatter_ragged_exact(n_in, n_rows, cols, pattern):
    """The kernel equals the plain twin bit for bit and two calls give the
    same bits.  Before each call a block of NaNs of the output's size is
    freed, which the caching allocator hands out again, so an element the
    kernel leaves unwritten shows."""
    dev = _card()
    val, idx = _scatter_case(n_in, n_rows, cols, pattern, dev)
    before = gather_ops.column_scatter.launches
    got = []
    for _ in range(2):
        torch.full((n_rows, cols), float("nan"), device=dev)   # freed at once
        got.append(gather_ops.column_scatter(val, idx, n_rows))
    want = gather_ops.column_scatter_reference(val, idx, n_rows)
    torch.cuda.synchronize()
    assert gather_ops.column_scatter.launches == before + 2
    assert torch.equal(got[0], want) and torch.equal(got[0], got[1])


@pytest.mark.gpu
def test_column_scatter_rows_match_python():
    """The C side's rows a block equal Python's ``scatter_rows_per_block``."""
    _card()
    lib = gather_ops._probe_library()
    for n in (1, 8, 512, 1056, 1057, 10**5, 811008, 811009, 2**24):
        assert lib.column_scatter_rows(n) == gather_ops.scatter_rows_per_block(n)


def _misaligned(t):
    """A contiguous copy of ``t`` one element past an aligned address."""
    out = t.new_empty(t.numel() + 1)[1:].view(t.shape)
    return out.copy_(t)


def _gather_cases(dev):
    """Per wrapper: good arguments, and (exception, bad arguments) pairs."""
    i32 = dict(dtype=torch.int32, device=dev)
    NB, B = 2, 32
    sw = dict(w=torch.zeros(64, device=dev),
              sites=torch.zeros(NB, B, **i32),
              nbrs=torch.zeros(NB, B, 16, **i32),
              q=torch.zeros(NB, B, 16, device=dev),
              P=torch.ones(NB, B, device=dev),
              noise=torch.zeros(1, NB, B, device=dev),
              keep=torch.ones(NB, B, dtype=torch.bool, device=dev))
    idx = torch.zeros(8, 4, **i32)
    sg = dict(src=torch.zeros(8, 4, device=dev), stages=[("rows", idx)])
    cs = dict(val=torch.zeros(8, 4, device=dev), idx=idx, n_rows=4)
    mm = dict(a=torch.zeros(8, 8, device=dev), b=torch.zeros(8, 4, device=dev))
    plan = gather_ops.gather_sweeps_plan(sw["sites"], sw["nbrs"], sw["q"],
                                         sw["keep"])
    return {
        "gather_sweeps": (sw, [
            (TypeError, {**sw, "nbrs": sw["nbrs"].long()}),
            (ValueError, {**sw, "P": sw["P"].cpu()}),
            (ValueError, {**sw, "q": torch.zeros(NB, B, 8, device=dev)}),
            (ValueError, {**sw, "cluster": 3}),
            (ValueError, {**sw, "plan": gather_ops.gather_sweeps_plan(
                sw["sites"], sw["nbrs"], sw["q"], sw["keep"], 2)}),
            (ValueError, {**sw, "sites": sw["sites"].clone(), "plan": plan}),
            *[(ValueError, {**sw, "plan": plan._replace(
                **{k: _misaligned(getattr(plan, k))})})
              for k in ("pushes", "owned", "where")]]),
        "staged_gather": (sg, [
            (TypeError, {**sg, "stages": [("rows", idx.long())]}),
            (ValueError, {**sg, "stages": [("rows", idx.cpu())]}),
            (TypeError, {**sg, "src": sg["src"].double()})]),
        "column_scatter": (cs, [
            (TypeError, {**cs, "idx": idx.long()}),
            (ValueError, {**cs, "idx": idx.cpu()}),
            (ValueError, {**cs, "idx": torch.zeros(8, 2, **i32)}),
            (ValueError, {**cs, "n_rows": 2**29})]),   # out of 2^31 elements
        "matmul_f32": (mm, [
            (TypeError, {**mm, "b": mm["b"].double()}),
            (ValueError, {**mm, "b": mm["b"].cpu()}),
            (ValueError, {**mm, "b": torch.zeros(6, 4, device=dev)}),
            (ValueError, {"a": torch.zeros(8, 6, device=dev),
                          "b": torch.zeros(6, 4, device=dev)})]),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gather_sweeps", "staged_gather",
                                  "column_scatter", "matmul_f32"])
def test_gather_kernel_rejects_bad_inputs(name):
    dev = _card()
    op = getattr(gather_ops, name)
    good, bad = _gather_cases(dev)[name]
    op(**good)
    torch.cuda.synchronize()
    for exc, kw in bad:
        with pytest.raises(exc):
            op(**kw)
