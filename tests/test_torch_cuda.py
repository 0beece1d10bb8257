"""Tests that need a CUDA card (marker ``gpu``; each skips without one).

This file imports no jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures jax).  The CPU path these
tests compare the card with is held against nngp_tpu by the other
tests/test_torch_*.py files.
"""

import numpy as np
import pytest
import torch

import nngp_tpu_torch
from nngp_tpu_torch.experiments import (data, gather_bench, gather_ops,
                                        gather_probe, gather_probe2)
from nngp_tpu_torch.models import gaussian as G
from nngp_tpu_torch.ops import sweep
from nngp_tpu_torch.ops.covariance import shape_transform
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


def _sweep_inputs(mc, C_run, S=6, zero_noise=False):
    """The kernel's arguments on ``mc``'s graph with its states tiled to
    ``C_run`` chains: (w0, args after w)."""
    from nngp_tpu_torch.experiments.sweep_bench import tile_states

    g = mc.graph
    st = tile_states(mc.states, C_run)
    names = mc.space_time_model["covfun"]["shape_params"]
    linv = vecchia_linv(g, shape_transform(names, st.shape))
    _, q_plan, P, rs, scal = G.sweep_inputs(g, mc.data, st, linv,
                                            G._mu_obs(mc.data, st, g))
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
        gen = torch.Generator().manual_seed(3)
        st = mc.states
        carry = (st, vecchia_linv(mc.graph, shape_transform(cfg.shape_names,
                                                            st.shape)),
                 torch.zeros(C, device=d), torch.zeros(C, device=d))
        for it in range(3):
            draws = G.IterationDraws.draw(gen, cfg, C, mc.graph.n,
                                          st.beta.shape[1], "cpu")
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
    return {
        "gather_sweeps": (sw, [
            (TypeError, {**sw, "nbrs": sw["nbrs"].long()}),
            (ValueError, {**sw, "P": sw["P"].cpu()}),
            (ValueError, {**sw, "q": torch.zeros(NB, B, 8, device=dev)}),
            (ValueError, {**sw, "cluster": 3})]),
        "staged_gather": (sg, [
            (TypeError, {**sg, "stages": [("rows", idx.long())]}),
            (ValueError, {**sg, "stages": [("rows", idx.cpu())]}),
            (TypeError, {**sg, "src": sg["src"].double()})]),
        "column_scatter": (cs, [
            (TypeError, {**cs, "idx": idx.long()}),
            (ValueError, {**cs, "idx": idx.cpu()}),
            (ValueError, {**cs, "idx": torch.zeros(8, 2, **i32)})]),
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
