"""The port's device ops (nngp_tpu_torch.ops) against nngp_tpu.ops on the
same graph and parameters, chains leading on the port's side.

Tolerances, by what differs between the two:
- factor rows: rtol 1e-4 / atol 1e-5 — the port's torch.exp against
  nngp_tpu's software exp_acc (both ~1 ulp, but the conditional variance
  amplifies an ulp of K by 1/d_i);
- gathers, solves, Q assembly on the SAME factor: 1e-5 — float32 summation
  order only;
- loglik: rtol 1e-5 (float64 against double-float accumulation);
- nngp_loglik_diff: abs 1e-4 (float64 sum against double-float sum of the
  same per-site differences, plus log1p against log1p_acc).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nngp_tpu
from nngp_tpu.ops import trisolve as jtri
from nngp_tpu.ops import vecchia as jvec
from nngp_tpu_torch.interop import from_numpy
from nngp_tpu_torch.ops import trisolve as ttri
from nngp_tpu_torch.ops import vecchia as tvec

torch.set_num_threads(1)

C = 2


@pytest.fixture(scope="module", params=["exponential_isotropic",
                                        "exponential_sphere"])
def problem(request):
    family = request.param
    rng = np.random.default_rng(11)
    n = 300
    if "sphere" in family:
        locs = np.stack([rng.uniform(-100, -80, n), rng.uniform(30, 45, n)], 1)
    else:
        locs = rng.uniform(size=(n, 2))
    mc = nngp_tpu.initialize(locs, rng.normal(size=n), m=5, n_chains=C,
                             seed=2, stationary_covfun=family)
    g_t, data_t, states_t = from_numpy(mc.graph, mc.data, mc.states,
                                       device="cpu")
    # natural ranges around the data's own spacing
    natural = np.exp(np.asarray(mc.states.shape, dtype=np.float32))
    return mc, g_t, states_t, natural, rng


def _jax_linv(mc, natural):
    return np.stack([np.asarray(jvec.vecchia_linv(mc.graph, jnp.asarray(nat)))
                     for nat in natural])


def test_vecchia_linv(problem):
    mc, g_t, _, natural, _ = problem
    want = _jax_linv(mc, natural)
    got = tvec.vecchia_linv(g_t, torch.as_tensor(natural)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_linv_mult_and_transpose(problem):
    mc, g_t, _, natural, rng = problem
    linv = _jax_linv(mc, natural)
    n = g_t.n
    x = rng.normal(size=(C, n)).astype(np.float32)
    X = rng.normal(size=(C, n, 3)).astype(np.float32)
    lt = torch.as_tensor(linv)
    for c in range(C):
        np.testing.assert_allclose(
            tvec.linv_mult(lt, torch.as_tensor(x), g_t)[c].numpy(),
            np.asarray(jvec.linv_mult(jnp.asarray(linv[c]), jnp.asarray(x[c]),
                                      mc.graph)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            tvec.linv_mult(lt, torch.as_tensor(X), g_t)[c].numpy(),
            np.asarray(jvec.linv_mult(jnp.asarray(linv[c]), jnp.asarray(X[c]),
                                      mc.graph)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            tvec.linv_t_mult(lt, torch.as_tensor(x), g_t)[c].numpy(),
            np.asarray(jvec.linv_t_mult(jnp.asarray(linv[c]), jnp.asarray(x[c]),
                                        mc.graph)), rtol=1e-5, atol=1e-5)


def test_precision_diag_and_q_edges(problem):
    mc, g_t, _, natural, _ = problem
    linv = _jax_linv(mc, natural)
    pdiag, q = tvec.precision_diag_and_q_edges(torch.as_tensor(linv), g_t)
    for c in range(C):
        jd, jq = jvec.precision_diag_and_q_edges(jnp.asarray(linv[c]), mc.graph)
        np.testing.assert_allclose(pdiag[c].numpy(), np.asarray(jd),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(q[c].numpy(), np.asarray(jq),
                                   rtol=1e-5, atol=1e-5)


def test_level_solve(problem):
    mc, g_t, _, natural, rng = problem
    linv = _jax_linv(mc, natural)
    n = g_t.n
    v = rng.normal(size=(C, n)).astype(np.float32)
    got = ttri.level_solve(torch.as_tensor(linv), torch.as_tensor(v), g_t).numpy()
    NN = np.asarray(mc.graph.NNarray)
    for c in range(C):
        want = np.asarray(jtri.level_solve(jnp.asarray(linv[c]),
                                           jnp.asarray(v[c]), mc.graph))
        np.testing.assert_allclose(got[c], want, rtol=1e-5, atol=1e-5)
        # dense back-substitution oracle (float64)
        L = np.zeros((n, n))
        for i in range(n):
            for j, col in enumerate(NN[i]):
                if col >= 0:
                    L[i, col] = linv[c, i, j]
        x = np.linalg.solve(L, v[c].astype(np.float64))
        np.testing.assert_allclose(got[c], x, rtol=1e-4, atol=1e-4)



def _graphs(problem):
    """The problem's graph and a prediction joint graph over it (60 new
    sites, m = 6, pad = n_joint), both with torch leaves on the CPU."""
    from nngp_tpu_torch import prediction as P

    mc, g_t, _, _, rng = problem
    lo, hi = mc.locs.min(0), mc.locs.max(0)
    joint = P._joint_graph(mc, rng.uniform(lo, hi, size=(60, 2)), 6)
    return {"graph": g_t, "joint": joint.to("cpu")}


def _numpy_walk(linv, v, ptr, sites, cols):
    """x of L x = v walked over the level-step CSR in NumPy, each site's
    arithmetic the twin's: float32 products summed by ``torch.sum`` (whose
    order the CPU's vector unit sets), then subtract and divide."""
    x = np.zeros(v.shape, dtype=np.float32)
    for s in range(len(ptr) - 1):
        st, c = sites[ptr[s]:ptr[s + 1]], cols[ptr[s]:ptr[s + 1]]
        prod = linv[:, st, 1:] * (c >= 0).astype(np.float32) \
            * x[:, np.maximum(c, 0)]
        acc = torch.sum(torch.from_numpy(prod), dim=-1).numpy()
        x[:, st] = (v[:, st] - acc) / linv[:, st, 0]
    return x


def test_level_steps_visit_every_site_once_after_its_parents(problem):
    from nngp_tpu_torch.preprocess.coloring import dag_levels, level_steps

    for name, g in _graphs(problem).items():
        ptr, sites, cols = level_steps(g.level_segs, g.NNarray, g.nn_mask)
        n = g.n
        assert ptr[0] == 0 and ptr[-1] == n and (np.diff(ptr) > 0).all()
        assert np.array_equal(np.sort(sites), np.arange(n)), name
        step = np.empty(n, dtype=np.int64)
        for s in range(len(ptr) - 1):
            st = sites[ptr[s]:ptr[s + 1]]
            assert (np.diff(st) > 0).all()          # increasing in a step
            step[st] = s
        NN = np.asarray(g.NNarray)
        want = np.where(NN[sites, 1:] >= 0, NN[sites, 1:], -1)
        assert np.array_equal(cols, want), name
        par = cols >= 0
        assert (step[cols[par]] < np.repeat(step[sites], par.sum(1))).all()
        # the rows of one level merge: a step a DAG level
        assert len(ptr) - 1 == int(dag_levels(NN).max()) + 1, name


def test_level_steps_walk_equals_reference_bits(problem):
    from nngp_tpu_torch.preprocess.coloring import level_steps

    mc, _, _, natural, rng = problem
    for name, g in _graphs(problem).items():
        linv = tvec.vecchia_linv(g, torch.as_tensor(natural))
        v = torch.as_tensor(rng.normal(size=(C, g.n)).astype(np.float32))
        want = ttri.level_solve_reference(linv, v, g).numpy()
        got = _numpy_walk(linv.numpy(), v.numpy(),
                          *level_steps(g.level_segs, g.NNarray, g.nn_mask))
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_graphs_carry_their_level_steps(problem):
    """Both graphs hold ``level_steps`` of their own schedule, int32 once
    moved to a device (the kernel reads them as they are)."""
    from nngp_tpu_torch.preprocess.coloring import STEP_FIELDS, level_steps

    for name, g in _graphs(problem).items():
        want = level_steps(g.level_segs, g.NNarray, g.nn_mask)
        for f, w in zip(STEP_FIELDS, want):
            t = getattr(g, f)
            assert t.dtype == torch.int32, (name, f)
            np.testing.assert_array_equal(t.numpy(), w, err_msg=f"{name} {f}")


def test_level_solve_on_cpu_is_the_plain_twin(problem):
    """The wrapper on CPU tensors runs the twin (today's row loop): the
    same bits, no kernel launch."""
    mc, g_t, _, natural, rng = problem
    linv = torch.as_tensor(_jax_linv(mc, natural))
    v = torch.as_tensor(rng.normal(size=(C, g_t.n)).astype(np.float32))
    before = ttri.level_solve.launches
    got = ttri.level_solve(linv, v, g_t)
    assert torch.equal(got, ttri.level_solve_reference(linv, v, g_t))
    assert ttri.level_solve.launches == before
    # float64 in, float64 out, on the same rows
    assert ttri.level_solve(linv.double(), v.double(), g_t).dtype == \
        torch.float64


def test_level_steps_merge_a_wide_level_and_refuse_bad_schedules():
    from types import SimpleNamespace

    from nngp_tpu_torch.preprocess.coloring import level_segments, level_steps

    # 1,300 roots, then 700 sites each with one root parent: two levels
    # split over 3 + 2 rows of 512, merged into two steps
    n = 2000
    NN = np.full((n, 3), -1, dtype=np.int64)
    NN[:, 0] = np.arange(n)
    NN[1300:, 1] = np.arange(700)
    mask = (NN >= 0).astype(np.float32)
    levels = (NN[:, 1] >= 0).astype(np.int32)
    segs = level_segments(levels, n_sentinel=n)
    assert [t.shape for t in segs] == [(5, 512)]
    ptr, sites, cols = level_steps(segs, NN, mask)
    assert ptr.tolist() == [0, 1300, 2000]
    assert np.array_equal(sites, np.arange(n))
    assert np.array_equal(cols[1300:, 0], np.arange(700))
    assert (cols[:1300] == -1).all() and (cols[:, 1] == -1).all()
    # a zero in the mask drops the parent, as the twin's product does
    mask2 = mask.copy()
    mask2[1300, 1] = 0
    assert level_steps(segs, NN, mask2)[2][1300, 0] == -1
    # the rows in the wrong order, a site twice, a site left out
    with pytest.raises(ValueError, match="parent comes after"):
        level_steps((segs[0][::-1],), NN, mask)
    twice = (np.concatenate([segs[0], segs[0][:1]]),)
    with pytest.raises(ValueError, match="two rows"):
        level_steps(twice, NN, mask)
    short = segs[0].copy()
    short[1, 288] = n                  # site 800, no one's parent: a pad
    with pytest.raises(ValueError, match="1 of 2000 sites"):
        level_steps((short,), NN, mask)
    # the wrapper's checks refuse CPU tensors and too many neighbours
    g = SimpleNamespace(n=n, NNarray=torch.as_tensor(NN),
                        nn_mask=torch.as_tensor(mask), level_segs=segs)
    with pytest.raises(TypeError, match="CUDA"):
        ttri.level_solve_cuda(torch.ones(2, n, 3), torch.ones(2, n), g)
    wide = SimpleNamespace(n=4, NNarray=torch.zeros(4, 18, dtype=torch.long))
    with pytest.raises(ValueError, match="at most 16"):
        ttri.level_solve_cuda(torch.ones(2, 4, 18), torch.ones(2, 4), wide)


def _kernel_sites(lv, mask, parents, v):
    """The level solve kernel's arithmetic one site at a time in Python
    floats (IEEE float64): each product of two float32 is exact, added in
    index order over the parents whose mask is not 0, then (v - sum) /
    lv[0], rounded once to float32."""
    x = np.empty(v.shape, dtype=np.float32)
    for c, w in np.ndindex(*v.shape):
        s = 0.0
        for j in range(mask.shape[1]):
            if mask[w, j] != 0:
                s += float(lv[c, w, j + 1]) * float(parents[c, w, j])
        x[c, w] = np.float32((float(v[c, w]) - s) / float(lv[c, w, 0]))
    return x


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m", [1, 2, 5, 16])
def test_kernel_rows_is_the_kernels_arithmetic(m, masked):
    """``kernel_rows`` (the card's row arithmetic, shared by the twin and
    halo mode's solve) gives the bits of the kernel's per-site sums.  At
    m >= 3 the first two products are about 2^40 and cancel exactly, so a
    sum in any other order than 1..m loses the others' low bits and shows
    at float32; a masked parent adds nothing, even an inf."""
    rng = np.random.default_rng(m)
    W = 257
    lv = rng.normal(size=(3, W, m + 1)).astype(np.float32)
    parents = rng.normal(size=(3, W, m)).astype(np.float32)
    if m >= 3:
        big = (2.0 ** 20 * rng.normal(size=(3, W))).astype(np.float32)
        lv[..., 1], lv[..., 2] = big, -big
        parents[..., 0] = parents[..., 1] = (
            2.0 ** 20 * rng.normal(size=(3, W))).astype(np.float32)
    v = rng.normal(size=(3, W)).astype(np.float32)
    mask = np.ones((W, m), dtype=np.float32)
    if masked:
        mask[rng.random((W, m)) < 0.25] = 0
        parents[:, mask == 0] = np.inf
    want = _kernel_sites(lv, mask, parents, v)
    got = ttri.kernel_rows(*(torch.as_tensor(a)
                             for a in (lv, mask, parents, v)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_nngp_loglik_and_diff(problem):
    mc, g_t, states_t, natural, rng = problem
    linv_old = _jax_linv(mc, natural)
    natural_new = natural * np.exp(rng.normal(size=natural.shape) * 0.05)
    linv_new = _jax_linv(mc, natural_new.astype(np.float32))
    field = np.asarray(mc.states.field) - np.asarray(mc.states.beta_0)[:, None]
    ls_old = np.asarray(mc.states.log_scale)
    ls_new = (ls_old + 0.03).astype(np.float32)
    f_t = torch.as_tensor(field)
    got_ll = tvec.nngp_loglik(torch.as_tensor(linv_old), f_t, g_t,
                              torch.as_tensor(ls_old)).numpy()
    got_diff = tvec.nngp_loglik_diff(
        torch.as_tensor(linv_new), torch.as_tensor(ls_new),
        torch.as_tensor(linv_old), torch.as_tensor(ls_old), f_t, g_t).numpy()
    for c in range(C):
        want_ll = float(jvec.nngp_loglik(jnp.asarray(linv_old[c]),
                                         jnp.asarray(field[c]), mc.graph,
                                         ls_old[c]))
        np.testing.assert_allclose(got_ll[c], want_ll, rtol=1e-5)
        want_diff = float(jvec.nngp_loglik_diff(
            jnp.asarray(linv_new[c]), ls_new[c], jnp.asarray(linv_old[c]),
            ls_old[c], jnp.asarray(field[c]), mc.graph))
        assert abs(got_diff[c] - want_diff) < 1e-4, (got_diff[c], want_diff)


# --- the fixed-order sums (ops/vecchia.py:ordered_sum) -----------------------

def _sum_cases(g_t, linv, rng):
    """name -> (the port's result [C, T], its terms [C, N], their targets
    [N], T) for the four scatter-sums of an iteration."""
    n = g_t.n
    masked = linv * g_t.nn_mask
    nn = torch.clamp_min(g_t.NNarray, 0).reshape(-1)
    z = torch.as_tensor(rng.normal(size=(C, n)).astype(np.float32))
    r = torch.as_tensor(rng.normal(size=(C, g_t.n_obs)).astype(np.float32))
    prods = masked[:, :, g_t.pair_a] * masked[:, :, g_t.pair_b]
    pdiag, q_edges = tvec.precision_diag_and_q_edges(linv, g_t)
    return {
        "pdiag": (pdiag, (masked * masked).reshape(C, -1), nn, n),
        "q_edges": (q_edges, prods.reshape(C, -1),
                    g_t.pair_edge_id.reshape(-1), g_t.n_edges + 1),
        "linv_t_mult": (tvec.linv_t_mult(linv, z, g_t),
                        (masked * z[..., None]).reshape(C, -1), nn, n),
        "rs": (tvec.ordered_sum(r, g_t.obs_sum), r, g_t.locs_match, n),
    }


@pytest.fixture(scope="module")
def repeated_sites():
    """A problem whose sites hold 1 to 3 observations (obs_sum has three
    steps), with its factor."""
    rng = np.random.default_rng(5)
    locs = rng.uniform(size=(200, 2))
    locs = np.concatenate([locs, locs[:60], locs[:25]])
    mc = nngp_tpu.initialize(locs, rng.normal(size=len(locs)), m=5,
                             n_chains=C, seed=3,
                             stationary_covfun="exponential_isotropic")
    g_t, _, _ = from_numpy(mc.graph, mc.data, mc.states, device="cpu")
    natural = np.exp(np.asarray(mc.states.shape, dtype=np.float32))
    return mc, g_t, torch.as_tensor(_jax_linv(mc, natural)), rng


@pytest.mark.parametrize("name", ["pdiag", "q_edges", "linv_t_mult", "rs"])
def test_ordered_sums_match_index_add_bit_for_bit(repeated_sites, name):
    """Each sum adds a target's terms in increasing term index from zero,
    the order of index_add_ on the CPU: the same bits as index_add_, and
    the same bits on a second call."""
    _, g_t, linv, rng = repeated_sites
    assert g_t.obs_sum.steps == tuple(
        int((np.bincount(g_t.locs_match.numpy()) > j).sum()) for j in range(3))
    seed = int(rng.integers(1 << 30))
    got, terms, targets, T = _sum_cases(g_t, linv,
                                        np.random.default_rng(seed))[name]
    again = _sum_cases(g_t, linv, np.random.default_rng(seed))[name][0]
    want = torch.zeros(C, T).index_add_(1, targets, terms)
    assert torch.equal(got, want)
    assert torch.equal(got, again)


def test_residual_sums_match_nngp_tpu(repeated_sites):
    """rs against nngp_tpu's scatter (models/gaussian.py:sweep_inputs,
    ``zeros(n).at[locs_match].add``) at 1e-5; pdiag, q_edges and L'z are
    held against nngp_tpu's functions by the tests above."""
    mc, g_t, linv, rng = repeated_sites
    got, r, _, n = _sum_cases(g_t, linv, rng)["rs"]
    for c in range(C):
        want = jnp.zeros(n, jnp.float32).at[
            jnp.asarray(mc.graph.locs_match)].add(jnp.asarray(r[c].numpy()))
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
