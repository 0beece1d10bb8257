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
