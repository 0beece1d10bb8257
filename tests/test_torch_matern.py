"""The port's Matérn families (ops/bessel.py, ops/covariance.py) against
nngp_tpu's and against scipy.

Tolerances:
- kv: relative 5e-4 against scipy in float32 (nngp_tpu's own bound,
  tests/test_ops.py), 1e-6 against nngp_tpu's kv (the same float32
  recurrences; observed ~1e-6), 1e-8 against scipy in float64;
- correlations: atol 2e-6 (float32; lgamma/log/exp of torch against XLA's
  and exp_acc, observed ~6e-7);
- factor rows: rtol 1e-4 / atol 1e-5 at the initial states, as for the
  exponential families (tests/test_torch_ops.py); at the Matérn probe's
  geometry against the float64 oracle, within 1.5x the error of nngp_tpu's
  jitted build on the same K (see the test).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.special
import torch

import nngp_tpu
from nngp_tpu.ops import covariance as jcov
from nngp_tpu.ops.bessel import kv as jax_kv
from nngp_tpu.ops.vecchia import linv_rows_from_K as jax_linv_rows_from_K
from nngp_tpu.ops.vecchia import vecchia_linv as jax_linv
from nngp_tpu_torch.interop import from_numpy
from nngp_tpu_torch.ops import covariance as tcov
from nngp_tpu_torch.ops.bessel import kv
from nngp_tpu_torch.ops.numpy_ref import np_vecchia_linv
from nngp_tpu_torch.ops.vecchia import vecchia_linv
from nngp_tpu_torch.preprocess.ordering import lonlat_to_xyz

torch.set_num_threads(1)

MATERN = ["matern_isotropic", "matern_sphere", "matern_scaledim",
          "matern_spacetime"]


def _kv_inputs():
    """The inputs of tests/test_ops.py::test_kv_against_scipy."""
    rng = np.random.default_rng(12345)
    nu = rng.uniform(0.05, 3.4, 500)
    x = np.exp(rng.uniform(np.log(1e-3), np.log(60), 500)).astype(np.float32)
    return nu, x


def test_kv_float32_matches_jax_and_scipy():
    nu, x = _kv_inputs()
    nu32 = nu.astype(np.float32)
    got = kv(torch.as_tensor(nu32), torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    ref = scipy.special.kv(nu, x.astype(np.float64))
    assert np.max(np.abs(got - ref) / np.abs(ref)) < 5e-4
    want = np.asarray(jax_kv(nu32, x))
    assert np.max(np.abs(got - want) / np.abs(want)) < 1e-6


def test_kv_float64_matches_scipy():
    nu, x = _kv_inputs()
    got = kv(torch.as_tensor(nu), torch.as_tensor(x.astype(np.float64)))
    assert got.dtype == torch.float64
    ref = scipy.special.kv(nu, x.astype(np.float64))
    assert np.max(np.abs(got.numpy() - ref) / np.abs(ref)) < 1e-8
    assert torch.isinf(kv(0.75, torch.zeros(1)))


def _graph(family, n=300, seed=11):
    rng = np.random.default_rng(seed)
    if "sphere" in family:
        locs = np.stack([rng.uniform(-100, -80, n), rng.uniform(30, 45, n)], 1)
    elif "spacetime" in family:
        locs = rng.uniform(size=(n, 3))
    else:
        locs = rng.uniform(size=(n, 2))
    mc = nngp_tpu.initialize(locs, rng.normal(size=n), m=5, n_chains=2,
                             seed=2, stationary_covfun=family)
    return mc, rng


@pytest.mark.parametrize("family", MATERN)
def test_names_and_shape_transform_match_jax(family):
    n_dims = 3 if "spacetime" in family else 2
    names = tcov.shape_param_names(family, n_dims)
    assert names == jcov.shape_param_names(family, n_dims)
    assert names[-1] == "qlogis_smoothness"
    sampled = np.random.default_rng(0).normal(size=(4, len(names))) * 2
    sampled = sampled.astype(np.float32)
    got = tcov.shape_transform(names, torch.as_tensor(sampled)).numpy()
    want = np.stack([np.asarray(jcov.shape_transform(names, jnp.asarray(s)))
                     for s in sampled])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.all((got[:, -1] > 0.5) & (got[:, -1] < 1.0))


def _natural(mc):
    """Natural shape params [2, n_shape]: every range at 2.5x its group's
    median neighbour distance (the probe's geometry,
    experiments/matern_probe.py), smoothness s = -2.5 and 3 (nu 0.54, 0.98)."""
    names = mc.space_time_model["covfun"]["shape_params"]
    d2g = np.asarray(mc.graph.nn_dist2)
    med = [np.median(np.sqrt(d2g[..., j][d2g[..., j] > 0]))
           for j in range(d2g.shape[-1])]
    sampled = np.array([list(np.log(2.5 * np.asarray(med))) + [s]
                        for s in (-2.5, 3.0)], np.float32)
    return tcov.shape_transform(names, torch.as_tensor(sampled))


@pytest.mark.parametrize("family", MATERN)
def test_correlation_from_sqdist_matches_jax(family):
    mc, _ = _graph(family)
    d2g = np.asarray(mc.graph.nn_dist2)
    natural = _natural(mc)
    got = tcov.correlation_from_sqdist(family, torch.as_tensor(d2g),
                                       natural).numpy()
    for c in range(2):
        want = np.asarray(jcov.correlation_from_sqdist(
            family, jnp.asarray(d2g), jnp.asarray(natural[c].numpy())))
        np.testing.assert_allclose(got[c], want, rtol=0, atol=2e-6)
    # both branches (series below 0.29, Bessel product above) were taken
    ranges = natural[:, :d2g.shape[-1]].numpy()
    d = np.sqrt((d2g[None] / ranges[:, None, None, None] ** 2).sum(-1))
    assert (d[d > 1e-8] <= 0.29).any() and (d > 0.29).any()


@pytest.mark.parametrize("family", ["matern_isotropic", "matern_sphere"])
def test_matern_vecchia_linv_matches_jax(family):
    mc, _ = _graph(family)
    g_t, _, states_t = from_numpy(mc.graph, mc.data, mc.states,
                                  device="cpu")
    assert g_t.d_floor == 1e-5
    names = mc.space_time_model["covfun"]["shape_params"]

    def both(natural):
        got = vecchia_linv(g_t, natural).numpy()
        want = np.stack([np.asarray(jax_linv(mc.graph, jnp.asarray(nat)))
                         for nat in natural.numpy()])
        return got, want

    got, want = both(tcov.shape_transform(names, states_t.shape))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # at the probe's geometry the conditional variance d_i falls to ~1e-4
    # and amplifies an ulp of K by 1/d_i (rows differ by up to 1e-3), so
    # both packages are held against the float64 oracle: the port's error
    # within 1.5x nngp_tpu's as its sampler runs it (jitted, each
    # multiply-subtract fused) on the port's own K, whose parity with
    # nngp_tpu's test_correlation_from_sqdist_matches_jax holds; the port's
    # log-determinant within 1e-3
    natural = _natural(mc)
    got = vecchia_linv(g_t, natural).numpy()
    K = tcov.correlation_from_sqdist(family, g_t.nn_dist2, natural).numpy()
    jit_rows = jax.jit(jax_linv_rows_from_K, static_argnums=2)
    want = np.asarray(jit_rows(jnp.asarray(K), jnp.asarray(mc.graph.nn_mask),
                               g_t.d_floor))
    coords = lonlat_to_xyz(mc.locs) if "sphere" in family else mc.locs
    for c, nat in enumerate(natural.numpy().astype(np.float64)):
        oracle = np_vecchia_linv(coords, mc.NNarray, family, nat)
        err_t = np.abs(got[c] - oracle).max()
        err_j = np.abs(want[c] - oracle).max()
        assert err_t <= 1.5 * err_j + 1e-6, (err_t, err_j)
        logdet_err = np.log(got[c][:, 0]).sum() - np.log(oracle[:, 0]).sum()
        assert abs(logdet_err) < 1e-3
