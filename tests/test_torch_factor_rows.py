"""The factor rows (``ops/vecchia.py:linv_rows_from_K``) against nngp_tpu's
``linv_rows_from_K`` as its sampler runs it: jitted, where XLA fuses each
multiply-subtract of the unrolled Cholesky, the two solves and d = 1 - u'u.

Each case feeds the SAME float32 K (the port's ``correlation_from_sqdist``,
held to nngp_tpu's by tests/test_torch_matern.py) to the port's plain twin
(the CPU side of the ``factor_rows`` kernel) and to ``jax.jit(
nngp_tpu.ops.vecchia.linv_rows_from_K)``, and holds both against the
float64 factor of that K:

- the port's log-diagonal error within 1.5x jitted nngp_tpu's + 1e-7 (on
  near-singular rows an op-by-op build errs 17-100x more);
- the rows within max relative difference 1e-4, |a - b| / (|b| + 1e-3), of
  jitted nngp_tpu's (both round each multiply-subtract once; 1/d amplifies
  the rare ulp where they differ).

Geometries: tests/test_torch_matern.py's (300 sites, m = 5, two states at
2.5 median neighbour distances, nu 0.54 and 0.98) and the Matérn probe's
clustered layout of tests/test_torch_audits.py (600 sites, maxmin, range
2.5 median neighbour distances, nu 0.75).  The exponential families keep
tests/test_torch_ops.py's tolerance against nngp_tpu's whole factor build
(rtol 1e-4 / atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nngp_tpu.ops.vecchia import linv_rows_from_K as jax_linv_rows_from_K
from nngp_tpu.ops.vecchia import vecchia_linv as jax_linv
from nngp_tpu_torch.interop import from_numpy
from nngp_tpu_torch.ops import covariance as tcov
from nngp_tpu_torch.ops import vecchia as tvec
from nngp_tpu_torch.ops.numpy_ref import np_linv_rows_from_K
from tests.test_torch_audits import _clustered
from tests.test_torch_matern import _graph, _natural

torch.set_num_threads(1)

LOGDIAG_FACTOR, LOGDIAG_ATOL = 1.5, 1e-7
ROWS_RTOL = 1e-4
jit_rows = jax.jit(jax_linv_rows_from_K, static_argnums=2)


def _probe_layout(covfun):
    """The Matérn probe's clustered layout (lon/lat degrees for the sphere)
    as a port graph, and its natural shape [1, G + 1] (range 2.5 median
    neighbour distances, nu 0.75: experiments/matern_probe.py)."""
    from nngp_tpu_torch.preprocess.dedupe import dedupe_and_match
    from nngp_tpu_torch.preprocess.graph import build_graph
    from nngp_tpu_torch.preprocess.ordering import reorder_locations

    locs = _clustered(np.random.default_rng(2))
    lonlat = covfun.endswith("sphere")
    if lonlat:
        locs = locs * [0.2, 0.1] + [-100.0, 35.0]
    maps = dedupe_and_match(
        locs, perm_fn=lambda L: reorder_locations(L, "maxmin", lonlat=lonlat))
    graph, _ = build_graph(maps, m=5, covfun=covfun)
    d2g = np.asarray(graph.nn_dist2)
    s = d2g.sum(-1)[np.asarray(graph.nn_mask) > 0]
    rho = 2.5 * float(np.sqrt(np.median(s[s > 0])))
    natural = np.array([[rho] * d2g.shape[-1] + [0.75]], np.float32)
    return graph, torch.as_tensor(natural)


def _case(covfun, where):
    """(K [1, n, k, k] f32, mask [n, k] f32, d_floor) of one case."""
    if where == "probe":
        graph, natural = _probe_layout(covfun)
        d2g, mask = torch.as_tensor(np.asarray(graph.nn_dist2)), \
            torch.as_tensor(np.asarray(graph.nn_mask))
        d_floor = graph.d_floor
    else:
        mc, _ = _graph(covfun)
        g, _, _ = from_numpy(mc.graph, mc.data, mc.states, device="cpu")
        natural = _natural(mc)[where:where + 1]
        d2g, mask, d_floor = g.nn_dist2, g.nn_mask, g.d_floor
    return tcov.correlation_from_sqdist(covfun, d2g, natural), mask, d_floor


def _logdiag_err(rows, rows64):
    return np.abs(np.log(rows[..., 0]) - np.log(rows64[..., 0])).max()


@pytest.mark.parametrize("where", [0, 1, "probe"])
@pytest.mark.parametrize("covfun", ["matern_isotropic", "matern_sphere"])
def test_factor_rows_match_jitted_nngp_tpu(covfun, where):
    K, mask, d_floor = _case(covfun, where)
    got = tvec.linv_rows_from_K(K, mask, d_floor).numpy()
    want = np.asarray(jit_rows(jnp.asarray(K.numpy()),
                               jnp.asarray(mask.numpy()), d_floor))
    rows64, _ = np_linv_rows_from_K(K[0].double().numpy(), mask.numpy(),
                                    d_floor)
    err_t, err_j = _logdiag_err(got, rows64), _logdiag_err(want, rows64)
    assert err_t <= LOGDIAG_FACTOR * err_j + LOGDIAG_ATOL, (err_t, err_j)
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    assert rel.max() <= ROWS_RTOL, rel.max()


@pytest.mark.parametrize("family", ["exponential_isotropic",
                                    "exponential_sphere",
                                    "exponential_scaledim",
                                    "exponential_spacetime"])
def test_exponential_factor_matches_jax(family):
    """The whole factor build (correlations and rows) against nngp_tpu's at
    the initial states, at test_torch_ops.py's tolerance."""
    mc, _ = _graph(family)
    g, _, states = from_numpy(mc.graph, mc.data, mc.states, device="cpu")
    natural = torch.exp(states.shape)
    got = tvec.vecchia_linv(g, natural).numpy()
    want = np.stack([np.asarray(jax_linv(mc.graph, jnp.asarray(nat)))
                     for nat in natural.numpy()])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_float64_rows_are_the_op_by_op_build():
    """float64 K runs the twin, whose casts then do nothing: the float64
    oracle's rows to rounding."""
    K, mask, d_floor = _case("matern_sphere", 0)
    got = tvec.linv_rows_from_K(K.double(), mask.double(), d_floor)
    assert got.dtype == torch.float64
    want, _ = np_linv_rows_from_K(K[0].double().numpy(), mask.numpy(),
                                  d_floor)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-9, atol=1e-12)


def test_padded_slots_and_no_neighbours():
    """Padded parent slots give exact zeros, and m = 0 gives rows of 1."""
    K, mask, d_floor = _case("matern_isotropic", 0)
    rows = tvec.linv_rows_from_K(K, mask, d_floor)
    assert torch.all(rows[..., mask == 0] == 0)
    assert torch.all(rows[..., 0] > 0)
    one = tvec.linv_rows_from_K(K[..., :1, :1], mask[:, :1], d_floor)
    assert one.shape == K.shape[:-2] + (1,) and torch.all(one == 1)


def test_kernel_refuses_more_than_sixteen_neighbours():
    k = tvec.FACTOR_ROWS_MAX_M + 2
    with pytest.raises(ValueError, match="at most 16"):
        tvec.linv_rows_cuda(torch.zeros(1, 3, k, k), torch.ones(3, k))
