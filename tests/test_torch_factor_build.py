"""The whole factor build (``ops/vecchia.py:vecchia_linv``) against
nngp_tpu's as its sampler runs it (jitted, where XLA fuses the correlation
and each multiply-subtract of the factor), for all eight families, and the
CPU side of the ``factor_build`` kernel (``csrc/factor_rows.cu``): its
plain twin ``vecchia_linv_reference``, the halo row subset, and the
wrapper's refusals.

Tolerances (those of tests/test_torch_ops.py, tests/test_torch_matern.py
and tests/test_torch_factor_rows.py):
- at the initial states (2 chains, m = 5): rtol 1e-4 / atol 1e-5 against
  jitted nngp_tpu;
- all eight families at 2.5 median neighbour distances, where the
  conditional variance falls and amplifies an ulp of K, both builds
  against the float64 oracle (tests/test_torch_matern.py's bounds): the
  port's largest row error within 1.5x jitted nngp_tpu's + 1e-6, its
  log-determinant within 1e-3; at that geometry the port's float32
  correlations themselves are held to nngp_tpu's against the float64
  ones: the largest and the mean error of K within 1.5x jitted
  nngp_tpu's;
- the Matérn build, which runs in float64 from the widened float32
  inputs through K, the Cholesky and the solves and rounds each row once:
  bit for bit that composition, and near singular, for both chains, its
  largest row error within 0.1x jitted nngp_tpu's + 1e-6 and its
  log-determinant within 1e-5 of the float64 oracle's (observed: at
  least 4x margin on the rows, at most 6.2e-7 on the log-determinant).

The card's kernel against this twin is tests/test_torch_cuda.py's
(marker gpu).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nngp_tpu.ops.vecchia import vecchia_linv as jax_linv
from nngp_tpu_torch.interop import from_numpy
from nngp_tpu_torch.ops import covariance as tcov
from nngp_tpu_torch.ops import vecchia as tvec
from nngp_tpu_torch.ops.numpy_ref import np_vecchia_linv
from nngp_tpu_torch.preprocess.ordering import lonlat_to_xyz
from tests.test_torch_matern import _graph, _natural

torch.set_num_threads(1)


def _port(family):
    """(nngp_tpu fit, the port's CPU graph, its initial natural shape
    [2, n_shape])."""
    mc, _ = _graph(family)
    g, _, states = from_numpy(mc.graph, mc.data, mc.states, device="cpu")
    names = mc.space_time_model["covfun"]["shape_params"]
    return mc, g, tcov.shape_transform(names, states.shape)


def _twin(g, natural):
    return tvec.vecchia_linv_reference(g.covfun, g.nn_dist2, g.nn_mask,
                                       natural, g.d_floor)


def _jitted(mc, natural):
    build = jax.jit(lambda nat: jax_linv(mc.graph, nat))
    return np.stack([np.asarray(build(jnp.asarray(nat)))
                     for nat in natural.numpy()])


@pytest.mark.parametrize("family", tcov.COVFUN_FAMILIES)
def test_reference_matches_jitted_nngp_tpu(family):
    mc, g, natural = _port(family)
    got = _twin(g, natural)
    assert got.shape == (2, g.n, g.nn_mask.shape[1])
    np.testing.assert_allclose(got.numpy(), _jitted(mc, natural),
                               rtol=1e-4, atol=1e-5)
    # the CPU's vecchia_linv is the twin, bit for bit
    assert torch.equal(tvec.vecchia_linv(g, natural), got)


@pytest.mark.parametrize("family", tcov.COVFUN_FAMILIES)
def test_reference_near_singular(family):
    mc, g, _ = _port(family)
    natural = _natural(mc)
    got, want = _twin(g, natural).numpy(), _jitted(mc, natural)
    coords = lonlat_to_xyz(mc.locs) if "sphere" in family else mc.locs
    for c, nat in enumerate(natural.numpy().astype(np.float64)):
        oracle = np_vecchia_linv(coords, mc.NNarray, family, nat)
        err_t = np.abs(got[c] - oracle).max()
        err_j = np.abs(want[c] - oracle).max()
        assert err_t <= 1.5 * err_j + 1e-6, (err_t, err_j)
        logdet_err = (np.log(got[c][:, 0]).sum()
                      - np.log(oracle[:, 0]).sum())
        assert abs(logdet_err) < 1e-3


@pytest.mark.parametrize("family", tcov.COVFUN_FAMILIES[4:])
def test_matern_build_float64_inside(family):
    """The Matérn twin widens the float32 distances and shape params and
    builds each row in float64 (K, Cholesky, solves), rounding it once:
    bit for bit that composition at the initial states and near singular,
    where, for both chains, its largest row error against the float64
    oracle is within 0.1x jitted nngp_tpu's + 1e-6 and its
    log-determinant within 1e-5."""
    mc, g, initial = _port(family)
    near = _natural(mc)
    for natural in (initial, near):
        got = _twin(g, natural)
        K = tcov.correlation_from_sqdist(family, g.nn_dist2.double(),
                                         natural.double())
        want = tvec.linv_rows_reference(K, g.nn_mask.double(),
                                        g.d_floor).float()
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
    got, jitted = _twin(g, near).numpy(), _jitted(mc, near)
    coords = lonlat_to_xyz(mc.locs) if "sphere" in family else mc.locs
    for c, nat in enumerate(near.numpy().astype(np.float64)):
        oracle = np_vecchia_linv(coords, mc.NNarray, family, nat)
        err_t = np.abs(got[c] - oracle).max()
        err_j = np.abs(jitted[c] - oracle).max()
        assert err_t <= 0.1 * err_j + 1e-6, (c, err_t, err_j)
        logdet_err = (np.log(got[c][:, 0].astype(np.float64)).sum()
                      - np.log(oracle[:, 0]).sum())
        assert abs(logdet_err) <= 1e-5, (c, logdet_err)


@pytest.mark.parametrize("family", tcov.COVFUN_FAMILIES[4:])
def test_matern_correlation_near_singular(family):
    """At the near-singular geometry the port's float32 Matérn
    correlations are at least as close to the float64 ones as jitted
    nngp_tpu's.  Rounded to float32, such a K still decides the rows'
    error there (an ulp amplified by the conditional variance), which is
    why the build keeps K in float64 (test_matern_build_float64_inside)."""
    from nngp_tpu.ops.covariance import correlation_from_sqdist as jax_corr
    from nngp_tpu_torch.ops.numpy_ref import np_correlation

    mc, g, _ = _port(family)
    natural = _natural(mc)
    coords = lonlat_to_xyz(mc.locs) if "sphere" in family else mc.locs
    NN = np.asarray(mc.NNarray)
    valid = (NN >= 0)[:, :, None] & (NN >= 0)[:, None, :]
    pts = np.asarray(coords, np.float64)[np.maximum(NN, 0)]
    got = tcov.correlation_from_sqdist(family, g.nn_dist2, natural).numpy()
    corr = jax.jit(lambda nat: jax_corr(family, mc.graph.nn_dist2, nat))
    for c, nat in enumerate(natural.numpy()):
        want = np_correlation(family, pts, nat.astype(np.float64))
        err_t = np.abs(got[c] - want)[valid]
        err_j = np.abs(np.asarray(corr(jnp.asarray(nat))) - want)[valid]
        assert err_t.max() <= 1.5 * err_j.max(), (err_t.max(), err_j.max())
        assert err_t.mean() <= 1.5 * err_j.mean(), (err_t.mean(),
                                                    err_j.mean())


@pytest.mark.parametrize("family", ["exponential_sphere",
                                    "exponential_scaledim",
                                    "matern_isotropic", "matern_spacetime"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_row_subset_equals_whole_factor_rows(family, dtype):
    """vecchia_linv at a non-contiguous, unsorted row list (halo mode's
    need rows) equals the whole factor at those rows bit for bit, and
    halo_vecchia_linv puts them in place with zeros elsewhere."""
    from types import SimpleNamespace

    from nngp_tpu_torch.parallel.halo_gibbs import halo_vecchia_linv

    _, g, natural = _port(family)
    whole = tvec.vecchia_linv(g, natural)
    rows = np.random.default_rng(5).permutation(g.n)[: g.n // 3]
    assert np.any(np.diff(rows) != 1)
    rows_t = torch.as_tensor(rows, dtype=dtype)
    got = tvec.vecchia_linv(g, natural, rows_t)
    assert got.shape == (2, len(rows), whole.shape[-1])
    assert torch.equal(got, whole[:, rows])
    shard = SimpleNamespace(rank=SimpleNamespace(need=rows_t))
    full = halo_vecchia_linv(g, natural, shard)
    assert torch.equal(full[:, rows], whole[:, rows])
    rest = np.setdiff1d(np.arange(g.n), rows)
    assert torch.all(full[:, rest] == 0)


def _fake_graph(m=5, G=1, n=10, covfun="exponential_sphere", **kw):
    from types import SimpleNamespace

    k = m + 1
    g = dict(covfun=covfun, nn_dist2=torch.zeros(n, k, k, G),
             nn_mask=torch.ones(n, k), d_floor=1e-12)
    g.update(kw)
    return SimpleNamespace(**g)


@pytest.mark.parametrize("case, err, match", [
    (dict(graph=dict(m=17)), ValueError, "at most 16"),
    (dict(graph=dict(nn_dist2=torch.zeros(10, 6, 5, 1))), ValueError,
     "nn_dist2 has shape"),
    (dict(graph=dict(nn_dist2=torch.zeros(10, 6, 6, 1, dtype=torch.float64))),
     TypeError, "float32"),
    (dict(graph=dict(nn_mask=torch.ones(10, 5))), ValueError,
     r"nn_mask has shape \(10, 5\)"),
    (dict(graph=dict(nn_mask=torch.ones(6, 10).t())), ValueError,
     "contiguous False"),
    (dict(natural=torch.ones(3, 1, dtype=torch.float64)), TypeError,
     "natural is torch.float64"),
    (dict(natural=torch.ones(3, 1), graph=dict(covfun="matern_sphere")),
     ValueError, "expected"),
    (dict(rows=torch.zeros(4)), TypeError, "rows is torch.float32"),
    (dict(rows=torch.zeros(2, 2, dtype=torch.int64)), TypeError, "1-D"),
    (dict(rows=torch.tensor([3, 10, 1])), ValueError,
     r"rows holds 1..10, expected indices in \[0, 10\)"),
    (dict(rows=torch.tensor([-1, 2], dtype=torch.int32)), ValueError,
     r"rows holds -1..2"),
    (dict(graph=dict(covfun="gaussian")), ValueError, "unknown"),
    (dict(), TypeError, "CUDA"),
])
def test_factor_build_refuses_before_any_launch(monkeypatch, case, err,
                                                match):
    """Every refusal is raised before the library is built or a launch
    counted (here on the CPU, where a well-formed call also refuses: the
    kernel takes only a card's tensors)."""
    def no_library(part, m):
        raise AssertionError("the library was reached")

    monkeypatch.setattr(tvec, "_factor_library", no_library)
    before = tvec.vecchia_linv.launches
    with pytest.raises(err, match=match):
        tvec.factor_build_cuda(_fake_graph(**case.get("graph", {})),
                               case.get("natural", torch.ones(3, 1)),
                               case.get("rows"))
    assert tvec.vecchia_linv.launches == before


def test_cpu_and_float64_never_launch():
    """vecchia_linv on the CPU, and in float64, runs the twin and counts
    no launch.  Rows come in the graph's dtype: a float64 graph gives
    float64 rows; float64 Matérn natural params on the float32 graph (the
    sampler's) give float32 rows built in float64, as float32 ones do."""
    from dataclasses import replace

    _, g, natural = _port("matern_sphere")
    g64 = replace(g, nn_dist2=g.nn_dist2.double(), nn_mask=g.nn_mask.double())
    before = tvec.vecchia_linv.launches
    a = tvec.vecchia_linv(g, natural)
    b = tvec.vecchia_linv(g64, natural.double())
    c = tvec.vecchia_linv(g, natural.double())
    assert a.dtype == c.dtype == torch.float32 and b.dtype == torch.float64
    assert tvec.vecchia_linv.launches == before
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-4)
    assert torch.equal(c, b.float())
