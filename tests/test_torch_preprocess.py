"""The port's host preprocessing against nngp_tpu's: the NumPy code is the
same, so for the same inputs and seed the graph tables and the initial chain
states must be bit-identical."""

import numpy as np
import pytest
import torch

import nngp_tpu
import nngp_tpu_torch
from nngp_tpu_torch.interop import graph_from_numpy

torch.set_num_threads(1)


def _problem(family, seed=0, n=320):
    rng = np.random.default_rng(seed)
    if "sphere" in family:
        locs = np.stack([rng.uniform(-100, -80, n), rng.uniform(30, 45, n)], 1)
    else:
        locs = rng.uniform(size=(n, 2))
    # a few repeated sites, so dedupe and the observation maps are exercised
    locs = np.concatenate([locs, locs[:20]])
    y = rng.normal(size=len(locs))
    X = {"a": rng.normal(size=len(locs)), "b": rng.normal(size=len(locs))}
    return locs, y, X


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


FAMILIES = ["exponential_isotropic", "exponential_sphere", "matern_isotropic",
            "matern_sphere", "exponential_scaledim", "exponential_spacetime"]
# every ordering reorder_locations offers, in the plane and on the sphere
# (the families above use the default, maxmin)
ORDERINGS = [("exponential_isotropic", "middleout"),
             ("exponential_sphere", "middleout"),
             ("exponential_isotropic", "random"),
             ("exponential_isotropic", ("coord", 2)),
             ("exponential_isotropic", ("dist_to_point", [0.3, 0.6])),
             ("exponential_sphere", ("dist_to_point", [-90.0, 40.0]))]


def _id(r):
    return r if isinstance(r, str) else r[0] + (str(r[1]) if r[0] == "coord"
                                                else "")


@pytest.mark.parametrize("family,reordering", [
    pytest.param(f, "maxmin", id=f) for f in FAMILIES] + [
    pytest.param(f, r, id=f"{f}-{_id(r)}") for f, r in ORDERINGS])
def test_initialize_bit_identical(family, reordering):
    locs, y, X = _problem(family)
    kw = dict(X_locs=X, m=5, n_chains=2, seed=7, stationary_covfun=family,
              reordering=reordering)
    ref = nngp_tpu.initialize(locs, y, **kw)
    mc = nngp_tpu_torch.initialize(locs, y, device="cpu", verbose=False,
                                   **kw)
    assert_same_setup(mc, ref)


def assert_same_setup(mc, ref):
    """The port's fit ``mc`` and nngp_tpu's ``ref`` from one initialize
    call: graph tables, model data and chain states bit for bit."""
    g, rg = mc.graph, ref.graph
    for name in ("NNarray", "nn_mask", "nn_dist2", "kernel_coords",
                 "pair_edge_id", "nbr_sites", "nbr_edge", "nbr_mask",
                 "locs_match", "hctam_scol_1", "obs_per_loc"):
        np.testing.assert_array_equal(_np(getattr(g, name)),
                                      np.asarray(getattr(rg, name)), err_msg=name)
    np.testing.assert_array_equal(_np(g.pair_a), np.asarray(rg.pair_a))
    np.testing.assert_array_equal(_np(g.pair_b), np.asarray(rg.pair_b))
    assert g.n_edges == rg.n_edges and g.d_floor == rg.d_floor
    assert len(g.level_segs) == len(rg.level_segs)
    for a, b in zip(g.level_segs, rg.level_segs):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # colours: the port's colour-major CSR is nngp_tpu's padded colour table
    # with the padding dropped
    colors_idx = np.asarray(rg.colors_idx)
    ptr, sites = _np(g.color_ptr), _np(g.color_sites)
    assert len(ptr) - 1 == colors_idx.shape[0]
    for c, row in enumerate(colors_idx):
        np.testing.assert_array_equal(sites[ptr[c]:ptr[c + 1]], row[row < g.n])
    np.testing.assert_array_equal(mc.NNarray, ref.NNarray)
    np.testing.assert_array_equal(mc.locs, ref.locs)
    # interop rebuilds the same graph from nngp_tpu's
    g2 = graph_from_numpy(rg)
    np.testing.assert_array_equal(g2.color_ptr, ptr)
    np.testing.assert_array_equal(g2.color_sites, sites)

    for name in ("y", "X", "X_locs_u", "solve_1XT1X",
                 "chol_solve_1XT1X_lower", "var_y", "range_cap", "range_floor"):
        np.testing.assert_array_equal(_np(getattr(mc.data, name)),
                                      np.asarray(getattr(ref.data, name)),
                                      err_msg=name)
    for name in ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
                 "field", "tk_ancillary", "tk_sufficient", "prop_mean",
                 "prop_m2", "prop_count"):
        np.testing.assert_array_equal(_np(getattr(mc.states, name)),
                                      np.asarray(getattr(ref.states, name)),
                                      err_msg=name)
    assert mc.records[0].keys() == ref.records[0].keys()


def test_isotropic_proposal_switch():
    locs, y, _ = _problem("exponential_isotropic", n=120)
    mc = nngp_tpu_torch.initialize(locs, y, m=4, n_chains=2, seed=1,
                                   adaptive_proposal=False, device="cpu",
                                   verbose=False)
    assert mc.states.prop_mean is None and mc.states.prop_m2 is None
    mc = nngp_tpu_torch.run(mc, n_iterations_update=5, verbose=False)
    assert mc.states.prop_mean is None
    assert np.isfinite(mc.states.field.numpy()).all()
