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


@pytest.mark.gpu
@pytest.mark.parametrize("zero_noise", [True, False])
def test_kernel_matches_plain(zero_noise):
    """Kernel against plain version on the same inputs; tolerance
    2e-3 * max(1, |w|_inf) (float32 neighbour sums in another order)."""
    dev = _card()
    mc = _mc(dev)
    g, st = mc.graph, mc.states
    names = mc.space_time_model["covfun"]["shape_params"]
    linv = vecchia_linv(g, shape_transform(names, st.shape))
    q, P, rs, scal = G.sweep_inputs(g, mc.data, st, linv,
                                    G._mu_obs(mc.data, st, g))
    w0 = torch.cat([st.field, st.field.new_zeros(C, 1)], 1)
    noise = torch.randn(C, 6, g.n, device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    if zero_noise:
        noise.zero_()
    tables = (g.color_ptr, g.color_sites, g.nbr_sites, g.nbr_edge)
    before = sweep.chromatic_sweeps.launches
    got = sweep.chromatic_sweeps(w0.clone(), q, P, rs, noise, scal, *tables)
    want = sweep.chromatic_sweeps_reference(w0.clone(), q, P, rs, noise, scal,
                                            *tables)
    torch.cuda.synchronize()
    assert sweep.chromatic_sweeps.launches == before + 1
    assert torch.isfinite(got).all()
    tol = 2e-3 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs():
    dev = _card()
    w = torch.zeros(1, 4, device=dev)
    ok = dict(q_edges=torch.zeros(1, 3, device=dev),
              P=torch.ones(1, 3, device=dev), rs=torch.zeros(1, 3, device=dev),
              noise=torch.zeros(1, 1, 3, device=dev),
              scal=torch.zeros(1, 3, device=dev),
              color_ptr=torch.tensor([0, 3], dtype=torch.int32, device=dev),
              color_sites=torch.arange(3, dtype=torch.int32, device=dev),
              nbr_sites=torch.full((3, 1), 3, dtype=torch.int32, device=dev),
              nbr_edge=torch.full((3, 1), 2, dtype=torch.int32, device=dev))
    sweep.chromatic_sweeps(w, **ok)
    with pytest.raises(TypeError):
        sweep.chromatic_sweeps(w, **{**ok, "nbr_sites": ok["nbr_sites"].long()})
    with pytest.raises(ValueError):
        sweep.chromatic_sweeps(w, **{**ok, "P": ok["P"].cpu()})
    with pytest.raises(ValueError):
        sweep.chromatic_sweeps(w, **{**ok, "rs": torch.zeros(1, 4, device=dev)})


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
