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
from nngp_tpu_torch.interop import from_numpy
from nngp_tpu_torch.models import gaussian as tg
from nngp_tpu_torch.ops import _build, sweep

torch.set_num_threads(1)

C = 2


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(4)
    n = 360
    locs = rng.uniform(size=(n, 2))
    mc = nngp_tpu.initialize(locs, rng.normal(size=n), m=4, n_chains=C,
                             seed=5, stationary_covfun="exponential_isotropic")
    g_t, data_t, states_t = from_numpy(mc.graph, mc.data, mc.states)
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
    # two colours on a 3-site path 0 - 1 - 2: colour 0 = {0, 2}, 1 = {1}
    nbr_sites = torch.tensor([[1, 3], [0, 2], [1, 3]], dtype=torch.int32)
    nbr_edge = torch.tensor([[0, 2], [0, 1], [1, 2]], dtype=torch.int32)
    args = dict(
        q_edges=torch.tensor([[-0.5, -0.25, 0.0]]),
        P=torch.tensor([[2.0, 3.0, 1.5]]), rs=torch.tensor([[0.1, 0.2, 0.3]]),
        noise=torch.as_tensor(rng.normal(size=(1, 2, 3)), dtype=torch.float32),
        scal=torch.tensor([[0.3, 1.2, 0.8]]),
        color_ptr=torch.tensor([0, 2, 3], dtype=torch.int32),
        color_sites=torch.tensor([0, 2, 1], dtype=torch.int32),
        nbr_sites=nbr_sites, nbr_edge=nbr_edge)
    w = torch.tensor([[1.0, -1.0, 0.5, 0.0]])
    before = sweep.chromatic_sweeps.launches
    got = sweep.chromatic_sweeps(w.clone(), **args)[0].numpy().astype(np.float64)
    assert sweep.chromatic_sweeps.launches == before
    # scalar loop oracle
    q = args["q_edges"][0].numpy().astype(np.float64)
    P, rs = args["P"][0].numpy(), args["rs"][0].numpy()
    b0, isc, ino = args["scal"][0].numpy()
    z = args["noise"][0].numpy()
    x = w[0].numpy().astype(np.float64)
    for s in range(2):
        for i in (0, 2, 1):
            prior = sum(q[e] * (x[j] - b0)
                        for j, e in zip(nbr_sites[i].tolist(),
                                        nbr_edge[i].tolist()) if j < 3)
            x[i] = b0 - (isc * prior - ino * rs[i]) / P[i] + z[s, i] / np.sqrt(P[i])
    np.testing.assert_allclose(got, x, rtol=1e-5, atol=1e-6)
