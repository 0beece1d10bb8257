"""The port's chain parallelism (nngp_tpu_torch/parallel, entry.py) on the
CPU, against nngp_tpu/parallel.

- ``collective_grb`` over 2 gloo ranks (local processes that import only
  torch) against ``nngp_tpu``'s ``make_collective_grb_fn`` on the 8
  virtual devices of tests/conftest.py, same samples (rtol 1e-4: JAX
  computes in float32 here), and against the host ``Gelman_Rubin_Brooks``
  (rtol 1e-10: float64 moments);
- ``local_chain_slice`` for worlds 1, 2 and 4;
- ``run(mc, mesh=...)`` on a one-rank gloo mesh equals ``run(mc)`` bit for
  bit, on a "chains" mesh and on a ("chains", "sites") mesh (halo mode);
  uneven chains and a 1-D "sites" mesh raise;
- ``entry()`` runs, and ``dryrun_multichip(2)`` runs over gloo.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import nngp_tpu_torch
from nngp_tpu.parallel.chains import chains_mesh as jax_chains_mesh
from nngp_tpu.parallel.collectives import make_collective_grb_fn as jax_grb_fn
from nngp_tpu_torch.diagnostics.grb import Gelman_Rubin_Brooks
from nngp_tpu_torch.parallel import (chains_mesh, collective_grb,
                                     initialize_distributed,
                                     local_chain_slice)
from nngp_tpu_torch.parallel.chains import gather_chains, shard_states
from nngp_tpu_torch.parallel.collectives import make_collective_grb_fn
from nngp_tpu_torch.parallel.distributed import launch_local
from nngp_tpu_torch.utils.datasets import synthetic_heavy_metals

torch.set_num_threads(1)
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
STATE_FIELDS = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
                "field", "tk_ancillary", "tk_sufficient", "prop_mean",
                "prop_m2", "prop_count")
RECORD_KEYS = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
               "field", "saved_field")


class _Mesh:
    """Stands in for rank ``rank`` of a 1-D "chains" DeviceMesh of ``size``
    ranks: what ``local_chain_slice`` reads, with no process group."""

    mesh_dim_names = ("chains",)

    def __init__(self, size, rank=0):
        self._size, self._rank = size, rank

    def size(self):
        return self._size

    def get_local_rank(self):
        return self._rank


@pytest.fixture
def mesh1(tmp_path):
    """A one-rank gloo group and its "chains" mesh."""
    assert initialize_distributed(f"file://{tmp_path / 'rdzv'}", 1, 0,
                                  device_type="cpu")
    try:
        yield chains_mesh()
    finally:
        dist.destroy_process_group()


def _fit(n_chains=2, seed=3):
    locs, y, X = synthetic_heavy_metals(n=400, p=2, seed=5)
    return nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=n_chains, seed=seed, device="cpu", verbose=False)


def _samples():
    rng = np.random.default_rng(12345)
    s = rng.normal(size=(8, 60, 3)) * 0.5
    s[:, :, 0] += rng.normal(size=(8, 1))      # between-chain spread
    return s


def _host_grb(s):
    """Gelman_Rubin_Brooks on every sample (burn-in of 1/T keeps all)."""
    records = [{"beta_0": c[:, 0], "log_scale": c[:, 1],
                "log_noise_variance": c[:, 2], "shape": np.zeros((len(c), 0))}
               for c in s]
    return Gelman_Rubin_Brooks(records, burn_in=1.0 / s.shape[1])["R_hat"]


GRB_RANK = r"""
import json, sys
import numpy as np, torch
from nngp_tpu_torch.parallel import (collective_grb, global_chains_mesh,
                                     initialize_distributed, local_chain_slice)
from nngp_tpu_torch.parallel.collectives import make_collective_grb_fn
assert initialize_distributed(device_type="cpu")
mesh = global_chains_mesh()
s = np.load(sys.argv[1])
lo, hi = local_chain_slice(s.shape[0], mesh)
x = torch.from_numpy(s[lo:hi])
print(json.dumps({"chains": [lo, hi],
                  "grb": collective_grb(x, s.shape[0]).tolist(),
                  "fn": make_collective_grb_fn(mesh, s.shape[0])(x).tolist()}))
torch.distributed.destroy_process_group()
"""


def test_collective_grb_two_ranks_matches_nngp_tpu(tmp_path):
    s = _samples()
    np.save(tmp_path / "s.npy", s)
    outs = [json.loads(o.strip().splitlines()[-1]) for o in launch_local(
        ["-c", GRB_RANK, str(tmp_path / "s.npy")], 2, timeout=120,
        env=ONE_THREAD)]
    assert [o["chains"] for o in outs] == [[0, 4], [4, 8]]
    assert outs[0]["grb"] == outs[1]["grb"] == outs[0]["fn"] == outs[1]["fn"]
    got = np.asarray(outs[0]["grb"])
    want = np.asarray(jax_grb_fn(jax_chains_mesh(jax.devices()[:8]), 8)(
        jnp.asarray(s, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, _host_grb(s), rtol=1e-10)


def test_collective_grb_one_rank_matches_host(mesh1):
    s = _samples()
    got = collective_grb(torch.from_numpy(s), 8).numpy()
    np.testing.assert_allclose(got, _host_grb(s), rtol=1e-10)
    fn = make_collective_grb_fn(mesh1, 8)
    np.testing.assert_array_equal(fn(torch.from_numpy(s)).numpy(), got)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_local_chain_slice(world):
    slices = [local_chain_slice(8, _Mesh(world, r)) for r in range(world)]
    per = 8 // world
    assert slices == [(r * per, (r + 1) * per) for r in range(world)]


def test_local_chain_slice_on_a_gloo_mesh(mesh1):
    assert (mesh1.size(), mesh1.mesh_dim_names) == (1, ("chains",))
    assert local_chain_slice(6, mesh1) == (0, 6)
    st = _fit().states
    half = shard_states(st, _Mesh(2, 1))
    assert torch.equal(half.field, st.field[1:])


def test_gather_chains_one_rank_round_trip(mesh1):
    """Every dtype and a tensor with no elements come back unchanged."""
    a = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    b = torch.zeros(3, 0)
    c = torch.linspace(0, 1, 30, dtype=torch.float64).reshape(5, 3, 2)
    got = gather_chains([(a, 0), (b, 0), (c, 1)], mesh1)
    for x, y in zip(got, (a, b, c)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_run_on_one_rank_mesh_equals_run(mesh1):
    """2 chains, 2 cycles of 5 iterations: states, records and the
    diagnostics bit for bit (rank 0 draws the unsharded stream)."""
    kw = dict(n_iterations_update=5, n_cycles=2, field_thinning=0.5,
              verbose=False, Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    a = nngp_tpu_torch.run(_fit(), mesh=mesh1, **kw)
    b = nngp_tpu_torch.run(_fit(), **kw)
    assert a.iterations == b.iterations == 10
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a.states, f), getattr(b.states, f)), f
    for ra, rb in zip(a.records, b.records):
        for k in RECORD_KEYS:
            np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)
    for ga, gb in zip(a.diagnostics["Gelman_Rubin_Brooks"],
                      b.diagnostics["Gelman_Rubin_Brooks"]):
        np.testing.assert_array_equal(ga["R_hat"], gb["R_hat"])


def test_uneven_chains_raise():
    mc = _fit(n_chains=3)
    with pytest.raises(ValueError, match="must be divisible by the chains"):
        nngp_tpu_torch.run(mc, n_iterations_update=5, mesh=_Mesh(2),
                           verbose=False)
    assert mc.iterations == 0


def test_sites_mesh_runs(mesh1):
    """A ("chains", "sites") mesh runs halo mode (tests/test_torch_halo*.py
    hold it against nngp_tpu): on one rank, run()'s chains bit for bit; a
    1-D "sites" mesh is refused."""
    from torch.distributed.device_mesh import init_device_mesh

    from nngp_tpu_torch.parallel import halo_mesh

    kw = dict(n_iterations_update=5, verbose=False)
    a = nngp_tpu_torch.run(_fit(), mesh=halo_mesh(1), **kw)
    b = nngp_tpu_torch.run(_fit(), **kw)
    assert a.iterations == b.iterations == 5
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a.states, f), getattr(b.states, f)), f
    sites = init_device_mesh("cpu", (1,), mesh_dim_names=("sites",))
    with pytest.raises(ValueError, match="mesh"):
        nngp_tpu_torch.run(_fit(), mesh=sites, **kw)


def test_entry_runs_on_cpu():
    from nngp_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    states, recs = fn(*args)
    assert states.field.shape == (2, 96)
    assert recs["log_scale"].shape == (2, 2)
    assert torch.isfinite(recs["log_scale"]).all()


def test_dryrun_multichip_two_gloo_ranks(capsys, monkeypatch):
    from nngp_tpu_torch.entry import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # the ranks inherit it
    dryrun_multichip(2, device_type="cpu")
    assert "dryrun_multichip OK: 2 x 2 chains (cpu" in capsys.readouterr().out
