"""Two ranks on the CPU: the port's sharded run across processes, the
counterpart of tests/test_distributed.py.

A 400-site fit of 4 chains is saved, and two launches of 2 gloo ranks each
(``launch_local``: local processes that import only torch, rendezvous
through a file) resume it with ``python -m nngp_tpu_torch.parallel.resume``,
2 chains a rank.  Meanwhile this process runs ``nngp_tpu`` on the same
problem.  Checked:

- both ranks hold the same 4-chain fit, R-hat and early-stop decision;
- a second launch gives the same chains; every rank's chains are those of
  ``run()`` without a mesh, over the first 5 iterations within
  tests/test_parallel.py::test_sharded_cycle_matches_vmap's tolerances
  (each chain draws from its own key, as nngp_tpu's do); rank 0's chains
  are those of an unsharded run of a fit holding only them, and the first
  2 chains of a 4-chain ``run()`` those of a 2-chain one;
- the fit rank 0 saved loads and resumes without a mesh (and on a one-rank
  mesh, the same bits), and ``nngp_tpu.load`` reads it;
- the pooled posterior means agree with ``nngp_tpu``'s 4-chain run within
  4 times their combined Monte Carlo error.
"""

import json
from concurrent.futures import ThreadPoolExecutor
from dataclasses import fields, replace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import nngp_tpu
import nngp_tpu_torch
from nngp_tpu_torch.diagnostics.ess import effective_size
from nngp_tpu_torch.parallel import chains_mesh, initialize_distributed
from nngp_tpu_torch.parallel.distributed import launch_local
from nngp_tpu_torch.parallel.resume import fit_digest

torch.set_num_threads(1)
ITERATIONS, CYCLES = 150, 2
GRB_STOP = (1.1, 1.1)          # run's default
FIT = dict(m=5, n_chains=4, seed=3, stationary_covfun="exponential_isotropic")


def _toy(n=400, seed=0):
    """__graft_entry__'s toy at 400 sites: an exponential field (scale 2,
    range 1) on [0, 8]^2 plus noise of variance 0.25."""
    rng = np.random.default_rng(seed)
    locs = rng.uniform(size=(n, 2)) * 8.0
    d = np.sqrt(((locs[:, None] - locs[None]) ** 2).sum(-1))
    w = np.linalg.cholesky(2.0 * np.exp(-d) + 1e-8 * np.eye(n)) @ rng.normal(
        size=n)
    return locs, 0.5 + w + rng.normal(size=n) * 0.5


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("two_ranks")
    locs, y = _toy()
    fit = str(d / "fit.pkl")
    nngp_tpu_torch.save(nngp_tpu_torch.initialize(
        locs, y, device="cpu", verbose=False, **FIT), fit)
    saved = [str(d / f"launch{i}.pkl") for i in range(2)]
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(
            launch_local, ["-m", "nngp_tpu_torch.parallel.resume", fit,
                           "--device", "cpu", "--iterations", str(ITERATIONS),
                           "--cycles", str(CYCLES), "--save", out],
            2, 240, {"OMP_NUM_THREADS": "1"}) for out in saved]
        ref = nngp_tpu.run(
            nngp_tpu.initialize(locs, y, **FIT),
            n_iterations_update=ITERATIONS * CYCLES, verbose=False,
            Gelman_Rubin_Brooks_stop=(0.0, 0.0))
        launches = [[json.loads(o.strip().splitlines()[-1])
                     for o in f.result()] for f in futures]
    return {"fit": fit, "saved": saved, "launches": launches, "ref": ref}


def test_ranks_hold_the_same_fit(two_ranks):
    for ranks in two_ranks["launches"]:
        r0, r1 = ranks
        assert (r0["rank"], r0["world"], r0["chains"]) == (0, 2, [0, 2])
        assert (r1["rank"], r1["world"], r1["chains"]) == (1, 2, [2, 4])
        for k in ("digest", "r_hat", "iterations", "n_diagnostics"):
            assert r0[k] == r1[k], k
        assert np.isfinite(r0["r_hat"]).all()


def test_early_stop_follows_the_r_hats(two_ranks):
    """Both ranks stop after the first cycle whose R-hat meets run's rule,
    the same cycle."""
    mc = nngp_tpu_torch.load(two_ranks["saved"][0], device="cpu")
    grbs = [g["R_hat"] for g in mc.diagnostics["Gelman_Rubin_Brooks"]]
    stop = next((i + 1 for i, r in enumerate(grbs)
                 if r[0] < GRB_STOP[0] or np.all(r[1:] < GRB_STOP[1])),
                CYCLES)
    assert len(grbs) == stop
    for r in two_ranks["launches"][0]:
        assert r["iterations"] == mc.iterations == ITERATIONS * stop


def test_second_launch_gives_the_same_chains(two_ranks):
    first, second = two_ranks["launches"]
    assert first[0]["digest"] == second[0]["digest"]
    a, b = (nngp_tpu_torch.load(p, device="cpu") for p in two_ranks["saved"])
    assert fit_digest(a) == fit_digest(b) == first[0]["digest"]


def _first_chains(mc, k):
    """The fit holding only chains [0, k) of ``mc``."""
    st = mc.states
    return replace(mc, n_chains=k, records=mc.records[:k], states=replace(
        st, **{f.name: getattr(st, f.name)[:k] for f in fields(st)
               if getattr(st, f.name) is not None}))


def test_rank0_chains_are_an_unsharded_run_of_them(two_ranks):
    """Rank 0's chains 0 and 1 draw from their own keys, as a 2-chain
    ``run()`` of a fit holding only them does, in a batch of the same
    size: the same chains, bit for bit, over the whole run."""
    mesh_fit = nngp_tpu_torch.load(two_ranks["saved"][0], device="cpu")
    alone = nngp_tpu_torch.run(
        _first_chains(nngp_tpu_torch.load(two_ranks["fit"], device="cpu"), 2),
        n_iterations_update=ITERATIONS,
        n_cycles=mesh_fit.iterations // ITERATIONS, verbose=False,
        Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    assert fit_digest(alone) == fit_digest(_first_chains(mesh_fit, 2))


FIRST = 5   # iterations, test_sharded_cycle_matches_vmap's cycle


@pytest.fixture(scope="module")
def first_iterations(two_ranks):
    """``run()`` without a mesh for FIRST iterations of the saved 4-chain
    fit, and of a fit holding only its first 2 chains."""
    kw = dict(n_iterations_update=FIRST, verbose=False,
              Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    fit = lambda: nngp_tpu_torch.load(two_ranks["fit"], device="cpu")  # noqa: E731
    return (nngp_tpu_torch.run(fit(), **kw),
            nngp_tpu_torch.run(_first_chains(fit(), 2), **kw))


def _held_to_run(got, want, k):
    """Chains [0, k) of records ``got`` against ``want`` over the first
    FIRST iterations: test_sharded_cycle_matches_vmap's rtol 1e-5 on
    log_scale and rtol = atol = 1e-4 on the field; returns whether every
    record was bit for bit equal."""
    exact = True
    for c in range(k):
        a, b = got[c], want[c]
        np.testing.assert_allclose(a["log_scale"][:FIRST],
                                   b["log_scale"][:FIRST], rtol=1e-5)
        np.testing.assert_allclose(a["field"][:FIRST], b["field"][:FIRST],
                                   rtol=1e-4, atol=1e-4)
        for key in ("beta_0", "log_scale", "log_noise_variance", "shape",
                    "field"):
            exact &= np.array_equal(a[key][:FIRST], b[key][:FIRST])
    return exact


def test_every_rank_gives_run_chains(two_ranks, first_iterations):
    """Both ranks' chains of the 2-rank mesh are ``run()``'s chains 0-3
    (nngp_tpu's test_sharded_cycle_matches_vmap for the port)."""
    mesh_fit = nngp_tpu_torch.load(two_ranks["saved"][0], device="cpu")
    plain, _ = first_iterations
    assert plain.iterations == FIRST
    assert _held_to_run(mesh_fit.records, plain.records, 4)


def test_first_chains_do_not_depend_on_the_chain_count(first_iterations):
    """The first 2 chains of a 4-chain ``run()`` are a 2-chain ``run()``
    of them (nngp_tpu's fold_in(ck, i) keys)."""
    four, two = first_iterations
    assert _held_to_run(four.records, two.records, 2)
    assert fit_digest(_first_chains(four, 2)) == fit_digest(two)


def test_saved_fit_resumes_without_a_mesh(two_ranks, tmp_path):
    path = two_ranks["saved"][0]
    kw = dict(n_iterations_update=10, verbose=False,
              Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    start = nngp_tpu_torch.load(path, device="cpu").iterations
    plain = nngp_tpu_torch.run(nngp_tpu_torch.load(path, device="cpu"), **kw)
    assert plain.iterations == start + 10
    assert torch.isfinite(plain.states.field).all()
    assert initialize_distributed(f"file://{tmp_path / 'rdzv'}", 1, 0,
                                  device_type="cpu")
    try:
        meshed = nngp_tpu_torch.run(nngp_tpu_torch.load(path, device="cpu"),
                                    mesh=chains_mesh(), **kw)
    finally:
        dist.destroy_process_group()
    assert fit_digest(meshed) == fit_digest(plain)
    ref = nngp_tpu.load(path)
    assert (ref.n_chains, ref.iterations) == (4, start)


def _mc_error(records, key, burn_in=0.5):
    """Monte Carlo error of the pooled posterior mean: pooled sd over the
    square root of the ESS summed over chains."""
    T = records[0][key].shape[0]
    lo = max(int(np.floor(burn_in * T)) - 1, 0)
    series = [np.asarray(r[key]).reshape(T, -1)[lo:, 0] for r in records]
    ess = sum(effective_size(s) for s in series)
    return float(np.std(np.concatenate(series), ddof=1) / np.sqrt(ess))


def _means(est):
    out = {}
    for block in (est["covariance_params"]["sampled_covparams"],
                  est["fixed_effects"]):
        out.update(zip(block["names"], block["table"][:, 0]))
    return out


def test_posterior_means_match_nngp_tpu(two_ranks):
    port = nngp_tpu_torch.load(two_ranks["saved"][0], device="cpu")
    ref = two_ranks["ref"]
    got = _means(nngp_tpu_torch.estimate(port))
    want = _means(nngp_tpu.estimate(ref))
    for key, name in (("beta_0", "beta_0"), ("log_scale", "log_scale"),
                      ("log_noise_variance", "log_noise_variance"),
                      ("shape", "log_range")):
        se = np.hypot(_mc_error(port.records, key),
                      _mc_error(ref.records, key))
        assert abs(got[name] - want[name]) <= 4 * se, (
            name, got[name], want[name], se)
