"""Halo mode end to end: ``run(mc, mesh=...)`` over a ``("chains", "sites")``
mesh of gloo ranks on the CPU, the counterpart of tests/test_halo_run.py.

One ``launch_local`` of 4 local processes runs every multi-rank case (each
rank saves its fits and writes a file; the tests compare):

- 1 x 1 meshes (rank 0: with covariates, rank 1: without) give ``run()``'s
  states and records bit for bit;
- 1 x 2 meshes (ranks 0-1 with covariates, 2-3 without), 2 x 2 meshes
  (all four, both problems) and 2-rank chains meshes match ``run()``:
  each chain draws from its own key, whatever block or rank holds it,
  within tests/test_halo_run.py's 5e-3 on the records and 2e-2 on the
  last field snapshot; the sites ranks of a run hold the same fit;
- the 2 x 2 fit with covariates resumes to 50 iterations;
- ``python -m nngp_tpu_torch.parallel.resume FIT --sites 2`` on the four
  ranks (a 2 x 2 mesh) reports its sites, its sweep-kernel launches and
  its exchanges.

In this process: ``field_record_columns`` raises in halo mode, and
``dryrun_multichip(4)`` runs its chains and halo parts over gloo.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import nngp_tpu_torch
from nngp_tpu_torch.parallel import halo_mesh, initialize_distributed
from nngp_tpu_torch.parallel.distributed import launch_local

torch.set_num_threads(1)
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
STATE_FIELDS = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
                "field", "tk_ancillary", "tk_sufficient", "prop_mean",
                "prop_m2", "prop_count")
RECORD_KEYS = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
               "field", "saved_field")


def _problem(rng, n=260, n_obs=300):
    """tests/test_halo_run.py's problem: duplicated observation sites, a
    location covariate and an observation one."""
    locs = rng.uniform(0, 40, size=(n, 2))
    idx = rng.integers(0, n, size=n_obs)
    w = np.sin(locs[:, 0] / 6.0) + rng.normal(size=n) * 0.3
    X = {"slope": locs[idx, 0] * 0.02, "noise": rng.normal(size=n_obs)}
    y = (1.5 + w[idx] + X["slope"] * 0.5 - X["noise"]
         + rng.normal(size=n_obs) * 0.7)
    return locs[idx], y, X


PROBLEMS = {
    # tests/test_halo_run.py's two tests: (initialize kwargs, run kwargs)
    "cov": (dict(m=5, n_chains=2, seed=11,
                 stationary_covfun="exponential_isotropic"),
            dict(n_iterations_update=25, field_thinning=0.5)),
    "nocov": (dict(m=4, n_chains=2, seed=3), dict(n_iterations_update=20)),
}


def _fits(tmp):
    """Both problems' initial fits, saved: {name: path}."""
    out = {}
    for name, (kw, _) in PROBLEMS.items():
        locs, y, X = _problem(np.random.default_rng(12345),
                              *((260, 300) if name == "cov" else (180, 200)))
        mc = nngp_tpu_torch.initialize(
            locs, y, X_locs=X if name == "cov" else None, device="cpu",
            verbose=False, **kw)
        out[name] = str(tmp / f"{name}.pkl")
        nngp_tpu_torch.save(mc, out[name])
    return out


RANK = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
import nngp_tpu_torch
from nngp_tpu_torch.parallel import initialize_distributed
from nngp_tpu_torch.parallel.resume import fit_digest, main as resume
torch.set_num_threads(1)
tmp, runs = sys.argv[1], json.loads(sys.argv[2])
assert initialize_distributed(device_type="cpu")
r = dist.get_rank()

def sub(shape):
    names = ("rep", "chains", "sites")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)["chains",
                                                                "sites"]

def go(case, name, mesh, mc=None):
    # one cycle of the saved fit `name`, or of `mc`
    if mc is None:
        mc = nngp_tpu_torch.load(f"{tmp}/{name}.pkl", device="cpu")
    mc = nngp_tpu_torch.run(mc, mesh=mesh, **runs[name], verbose=False,
                            Gelman_Rubin_Brooks_stop=(0., 0.),
                            save_name=f"{tmp}/{case}-{name}-{r}.pkl")
    out[case if case in ("1x1", "1x2", "resume") else f"{case}-{name}"] = {
        "digest": fit_digest(mc), "iterations": mc.iterations}
    return mc

out = {}
one = sub((4, 1, 1))                       # four 1 x 1 meshes
if r < 2:
    go("1x1", ("cov", "nocov")[r], one)
pair = sub((2, 1, 2))                      # two 1 x 2 meshes
go("1x2", ("cov", "nocov")[r // 2], pair)
four = init_device_mesh("cpu", (2, 2), mesh_dim_names=("chains", "sites"))
for name in ("nocov", "cov"):
    # the same chains without sites: a 2-rank chains mesh
    go("chains2", name, four["chains"])
    mc = go("2x2", name, four)
go("resume", "cov", four, mc=mc)             # the 2 x 2 fit's second cycle
with open(f"{tmp}/rank{r}.json", "w") as f:
    json.dump(out, f)
resume([f"{tmp}/cov.pkl", "--device", "cpu", "--sites", "2",
        "--iterations", "5"])
"""


@pytest.fixture(scope="module")
def halo_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("halo_run")
    fits = _fits(tmp)
    runs = {k: v[1] for k, v in PROBLEMS.items()}
    lines = launch_local(["-c", RANK, str(tmp), json.dumps(runs)], 4,
                         timeout=400, env=ONE_THREAD)
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    kw = dict(verbose=False, Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    plain = {name: nngp_tpu_torch.run(
        nngp_tpu_torch.load(fits[name], device="cpu"), **runs[name], **kw)
        for name in fits}
    return {"tmp": tmp, "ranks": ranks, "plain": plain,
            "resume": [json.loads(t.strip().splitlines()[-1])
                       for t in lines]}


def _load(halo_runs, case, name):
    """The fit the writing rank of a run saved (the rank of chain 0 and
    sites part 0; two such ranks for the two 2-rank chains meshes)."""
    path = min(halo_runs["tmp"].glob(f"{case}-{name}-*.pkl"))
    return nngp_tpu_torch.load(str(path), device="cpu")


def _close(a, b):
    """tests/test_halo_run.py's comparison."""
    for key in ("beta_0", "log_scale", "log_noise_variance"):
        np.testing.assert_allclose(a.records[0][key], b.records[0][key],
                                   rtol=0, atol=5e-3, err_msg=key)
    np.testing.assert_allclose(a.records[1]["shape"], b.records[1]["shape"],
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(a.records[0]["field"][-1],
                               b.records[0]["field"][-1], rtol=0, atol=2e-2)


@pytest.mark.parametrize("name", ["cov", "nocov"])
def test_one_by_one_mesh_equals_run(halo_runs, name):
    a, b = _load(halo_runs, "1x1", name), halo_runs["plain"][name]
    assert a.iterations == b.iterations
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a.states, f), getattr(b.states, f)), f
    for ra, rb in zip(a.records, b.records):
        for k in RECORD_KEYS:
            if ra[k] is not None:
                np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)


@pytest.mark.parametrize("case", ["1x2-cov", "1x2-nocov", "2x2-cov",
                                  "2x2-nocov", "chains2-cov",
                                  "chains2-nocov"])
def test_sharded_sites_match_the_same_streams(halo_runs, case):
    """Every mesh against ``run()``: the draws are keyed per chain, so a
    chains block draws its chains' numbers of the unsharded run."""
    mesh, name = case.split("-")
    a = _load(halo_runs, mesh, name)
    b = halo_runs["plain"][name]
    assert a.iterations == b.iterations == PROBLEMS[name][1][
        "n_iterations_update"]
    _close(a, b)


def test_sites_ranks_hold_the_same_fit(halo_runs):
    r0, r1, r2, r3 = halo_runs["ranks"]
    assert r0["1x2"] == r1["1x2"] and r2["1x2"] == r3["1x2"]
    for k in ("2x2-cov", "2x2-nocov", "chains2-cov", "resume"):
        assert r0[k] == r1[k] == r2[k] == r3[k], k


def test_resume_in_halo_mode_reaches_50(halo_runs):
    assert halo_runs["ranks"][0]["resume"]["iterations"] == 50
    assert _load(halo_runs, "resume", "cov").iterations == 50


def test_resume_cli_with_sites(halo_runs):
    lines = halo_runs["resume"]
    assert [(o["rank"], o["sites"], o["chains"]) for o in lines] == [
        (0, 2, [0, 1]), (1, 2, [0, 1]), (2, 2, [1, 2]), (3, 2, [1, 2])]
    assert len({o["digest"] for o in lines}) == 1
    for o in lines:
        assert o["iterations"] == 5
        assert o["sweep_launches"] == 0          # the plain version on the CPU
        assert o["exchanges_per_iteration"] > 0 and o["overlap"] > 0


def test_field_record_columns_raise_in_halo_mode(tmp_path):
    fits = _fits(tmp_path)
    mc = nngp_tpu_torch.load(fits["nocov"], device="cpu")
    assert initialize_distributed(f"file://{tmp_path / 'rdzv'}", 1, 0,
                                  device_type="cpu")
    try:
        with pytest.raises(ValueError, match="halo"):
            nngp_tpu_torch.run(mc, n_iterations_update=5, verbose=False,
                               field_record_columns=[0, 1], mesh=halo_mesh(1))
    finally:
        dist.destroy_process_group()
    assert mc.iterations == 0


def test_dryrun_multichip_four_gloo_ranks(capsys, monkeypatch):
    from nngp_tpu_torch.entry import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # the ranks inherit it
    dryrun_multichip(4, device_type="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: 4 x 2 chains (cpu" in out
    assert "dryrun_multichip halo OK: 2 x 2 (chains x sites) mesh" in out
