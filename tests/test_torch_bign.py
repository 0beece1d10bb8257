"""The port's large-n script (nngp_tpu_torch/experiments/bigN.py) against
nngp_tpu on the CPU, at n = 2,000: its data are the JAX script's draws, its
middle-out ``initialize`` is bit-identical to nngp_tpu's (neighbours,
colours, level schedule, chain states), its D = 8 halo plan has JAX's owned
rows, need rows and overlap, and its ``main`` runs to its JSON line."""

import json

import numpy as np
import pytest
import torch

import nngp_tpu
from nngp_tpu.parallel.halo import build_halo_plan as jax_halo_plan
from nngp_tpu_torch.experiments import bigN
from nngp_tpu_torch.parallel.halo import build_halo_plan, plan_overlap
from test_torch_preprocess import assert_same_setup

torch.set_num_threads(1)

N = 2000
# experiments/bigN.py's record keys
JAX_KEYS = {"backend", "n", "chains", "schedule", "setup_s", "compile_s",
            "ms_per_iter", "it_per_s"}


@pytest.fixture(scope="module")
def fits():
    locs, y = bigN.problem(N)
    ref = nngp_tpu.initialize(
        locs, y, m=5, reordering="middleout",
        stationary_covfun="exponential_isotropic", n_chains=3, seed=1)
    return bigN.fit(locs, y, 3, "cpu"), ref


def test_problem_is_the_scripts():
    """The draws of experiments/bigN.py's main (restated verbatim)."""
    rng = np.random.default_rng(0)
    n = N
    locs = rng.uniform(0, 1000.0, size=(n, 2))
    w = np.sin(locs[:, 0] / 40.0) * np.cos(locs[:, 1] / 55.0)
    y = 1.0 + w + rng.normal(size=n) * 0.6
    got = bigN.problem(N)
    np.testing.assert_array_equal(got[0], locs)
    np.testing.assert_array_equal(got[1], y)


def test_middleout_initialize_bit_identical(fits):
    mc, ref = fits
    assert_same_setup(mc, ref)
    assert mc.graph.n == N


def test_halo_plan_matches_jax(fits):
    mc, ref = fits
    plan = build_halo_plan(mc.graph, bigN.HALO_RANKS)
    jplan = jax_halo_plan(ref.graph, bigN.HALO_RANKS)
    np.testing.assert_array_equal(plan.owner, np.asarray(jplan.owner))
    for name in ("owned_rows", "need_rows"):
        np.testing.assert_array_equal(np.asarray(getattr(plan, name)),
                                      np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    need = np.asarray(jplan.need_rows)
    assert plan_overlap(plan) == float((need < N).sum() / N) - 1.0
    entry = bigN.halo_plan_entry(mc.graph)
    assert entry["need_rows_per_device"] == int((need < N).sum(1).max())
    assert entry["halo_overlap_fraction"] == round(plan_overlap(plan), 4)
    assert sum(entry["owned_rows_per_device"]) == N


def test_graph_bytes_counts_every_tensor(fits):
    g = fits[0].graph
    want = sum(t.numel() * t.element_size() for t in (
        g.kernel_coords, g.nn_dist2, g.NNarray, g.nn_mask, g.pair_edge_id,
        g.pair_a, g.pair_b, g.nbr_sites, g.nbr_edge, g.nbr_mask, g.color_ptr,
        g.color_sites, g.plan_sites, g.plan_ptr, g.plan_nbr, g.plan_edge,
        *g.level_segs, g.locs_match, g.hctam_scol_1, g.obs_per_loc,
        g.nn_sum.src, g.nn_sum.pos, g.pair_sum.src, g.pair_sum.pos,
        g.obs_sum.src, g.obs_sum.pos))
    assert bigN.graph_bytes(g) == want


def test_main_runs_on_cpu(tmp_path):
    out = tmp_path / "bigN.jsonl"
    args = ["--device", "cpu", "--n", str(N), "--iters", "2", "--out",
            str(out)]
    e = bigN.main(args + ["--halo-plan"])
    bigN.main(args)
    lines = [json.loads(l) for l in out.read_text().splitlines()]
    assert len(lines) == 2 and lines[0] == json.loads(json.dumps(e))
    assert JAX_KEYS <= set(e)
    assert e["backend"] == "cpu" and e["n"] == N and e["chains"] == 3
    assert e["iterations"] == 3 * 2 and e["k1_launches"] == 0  # CPU: no card
    assert e["max_memory_allocated"] is None
    assert e["level_rows"] > 0 and e["colours"] > 0
    assert e["graph_device_bytes"] > e["nbr_tables_bytes"] > 0
    assert set(e["setup_timings"]) >= {"ordering_s", "nn_search_s",
                                       "prior_fields_s"}
    assert e["halo_plan"]["D"] == 8 and "halo_plan" not in lines[1]


def test_default_out_in_the_ports_out_dir():
    from nngp_tpu_torch.experiments import _common

    assert bigN.parse_args([]).out.startswith(_common.OUT_DIR)
    assert bigN.parse_args([]).n == 500_000


def test_card_asked_for_without_one_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        bigN.main(["--n", "100", "--out", str(tmp_path / "x.jsonl")])
    assert not (tmp_path / "x.jsonl").exists()
