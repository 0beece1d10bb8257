#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nngp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its result and time; any failure ends the run
with a nonzero exit and no "ok" line:

  1. device       the card's name and power limit (nvidia-smi)
  2. build        nvcc builds the six CUDA sources of csrc/ (factor_rows.cu
                  as its three parts and level_solve.cu at the main path's
                  m = 5; other m are built on first use), one nvcc each,
                  all at once
  3. small parity 3 Gibbs iterations of a 400-site problem on the card
                  against the same iterations on the CPU (whose path the
                  tests hold against nngp_tpu), same injected draws
  4. initialize   the Heavy-metals configuration at full width: 64,274
                  synthetic lon/lat sites, 14 location covariates,
                  exponential_sphere, m = 5, 3 chains, seed 1
  5. kernel       the sweep kernel against its plain PyTorch version on
                  that graph at 3 and 96 chains (the states tiled), 10
                  sweeps, zero and injected noise, tolerance 2e-3 *
                  max(1, |w|_inf), repeat calls bit for bit; median times
                  of the kernel, of the Q layout gather that feeds it, of
                  its grid barriers alone and (3 chains) of the plain
                  version, beside the byte bound
                  (nngp_tpu_torch/experiments/sweep_bench.py)
  6. draws        the chain_draws kernel (csrc/chain_draws.cu) at the main
                  path's layout, 3 and 96 chains: every field bit for bit
                  with its plain twin run on the card and with a repeat
                  call; against the twin on the CPU the Philox words and
                  the uniforms bit for bit, at most 1e-6 of the normals
                  differing and each by at most one float32 ulp (the
                  card's float64 libm against the CPU's); the same
                  bit-for-bit checks at two ragged layouts (the sweep
                  normals at 20,001 sites, every field at 5 numbers a
                  chain; 97 chains); sincos against cos and sin alone at
                  all 2^32 angles; the float64 and all instructions of one
                  Philox call of normals counted in the SASS of the
                  kernel each launch runs (cuobjdump; the listing to
                  nngp_tpu_torch/_build/);
                  the kernel's device time back to back and median times
                  around the wrapper, of the twin and of torch.randn +
                  torch.rand of the same shapes
                  (experiments/draws_bench.py), beside the bound: bytes
                  written, or the SASS-counted float64 instructions at
                  132 SMs x 64 a clock at the card's highest SM clock
  7. level solve  the level solve kernel (csrc/level_solve.cu) on that
                  graph at 3 and 96 chains (the states tiled, standard
                  normal right-hand sides): within SOLVE_F64_TOL * max(1,
                  |x|_inf) of its plain twin run in float64 on the card,
                  bit for bit with the twin in float32 (which has the
                  kernel's arithmetic on a card) and between two calls,
                  one launch a call; median times of the kernel and of
                  the twin, its
                  device time back to back, beside the byte bound and the
                  floor of its steps (the kernel on a path graph of as
                  many one-site steps; experiments/sweep_bench.py)
  8. gather probes the four kernels of the gather microbenchmarks
                  (nngp_tpu_torch/experiments: X1 gather_bench, X2
                  gather_probe, X3 gather_probe2) at the scripts' full
                  shapes, each against its plain PyTorch twin: the DSMEM
                  sweep within 1e-5 * max(1, |w|_inf) at every cluster
                  size and its repeat calls bit for bit, its plan's build
                  time and its barriers alone (X1's floor), the launch
                  floor of the others, gathers/roll/transpose/scatter
                  exactly, the matmul
                  within 1e-5 * max(1, |C|_inf) at the probe's shape and at
                  shapes that cross every tile edge, its repeat calls bit
                  for bit; the matmul and cuBLAS FP32 timed at 2048 x 512 x
                  2048; each kernel's byte or operation bound and the time
                  of the PyTorch calls computing its function
                  (torch.gather/roll per stage, Tensor.scatter_, cuBLAS
                  FP32); then the three entry points, with each kernel's
                  launch count from that run
  9. main path    run (1 cycle x 25 iterations, field thinning 0.5) and
                  estimate, with the kernel's launch count from that run
                  only; then 25 more iterations to time a warm cycle
 10. predict      predict_field at 2,000 new sites in the data's lon/lat
                  box (m = 10) and predict_fixed_effects on 14 covariate
                  columns, finite and of the right shapes; then the
                  conditional draws card against CPU on a 400-site fit,
                  same retained samples and normals, tolerance 1e-3 *
                  max(1, |w|_inf)
 11. save/load    save the fit, load it on the card (states and records bit
                  for bit) and resume it for 25 iterations
 12. examples     the six scripts of nngp_tpu_torch/examples/ through their
                  main() on the card: heavy_metals at full width (3 chains,
                  1 cycle x 25 iterations, saved), heavy_metals_analysis on
                  that fit (predict_field on the 0.25 deg US grid, no
                  figures), heavy_metals_96 (96 chains, 1 x 10), then
                  vignette_toy, matern_fit and synthetic_families with
                  --quick; for each the sweep kernel's launches counted
                  from zero (one an iteration it ran), a finite summary,
                  seconds and ms per iteration
 13. matern       initialize with matern_sphere at full width; the factor
                  build's proposal log-det difference at the Matérn probe's
                  (range, nu) against the float64 oracle (tolerance 1e-2),
                  then run 25 iterations and estimate the smoothness
 14. factor rows  both entries of csrc/factor_rows.cu at the main path's
                  shapes (the Heavy-metals graph's states tiled to 3 and 96
                  chains, matern_sphere's at 3).  The K-input entry
                  factor_rows against its plain twin on the same K: max
                  |a - b| / (|b| + 1e-3) at most 1e-4 and the count of
                  differing elements; median ms of the kernel, the twin and
                  PyTorch's batched solvers (cholesky_ex, two
                  solve_triangular) beside the byte bound; its log-diagonal
                  error against the float64 factor of the same K at
                  factor_probe's and matern_probe's Heavy-metals states,
                  at most 1.5 x the jitted JAX script's CPU figure.  The
                  fused factor_build (the main path's) against
                  vecchia_linv_reference: max relative row difference at
                  most 1e-4 (Matérn's rows built in float64 by both), the
                  count of differing elements, median ms of the kernel,
                  the twin and the yardstick (correlation_from_sqdist,
                  then the batched solvers; Matérn in float64) beside the
                  bound (bytes; Matérn's float64 operations counted from
                  this run's data, at the float64 rate); its log-diagonal
                  against the float64 factor of float64 correlations at
                  the same two states, at most 1.5 x the JAX script's full
                  (total) figure; then the four Matérn families near
                  singular (300 sites, ranges at 2.5 median neighbour
                  distances, nu 0.54 and 0.98): log-determinant within
                  1e-5 of the float64 oracle, rows within 1e-4 of the twin
 15. diagnostics  the five diagnostics scripts of nngp_tpu_torch/
                  experiments by python -m, all at once, at cut sizes:
                  grb_guard, hm_mpsrf on the main path's fit, hm_crossval
                  (400 sites, 1 engine cycle of 40, 60 oracle
                  iterations), am_ab's three arms (8k sites, 2 x 10),
                  halo_overhead_table (20,000 sites, 8 ranks): records
                  finite, every sampler run launching both kernels
 16. determinism  the main path twice from seed 1 (initialize -> run, 10
                  iterations, 3 chains, full width): states and records bit
                  for bit, the count of differing elements 0
 17. entry        nngp_tpu_torch/entry.py's entry() on the card: one cycle of
                  2 iterations x 2 chains of the 96-site toy, records finite
 18. chains mesh  a one-process NCCL group: the main path's fit (3 chains,
                  K = 1) saved and loaded twice, then run for 25 iterations
                  with run(mc, mesh=...) and with run(mc): the count of
                  differing state and record elements 0; collective_grb over
                  NCCL against the host Gelman_Rubin_Brooks, rtol 1e-10
 19. two ranks    a 6-chain fit at full width saved once; then
                  python -m nngp_tpu_torch.parallel.resume on it for 25
                  iterations as 1 process (6 chains) and twice as 2 gloo
                  ranks sharing the card (3 chains each): the ranks hold the
                  same R-hat and fit digest, both 2-rank launches the same
                  digest, every rank one sweep-kernel launch an iteration;
                  ms per iteration of each; the 2 x 3 fit's records of the
                  first 5 iterations held to the 1 x 6 fit's (log_scale
                  rtol 1e-5, field rtol = atol = 1e-4, the tolerances of
                  tests/test_parallel.py::test_sharded_cycle_matches_vmap:
                  each chain draws from its own key), and the count of
                  state elements that differ after 25 iterations
 20. halo         halo mode (sites sharded, nngp_tpu_torch/parallel/halo*.py)
                  on the main path's fit: every colour step of both D = 2
                  owned sub-plans on the fit's sweep inputs, bit for bit
                  with one launch of the whole plan and within TOL_REL of
                  the plain version; a 1 x 1 ("chains", "sites") NCCL
                  mesh runs 25 iterations against run() from the same loaded
                  fit (0 differing state and record elements: halo
                  mode's solve has the level solve kernel's row
                  arithmetic on a card; one sweep kernel launch a
                  colour step, 25 x 10 x 11); two gloo sites
                  ranks sharing the card (python -m
                  nngp_tpu_torch.parallel.resume --sites 2, a 1 x 2 mesh)
                  resume it for 10 iterations: the ranks hold the same fit,
                  every state element within 1e-3 * max(1, |x|_inf) of run()'s,
                  each rank's ms per iteration, exchanges and bytes per
                  iteration and the plan's overlap; then the plan at scale
                  (host only): 100,000 sites over 8 ranks, overlap < 10 %
 21. bench        the bench's path (nngp_tpu_torch/bench.py) through its
                  functions at full width with short fixed windows: the
                  sweep kernel's parity preflight, the 96-chain leg (K = 3,
                  lean records, 100 warmup + 100 timed iterations), the
                  3-chain leg (100 + 200), the R-equivalent baseline (2
                  iterations); its JSON line checked as
                  tests/test_bench_smoke.py checks bench.py's, and ESS/s,
                  ms/iteration and the baseline's it/s printed
 22. audits       the numeric audits of nngp_tpu_torch/experiments at the
                  synthetic Heavy-metals width (ratio_audit at 8
                  proposals, factor_probe, cotransform_probe, op_probe,
                  matern_probe's two layouts): each headline figure (the
                  rms of ratio_audit's four errors, |logdet_ratio_err|,
                  |llr_impact_vs_full_oracle|, |sum_err|, each layout's
                  |proposal_logdet_diff_err|) finite and at most max(3 x
                  the JAX script's figure on the CPU on the same geometry,
                  1e-3), printed beside it; the factor's log-diagonal
                  errors against the float64 Cholesky of the same K
                  (factor_probe's two states, matern_probe's two layouts)
                  at most 1.5 x the jitted JAX script's
 23. bigN         nngp_tpu_torch/experiments/bigN.py at 150,000 uniform
                  sites (its 500,000 are cut to fit the time limit),
                  middle-out ordering, exponential_isotropic, 3
                  chains: initialize by host stage, one warm and two timed
                  cycles of 25 iterations (one sweep-kernel launch an
                  iteration), the level rows, colours, largest degree,
                  the graph's bytes on the card and the peak allocation;
                  then the sweep kernel against its plain version on that
                  plan at 3 chains (tolerance and times as in phase 5) and
                  a profile of 5 iterations under the program's spans
                  (each span's host time, the level solve's share of the
                  traced iterations, the card's idle share and its idle
                  time by span; experiments/sweep_bench.py)

Phase 3 runs for exponential_sphere and for matern_sphere.  Every run
counts the sweep kernel's and chain_draws' launches from zero and needs
exactly one of each per iteration (halo mode's sweep launches below), and
one level solve launch an ASIS pair (none in halo mode, which solves with
its own rows); halo mode needs one per colour step that has a site of the
rank; the bench phase needs one per iteration of its legs plus the
preflight's one.  Every run also counts the fused factor build from zero
and needs one launch for the cycle's factor and two an ASIS pair, and no
launch of the K-input factor rows (the main path never writes K).

The line before last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}.  Needs no network and imports no jax.
"""

import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

TOL_REL = 2e-3      # kernel against plain: 2e-3 * max(1, |w|_inf)
SWEEP_CHAINS = (3, 96)   # the sweep kernel's checks and times (states tiled)
SOLVE_CHAINS = (3, 96)   # the level solve's checks and times (states tiled)
# level solve against its twin in float64: x_i rounded once from a float64
# sum of exact products, carrying its parents' rounding (tests/
# test_torch_cuda.py's SOLVE_F64_TOL)
SOLVE_F64_TOL = 1e-5
PARITY_TOL = 1e-3   # card against CPU after 3 iterations, same scaling
# two sites ranks against run() after 10 iterations: 1e-3 * max(1, |x|_inf)
# per state field (only the cross-rank sums add in another order)
HALO_TOL = 1e-3
STATE_KEYS = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
              "field", "tk_ancillary", "tk_sufficient", "prop_mean",
              "prop_m2", "prop_count")
# X1 kernel against plain: float32 neighbour sums in another order and
# rsqrtf, through 600 dependent steps of a linear map whose field grows to
# ~6e14, so the error is held relative to |w|_inf
X1_TOL_REL = 1e-5
MM_TOL_REL = 1e-5   # matmul against plain: 1e-5 * max(1, |C|_inf)
# (M, K, N) across every edge of the matmul's 64 x 128 x 32 tiles
MM_RAGGED = ((1, 4, 4), (65, 1028, 132), (512, 1024, 128), (130, 36, 260),
             (2048, 512, 2048))
# the Matérn probe's (range, nu) and its proposal (experiments/matern_probe.py,
# matern_probe_cpu.json: 2.2e-3 at 58k real sites on the CPU)
MATERN_THETA = (0.006120802718214691, 0.75)
MATERN_THETA_P = (0.006120802718214691 * 1.02, 0.7525)
LOGDET_TOL = 1e-2   # proposal log-det difference, card against float64
# factor rows kernels against their twins: |a - b| / (|b| + 1e-3), the CPU
# test's bound against jitted nngp_tpu (tests/test_torch_factor_rows.py);
# the fused build's Matérn rows too (both in float64, rounded once)
FACTOR_TOL_REL = 1e-4
# the fused Matérn build near singular (tests/test_torch_matern.py's 300-site
# layouts, ranges at 2.5 median neighbour distances, nu 0.54 and 0.98): its
# log-determinant against the float64 oracle
NEAR_SINGULAR_LOGDET = 1e-5
# its log-diagonal error against the float64 factor of the same K: at most
# this times the jitted JAX script's figure on the CPU
FACTOR_LOGDIAG = 1.5
N_PREDICT = 2000
# two ranks against one: the iterations whose records are held to
# tests/test_parallel.py::test_sharded_cycle_matches_vmap's tolerances
FIRST_ITERS = 5
# the chain_draws kernel's checks and times: chains [0, C), and the key of
# iteration 7 of the cycle that starts at 25, seed 1
DRAW_CHAINS = (3, 96)
DRAW_KEY = (1, 25, 7)
# normals, card against the CPU twin: at most this share may differ (the
# card's float64 libm against the CPU's), each by at most one float32 ulp
DRAW_DIFF_SHARE, DRAW_ULPS = 1e-6, 1
# ragged layouts held bit for bit at 97 chains: the sweep normals at 20,001
# sites (rows off 16-byte boundaries, ragged last calls) and every field at
# 5 numbers a chain
DRAW_RAGGED_CHAINS, DRAW_RAGGED_SITES, DRAW_RAGGED_COUNT = 97, 20_001, 5
# audits: each headline figure <= max(AUDIT_FACTOR x the JAX script's figure
# on the CPU on the same synthetic geometry, AUDIT_FLOOR)
AUDIT_FACTOR, AUDIT_FLOOR = 3.0, 1e-3
AUDIT_PROPOSALS = 8
# bigN's sites here: at 500,000 its host initialize alone takes ~360 s, and
# at 250,000 130 s, with the whole smoke at 700-960 s of its 1,200 s limit
# by host; the 500k run is python -m nngp_tpu_torch.experiments.bigN
# (records/bigN_h100.jsonl)
BIGN_SITES, BIGN_ITERS = 150_000, 25
REPO = os.path.dirname(os.path.abspath(__file__))


def phase(name, msg, t0):
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.3f} s)", flush=True)


def small_parity(dev, family="exponential_sphere"):
    """3 iterations on the card against the CPU, same draws."""
    import numpy as np
    import torch

    import nngp_tpu_torch
    from nngp_tpu_torch.models import gaussian as G
    from nngp_tpu_torch.ops.covariance import shape_transform
    from nngp_tpu_torch.ops.draws import DrawKey
    from nngp_tpu_torch.ops.vecchia import vecchia_linv
    from nngp_tpu_torch.utils.datasets import synthetic_heavy_metals

    locs, y, X = synthetic_heavy_metals(n=400, p=2, seed=5)
    kw = dict(X_locs=X, m=5, stationary_covfun=family,
              n_chains=2, seed=3, verbose=False)
    runs = {}
    for d in ("cpu", dev):
        mc = nngp_tpu_torch.initialize(locs, y, device=d, **kw)
        cfg = G.UpdateConfig(
            n_iterations=3,
            shape_names=tuple(mc.space_time_model["covfun"]["shape_params"]),
            locs_cols=tuple(int(c) for c in mc.design.locs_cols))
        key = DrawKey.of(11, 0, 0, 2, "cpu")
        st = mc.states
        carry = (st, vecchia_linv(mc.graph, shape_transform(cfg.shape_names,
                                                            st.shape)),
                 torch.zeros(2, device=d), torch.zeros(2, device=d))
        for it in range(3):
            draws = G.IterationDraws.draw(key, it, cfg, mc.graph.n,
                                          st.beta.shape[1])
            draws = draws.to(d)
            carry = G.gibbs_iteration(mc.graph, mc.data, cfg, carry, it, 0,
                                      draws)
        runs[str(d)] = carry
    cpu, gpu = runs["cpu"], runs[str(dev)]
    worst = 0.0
    for f in ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
              "field"):
        a = getattr(cpu[0], f).numpy()
        b = getattr(gpu[0], f).cpu().numpy()
        if not np.isfinite(b).all():
            raise RuntimeError(f"small parity: non-finite {f} on the card")
        err = float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max()))
        worst = max(worst, err)
    for a, b in zip(cpu[2:], gpu[2:]):
        if not torch.equal(a, b.cpu()):
            raise RuntimeError("small parity: accept decisions differ")
    if worst > PARITY_TOL:
        raise RuntimeError(f"small parity: scaled max diff {worst:.3e} > "
                           f"{PARITY_TOL}")
    return worst


def kernel_vs_plain(mc, chains=SWEEP_CHAINS):
    """The sweep kernel against its plain version on ``mc``'s plan at
    ``chains`` (the initial states tiled), zero and injected noise, repeat
    calls bit for bit; then median times (sweep_bench.time_case)."""
    import torch

    from nngp_tpu_torch.experiments import sweep_bench
    from nngp_tpu_torch.ops import sweep

    out = {"max_abs_err": 0.0}
    for C in chains:
        for zero in (True, False):
            case = sweep_bench.sweep_case(mc, C, zero_noise=zero)
            got = case["call"](case["w0"].clone())
            again = case["call"](case["w0"].clone())
            want = case["plain"](case["w0"].clone())
            torch.cuda.synchronize()
            diff = (got - want).abs()
            mx, rms = diff.max().item(), diff.pow(2).mean().sqrt().item()
            tol = TOL_REL * max(1.0, want.abs().max().item())
            same = torch.equal(got, again)
            ok = bool(torch.isfinite(got).all()) and mx <= tol and same
            print(f"  {C} chains, {'zero' if zero else 'injected'} noise: max "
                  f"abs diff {mx:.3e}, rms {rms:.3e}, tol {tol:.3e}, repeat "
                  f"call {'bit-identical' if same else 'DIFFERS'} -> "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise RuntimeError(f"sweep kernel disagrees with its plain "
                                   f"version ({C} chains)")
            out["max_abs_err"] = max(out["max_abs_err"], mx)
        t = sweep_bench.time_case(case, plain=(C == 3))
        out[C] = t
        print(f"  {C} chains: kernel {t['ms']:.4f} ms, q_plan gather "
              f"{t['layout_ms']:.4f} ms, grid barriers alone "
              f"{t['barriers_ms']:.4f} ms"
              + (f", plain {t['plain_ms']:.3f} ms" if "plain_ms" in t else "")
              + f"; byte bound {1e3 * t['bound_ms']:.2f} us, "
              f"{100 * t['share']:.2f} % of it", flush=True)
        del case
    g = mc.graph
    lane_tab = sweep.lanes(g.color_ptr, g.plan_sites, g.plan_ptr)[1]
    out["shape"] = (f"S={sweep_bench.SWEEPS} n={g.n} colours={g.n_colors} "
                    f"2E={g.plan_nbr.shape[0]} lane slots="
                    f"{lane_tab.shape[1]}, grid of {sweep.grid_threads()} "
                    "threads")
    return out


def matmul_checks(dev):
    """The matmul at MM_RAGGED against its twin, repeat calls bit for bit,
    and both timed at 2048 x 512 x 2048 (one line each)."""
    import numpy as np
    import torch

    from nngp_tpu_torch.experiments import gather_ops, timing

    rng = np.random.default_rng(0)
    report, ops = [], {}
    for M, K, N in MM_RAGGED:
        a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(dev)
        got = gather_ops.matmul_f32(a, b)
        again = gather_ops.matmul_f32(a, b)
        want = gather_ops.matmul_f32_reference(a, b)
        diff = (got - want).abs().max().item()
        tol = MM_TOL_REL * max(1.0, want.abs().max().item())
        report.append(f"{M}x{K}x{N} {diff:.2e}/{tol:.2e}")
        if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
                or diff > tol:
            raise RuntimeError(f"matmul_f32 at {M}x{K}x{N}: max abs diff "
                               f"{diff:.3e} > tol {tol:.3e}")
        if not torch.equal(got, again):
            raise RuntimeError(f"matmul_f32 at {M}x{K}x{N}: repeat calls "
                               "differ")
        ops[(M, K, N)] = (a, b)
    print("  matmul ragged shapes, max abs diff/tol: " + ", ".join(report)
          + "; repeat calls bit-identical -> ok", flush=True)
    a, b = ops[(2048, 512, 2048)]
    ms, _ = timing.per_call_ms(lambda: gather_ops.matmul_f32(a, b))
    plain_ms, _ = timing.per_call_ms(
        lambda: gather_ops.matmul_f32_reference(a, b))
    print(f"  matmul 2048x512x2048: kernel {ms * 1e3:.2f} us, cuBLAS FP32 "
          f"{plain_ms * 1e3:.2f} us per call", flush=True)


def gather_probes(dev):
    """The four gather-probe kernels against their plain twins at the
    scripts' shapes, then the three entry points with counted launches."""
    import torch

    from nngp_tpu_torch.experiments import (data, gather_bench, gather_ops,
                                            gather_probe, gather_probe2)

    torch.backends.cuda.matmul.allow_tf32 = False   # the matmul twin: FP32
    err = {}

    def held(name, got, want, tol):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"{name}: kernel gives {got.dtype} "
                               f"{tuple(got.shape)}, plain version "
                               f"{want.dtype} {tuple(want.shape)}")
        diff = (got - want).abs().max().item() if got.numel() else 0.0
        ok = bool(torch.isfinite(got).all()) and diff <= tol
        print(f"  {name}: max abs diff {diff:.3e}, tol {tol:.3e} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"{name}: kernel disagrees with plain version")
        return diff

    t = gather_bench.inputs(dev)
    args = gather_bench.sweep_args(t)
    want = gather_ops.gather_sweeps_reference(t["w0"].clone(), *args)
    tol = X1_TOL_REL * max(1.0, want.abs().max().item())
    err["gather_sweeps"] = 0.0
    for cs in gather_ops.CLUSTERS:
        got = gather_ops.gather_sweeps(t["w0"].clone(), *args, cluster=cs)
        err["gather_sweeps"] = max(err["gather_sweeps"], held(
            f"X1 gather_sweeps cluster {cs}", got, want, tol))
        if not torch.equal(got, gather_ops.gather_sweeps(
                t["w0"].clone(), *args, cluster=cs)):
            raise RuntimeError(f"X1 cluster {cs}: repeat calls differ")
    for mod, arrays in ((gather_probe, data.probe_arrays()),
                        (gather_probe2, data.probe2_arrays())):
        for p in mod.probes(data.to_device(arrays, dev)):
            want = p.plain(*p.args)
            tol = (MM_TOL_REL * max(1.0, want.abs().max().item())
                   if p.op is gather_ops.matmul_f32 else 0.0)
            name = p.op.__name__
            got = p.op(*p.args)
            err[name] = max(err.get(name, 0.0),
                            held(f"{mod.__name__.rsplit('.', 1)[1]}: "
                                 f"{p.name}", got, want, tol))
            if p.op is gather_ops.column_scatter:
                if not torch.equal(got, p.op(*p.args)):
                    raise RuntimeError(f"{p.name}: repeat calls differ")
                print(f"  {p.name}: repeat call bit-identical", flush=True)
    matmul_checks(dev)
    torch.cuda.synchronize()
    yardsticks = probe_yardsticks(dev)

    ops = (gather_ops.gather_sweeps, gather_ops.staged_gather,
           gather_ops.column_scatter, gather_ops.matmul_f32)
    for op in ops:
        op.launches = 0
    x1 = gather_bench.main()
    probes = gather_probe.main() + gather_probe2.main()
    torch.cuda.synchronize()
    out = {op.__name__: {"launches": op.launches,
                         "max_abs_err": err[op.__name__]} for op in ops}
    for name, o in out.items():
        if o["launches"] == 0:
            raise RuntimeError(f"the gather probes launched {name} no time")
    cs = gather_ops.CLUSTER
    out["gather_sweeps"].update(ms=x1[cs], plain_ms=x1["plain_ms"],
                                floor_ms=x1["floor_ms"][cs],
                                plan_ms=1e3 * x1["plan_s"][cs])
    print(f"  X1 cluster {cs}: kernel {x1[cs]:.4f} ms, barriers alone "
          f"{x1['floor_ms'][cs]:.4f} ms, plan built in "
          f"{1e3 * x1['plan_s'][cs]:.2f} ms outside the timed calls; repeat "
          "calls bit-identical at every cluster size", flush=True)
    for name in ("staged_gather", "column_scatter", "matmul_f32"):
        rows = [r for r in probes if r["op"] == name]
        out[name].update(ms=sum(r["ms"] for r in rows),
                         plain_ms=sum(r["plain_ms"] for r in rows))
    for name, y in yardsticks.items():
        out[name].update(y)
    return out


# H100 SXM float64 outside the tensor cores (NVIDIA's data sheet)
F64_FLOPS_PER_S = 34e12


def _bound(nbytes, flops=0.0, f64=False):
    """(ms, "bytes" or "operations"): the larger of the bytes over an H100
    SXM's memory rate and the operations over its float32 rate (its
    float64 rate when ``f64``)."""
    from nngp_tpu_torch.experiments.sweep_bench import (F32_FLOPS_PER_S,
                                                        HBM_BYTES_PER_S)

    rate = F64_FLOPS_PER_S if f64 else F32_FLOPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _library_call(p):
    """One PyTorch call computing probe ``p``'s function (a chain of one
    call per stage for the staged gathers), its indices cast beforehand."""
    import torch

    from nngp_tpu_torch.experiments import gather_ops

    if p.op is gather_ops.matmul_f32:
        a, b = p.args
        return lambda: a @ b                                 # cuBLAS FP32
    if p.op is gather_ops.column_scatter:
        val, idx, n_rows = p.args
        src, col = val[:, :1].contiguous(), idx[:, :1].long()
        return lambda: torch.zeros(n_rows, val.shape[1], device=val.device
                                   ).scatter_(0, col, src)
    src, stages = p.args
    steps = [(st[0], st[1].long() if st[0] in ("rows", "cols") else st[1:])
             for st in stages]

    def chain():
        x = src
        for kind, arg in steps:
            if kind in ("rows", "cols"):
                x = torch.gather(x, int(kind == "cols"), arg)
            elif kind == "roll":
                x = torch.roll(x, arg[0], 0)
            else:
                x = x.t().contiguous()
        return x
    return chain


def probe_yardsticks(dev):
    """Per gather-probe kernel, summed over its bodies at the scripts'
    shapes: the least time of its bytes and operations (``bound_ms``,
    ``bound_by``; column_scatter's bytes are out and the sectors of column
    0 of val and idx), the time of the PyTorch calls computing the same
    function (``library_ms``; none for X1's colour-ordered sweep) and, for
    the kernels other than X1, the launch floor: one empty kernel's time
    back to back (``torch.cuda._sleep(0)``) times the bodies
    (``floor_ms``; X1's is its barriers alone, from gather_bench)."""
    import torch

    from nngp_tpu_torch.experiments import (data, gather_bench, gather_ops,
                                            gather_probe, gather_probe2,
                                            timing)

    launch_ms, _ = timing.per_call_ms(lambda: torch.cuda._sleep(0))
    print(f"  launch floor: {launch_ms * 1e3:.3f} us per empty kernel back "
          "to back", flush=True)

    t = gather_bench.inputs(dev)
    args = gather_bench.sweep_args(t)
    S, NB, B = t["noise"].shape
    ms, by = _bound(_nbytes(t["w0"], *args) + _nbytes(t["w0"]),
                    S * NB * B * (2 * gather_ops._W + 4))
    out = {"gather_sweeps": {"bound_ms": ms, "bound_by": by,
                             "library_ms": None}}
    for mod, arrays in ((gather_probe, data.probe_arrays()),
                        (gather_probe2, data.probe2_arrays())):
        for p in mod.probes(data.to_device(arrays, dev)):
            name = p.op.__name__
            res = p.plain(*p.args)
            tensors = [a for a in p.args if hasattr(a, "numel")]
            if p.op is gather_ops.staged_gather:
                tensors += [st[1] for st in p.args[1]
                            if st[0] in ("rows", "cols")]
            flops, nbytes = 0.0, _nbytes(res, *tensors)
            if p.op is gather_ops.matmul_f32:
                (M, K), N = p.args[0].shape, p.args[1].shape[1]
                flops = 2.0 * M * N * K
            if p.op is gather_ops.column_scatter:
                # it reads column 0 of val and idx: an element a 32-byte
                # sector where the row stride is wider
                n_in, cols = p.args[0].shape
                nbytes = _nbytes(res) + 2 * n_in * min(4 * cols, 32)
            ms, by = _bound(nbytes, flops)
            lib, _ = timing.per_call_ms(_library_call(p))
            o = out.setdefault(name, {"bound_ms": 0.0, "bound_by": by,
                                      "library_ms": 0.0, "floor_ms": 0.0})
            o["bound_ms"] += ms
            o["library_ms"] += lib
            o["floor_ms"] += launch_ms
    return out


def run_counted(mc, n_iterations, per_iteration=1, solves=None, **kw):
    """``run`` with the sweep, factor-build, draws and level solve kernels'
    launches counted from zero; fails unless every iteration launched the
    sweep kernel ``per_iteration`` times and ``chain_draws`` once
    (``run_counted.draw_launches``), the fused factor build ran once for
    the cycle's factor and twice an ASIS pair
    (``run_counted.factor_launches``), the K-input factor rows never
    (``run_counted.factor_rows_launches``), the level solve ``solves``
    times (default once an ASIS pair; ``run_counted.solve_launches``), and
    every state is finite."""
    import torch

    import nngp_tpu_torch
    from nngp_tpu_torch.ops import sweep
    from nngp_tpu_torch.ops.draws import chain_draws
    from nngp_tpu_torch.ops.trisolve import level_solve
    from nngp_tpu_torch.ops.vecchia import linv_rows_from_K, vecchia_linv

    start = mc.iterations
    t = time.perf_counter()
    sweep.chromatic_sweeps.launches = 0
    vecchia_linv.launches = linv_rows_from_K.launches = 0
    chain_draws.launches = level_solve.launches = 0
    mc = nngp_tpu_torch.run(mc, n_cycles=1, n_iterations_update=n_iterations,
                            **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = sweep.chromatic_sweeps.launches
    run_counted.factor_launches = vecchia_linv.launches
    run_counted.factor_rows_launches = linv_rows_from_K.launches
    run_counted.draw_launches = chain_draws.launches
    run_counted.solve_launches = level_solve.launches
    if launches != n_iterations * per_iteration:
        raise RuntimeError(f"run launched the sweep kernel {launches} times "
                           f"in {n_iterations} iterations")
    if run_counted.draw_launches != n_iterations:
        raise RuntimeError(f"run launched the chain_draws kernel "
                           f"{run_counted.draw_launches} times in "
                           f"{n_iterations} iterations")
    want = 1 + 2 * kw.get("covparams_steps", 1) * n_iterations
    if (run_counted.factor_launches != want
            or run_counted.factor_rows_launches):
        raise RuntimeError(f"run launched the factor build "
                           f"{run_counted.factor_launches} times in "
                           f"{n_iterations} iterations, expected {want}, and "
                           f"the K-input factor rows "
                           f"{run_counted.factor_rows_launches} times, "
                           "expected 0")
    if solves is None:
        solves = kw.get("covparams_steps", 1) * n_iterations
    if run_counted.solve_launches != solves:
        raise RuntimeError(f"run launched the level solve kernel "
                           f"{run_counted.solve_launches} times in "
                           f"{n_iterations} iterations, expected {solves}")
    if mc.iterations != start + n_iterations:
        raise RuntimeError(f"iterations {start} -> {mc.iterations}, not "
                           f"+{n_iterations}")
    for f in ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
              "field", "tk_ancillary", "tk_sufficient"):
        if not bool(torch.isfinite(getattr(mc.states, f)).all()):
            raise RuntimeError(f"non-finite {f} after run")
    return mc, secs, launches




def _ulps(a, b):
    """float32 ulps between a and b of one sign (their bit patterns' gap)."""
    import torch

    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def _draw_layout(mc):
    """{field: per-chain shape} of one main-path iteration of ``mc`` (K = 1,
    10 sweeps, 10 noise steps)."""
    from nngp_tpu_torch.models import gaussian as G

    cfg = G.UpdateConfig(
        n_iterations=1,
        shape_names=tuple(mc.space_time_model["covfun"]["shape_params"]),
        locs_cols=tuple(int(c) for c in mc.design.locs_cols))
    return G.IterationDraws.layout(cfg, mc.graph.n, mc.states.beta.shape[1])


def _draws_held(layout, ids, words=True):
    """chain_draws at ``layout`` for the chain ids ``ids`` (on the card):
    every field bit for bit with the twin on the card and with a repeat
    call, and finite; with ``words``, each field's Philox words bit for bit
    with the CPU twin's.  Returns the kernel's fields."""
    import torch

    from nngp_tpu_torch.ops import draws

    seed, start, it = DRAW_KEY
    call = functools.partial(draws.chain_draws_cuda, seed, start, ids, it,
                             layout)
    got, again = call(), call()
    twin = draws.chain_draws_reference(seed, start, ids, it, layout)
    torch.cuda.synchronize()
    for k, shape in layout.items():
        if not (torch.equal(got[k], twin[k])
                and torch.equal(got[k], again[k])):
            raise RuntimeError(f"chain_draws, {ids.numel()} chains: field "
                               f"{k} {shape} differs from the twin on the "
                               "card or between two calls")
        if not bool(torch.isfinite(got[k]).all()):
            raise RuntimeError(f"chain_draws: non-finite {k}")
        if words:
            n = math.prod(shape)
            w = [draws.chain_words(seed, start, p, it, k, n).cpu()
                 for p in (ids, ids.cpu())]
            if not torch.equal(*w):
                raise RuntimeError(f"chain_draws: the Philox words of {k} "
                                   f"{shape} differ from the CPU twin's")
    return got


def draws_check(layout, dev):
    """The chain_draws kernel at the main path's ``layout`` (K = 1, 10
    sweeps, 10 noise steps) for chains [0, C), C in DRAW_CHAINS, at
    DRAW_KEY: every field bit for bit with the twin on the card and with a
    repeat call; against the CPU twin (8 chains at a time) the Philox words
    and the uniforms bit for bit, at most DRAW_DIFF_SHARE of the normals
    differing, each by at most DRAW_ULPS.  The same bit-for-bit checks at
    two ragged layouts (DRAW_RAGGED_*), and sincos against cos and sin
    alone at all 2^32 angles.  Times (experiments/draws_bench.py:
    time_draws): the kernel's device time back to back (``device_ms``,
    without the wrapper's host work), the median around the wrapper over
    21 CUDA events, the twin on the card and torch.randn + torch.rand of
    the same shapes.  The bound is the larger of the bytes written over
    3.35 TB/s and the FP64 floor: the float64 instructions a Philox call
    of normals, counted in the SASS of the kernel the launch runs
    (``draws_bench.sass_counts``), at 132 SMs x 64 a clock x the card's
    highest SM clock.  Returns {C: figures, "sass": the counts a call of
    each kernel by its calls a thread, "sincos_differ": words}."""
    import torch

    from nngp_tpu_torch.experiments import draws_bench, timing
    from nngp_tpu_torch.ops import _build, draws

    count = {k: math.prod(v) for k, v in layout.items()}
    normal = {k for k in layout if draws.FIELDS[k][1] == draws.NORMAL}
    seed, start, it = DRAW_KEY
    listing = draws_bench.library_sass(draws._library()._name)
    with open(os.path.join(_build.BUILD_DIR, "chain_draws.sass"), "w") as f:
        f.write(listing)
    mhz = draws_bench.max_sm_clock_mhz()
    counts = {}
    for C in DRAW_CHAINS:
        calls = draws_bench.tile_calls(C, layout)
        if calls not in counts:
            counts[calls] = c = draws_bench.sass_counts(listing, calls)
            print(f"  chain_draws_kernel<{calls}> SASS, a Philox call of "
                  f"normals on its data's path: {c['f64']} float64 "
                  f"arithmetic + {c['f64_conv']} float64 conversions, "
                  f"{c['mufu64']} MUFU.*64H, {c['total']} instructions "
                  f"({c['skipped']} of the tile left out); highest SM clock "
                  f"{mhz:.0f} MHz", flush=True)
    t = time.perf_counter()
    sincos_differ = draws.sincos_differ(dev)
    print(f"  sincos against cos and sin alone: {2**32} words checked, "
          f"{sincos_differ} differ ({time.perf_counter() - t:.2f} s)",
          flush=True)
    if sincos_differ:
        raise RuntimeError(f"chain_draws: sincos differs from cos and sin "
                           f"at {sincos_differ} angles")
    C = DRAW_RAGGED_CHAINS
    ragged = {f"sweep_z at {DRAW_RAGGED_SITES} sites": dict(
        layout, sweep_z=(layout["sweep_z"][0], DRAW_RAGGED_SITES)),
        f"every field at {DRAW_RAGGED_COUNT}": {
            k: (DRAW_RAGGED_COUNT,) for k in draws.FIELDS}}
    for name, rag in ragged.items():
        _draws_held(rag, torch.arange(C, device=dev))
        print(f"  ragged layout, {name}, {C} chains: kernel = twin on the "
              "card bit for bit, repeat call too, words = the CPU twin's",
              flush=True)
    out = {"sass": counts, "sincos_differ": sincos_differ}
    for C in DRAW_CHAINS:
        ids = torch.arange(C, device=dev)
        got = _draws_held(layout, ids, words=False)
        differ, n_normals, worst = 0, 0, 0
        for lo in range(0, C, 8):
            part = torch.arange(lo, min(C, lo + 8))
            cpu = draws.chain_draws_reference(seed, start, part, it, layout)
            for k in layout:
                words = [draws.chain_words(seed, start, p, it, k, count[k])
                         .cpu() for p in (part.to(dev), part)]
                if not torch.equal(*words):
                    raise RuntimeError(f"chain_draws, chains {lo}+: the "
                                       f"Philox words of {k} differ from "
                                       "the CPU twin's")
                a, b = got[k][lo:lo + 8].cpu(), cpu[k]
                diff = a != b
                if k not in normal and bool(diff.any()):
                    raise RuntimeError(f"chain_draws: uniforms of {k} differ "
                                       "from the CPU twin's")
                if k in normal:
                    n_normals += a.numel()
                    differ += int(diff.sum())
                    if bool(diff.any()):
                        worst = max(worst, int(_ulps(a[diff], b[diff]).max()))
        if differ > DRAW_DIFF_SHARE * n_normals or worst > DRAW_ULPS:
            raise RuntimeError(f"chain_draws, {C} chains: {differ} of "
                               f"{n_normals} normals differ from the CPU "
                               f"twin's, by up to {worst} ulps")
        del got
        o = draws_bench.time_draws(C, layout, DRAW_KEY, rounds=3, device=dev)
        calls = draws_bench.tile_calls(C, layout)
        f64_ms, issue_ms = draws_bench.floors(
            C * draws_bench.shapes(layout)[2], counts[calls], mhz)
        bytes_ms = o["bytes_ms"]
        o.update(max_abs_err=0.0, cpu_differ=differ, cpu_normals=n_normals,
                 cpu_max_ulps=worst, tile_calls=calls, max_sm_clock_mhz=mhz,
                 f64_floor_ms=f64_ms, issue_floor_ms=issue_ms,
                 bound_ms=max(bytes_ms, f64_ms),
                 bound_by="bytes" if bytes_ms >= f64_ms else "operations",
                 plain_ms=timing.median_ms(
                     lambda: draws.chain_draws_reference(seed, start, ids, it,
                                                         layout), 21))
        out[C] = o
        n_norm = C * draws_bench.shapes(layout)[0]
        print(f"  {C} chains, {n_norm} normals: kernel = twin on the card "
              f"bit for bit, repeat call too; vs the CPU twin: words and "
              f"uniforms bit for bit, {differ} of {n_normals} normals "
              f"differ (max {worst} ulp); kernel {o['device_ms']:.4f} ms "
              f"back to back (runs "
              f"{', '.join(f'{x:.4f}' for x in o['device_ms_runs'])}), "
              f"{o['ms']:.4f} ms around the wrapper, twin "
              f"{o['plain_ms']:.3f} ms, randn + rand {o['library_ms']:.4f} "
              f"ms; bytes {1e3 * bytes_ms:.2f} us, FP64 floor "
              f"{1e3 * f64_ms:.2f} us and issue floor {1e3 * issue_ms:.2f} "
              f"us ({calls} calls a thread) at {mhz:.0f} MHz; bound by "
              f"{o['bound_by']}",
              flush=True)
    return out


def level_solve_check(mc):
    """The level solve kernel on ``mc``'s graph at its states tiled to C
    chains, C in SOLVE_CHAINS (``sweep_bench.time_solve``): within
    SOLVE_F64_TOL * max(1, |x|_inf) of its twin in float64 on the card,
    bit for bit with the twin in float32 and between two calls, one launch
    a call; its times beside the byte bound and the step floor.
    {C: figures}."""
    import torch

    from nngp_tpu_torch.experiments import sweep_bench

    out = {}
    for C in SOLVE_CHAINS:
        r = out[C] = sweep_bench.time_solve(mc, C)
        if not r["f64_max_diff"] <= SOLVE_F64_TOL:
            raise RuntimeError(f"level solve, {C} chains: scaled difference "
                               f"{r['f64_max_diff']:.3e} from float64 > "
                               f"{SOLVE_F64_TOL}")
        if not (r["same_bits"] and r["twin_bits"]) \
                or r["launches_a_call"] != 1:
            raise RuntimeError(f"level solve, {C} chains: other bits from "
                               "the twin or a repeat call, or "
                               f"{r['launches_a_call']} launches a call")
        torch.cuda.empty_cache()
    return out


def examples(td):
    """Each example of nngp_tpu_torch/examples/ through its main() on the
    card, the sweep kernel's launches counted from zero for each: exactly
    one an iteration it ran, and a finite summary.  (name, summary,
    seconds, launches) for each, in order; the ms per iteration printed is
    the example's own (its run calls, setup excluded)."""

    import torch

    from nngp_tpu_torch.examples import (_common, heavy_metals,
                                         heavy_metals_96,
                                         heavy_metals_analysis, matern_fit,
                                         synthetic_families, vignette_toy)
    from nngp_tpu_torch.ops import sweep

    fit, out = os.path.join(td, "hm_fit.pkl"), os.path.join(td, "examples")
    runs = ((heavy_metals, ["--cycles", "1", "--iters", "25", "--save", fit]),
            (heavy_metals_analysis, [fit]),
            (heavy_metals_96, ["--cycles", "1", "--iters", "10"]),
            (vignette_toy, ["--quick"]),
            (matern_fit, ["--quick"]),
            (synthetic_families, ["--quick"]))
    done = []
    for module, argv in runs:
        name = module.__name__.rsplit(".", 1)[1]
        sweep.chromatic_sweeps.launches = 0
        t = time.perf_counter()
        summary = module.main(argv + ["--out", out])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = sweep.chromatic_sweeps.launches
        if launches != summary["iterations_run"]:
            raise RuntimeError(f"{name}: the sweep kernel launched {launches} "
                               f"times in {summary['iterations_run']} "
                               "iterations")
        if not _common.all_finite(summary):
            raise RuntimeError(f"{name}: non-finite summary {summary}")
        done.append((name, summary, secs, launches))
        its = summary["iterations_run"]
        print(f"  [{name}] {secs:.3f} s, {its} iterations"
              + (f", {summary['ms_per_iteration']:.2f} ms/iteration"
                 if its else "")
              + f", sweep kernel launches {launches}", flush=True)
    return done


def matern_logdet(mc):
    """The factor build's proposal log-determinant difference
    sum_i dlog L_ii between the Matérn probe's two shape vectors
    (experiments/matern_probe.py), on the card, against the float64 oracle
    numpy_ref.np_vecchia_linv on the same graph and float64 coordinates."""
    import numpy as np
    import torch

    from nngp_tpu_torch.ops.numpy_ref import np_vecchia_linv
    from nngp_tpu_torch.ops.vecchia import vecchia_linv
    from nngp_tpu_torch.preprocess.ordering import lonlat_to_xyz

    covfun = mc.space_time_model["covfun"]["stationary_covfun"]
    coords = lonlat_to_xyz(mc.locs)
    out = {}
    for label, nat in (("theta", MATERN_THETA), ("theta_p", MATERN_THETA_P)):
        linv = vecchia_linv(mc.graph, torch.tensor([nat], device=mc.device))
        card = torch.log(linv[0, :, 0].double()).cpu().numpy()
        oracle = np.log(np_vecchia_linv(coords, mc.NNarray, covfun,
                                        np.asarray(nat))[:, 0])
        out[label] = (card, oracle)
    card = float((out["theta_p"][0] - out["theta"][0]).sum())
    oracle = float((out["theta_p"][1] - out["theta"][1]).sum())
    return card, oracle


def _library_factor_rows(K, mask, d_floor):
    """The factor rows by PyTorch's batched solvers (the yardstick, used
    nowhere in the port): the padded slots forced to identity,
    ``cholesky_ex`` of the [B, m, m] blocks, two ``solve_triangular``, then
    d, rsqrt and the row algebra."""
    import torch

    k = K.shape[-1]
    valid2 = mask[:, :, None] * mask[:, None, :]
    eye = torch.eye(k, device=K.device)

    def call():
        Ke = (K * valid2 + eye * (1.0 - valid2)).reshape(-1, k, k)
        L, _ = torch.linalg.cholesky_ex(Ke[:, 1:, 1:])
        u = torch.linalg.solve_triangular(L, Ke[:, 1:, :1], upper=False)
        d = torch.clamp_min(Ke[:, 0, 0] - (u * u).sum((-2, -1)), d_floor)
        b = torch.linalg.solve_triangular(L.transpose(-1, -2), u, upper=True)
        inv = torch.rsqrt(d)[:, None]
        rows = torch.cat([inv, -b[..., 0] * inv], -1).view(K.shape[:-1])
        return rows * mask
    return call


def _read_json(*parts):
    """A JSON file of this checkout, by its path's parts."""
    with open(os.path.join(REPO, *parts)) as f:
        return json.load(f)


def factor_rows(mc, mm):
    """The factor-rows kernel (csrc/factor_rows.cu) against its plain twin
    on the card at the main path's shapes: the Heavy-metals graph's K from
    its states tiled to 3 and 96 chains, and matern_sphere's at its
    states.  For each: the max relative row difference |a - b| / (|b| +
    1e-3) (at most FACTOR_TOL_REL), the count of differing elements, the
    median ms of the kernel, the twin and the library's batched solvers
    (21 calls), the byte bound.  Then the kernel's log-diagonal error
    against the float64 factor of the same K at factor_probe's and
    matern_probe's Heavy-metals states, at most FACTOR_LOGDIAG x the JAX
    scripts' jitted figure on the CPU (records/*_jax_cpu_synthetic.json).
    Returns (cases, log-diagonal rows)."""
    import numpy as np
    import torch

    from nngp_tpu_torch.experiments import factor_probe, timing
    from nngp_tpu_torch.experiments._oracles import (f64_linv_from_K,
                                                     f64_linv_logdiag)
    from nngp_tpu_torch.experiments.sweep_bench import tile_states
    from nngp_tpu_torch.ops import vecchia as V
    from nngp_tpu_torch.ops.covariance import (correlation_from_sqdist,
                                               shape_transform)

    def names(fit):
        return fit.space_time_model["covfun"]["shape_params"]

    cases = {f"exponential_sphere {C} chains": (
        mc.graph, shape_transform(names(mc), tile_states(mc.states, C).shape))
        for C in (3, 96)}
    cases["matern_sphere 3 chains"] = (
        mm.graph, shape_transform(names(mm), mm.states.shape))
    out = {}
    for label, (g, nat) in cases.items():
        K = correlation_from_sqdist(g.covfun, g.nn_dist2, nat).contiguous()
        mask, df = g.nn_mask, g.d_floor
        kernel = V.linv_rows_cuda(K, mask, df)
        twin = V.linv_rows_reference(K, mask, df)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(kernel).all()):
            raise RuntimeError(f"factor rows, {label}: non-finite rows")
        rel = float(((kernel - twin).abs() / (twin.abs() + 1e-3)).max())
        differ = int((kernel != twin).sum())
        nbytes = _nbytes(K, mask, kernel)
        bound, by = _bound(nbytes)
        out[label] = {
            "shape": list(K.shape), "max_rel": rel, "differ": differ,
            "numel": kernel.numel(),
            "max_abs_err": float((kernel - twin).abs().max()),
            "ms": timing.median_ms(lambda: V.linv_rows_cuda(K, mask, df), 21),
            "plain_ms": timing.median_ms(
                lambda: V.linv_rows_reference(K, mask, df), 21),
            "library_ms": timing.median_ms(
                _library_factor_rows(K, mask, df), 21),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes}
        print(f"  {label}: K {list(K.shape)}, kernel vs twin max rel "
              f"{rel:.3e} <= {FACTOR_TOL_REL:g}, {differ} of "
              f"{kernel.numel()} elements differ; median ms kernel "
              f"{out[label]['ms']:.4f}, twin {out[label]['plain_ms']:.3f}, "
              f"library {out[label]['library_ms']:.3f}, bound {bound:.4f} "
              f"({nbytes / 1e6:.1f} MB)", flush=True)
        if not rel <= FACTOR_TOL_REL:
            raise RuntimeError(f"factor rows, {label}: kernel vs twin max "
                               f"rel {rel:.3e} > {FACTOR_TOL_REL}")
        del K, kernel, twin
        torch.cuda.empty_cache()

    records = ("nngp_tpu_torch", "experiments", "records")
    jf = _read_json(*records, "factor_probe_jax_cpu_synthetic.json")
    jm = _read_json(*records, "matern_probe_jax_cpu_synthetic.json")
    d2g = mm.graph.nn_dist2.cpu().numpy()
    sq = d2g.sum(-1)[mm.graph.nn_mask.cpu().numpy() > 0]
    rho = 2.5 * float(np.sqrt(np.median(sq[sq > 0])))
    checks = (
        ("factor_probe theta", mc.graph, [factor_probe.RHO], f64_linv_from_K,
         jf["logdiag_chol_theta"]["max"]),
        ("matern_probe hm_matern_sphere", mm.graph, [rho, 0.75],
         f64_linv_logdiag, jm["hm_matern_sphere"]["logdiag_err_vs_devK"]["max"]))
    logdiag = []
    for label, g, nat, oracle, jax_max in checks:
        nat = torch.tensor([nat], dtype=torch.float32, device=g.nn_mask.device)
        K = correlation_from_sqdist(g.covfun, g.nn_dist2, nat).contiguous()
        rows = V.linv_rows_cuda(K, g.nn_mask, g.d_floor)
        K64 = K[0].double().cpu().numpy()
        mask = g.nn_mask.cpu().numpy()
        if oracle is f64_linv_from_K:
            ld64 = np.log(oracle(K64, mask)[0][:, 0])
        else:
            ld64 = oracle(K64, mask)[0]
        err = float(np.abs(np.log(rows[0, :, 0].double().cpu().numpy())
                           - ld64).max())
        bound = FACTOR_LOGDIAG * jax_max
        logdiag.append((label, err, jax_max, bound))
        print(f"  log-diagonal vs float64 of the same K, {label}: kernel "
              f"{err:.3e}, jitted JAX CPU {jax_max:.3e}, bound {bound:.3e}",
              flush=True)
        if not err <= bound:
            raise RuntimeError(f"factor rows, {label}: log-diagonal error "
                               f"{err:.3e} > {bound:.3e}")
    return out, logdiag


# Operations of csrc/factor_rows.cu:factor_build, counted from its code:
# + - x / max each 1, an fma 2, and each transcendental and square root at
# its cost.  Exponential runs in float32: expf and sqrtf on the SFU, 8 each
# (its 16 a clock an SM against 128 float32 lanes).  Matérn runs in float64,
# which has no SFU path: a double exp, log, sinh or cosh is ~10 fused
# multiply-adds of its polynomial on the FMA pipe (20), a double square root
# ~4 Newton fmas (8).
SFU = 8
F64_TRANS, F64_SQRT = 20, 8
# (operations, transcendentals, square roots) of each piece
PIECES = {
    "dist": (3, 0, 1),          # d2g / rr (G = 1), max, sqrt; then K v
    "exp": (1, 1, 0),           # expf(-d)
    "series": (58, 2, 0),       # d <= 0.29: the complementary series
    "temme": (360, 4, 0),       # 0.29 < d <= 2: Temme's set-up, 20 terms
    "cf2": (19, 1, 1),          # d > 2: CF2's set-up and end
    "cf2_step": (30, 0, 0),     # one CF2 step
    "big": (4, 2, 0),           # exp(lognorm + nu log x) K_nu
    "recur": (5, 0, 0),         # one upward recurrence step
}


def _ops(piece, f64):
    ops, trans, roots = PIECES[piece]
    return ops + trans * (F64_TRANS if f64 else SFU) + roots * (
        F64_SQRT if f64 else SFU)


def _row_ops(m, f64=False):
    """Operations of the unrolled row body at m neighbours."""
    root = F64_SQRT if f64 else SFU
    chol = sum(2 * j + 2 + root + 2 * j * (m - j - 1) + (m - j - 1)
               for j in range(m))
    solves = sum(2 * i + 1 for i in range(m)) * 2
    return chol + solves + 2 * m + 1 + root + 1 + 2 * m


def _cf2_steps(x, mu):
    """Steps ops/bessel.py:_cf2_large_x runs at each x > 2 before its lane
    freezes (at most 40), replayed by the twin's recurrence in x's dtype
    (frozen at 1e-10 in float64, 1e-8 in float32)."""
    import torch

    eps = 1e-10 if x.dtype == torch.float64 else 1e-8
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    delh = d
    q1, q2 = torch.zeros_like(x), torch.ones_like(x)
    a1 = 0.25 - mu * mu
    q, c, a = a1.clone(), a1.clone(), -a1
    s = 1.0 + q * delh
    steps = torch.full_like(x, 40)
    live = torch.ones_like(x, dtype=torch.bool)
    for i in range(2, 42):
        a = a - 2.0 * (i - 1)
        c = -a * c / i
        qnew = (q1 - b * q2) / a
        q1, q2 = q2, qnew
        q = q + c * qnew
        r = torch.clamp_min(c.abs(), 1e-30)
        c, q1, q2 = c / r, q1 * r, q2 * r
        b = b + 2.0
        denom = b + a * d
        d = 1.0 / torch.where(denom.abs() < 1e-30,
                              torch.full_like(denom, 1e-30), denom)
        delh = (b * d - 1.0) * delh
        dels = q * delh
        s = s + dels
        stop = live & (dels.abs() < eps * s.abs())
        steps[stop] = i - 1
        live &= ~stop
    return steps


def factor_build_ops(g, nat):
    """The operations factor_build does on these inputs (float32 for the
    exponential families, float64 for Matérn, as the kernel computes
    them): each chain's valid strictly-lower pairs of every row (the
    entries the row body reads), by the branch their distance takes and,
    beyond 2, by the CF2 steps this data needs; then the row body."""
    import torch

    f64 = g.covfun.startswith("matern")
    dt = torch.float64 if f64 else torch.float32
    k = g.nn_mask.shape[1]
    G = g.nn_dist2.shape[-1]
    i, j = torch.tril_indices(k, k, -1, device=nat.device)
    valid = (g.nn_mask[:, i] * g.nn_mask[:, j]) > 0               # [n, P]
    nat = nat.to(dt)
    rr = nat[:, :G] * nat[:, :G]
    d2 = (g.nn_dist2.to(dt)[None, :, i, j] / rr[:, None, None]).sum(-1)
    d = torch.sqrt(torch.clamp_min(d2, 0.0))                     # [C, n, P]
    live = valid[None].expand_as(d)
    ops = float(live.sum()) * _ops("dist", f64)
    if not f64:
        ops += float(live.sum()) * _ops("exp", f64)
    else:
        live = live & (d > 1e-8)
        x = torch.clamp_min(d, 1e-8)
        # kv's split nu = mu + l, |mu| <= 1/2
        l = torch.floor(nat[:, G] + 0.5)[:, None, None].expand_as(x)
        mu = nat[:, G][:, None, None] - l
        series, big = live & (x <= 0.29), live & (x > 0.29)
        cf2 = big & (x > 2.0)
        ops += (float(series.sum()) * _ops("series", f64)
                + float((big & ~cf2).sum()) * _ops("temme", f64)
                + float(cf2.sum()) * _ops("cf2", f64)
                + float(_cf2_steps(x[cf2], mu[cf2]).sum())
                * _ops("cf2_step", f64)
                + float(big.sum()) * _ops("big", f64)
                + float(l[big].sum()) * _ops("recur", f64))
    return ops + nat.shape[0] * g.nn_mask.shape[0] * _row_ops(k - 1, f64)


def _library_factor_build(g, nat):
    """The yardstick of the fused build (used nowhere in the port): the
    correlations by ``correlation_from_sqdist``, then PyTorch's batched
    solvers (``_library_factor_rows``); for Matérn in float64 from the
    widened inputs, rounded to float32 at the end, as the kernel
    computes it."""
    from nngp_tpu_torch.ops.covariance import correlation_from_sqdist

    if g.covfun.startswith("matern"):
        d2g, mask, nat64 = (g.nn_dist2.double(), g.nn_mask.double(),
                            nat.double())

        def call64():
            K = correlation_from_sqdist(g.covfun, d2g, nat64)
            return _library_factor_rows(K, mask, g.d_floor)().float()
        return call64

    def call():
        K = correlation_from_sqdist(g.covfun, g.nn_dist2, nat)
        return _library_factor_rows(K, g.nn_mask, g.d_floor)()
    return call


def near_singular(dev):
    """The fused Matérn build near singular, on the card through the port's
    own initialize: tests/test_torch_matern.py's 300-site layouts (seed
    11, m = 5), every range at 2.5 median neighbour distances, nu 0.54 and
    0.98 (s = -2.5, 3), the four Matérn families.  Each chain's
    log-determinant error against the float64 oracle np_vecchia_linv (at
    most NEAR_SINGULAR_LOGDET) and its rows against the twin's (at most
    FACTOR_TOL_REL).  Returns {family: (largest |log-det error|, largest
    relative difference from the twin, differing elements)}."""
    import numpy as np
    import torch

    import nngp_tpu_torch
    from nngp_tpu_torch.ops import vecchia as V
    from nngp_tpu_torch.ops.covariance import shape_transform
    from nngp_tpu_torch.ops.numpy_ref import np_vecchia_linv
    from nngp_tpu_torch.preprocess.ordering import lonlat_to_xyz

    out = {}
    for family in ("matern_isotropic", "matern_sphere", "matern_scaledim",
                   "matern_spacetime"):
        n = 300
        rng = np.random.default_rng(11)
        if "sphere" in family:
            locs = np.stack([rng.uniform(-100, -80, n),
                             rng.uniform(30, 45, n)], 1)
        elif "spacetime" in family:
            locs = rng.uniform(size=(n, 3))
        else:
            locs = rng.uniform(size=(n, 2))
        mc = nngp_tpu_torch.initialize(
            locs, rng.normal(size=n), m=5, n_chains=2, seed=2,
            stationary_covfun=family, device=dev, verbose=False)
        g = mc.graph
        d2g = g.nn_dist2.cpu().numpy()
        med = [np.median(np.sqrt(d2g[..., j][d2g[..., j] > 0]))
               for j in range(d2g.shape[-1])]
        sampled = np.array([list(np.log(2.5 * np.asarray(med))) + [s]
                            for s in (-2.5, 3.0)], np.float32)
        nat = shape_transform(mc.space_time_model["covfun"]["shape_params"],
                              torch.as_tensor(sampled, device=dev))
        kernel = V.factor_build_cuda(g, nat.contiguous())
        twin = V.vecchia_linv_reference(family, g.nn_dist2, g.nn_mask, nat,
                                        g.d_floor)
        torch.cuda.synchronize()
        rel = float(((kernel - twin).abs() / (twin.abs() + 1e-3)).max())
        differ = int((kernel != twin).sum())
        coords = lonlat_to_xyz(mc.locs) if "sphere" in family else mc.locs
        rows = kernel.double().cpu().numpy()
        worst = 0.0
        for c, nt64 in enumerate(nat.cpu().numpy().astype(np.float64)):
            oracle = np_vecchia_linv(coords, mc.NNarray, family, nt64)
            worst = max(worst, abs(float(np.log(rows[c, :, 0]).sum()
                                         - np.log(oracle[:, 0]).sum())))
        out[family] = (worst, rel, differ)
        print(f"  near singular {family}: log-det error vs float64 "
              f"{worst:.3e} <= {NEAR_SINGULAR_LOGDET:g}, kernel vs twin max "
              f"rel {rel:.3e}, {differ} of {kernel.numel()} elements differ",
              flush=True)
        if not (worst <= NEAR_SINGULAR_LOGDET and rel <= FACTOR_TOL_REL):
            raise RuntimeError(f"factor build near singular, {family}: "
                               f"log-det error {worst:.3e}, rel {rel:.3e}")
    return out


def factor_build(mc, mm):
    """The fused factor build (csrc/factor_rows.cu:factor_build, the main
    path's) against its plain twin vecchia_linv_reference on the card at
    the main path's shapes (the Heavy-metals states tiled to 3 and 96
    chains, matern_sphere's at 3): the max relative row difference |a - b|
    / (|b| + 1e-3) (at most FACTOR_TOL_REL), the count of differing
    elements, the median ms of the kernel, the twin and the yardstick (21
    calls each), and the bound (Matérn's operations at the float64 rate).
    Then its
    log-diagonal against the float64 factor of float64 correlations at
    factor_probe's and matern_probe's Heavy-metals states, at most
    FACTOR_LOGDIAG x the JAX scripts' full figure on the CPU.  Returns
    (cases, log-diagonal rows)."""
    import numpy as np
    import torch

    from nngp_tpu_torch.experiments import factor_probe, timing
    from nngp_tpu_torch.experiments._oracles import (f64_linv_from_K,
                                                     f64_linv_logdiag,
                                                     f64_matern_from_d2g)
    from nngp_tpu_torch.experiments.sweep_bench import tile_states
    from nngp_tpu_torch.ops import vecchia as V
    from nngp_tpu_torch.ops.covariance import shape_transform

    def names(fit):
        return fit.space_time_model["covfun"]["shape_params"]

    cases = {f"exponential_sphere {C} chains": (
        mc.graph, shape_transform(names(mc), tile_states(mc.states, C).shape))
        for C in (3, 96)}
    cases["matern_sphere 3 chains"] = (
        mm.graph, shape_transform(names(mm), mm.states.shape))
    out = {}
    for label, (g, nat) in cases.items():
        nat = nat.contiguous()
        tol = FACTOR_TOL_REL
        kernel = V.factor_build_cuda(g, nat)
        twin = V.vecchia_linv_reference(g.covfun, g.nn_dist2, g.nn_mask, nat,
                                        g.d_floor)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(kernel).all()):
            raise RuntimeError(f"factor build, {label}: non-finite rows")
        rel = float(((kernel - twin).abs() / (twin.abs() + 1e-3)).max())
        differ = int((kernel != twin).sum())
        nbytes = _nbytes(g.nn_dist2, g.nn_mask, nat, kernel)
        flops = factor_build_ops(g, nat)
        bound, by = _bound(nbytes, flops, g.covfun.startswith("matern"))
        out[label] = {
            "shape": list(kernel.shape), "max_rel": rel, "differ": differ,
            "numel": kernel.numel(), "tol": tol,
            "max_abs_err": float((kernel - twin).abs().max()),
            "ms": timing.median_ms(lambda: V.factor_build_cuda(g, nat), 21),
            "plain_ms": timing.median_ms(
                lambda: V.vecchia_linv_reference(
                    g.covfun, g.nn_dist2, g.nn_mask, nat, g.d_floor), 21),
            "library_ms": timing.median_ms(_library_factor_build(g, nat), 21),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "operations": flops}
        print(f"  fused {label}: rows {list(kernel.shape)}, kernel vs twin "
              f"max rel {rel:.3e} <= {tol:g}, {differ} of {kernel.numel()} "
              f"elements differ; median ms kernel {out[label]['ms']:.4f}, "
              f"twin {out[label]['plain_ms']:.3f}, library "
              f"{out[label]['library_ms']:.3f}, bound {bound:.4f} by {by} "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)", flush=True)
        if not rel <= tol:
            raise RuntimeError(f"factor build, {label}: kernel vs twin max "
                               f"rel {rel:.3e} > {tol}")
        del kernel, twin
        torch.cuda.empty_cache()

    records = ("nngp_tpu_torch", "experiments", "records")
    jf = _read_json(*records, "factor_probe_jax_cpu_synthetic.json")
    jm = _read_json(*records, "matern_probe_jax_cpu_synthetic.json")
    d2g = mm.graph.nn_dist2.cpu().numpy()
    sq = d2g.sum(-1)[mm.graph.nn_mask.cpu().numpy() > 0]
    rho = 2.5 * float(np.sqrt(np.median(sq[sq > 0])))

    def exp64(g, nat):
        d2 = g.nn_dist2[..., 0].double().cpu().numpy()
        K = np.exp(-np.sqrt(np.maximum(d2, 0.0)) / np.float64(np.float32(
            nat[0])))
        return np.log(f64_linv_from_K(K, g.nn_mask.cpu().numpy())[0][:, 0])

    def matern64(g, nat):
        K = f64_matern_from_d2g(g.nn_dist2.cpu().numpy(), nat[:1], nat[1])
        return f64_linv_logdiag(K, g.nn_mask.cpu().numpy())[0]

    checks = (
        ("factor_probe theta", mc.graph, [factor_probe.RHO], exp64,
         jf["logdiag_total_theta"]["max"]),
        ("matern_probe hm_matern_sphere", mm.graph, [rho, 0.75], matern64,
         jm["hm_matern_sphere"]["logdiag_err_total"]["max"]))
    logdiag = []
    for label, g, nat, oracle, jax_max in checks:
        t = torch.tensor([nat], dtype=torch.float32, device=g.nn_mask.device)
        rows = V.factor_build_cuda(g, t)
        err = float(np.abs(np.log(rows[0, :, 0].double().cpu().numpy())
                           - oracle(g, nat)).max())
        bound = FACTOR_LOGDIAG * jax_max
        logdiag.append((label, err, jax_max, bound))
        print(f"  fused log-diagonal vs float64 of float64 correlations, "
              f"{label}: kernel {err:.3e}, JAX CPU full {jax_max:.3e}, bound "
              f"{bound:.3e}", flush=True)
        if not err <= bound:
            raise RuntimeError(f"factor build, {label}: log-diagonal error "
                               f"{err:.3e} > {bound:.3e}")
    return out, logdiag


DIAG_RUNS = (   # (script, arguments): the cut sizes of the diagnostics phase
    ("grb_guard", ()),
    ("hm_mpsrf", ("{fit}",)),
    ("hm_crossval", ("--n", "400", "--engine-cycles", "1",
                     "--engine-iters", "40", "--iters", "60")),
    ("am_ab", ("--cycles", "2", "--iters", "10")),
    ("halo_overhead_table", ("--n", "20000")),
)


def diagnostics(mc, td):
    """The five diagnostics scripts of nngp_tpu_torch/experiments by python
    -m on the card, all started at once, at cut sizes (DIAG_RUNS):
    grb_guard's three cases, hm_mpsrf on the main path's fit (saved here),
    hm_crossval at 400 of its 700 sites (one engine cycle of 40
    iterations, 60 oracle iterations), am_ab's three arms on the 8k subset (2 cycles of
    10 iterations), halo_overhead_table at 20,000 sites over 8 ranks.
    Fails on a nonzero exit, a record without its keys, a non-finite
    figure, or a sampler run (hm_crossval, each am_ab arm) whose sweep or
    factor-rows kernel launched no time.  Returns {script: (record,
    seconds)}."""
    import nngp_tpu_torch
    from nngp_tpu_torch.examples._common import all_finite

    fit = os.path.join(td, "fit.pkl")
    nngp_tpu_torch.save(mc, fit)
    procs = {}
    for name, args in DIAG_RUNS:
        out = os.path.join(td, f"{name}.json")
        cmd = [sys.executable, "-m", f"nngp_tpu_torch.experiments.{name}",
               *(a.format(fit=fit) for a in args), "--out", out]
        procs[name] = (subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out, time.perf_counter())
    done, bad = {}, []
    for name, (proc, out, t) in procs.items():
        try:
            log, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        secs = time.perf_counter() - t
        if proc.returncode != 0:
            bad.append(f"{name} exited {proc.returncode}: {log[-1500:]}")
            continue
        with open(out) as f:
            rec = ({"rows": [json.loads(line) for line in f]}
                   if name == "am_ab" else json.load(f))
        done[name] = (rec, secs)
        if not all_finite(rec):
            bad.append(f"{name}: a figure is not finite")
    if bad:
        raise RuntimeError("diagnostics: " + "; ".join(bad))
    grb, hm = done["grb_guard"][0], done["hm_mpsrf"][0]
    cv, ab = done["hm_crossval"][0], done["am_ab"][0]["rows"]
    ho = done["halo_overhead_table"][0]
    if not grb["A_well_conditioned"]["abs_diff"] < 1e-8:
        bad.append(f"grb_guard case A: {grb['A_well_conditioned']}")
    if hm["iterations"] != mc.iterations:
        bad.append(f"hm_mpsrf read {hm['iterations']} iterations, the fit "
                   f"has {mc.iterations}")
    runs = [("hm_crossval", cv)] + [(f"am_ab {r['arm']}", r) for r in ab]
    if [r["arm"] for r in ab] != ["am", "isotropic", "am_k3"]:
        bad.append(f"am_ab arms {[r['arm'] for r in ab]}")
    for label, r in runs:
        if min(r["kernel_launches"].values()) < 1:
            bad.append(f"{label}: kernel launches {r['kernel_launches']}")
    if ho["totals"]["owned_site_updates"] != 2 * ho["n"]:
        bad.append(f"halo_overhead_table totals {ho['totals']}")
    if bad:
        raise RuntimeError("diagnostics: " + "; ".join(bad))
    return done


def predict_parity(dev):
    """predict_field's conditional draws on the card against the CPU: a
    400-site fit run on the card, loaded on both devices from one file, the
    same retained samples and the same normals z at 100 new sites."""
    import tempfile

    import numpy as np
    import torch

    import nngp_tpu_torch
    from nngp_tpu_torch import prediction as P
    from nngp_tpu_torch.utils.datasets import synthetic_heavy_metals

    locs, y, X = synthetic_heavy_metals(n=400, p=2, seed=5)
    mc = nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=2, seed=3, device=dev, verbose=False)
    mc = nngp_tpu_torch.run(mc, n_iterations_update=20, field_thinning=0.5,
                            verbose=False, Gelman_Rubin_Brooks_stop=(0., 0.))
    new = synthetic_heavy_metals(n=100, p=0, seed=6)[0]
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "fit.pkl")
        nngp_tpu_torch.save(mc, path)
        fits = {d: nngp_tpu_torch.load(path, device=d) for d in ("cpu", dev)}
    names = list(mc.space_time_model["covfun"]["shape_params"])
    stored = P._stored_idx(mc, 0.5)
    z = torch.randn(len(stored), len(new),
                    generator=torch.Generator().manual_seed(2))
    draws = {}
    for d, fit in fits.items():
        g = P._joint_graph(fit, new, 10).to(d)
        draws[str(d)] = P.conditional_field(
            g, names, fit.graph.n, *P.retained_samples(fit.records[0], stored,
                                                       d), z.to(d)).cpu()
    cpu, card = draws["cpu"], draws[str(dev)]
    if not bool(torch.isfinite(card).all()):
        raise RuntimeError("predict parity: non-finite draws on the card")
    err = (cpu - card).abs().max().item() / max(1.0, cpu.abs().max().item())
    if err > PARITY_TOL:
        raise RuntimeError(f"predict parity: scaled max diff {err:.3e} > "
                           f"{PARITY_TOL}")
    return err


def save_load(mc, dev):
    """save the fit, load it on the card: states and records bit for bit."""
    import tempfile

    import numpy as np
    import torch

    import nngp_tpu_torch

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "fit.pkl")
        t = time.perf_counter()
        nngp_tpu_torch.save(mc, path)
        save_s = time.perf_counter() - t
        size = os.path.getsize(path)
        t = time.perf_counter()
        back = nngp_tpu_torch.load(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    for f in STATE_KEYS:
        a, b = getattr(mc.states, f), getattr(back.states, f)
        if b.device != a.device or not torch.equal(a, b):
            raise RuntimeError(f"save/load: state {f} differs")
    for ra, rb in zip(mc.records, back.records):
        for k, v in ra.items():
            same = (np.array_equal(v, rb[k]) if isinstance(v, np.ndarray)
                    else v == rb[k])
            if not same:
                raise RuntimeError(f"save/load: record {k} differs")
    return back, save_s, load_s, size


def determinism(dev, locs, y, X):
    """initialize -> run twice from seed 1: the count of elements of the
    states and records that differ between the two runs."""
    import nngp_tpu_torch

    fits = []
    for _ in range(2):
        mc = nngp_tpu_torch.initialize(
            locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
            n_chains=3, seed=1, device=dev, verbose=False)
        fits.append(run_counted(mc, 10, field_thinning=0.5, verbose=False)[0])
    return count_differing(*fits)


def count_differing(a, b):
    """(elements of the states and records of fits a and b that differ,
    elements compared)."""
    import numpy as np
    import torch

    differ, total = 0, 0
    for f in STATE_KEYS:
        x, z = getattr(a.states, f), getattr(b.states, f)
        differ += int((x != z).sum())   # NaN != NaN counts too
        total += x.numel()
    for ra, rb in zip(a.records, b.records):
        for k in ("beta_0", "beta", "log_scale", "log_noise_variance",
                  "shape", "field", "saved_field"):
            differ += int(np.sum(ra[k] != rb[k]))
            total += ra[k].size
    torch.cuda.synchronize()
    return differ, total


def entry_run():
    """entry() on the card: (sweep kernel launches, chains, iterations)."""
    import torch

    from nngp_tpu_torch.entry import entry
    from nngp_tpu_torch.ops import sweep
    from nngp_tpu_torch.ops.draws import chain_draws

    fn, args = entry()
    sweep.chromatic_sweeps.launches = chain_draws.launches = 0
    states, recs = fn(*args)
    torch.cuda.synchronize()
    for k, v in recs.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"entry(): non-finite {k} records")
    T, C = recs["log_scale"].shape
    if sweep.chromatic_sweeps.launches != T or chain_draws.launches != T:
        raise RuntimeError(f"entry(): {sweep.chromatic_sweeps.launches} "
                           f"sweep kernel and {chain_draws.launches} "
                           f"chain_draws launches in {T} iterations")
    return sweep.chromatic_sweeps.launches, C, T


GRB_KEYS = ("beta_0", "log_scale", "log_noise_variance")


def chains_mesh_parity(mc, dev, td):
    """A one-process NCCL group: ``mc`` saved, loaded twice, run for 25
    iterations with and without the chains mesh; (differing elements,
    elements, mesh run s, plain run s, launches, collective_grb's largest
    relative difference from the host Gelman_Rubin_Brooks)."""

    import numpy as np
    import torch
    import torch.distributed as dist

    import nngp_tpu_torch
    from nngp_tpu_torch.parallel import (chains_mesh, collective_grb,
                                         initialize_distributed)

    path = os.path.join(td, "fit3.pkl")
    nngp_tpu_torch.save(mc, path)
    meshed, plain = (nngp_tpu_torch.load(path, device=dev) for _ in range(2))
    initialize_distributed("file://" + os.path.join(td, "rdzv"), 1, 0,
                           device_type="cuda")
    try:
        mesh = chains_mesh()
        if (mesh.device_type, dist.get_backend()) != ("cuda", "nccl"):
            raise RuntimeError(f"chains mesh: {mesh.device_type} over "
                               f"{dist.get_backend()}")
        dist.barrier()   # NCCL sets up its communicator here, untimed
        kw = dict(field_thinning=0.5, verbose=False, covparams_steps=1)
        meshed, mesh_s, launches = run_counted(meshed, 25, mesh=mesh, **kw)
        plain, plain_s, _ = run_counted(plain, 25, **kw)
        differ, total = count_differing(meshed, plain)
        # K8 over NCCL against the host, on the rows the host keeps
        T = meshed.records[0]["log_scale"].shape[0]
        lo = max(int(np.floor(0.5 * T)) - 1, 0)
        samples = np.stack([np.stack([r[k][lo:] for k in GRB_KEYS], axis=-1)
                            for r in meshed.records])
        got = collective_grb(torch.as_tensor(samples, device=dev),
                             meshed.n_chains).cpu().numpy()
    finally:
        dist.destroy_process_group()
    want = nngp_tpu_torch.Gelman_Rubin_Brooks(
        [dict({k: r[k] for k in GRB_KEYS}, shape=np.zeros((T, 0)))
         for r in meshed.records], 0.5)["R_hat"]
    grb_err = float(np.max(np.abs(got - want) / np.abs(want)))
    return differ, total, mesh_s, plain_s, launches, grb_err


def two_ranks(dev, locs, y, X, td):
    """A 6-chain fit saved once, then resumed for 25 iterations by
    ``nngp_tpu_torch.parallel.resume`` as one process and twice as two gloo
    ranks on the card; returns ({launch name: per-rank JSON lines}, the
    count of state elements of the 2 x 3 fit that differ from the 1 x 6
    fit's, elements).  The 2 x 3 fit's records of the first FIRST_ITERS
    iterations are held to the 1 x 6 fit's at
    tests/test_parallel.py::test_sharded_cycle_matches_vmap's tolerances."""
    import numpy as np

    import nngp_tpu_torch
    from nngp_tpu_torch.parallel.distributed import launch_local

    path = os.path.join(td, "fit6.pkl")
    nngp_tpu_torch.save(nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=6, seed=1, device=dev, verbose=False), path)
    out, saved = {}, {}
    for name, world in (("1 x 6", 1), ("2 x 3", 2), ("2 x 3 again", 2)):
        saved[name] = os.path.join(td, f"resumed{len(saved)}.pkl")
        argv = ["-m", "nngp_tpu_torch.parallel.resume", path, "--iterations",
                "25", "--mesh-device", "cpu", "--save", saved[name]]
        out[name] = [json.loads(text.strip().splitlines()[-1])
                     for text in launch_local(argv, world, timeout=300)]
    for name, ranks in out.items():
        for r in ranks:
            if r["sweep_launches"] != 25 or r["iterations"] != 25:
                raise RuntimeError(f"two ranks, {name}: rank {r['rank']} "
                                   f"{r['sweep_launches']} sweep kernel "
                                   f"launches, {r['iterations']} iterations")
            for k in ("digest", "r_hat"):
                if r[k] != ranks[0][k]:
                    raise RuntimeError(f"two ranks, {name}: rank "
                                       f"{r['rank']}'s {k} differs")
    if out["2 x 3"][0]["digest"] != out["2 x 3 again"][0]["digest"]:
        raise RuntimeError("two ranks: a second launch gave other chains")
    one, two = (nngp_tpu_torch.load(saved[k], device="cpu")
                for k in ("1 x 6", "2 x 3"))
    for c, (a, b) in enumerate(zip(two.records, one.records)):
        for k, rtol, atol in (("log_scale", 1e-5, 0.0),
                              ("field", 1e-4, 1e-4)):
            x, z = a[k][:FIRST_ITERS], b[k][:FIRST_ITERS]
            if not np.allclose(x, z, rtol=rtol, atol=atol):
                raise RuntimeError(
                    f"two ranks: chain {c}'s {k} records of the first "
                    f"{FIRST_ITERS} iterations differ between 2 x 3 and "
                    f"1 x 6 by up to {np.abs(x - z).max():.3e}")
    differ = total = 0
    for f in STATE_KEYS:
        x, z = getattr(two.states, f), getattr(one.states, f)
        differ += int((x != z).sum())
        total += x.numel()
    return out, differ, total


def halo_one_rank(dev, td):
    """A 1 x 1 ("chains", "sites") NCCL mesh: the fit ``chains_mesh_parity``
    saved, loaded twice, run for 25 iterations in halo mode and with run()
    (``parallel/halo.py:halo_level_solve`` has the level solve kernel's row
    arithmetic on a card).  (differing elements, elements, halo s, run s, halo launches, run
    launches)."""

    import torch
    import torch.distributed as dist

    import nngp_tpu_torch
    from nngp_tpu_torch.parallel import halo_mesh, initialize_distributed

    path = os.path.join(td, "fit3.pkl")
    meshed, plain = (nngp_tpu_torch.load(path, device=dev) for _ in range(2))
    per = 10 * meshed.graph.n_colors          # one launch a colour step
    initialize_distributed("file://" + os.path.join(td, "rdzv_halo"), 1, 0,
                           device_type="cuda")
    try:
        mesh = halo_mesh(1)
        if (mesh.device_type, dist.get_backend()) != ("cuda", "nccl"):
            raise RuntimeError(f"halo mesh: {mesh.device_type} over "
                               f"{dist.get_backend()}")
        for dim in ("chains", "sites"):      # NCCL's communicators, untimed
            dist.all_reduce(torch.zeros(1, device=dev),
                            group=mesh[dim].get_group())
        kw = dict(field_thinning=0.5, verbose=False, covparams_steps=1)
        meshed, halo_s, launches = run_counted(meshed, 25, per_iteration=per,
                                               solves=0, mesh=mesh, **kw)
        plain, plain_s, plain_launches = run_counted(plain, 25, **kw)
        differ, total = count_differing(meshed, plain)
    finally:
        dist.destroy_process_group()
    return differ, total, halo_s, plain_s, launches, plain_launches


def halo_steps(mc):
    """Every colour step of both D = 2 owned sub-plans of the fit's graph,
    on the fit's sweep inputs (3 chains, injected noise), launched in turn
    on one field as halo mode launches them: held bit for bit against one
    launch of the whole plan and against the plain version at TOL_REL;
    (launches, steps a sweep, max abs diff against plain, tol)."""
    import torch

    from nngp_tpu_torch.experiments import sweep_bench
    from nngp_tpu_torch.models import gaussian as G
    from nngp_tpu_torch.ops import sweep
    from nngp_tpu_torch.ops.covariance import shape_transform
    from nngp_tpu_torch.ops.vecchia import vecchia_linv
    from nngp_tpu_torch.parallel.halo import build_halo_plan

    g, st = mc.graph, mc.states
    linv = vecchia_linv(g, shape_transform(
        mc.space_time_model["covfun"]["shape_params"], st.shape))
    q_edges, q_plan, P, rs, scal = G.sweep_inputs(
        g, mc.data, st, linv, G._mu_obs(mc.data, st, g))
    noise = torch.randn(st.field.shape[0], sweep_bench.SWEEPS, g.n,
                        device=st.field.device,
                        generator=torch.Generator(st.field.device)
                        .manual_seed(0))
    args = (q_plan, P, rs, noise, scal, g.color_ptr, g.plan_sites,
            g.plan_ptr, g.plan_nbr)
    whole = sweep.chromatic_sweeps_cuda(st.field.clone(), *args)
    plain = sweep.chromatic_sweeps_reference(st.field.clone(), *args)
    plan = build_halo_plan(g, 2)
    subs = [plan.for_rank(d).to(st.field.device).rank.sub for d in range(2)]
    qs = [q_edges.index_select(1, sub.plan_edge) for sub in subs]
    steps = sum(b1 > b0 for sub in subs
                for b0, b1 in zip(sub.bounds, sub.bounds[1:]))
    w = st.field.clone()
    sweep.chromatic_sweeps.launches = 0
    for s_ in range(noise.shape[1]):
        z = noise[:, s_:s_ + 1].contiguous()
        for c in range(g.n_colors):
            for sub, q in zip(subs, qs):
                sweep.chromatic_sweep_step(w, q, P, rs, z, scal, sub, c)
    torch.cuda.synchronize()
    launches = sweep.chromatic_sweeps.launches
    if launches != noise.shape[1] * steps:
        raise RuntimeError(f"halo steps: {launches} launches, not "
                           f"{noise.shape[1]} x {steps}")
    if not torch.equal(w, whole):
        raise RuntimeError(f"halo steps: {int((w != whole).sum())} elements "
                           "differ from one launch of the whole plan")
    mx = (w - plain).abs().max().item()
    tol = TOL_REL * max(1.0, plain.abs().max().item())
    if not mx <= tol:
        raise RuntimeError(f"halo steps: max abs diff {mx:.3e} against the "
                           f"plain version > tol {tol:.3e}")
    return launches, steps, mx, tol


def halo_two_ranks(dev, td):
    """The same fit resumed for 10 iterations by two gloo sites ranks on the
    card (``parallel.resume --sites 2``) and by run(); (the ranks' JSON
    lines, the largest scaled state difference, run's ms per
    iteration)."""

    import torch

    import nngp_tpu_torch
    from nngp_tpu_torch.parallel.distributed import launch_local
    from nngp_tpu_torch.parallel.halo import build_halo_plan

    path, out = os.path.join(td, "fit3.pkl"), os.path.join(td, "halo2.pkl")
    ranks = [json.loads(text.strip().splitlines()[-1]) for text in
             launch_local(["-m", "nngp_tpu_torch.parallel.resume", path,
                           "--iterations", "10", "--mesh-device", "cpu",
                           "--sites", "2", "--save", out], 2, timeout=400)]
    plain = nngp_tpu_torch.load(path, device=dev)
    plan = build_halo_plan(plain.graph, 2)
    steps = [10 * sum(b1 > b0 for b0, b1 in zip(rk.sub.bounds,
                                                 rk.sub.bounds[1:]))
             for rk in plan.ranks]
    for r in ranks:
        if r["digest"] != ranks[0]["digest"] or r["sites"] != 2:
            raise RuntimeError(f"halo two ranks: rank {r['rank']} holds "
                               "another fit")
        if r["sweep_launches"] != 10 * steps[r["rank"]]:
            raise RuntimeError(f"halo two ranks: rank {r['rank']} launched "
                               f"the sweep kernel {r['sweep_launches']} "
                               f"times, not {10 * steps[r['rank']]}")
    plain, plain_s, _ = run_counted(plain, 10, verbose=False)
    halo = nngp_tpu_torch.load(out, device=dev)
    if halo.iterations != plain.iterations:
        raise RuntimeError(f"halo two ranks: {halo.iterations} iterations, "
                           f"run() {plain.iterations}")
    worst = 0.0
    for f in STATE_KEYS:
        a, b = getattr(halo.states, f), getattr(plain.states, f)
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"halo two ranks: non-finite {f}")
        worst = max(worst, (a - b).abs().max().item()
                    / max(1.0, b.abs().max().item()))
    if worst > HALO_TOL:
        raise RuntimeError(f"halo two ranks: scaled state difference "
                           f"{worst:.3e} > {HALO_TOL}")
    return ranks, worst, 1e3 * plain_s / 10


def bench_legs(dev):
    """The bench's legs, preflight and baseline at full width with short
    fixed windows; (its JSON line, the sweep kernel's launches)."""
    from nngp_tpu_torch import bench
    from nngp_tpu_torch.ops import sweep

    short = dict(warmup_iters=100, warmup_max_iters=100,
                 n_iterations_update=100, device=dev)
    legs, parity = {}, {}
    sweep.chromatic_sweeps.launches = 0
    for name, kw in (("best_chains_leg", dict(
            n_chains=96, covparams_steps=3, lean_records=True,
            n_timed_iters=100, field_thinning=0.05, parity_out=parity)),
            ("reference_protocol_3_chains", dict(
                n_chains=3, n_timed_iters=200, field_thinning=0.1))):
        legs[name] = bench.measure_engine(**short, **kw)
    launches = sweep.chromatic_sweeps.launches
    base = bench.measure_r_equivalent_baseline(n_iters=2)
    return bench.result_line(legs, base, parity, {}), legs, launches


def check_bench_line(result):
    """tests/test_bench_smoke.py's checks, and the preflight's verdict."""
    detail = result["detail"]
    if "errors" in detail:
        raise RuntimeError(f"bench: errors {detail['errors']}")
    if not (result["value"] > 0.0 and result["vs_baseline"] > 0.0):
        raise RuntimeError(f"bench: value {result['value']}, vs_baseline "
                           f"{result['vs_baseline']}")
    if not detail["sweep_parity_preflight"]["ok"]:
        raise RuntimeError("bench: preflight "
                           f"{detail['sweep_parity_preflight']}")
    legs = [detail["best_config"]] + [
        detail[k] for k in ("reference_protocol_3_chains", "best_chains_leg")
        if k in detail]
    lean = [leg for leg in legs if leg["lean_records"]]
    if not (lean and lean[0]["ess_per_s"]["field_mean"] > 0.0
            and lean[0]["rhat_timed_window"] is not None
            and lean[0]["field_kept_samples"] > 0):
        raise RuntimeError(f"bench: no usable lean leg in {legs}")


def _audit_figures():
    """(name, audit, path into its record) of each headline figure."""
    from nngp_tpu_torch.experiments import ratio_audit

    return ([(f"ratio_audit {k} rms", "ratio_audit", ("summary", k, "rms"))
             for k in ratio_audit.KEYS]
            + [("factor_probe |logdet_ratio_err|", "factor_probe",
                ("logdet_ratio_err",)),
               ("cotransform_probe |llr_impact_vs_full_oracle|",
                "cotransform_probe", ("llr_impact_vs_full_oracle",)),
               ("op_probe |sum_err|", "op_probe", ("sum_err",))]
            + [(f"matern_probe {lab} |proposal_logdet_diff_err|",
                "matern_probe", (lab, "proposal_logdet_diff_err"))
               for lab in ("hm_matern_sphere", "synthetic_matern_iso")])


def _factor_figures():
    """(name, audit, path) of each factor-build log-diagonal error against
    the float64 Cholesky of the same float32 K."""
    return ([(f"factor_probe {t} max", "factor_probe",
              (f"logdiag_chol_{t}", "max")) for t in ("theta", "theta_prime")]
            + [(f"matern_probe {lab} logdiag_err_vs_devK max", "matern_probe",
                (lab, "logdiag_err_vs_devK", "max"))
               for lab in ("hm_matern_sphere", "synthetic_matern_iso")])


def _figure(rec, path):
    for k in path:
        rec = rec[k]
    return abs(rec)


def audits(dev, locs, y, X):
    """The five numeric audits (nngp_tpu_torch/experiments) on the card at
    the synthetic Heavy-metals width, ratio_audit at AUDIT_PROPOSALS
    proposals; each headline figure against max(AUDIT_FACTOR x the JAX
    script's figure on the CPU on the same geometry (records/
    *_jax_cpu_synthetic.json), AUDIT_FLOOR), synthetic_matern_iso also
    against experiments/matern_probe_cpu.json (the same seeded layout).
    Fails on a figure that is not finite or breaks its bound; returns
    (rows, seconds by audit)."""

    import numpy as np

    from nngp_tpu_torch.examples._common import all_finite
    from nngp_tpu_torch.experiments import (_common, cotransform_probe,
                                            factor_probe, matern_probe,
                                            op_probe, ratio_audit)

    recs, secs = {}, {}
    t = time.perf_counter()
    recs["ratio_audit"] = ratio_audit.audit(locs, y, X, AUDIT_PROPOSALS, dev,
                                            {})
    secs["ratio_audit"] = time.perf_counter() - t
    t = time.perf_counter()
    graph, NN, maps = _common.sphere_graph(locs, factor_probe.COVFUN)
    secs["graph"] = time.perf_counter() - t
    t = time.perf_counter()
    recs["factor_probe"] = factor_probe.probe(graph, dev, {})
    secs["factor_probe"] = time.perf_counter() - t
    t = time.perf_counter()
    recs["cotransform_probe"] = cotransform_probe.probe(graph, NN, maps.locs,
                                                        y, dev, {})
    secs["cotransform_probe"] = time.perf_counter() - t
    t = time.perf_counter()
    rng = np.random.default_rng(0)
    recs["op_probe"] = op_probe.probe(
        graph, NN, y, rng, dev, op_probe.op_accuracy(rng, dev, {}))
    secs["op_probe"] = time.perf_counter() - t
    t = time.perf_counter()
    recs["matern_probe"] = matern_probe.probe(locs, dev, {})
    secs["matern_probe"] = time.perf_counter() - t

    jax = {name: _read_json("nngp_tpu_torch", "experiments", "records",
                            f"{name}_jax_cpu_synthetic.json") for name in recs}
    old = _read_json("experiments", "matern_probe_cpu.json")
    out, bad = [], []
    for name, script, path in _audit_figures():
        card = _figure(recs[script], path)
        refs = [("JAX CPU synthetic", _figure(jax[script], path))]
        if path[0] == "synthetic_matern_iso":
            refs.append(("experiments/matern_probe_cpu.json",
                         _figure(old, path)))
        for label, ref in refs:
            bound = max(AUDIT_FACTOR * ref, AUDIT_FLOOR)
            ok = card == card and card <= bound
            out.append((name, card, label, ref, bound, ok))
            print(f"  {name}: card {card:.3e}, {label} {ref:.3e}, bound "
                  f"{bound:.3e} -> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                bad.append(name)
    for name, script, path in _factor_figures():
        card, ref = _figure(recs[script], path), _figure(jax[script], path)
        bound = FACTOR_LOGDIAG * ref
        ok = card <= bound
        out.append((name, card, "JAX CPU synthetic", ref, bound, ok))
        print(f"  {name}: card {card:.3e}, JAX CPU synthetic {ref:.3e}, "
              f"bound {bound:.3e} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(name)
    for script, rec in recs.items():
        if not all_finite(rec):
            bad.append(f"{script}: a figure is not finite")
    if bad:
        raise RuntimeError("audits: " + "; ".join(bad))
    return out, secs


def big_n(dev, td, n, halo_plan=False):
    """bigN (nngp_tpu_torch/experiments/bigN.py) at ``n`` sites on the card:
    initialize, one warm and two timed cycles of BIGN_ITERS iterations at 3
    chains, the sweep kernel launched once an iteration; with ``halo_plan``
    the D = 8 plan (bigN's ``--halo-plan``); its JSON line, appended to
    ``td``/bigN.jsonl;
    then the kernel against its plain twin on that plan (3 chains) and a
    profile of 5 iterations (sweep_bench.profile_iteration: each span's
    host time, the card's idle share and its idle time by span).  Returns
    (entry, kernel checks and times, profile)."""

    from nngp_tpu_torch.experiments import _common, bigN, sweep_bench

    args = bigN.parse_args(["--n", str(n), "--iters", str(BIGN_ITERS),
                            "--out", os.path.join(td, "bigN.jsonl")]
                           + ["--halo-plan"] * halo_plan)
    _, entry = _common.setup(args)
    mc = bigN.measure(args, dev, entry)
    want = 3 * args.iters
    if entry["k1_launches"] != want or entry["iterations"] != want:
        raise RuntimeError(f"bigN: {entry['k1_launches']} sweep kernel "
                           f"launches in {entry['iterations']} iterations, "
                           f"expected {want}")
    bigN.append_line(args.out, entry)
    kv = kernel_vs_plain(mc, chains=(3,))
    return entry, kv, sweep_bench.profile_iteration(mc)


GATHER_KERNELS = (
    ("gather_sweeps", "nngp_tpu_torch/csrc/gather_sweep.cu",
     "experiments/gather_bench.py:92"),
    ("staged_gather", "nngp_tpu_torch/csrc/gather_probes.cu",
     "experiments/gather_probe.py:27,42; experiments/gather_probe2.py:29"),
    ("column_scatter", "nngp_tpu_torch/csrc/gather_probes.cu",
     "experiments/gather_probe.py:27,42 (k_scat :82)"),
    ("matmul_f32", "nngp_tpu_torch/csrc/gather_probes.cu",
     "experiments/gather_probe.py:27,42 (k_mm :93)"),
)


def main():
    t0 = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import nngp_tpu_torch
    from nngp_tpu_torch.experiments import gather_ops
    from nngp_tpu_torch.ops import _build, draws, sweep, trisolve, vecchia
    from nngp_tpu_torch.preprocess.coloring import dag_levels
    from nngp_tpu_torch.utils.datasets import synthetic_heavy_metals

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    phase("device", kind, t0)

    t = time.perf_counter()
    libs = {"chromatic_sweep": sweep._library,
            **{f"factor_rows{part}_m5": functools.partial(
                vecchia._factor_library, part, 5)
               for part in vecchia.FACTOR_PARTS},
            "gather_sweep": gather_ops._sweep_library,
            "gather_probes": gather_ops._probe_library,
            "chain_draws": draws._library,
            "level_solve_m5": functools.partial(trisolve._library, 5)}
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source
        for f in [pool.submit(build) for build in libs.values()]:
            f.result()
    for name in libs:
        ptxas = [l.strip() for l in _build.build_log(name).splitlines()
                 if "registers" in l or "spill" in l]
        print(f"  {name}.cu -> sm_90a: " + " | ".join(ptxas))
    phase("build", f"{len(libs)} sources built in parallel", t)

    for family in ("exponential_sphere", "matern_sphere"):
        t = time.perf_counter()
        worst = small_parity(dev, family)
        phase("small parity", f"{family}, 3 iterations, 400 sites, 2 chains: "
              f"scaled max diff card vs CPU {worst:.3e} <= {PARITY_TOL}", t)

    t = time.perf_counter()
    locs, y, X = synthetic_heavy_metals()
    mc = nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=3, seed=1, device=dev)
    torch.cuda.synchronize()
    n_levels = int(dag_levels(mc.NNarray).max()) + 1
    phase("initialize", f"n={mc.graph.n} p={mc.design.p} colours="
          f"{mc.graph.n_colors} DAG levels={n_levels} level-solve rows="
          f"{mc.graph.n_levels_rows}; host stages "
          + json.dumps({k: round(v, 3) for k, v in mc.setup_timings.items()}),
          t)

    t = time.perf_counter()
    kv = kernel_vs_plain(mc)
    phase("kernel", f"{kv['shape']}: kernel {kv[3]['ms']:.4f} ms at 3 "
          f"chains, {kv[96]['ms']:.3f} ms at 96; plain {kv[3]['plain_ms']:.3f}"
          " ms at 3 (medians)", t)

    t = time.perf_counter()
    dr = draws_check(_draw_layout(mc), dev)
    phase("draws", "chain_draws at the main path's layout: device time "
          "back to back " + ", ".join(
              f"{dr[C]['device_ms']:.4f} ms at {C} chains (around the "
              f"wrapper {dr[C]['ms']:.4f}; bound {dr[C]['bound_ms']:.4f} by "
              f"{dr[C]['bound_by']}: bytes {dr[C]['bytes_ms']:.4f}, FP64 "
              f"floor {dr[C]['f64_floor_ms']:.4f}; randn + rand "
              f"{dr[C]['library_ms']:.4f})" for C in DRAW_CHAINS)
          + "; bit for bit with its twin on the card, ragged layouts too; "
          f"sincos = cos, sin at all 2^32 angles ({dr['sincos_differ']} "
          "differ); normals differing from the CPU twin: " + ", ".join(
              f"{dr[C]['cpu_differ']} of {dr[C]['cpu_normals']}"
              for C in DRAW_CHAINS), t)

    t = time.perf_counter()
    ls = level_solve_check(mc)
    phase("level solve", "kernel against its float64 twin " + ", ".join(
        f"{ls[C]['f64_max_diff']:.2e} at {C} chains" for C in SOLVE_CHAINS)
        + f" (<= {SOLVE_F64_TOL}), bit for bit with the twin; "
        f"{ls[3]['steps']} steps from {ls[3]['rows']} rows; " + "; ".join(
            f"{C} chains: {ls[C]['ms']:.4f} ms, device "
            f"{ls[C]['device_ms']:.4f}, bound {ls[C]['bound_ms']:.4f} "
            f"({100 * ls[C]['share']:.1f} %), step floor "
            f"{ls[C]['floor_ms']:.4f} ({100 * ls[C]['floor_share']:.1f} %), "
            f"twin {ls[C]['plain_ms']:.3f}" for C in SOLVE_CHAINS), t)

    t = time.perf_counter()
    gp = gather_probes(dev)
    phase("gather probes", "kernel / plain ms: " + ", ".join(
        f"{k} {v['ms']:.4f} / {v['plain_ms']:.4f} ({v['launches']} launches)"
        for k, v in gp.items()), t)

    t = time.perf_counter()
    mc, run_s, launches = run_counted(mc, 25, field_thinning=0.5)
    est = nngp_tpu_torch.estimate(mc)
    for rec in mc.records:
        if rec["log_scale"].shape[0] != 25 or rec["field"].shape != (12, mc.graph.n):
            raise RuntimeError("records do not hold 25 iterations")
    tab = est["covariance_params"]["GpGp_covparams"]
    if not np.isfinite(tab["table"]).all():
        raise RuntimeError("non-finite covariance estimates")
    factor_launches = run_counted.factor_launches
    fr_main_launches = run_counted.factor_rows_launches
    draw_launches = run_counted.draw_launches
    solve_launches = run_counted.solve_launches
    phase("main path", f"run 25 iterations x 3 chains: {run_s:.3f} s = "
          f"{1e3 * run_s / 25:.2f} ms/iteration (cold), sweep kernel "
          f"launches {launches}, factor build launches {factor_launches} "
          f"(K-input factor rows {fr_main_launches}), chain_draws launches "
          f"{draw_launches}, level solve launches {solve_launches}", t)
    print("  GpGp_covparams " + json.dumps(
        {nm: [round(float(v), 6) for v in row]
         for nm, row in zip(tab["names"], tab["table"])}) + f" columns {tab['columns']}")

    t = time.perf_counter()
    mc, warm_s, _ = run_counted(mc, 25, field_thinning=0.5, verbose=False)
    phase("warm cycle", f"25 more iterations: {1e3 * warm_s / 25:.2f} "
          f"ms/iteration, iterations now {mc.iterations}", t)

    t = time.perf_counter()
    rng = np.random.default_rng(7)
    lo, hi = mc.locs.min(0), mc.locs.max(0)
    new = rng.uniform(lo, hi, size=(N_PREDICT, 2))
    pred = nngp_tpu_torch.predict_field(mc, new, m=10)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t
    Xp = {f"x{j}": rng.normal(size=N_PREDICT) for j in range(14)}
    fe = nngp_tpu_torch.predict_fixed_effects(mc, Xp, add_intercept=True)
    n_kept = len(pred["predicted_field_samples"][0])
    for s_ in pred["predicted_field_samples"]:
        if s_.shape != (n_kept, N_PREDICT) or not np.isfinite(s_).all():
            raise RuntimeError("predict_field: bad or non-finite samples")
    for out, key in ((pred, "predicted_field_summary"),
                     (fe, "predicted_fixed_effects_summary")):
        tab = out[key]["table"]
        if tab.shape != (N_PREDICT, 5) or not np.isfinite(tab).all():
            raise RuntimeError(f"{key}: shape {tab.shape} or non-finite")
    err = predict_parity(dev)
    phase("predict", f"predict_field at {N_PREDICT} new sites, m = 10, "
          f"{mc.n_chains} x {n_kept} retained samples: {pred_s:.3f} s; "
          f"predict_fixed_effects 14 columns ok; card vs CPU at 400 sites, "
          f"same samples and z: scaled max diff {err:.3e} <= {PARITY_TOL}", t)

    t = time.perf_counter()
    back, save_s, load_s, size = save_load(mc, dev)
    back, resume_s, resume_launches = run_counted(back, 25, field_thinning=0.5,
                                                  verbose=False)
    phase("save/load", f"save {save_s:.3f} s ({size / 2**20:.1f} MiB), "
          f"load on the card {load_s:.3f} s, states and records bit for bit; "
          f"resumed 25 iterations ({1e3 * resume_s / 25:.2f} ms/iteration, "
          f"sweep kernel launches {resume_launches}), iterations "
          f"{mc.iterations} -> {back.iterations}", t)
    del back

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        ex = {name: (s, secs, n) for name, s, secs, n in examples(td)}
    hm, hm96, an = (ex[k][0] for k in ("heavy_metals", "heavy_metals_96",
                                       "heavy_metals_analysis"))
    if hm["n_sites"] != mc.graph.n or hm96["n_sites"] != mc.graph.n \
            or hm96["n_chains"] != 96:
        raise RuntimeError(f"examples: heavy_metals at {hm['n_sites']} sites,"
                           f" heavy_metals_96 at {hm96['n_sites']} sites and "
                           f"{hm96['n_chains']} chains, not {mc.graph.n}")
    ex_launches = sum(n for _, _, n in ex.values())
    phase("examples", f"six examples through main() on the card: "
          f"heavy_metals {hm['n_sites']} sites x 3 chains "
          f"{hm['ms_per_iteration']:.2f} ms/iteration, heavy_metals_96 x 96 "
          f"chains {hm96['ms_per_iteration']:.2f}, heavy_metals_analysis "
          f"predict_field at {an['grid_sites']} grid sites "
          f"{an['predict_s']:.3f} s; " + ", ".join(
              f"{k} {secs:.1f} s" for k, (_, secs, _) in ex.items())
          + f"; sweep kernel launches {ex_launches}, one an iteration", t)

    t = time.perf_counter()
    mm = nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="matern_sphere",
        n_chains=3, seed=1, device=dev, verbose=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    card, oracle = matern_logdet(mm)
    if not abs(card - oracle) <= LOGDET_TOL:
        raise RuntimeError(f"Matérn proposal log-det difference: card {card} "
                           f"vs float64 {oracle}, error {card - oracle:.3e} "
                           f"> {LOGDET_TOL}")
    mm, m_run_s, m_launches = run_counted(mm, 25, field_thinning=0.5,
                                          verbose=False)
    m_tab = nngp_tpu_torch.estimate(mm)["covariance_params"]["GpGp_covparams"]
    if "smoothness" not in m_tab["names"] or not np.isfinite(
            m_tab["table"]).all():
        raise RuntimeError(f"Matérn estimate: {m_tab['names']} "
                           f"{m_tab['table']}")
    phase("matern", f"matern_sphere n={mm.graph.n}, 3 chains: initialize "
          f"{init_s:.3f} s; proposal log-det difference card {card:.6f} vs "
          f"float64 {oracle:.6f}, error {card - oracle:.3e} <= {LOGDET_TOL}; "
          f"run 25 iterations {1e3 * m_run_s / 25:.2f} ms/iteration (cold; "
          f"exponential {1e3 * run_s / 25:.2f}), sweep kernel launches "
          f"{m_launches}", t)
    print("  GpGp_covparams " + json.dumps(
        {nm: [round(float(v), 6) for v in row]
         for nm, row in zip(m_tab["names"], m_tab["table"])}))

    t = time.perf_counter()
    fr, fr_logdiag = factor_rows(mc, mm)
    fb, fb_logdiag = factor_build(mc, mm)
    ns = near_singular(dev)
    del mm
    torch.cuda.empty_cache()
    phase("factor rows", "K-input kernel within "
          f"{FACTOR_TOL_REL:g} relative of its twin at " + ", ".join(
              f"{k} ({v['ms']:.4f} ms, twin {v['plain_ms']:.3f}, library "
              f"{v['library_ms']:.3f}, bound {v['bound_ms']:.4f})"
              for k, v in fr.items())
          + "; log-diagonal within " + ", ".join(
              f"{e:.3e} <= {b:.3e}" for _, e, _, b in fr_logdiag)
          + "; fused build within its tolerance of its twin at " + ", ".join(
              f"{k} ({v['ms']:.4f} ms, twin {v['plain_ms']:.3f}, library "
              f"{v['library_ms']:.3f}, bound {v['bound_ms']:.4f} by "
              f"{v['bound_by']}, {v['differ']} elements differ)"
              for k, v in fb.items())
          + "; log-diagonal vs float64 correlations within " + ", ".join(
              f"{e:.3e} <= {b:.3e}" for _, e, _, b in fb_logdiag)
          + "; Matérn near singular, log-det error vs float64 " + ", ".join(
              f"{f} {e:.3e}" for f, (e, _, _) in ns.items())
          + f" <= {NEAR_SINGULAR_LOGDET:g}", t)

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        dg = diagnostics(mc, td)
    cv = dg["hm_crossval"][0]
    phase("diagnostics", "five scripts by python -m at once: " + ", ".join(
        f"{k} {secs:.1f} s" for k, (_, secs) in dg.items())
        + f"; grb_guard A diff {dg['grb_guard'][0]['A_well_conditioned']['abs_diff']:.2e}, "
        f"hm_mpsrf MPSRF {dg['hm_mpsrf'][0]['mpsrf_ours']}, hm_crossval "
        f"{cv['engine_iters']} engine iterations (kernel launches "
        f"{cv['kernel_launches']}), am_ab " + ", ".join(
            f"{r['arm']} {r['ms_per_iteration']:.1f} ms/iteration"
            for r in dg["am_ab"][0]["rows"])
        + f", halo table overlap {dg['halo_overhead_table'][0]['overlap_fraction']}", t)

    t = time.perf_counter()
    differ, total = determinism(dev, locs, y, X)
    if differ:
        raise RuntimeError(f"determinism: {differ} of {total} elements "
                           "differ between two runs from one seed")
    phase("determinism", f"initialize -> run 10 iterations twice from seed 1, "
          f"n={mc.graph.n}, 3 chains: {differ} of {total} state and record "
          "elements differ", t)

    t = time.perf_counter()
    e_launches, e_chains, e_iters = entry_run()
    phase("entry", f"entry(): {e_iters} iterations x {e_chains} chains of the "
          f"96-site toy on the card, records finite, sweep kernel launches "
          f"{e_launches}", t)

    with tempfile.TemporaryDirectory() as td:
        t = time.perf_counter()
        differ, total, mesh_s, plain_s, mesh_launches, grb_err = \
            chains_mesh_parity(mc, dev, td)
        if differ or grb_err > 1e-10:
            raise RuntimeError(f"chains mesh: {differ} of {total} elements "
                               f"differ; collective_grb vs host relative "
                               f"difference {grb_err:.3e}")
        phase("chains mesh", f"one-rank NCCL mesh, n={mc.graph.n}, "
              f"{mc.n_chains} chains, K = 1, 25 iterations: run(mesh=) "
              f"{1e3 * mesh_s / 25:.2f} ms/iteration (sweep kernel launches "
              f"{mesh_launches}), run() {1e3 * plain_s / 25:.2f}; {differ} of "
              f"{total} state and record elements differ; collective_grb "
              f"over NCCL vs host R-hat: largest relative difference "
              f"{grb_err:.3e} <= 1e-10", t)

        t = time.perf_counter()
        ranks, differ, total = two_ranks(dev, locs, y, X, td)
        phase("two ranks", "resume of a 6-chain fit, 25 iterations, "
              f"n={mc.graph.n}, gloo on one card: " + "; ".join(
                  f"{name}: " + ", ".join(f"{r['ms_per_iteration']:.2f}"
                                          for r in rs) + " ms/iteration"
                  for name, rs in ranks.items())
              + "; the ranks agree on R-hat and digest, the second 2-rank "
              "launch gives the same digest "
              f"{ranks['2 x 3'][0]['digest'][:12]}; 2 x 3 holds 1 x 6's "
              f"records of the first {FIRST_ITERS} iterations (log_scale "
              "rtol 1e-5, field rtol = atol = 1e-4); after 25 iterations "
              f"{differ} of {total} state elements differ (1 x 6 digest "
              f"{ranks['1 x 6'][0]['digest'][:12]})", t)

        t = time.perf_counter()
        step_launches, steps, step_err, step_tol = halo_steps(mc)
        print(f"  D = 2 owned sub-plans, every colour step of 10 sweeps on "
              f"one field ({steps} nonempty steps a sweep, "
              f"{step_launches} launches): bit for bit with one launch of "
              f"the whole plan; max abs diff against plain {step_err:.3e} "
              f"<= tol {step_tol:.3e}", flush=True)
        differ, total, halo_s, plain_s, halo_launches, plain_launches = \
            halo_one_rank(dev, td)
        if differ:
            raise RuntimeError(f"halo: {differ} of {total} elements differ "
                               "between a 1 x 1 mesh run and run()")
        print(f"  1 x 1 NCCL mesh, 25 iterations: {differ} of {total} state "
              f"and record elements differ from run(); sweep kernel "
              f"launches {halo_launches} (run(): {plain_launches}); "
              f"{1e3 * halo_s / 25:.2f} ms/iteration (run(): "
              f"{1e3 * plain_s / 25:.2f})", flush=True)
        ranks, worst, plain_ms = halo_two_ranks(dev, td)
        print("  1 x 2 gloo sites ranks on one card, 10 iterations: " +
              "; ".join(f"rank {r['rank']} {r['ms_per_iteration']:.2f} "
                        f"ms/iteration, {r['exchanges_per_iteration']:.1f} "
                        f"exchanges and "
                        f"{r['exchange_bytes_per_iteration'] / 2**20:.3f} MiB"
                        f" sent an iteration, {r['sweep_launches']} sweep "
                        f"kernel launches" for r in ranks)
              + f"; overlap {100 * ranks[0]['overlap']:.2f} %; run() "
              f"{plain_ms:.2f} ms/iteration; same digest "
              f"{ranks[0]['digest'][:12]}; largest scaled state difference "
              f"{worst:.3e} <= {HALO_TOL}", flush=True)
        from nngp_tpu_torch.parallel.halo import halo_plan_check

        big = halo_plan_check()
        phase("halo", f"D = 2 sub-plan steps bit for bit with the whole "
              f"launch; 1 x 1 NCCL: {differ} elements differ, "
              f"{halo_launches} launches in 25 iterations; 1 x 2 gloo: "
              f"scaled state difference {worst:.3e}; plan at "
              f"{big['n']}/D={big['D']}: overlap {100 * big['overlap']:.2f} "
              f"% < 10 % (graph {big['graph_s']:.2f} s, plan "
              f"{big['plan_s']:.2f} s)", t)

    t = time.perf_counter()
    result, legs, bench_launches = bench_legs(dev)
    check_bench_line(result)
    want = 1 + sum(e["warmup_iters"] + e["iters"] for e in legs.values())
    if bench_launches != want:
        raise RuntimeError(f"bench: the sweep kernel launched "
                           f"{bench_launches} times, expected {want}")
    d = result["detail"]
    phase("bench", f"preflight max abs diff "
          f"{d['sweep_parity_preflight']['max_abs_diff']:.3e} ok; "
          + "; ".join(f"{name}: {e['n_chains']} chains K={e['covparams_steps']}"
                      f" {1e3 / e['it_per_s']:.2f} ms/iteration, ESS/s "
                      f"range {e['ess_per_s']['range']:.4f} field "
                      f"{e['ess_per_s']['field_mean']:.4f}, window R-hat "
                      f"{e['rhat_timed_window']}" for name, e in legs.items())
          + f"; baseline {d['r_equiv_it_per_s']:.4f} it/s; headline "
          f"{result['value']} ESS/s, vs_baseline {result['vs_baseline']}; "
          f"sweep kernel launches {bench_launches}", t)
    print("  " + json.dumps(result))

    t = time.perf_counter()
    vecchia.linv_rows_from_K.launches = 0
    rows, secs = audits(dev, locs, y, X)
    fr_launches = vecchia.linv_rows_from_K.launches
    phase("audits", f"{len(rows)} figures within max({AUDIT_FACTOR:g} x the "
          f"JAX CPU figure, {AUDIT_FLOOR:g}), the factor's log-diagonal "
          f"errors within {FACTOR_LOGDIAG:g} x; K-input factor rows "
          f"launches {fr_launches} (the same-K figures); seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), t)

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        big, bk, prof = big_n(dev, td, BIGN_SITES)
    solve = prof["blocks"]["level_solve"]
    phase("bigN", f"n={big['n']}, 3 chains: setup {big['setup_s']} s "
          + json.dumps(big["setup_timings"]) + f", first cycle "
          f"{big['compile_s']} s, {big['ms_per_iter']} ms/iteration "
          f"({big['it_per_s']} it/s), sweep kernel launches "
          f"{big['k1_launches']}; colours {big['colours']}, level rows "
          f"{big['level_rows']}, largest degree {big['max_degree']}, graph "
          f"{big['graph_device_bytes'] / 2**20:.1f} MiB on the card, peak "
          f"allocated {big['max_memory_allocated'] / 2**30:.2f} GiB; "
          f"{bk['shape']}: kernel {bk[3]['ms']:.4f} ms, plain "
          f"{bk[3]['plain_ms']:.3f} ms; profile: bare loop "
          f"{prof['loop_ms']:.2f} ms/iteration, traced "
          f"{prof['traced_ms']:.2f}, level solve {solve['host_ms']:.2f} ms "
          f"host = {100 * solve['host_ms'] / prof['traced_ms']:.1f} %, "
          "card idle "
          + ("not measured" if prof["idle_share"] is None
             else f"{100 * prof['idle_share']:.1f} %"), t)
    print("  " + json.dumps(prof), flush=True)

    print(json.dumps({"kernels": [{
        "name": "chromatic_sweeps", "route": "cuda",
        "source": "nngp_tpu_torch/csrc/chromatic_sweep.cu",
        "replaces": "nngp_tpu/ops/pallas_sweep.py:159",
        "launches": launches + ex_launches + big["k1_launches"],
        "max_abs_err": max(kv["max_abs_err"], bk["max_abs_err"]),
        "ms": kv[3]["ms"], "plain_ms": kv[3]["plain_ms"],
        "bound_ms": kv[3]["bound_ms"], "bound_by": kv[3]["bound_by"],
        "floor_ms": kv[3]["barriers_ms"], "library_ms": None,
        "96_chains": {k: kv[96][k] for k in (
            "ms", "bound_ms", "bound_by", "barriers_ms")},
        "halo": f"halo mode launches it once a colour step a rank: "
                f"{halo_launches} launches in 25 iterations of a 1 x 1 mesh",
        "examples": f"launches: {launches} on the main path, "
                    f"{ex_launches} in the examples phase and "
                    f"{big['k1_launches']} in the bigN phase",
        "bigN": {"n": big["n"], "chains": 3, **{
            k: bk[3][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "floor_ms": bk[3]["barriers_ms"]}}
        ] + [{
        "name": "factor_build", "route": "cuda",
        "source": "nngp_tpu_torch/csrc/factor_rows.cu",
        "replaces": "nngp_tpu/ops/vecchia.py:116 (vecchia_linv: the "
                    "correlation, covariance.py:145, and the rows :83, "
                    "fused by XLA under nngp_tpu/models/gaussian.py:805's "
                    "jit; not a Pallas kernel)",
        "launches": factor_launches,
        **{k: fb["exponential_sphere 3 chains"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "96_chains": {k: fb["exponential_sphere 96 chains"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "matern_sphere": {k: fb["matern_sphere 3 chains"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "matern_precision": "float64 inside, rows rounded once to float32; "
                            "bound at 34 TFLOP/s",
        "near_singular_logdet_err": {f: e for f, (e, _, _) in ns.items()}}
        ] + [{
        "name": "factor_rows", "route": "cuda",
        "source": "nngp_tpu_torch/csrc/factor_rows.cu",
        "replaces": "nngp_tpu/ops/vecchia.py:83 (linv_rows_from_K, fused "
                    "by XLA under nngp_tpu/models/gaussian.py:805's jit; "
                    "not a Pallas kernel)",
        "launches": fr_main_launches,
        "audits_launches": fr_launches,
        **{k: fr["exponential_sphere 3 chains"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "96_chains": {k: fr["exponential_sphere 96 chains"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")},
        "matern_sphere": {k: fr["matern_sphere 3 chains"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}}
        ] + [{
        "name": "chain_draws", "route": "cuda",
        "source": "nngp_tpu_torch/csrc/chain_draws.cu",
        "replaces": "nngp_tpu/api.py:599 (the per-chain keys fold_in("
                    "fold_in(key(seed), iter_start), i) under "
                    "jax.random.normal/uniform in nngp_tpu/models/"
                    "gaussian.py; XLA's threefry, not a Pallas kernel)",
        "launches": draw_launches,
        **{k: dr[3][k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")},
        **{k: dr[3][k] for k in ("device_ms", "bytes_ms", "f64_floor_ms",
                                 "issue_floor_ms", "tile_calls",
                                 "max_sm_clock_mhz")},
        "96_chains": {k: dr[96][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "bytes_ms", "f64_floor_ms", "issue_floor_ms",
            "tile_calls", "max_sm_clock_mhz")},
        "sass_per_normal_call": {f"kernel<{c}>": v
                                 for c, v in dr["sass"].items()},
        "sincos_differ": dr["sincos_differ"],
        "cpu_twin": {C: {k: dr[C][k] for k in (
            "cpu_differ", "cpu_normals", "cpu_max_ulps")}
            for C in DRAW_CHAINS}}
        ] + [{
        "name": "level_solve", "route": "cuda",
        "source": "nngp_tpu_torch/csrc/level_solve.cu",
        "replaces": "nngp_tpu/ops/trisolve.py:level_solve (a fori_loop "
                    "over level_segs under nngp_tpu/models/gaussian.py's "
                    "jit; XLA, not a Pallas kernel)",
        "launches": solve_launches,
        **{k: ls[3][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "floor_ms", "share",
            "floor_share", "f64_max_diff", "twin_bits", "steps")},
        "96_chains": {k: ls[96][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "floor_ms", "share",
            "floor_share", "f64_max_diff", "twin_bits")}}
        ] + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **gp[name]} for name, src, rep in GATHER_KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
