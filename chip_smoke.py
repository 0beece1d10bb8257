#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nngp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its result and time; any failure ends the run
with a nonzero exit and no "ok" line:

  1. device       the card's name and power limit (nvidia-smi)
  2. build        nvcc builds the three CUDA sources of csrc/, all at once
  3. small parity 3 Gibbs iterations of a 400-site problem on the card
                  against the same iterations on the CPU (whose path the
                  tests hold against nngp_tpu), same injected draws
  4. initialize   the Heavy-metals configuration at full width: 64,274
                  synthetic lon/lat sites, 14 location covariates,
                  exponential_sphere, m = 5, 3 chains, seed 1
  5. kernel       the sweep kernel against its plain PyTorch version on
                  that graph (3 chains, 10 sweeps), zero and injected
                  noise, tolerance 2e-3 * max(1, |w|_inf); median times
  6. gather probes the four kernels of the gather microbenchmarks
                  (nngp_tpu_torch/experiments: X1 gather_bench, X2
                  gather_probe, X3 gather_probe2) at the scripts' full
                  shapes, each against its plain PyTorch twin: the DSMEM
                  sweep within 1e-5 * max(1, |w|_inf) at every cluster
                  size, gathers/roll/transpose/scatter exactly, the matmul
                  within 1e-5 * max(1, |C|_inf) at the probe's shape and at
                  shapes that cross every tile edge, its repeat calls bit
                  for bit; the matmul and cuBLAS FP32 timed at 2048 x 512 x
                  2048; then the three entry points, with each kernel's
                  launch count from that run
  7. main path    run (1 cycle x 25 iterations, field thinning 0.5) and
                  estimate, with the kernel's launch count from that run
                  only; then 25 more iterations to time a warm cycle

The line before last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}.  Needs no network and imports no jax.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

TOL_REL = 2e-3      # kernel against plain: 2e-3 * max(1, |w|_inf)
PARITY_TOL = 1e-3   # card against CPU after 3 iterations, same scaling
# X1 kernel against plain: float32 neighbour sums in another order and
# rsqrtf, through 600 dependent steps of a linear map whose field grows to
# ~6e14, so the error is held relative to |w|_inf
X1_TOL_REL = 1e-5
MM_TOL_REL = 1e-5   # matmul against plain: 1e-5 * max(1, |C|_inf)
# (M, K, N) across every edge of the matmul's 64 x 128 x 32 tiles
MM_RAGGED = ((1, 4, 4), (65, 1028, 132), (512, 1024, 128), (130, 36, 260),
             (2048, 512, 2048))


def phase(name, msg, t0):
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.3f} s)", flush=True)


def small_parity(dev):
    """3 iterations on the card against the CPU, same draws."""
    import numpy as np
    import torch

    import nngp_tpu_torch
    from nngp_tpu_torch.models import gaussian as G
    from nngp_tpu_torch.ops.covariance import shape_transform
    from nngp_tpu_torch.ops.vecchia import vecchia_linv
    from nngp_tpu_torch.utils.datasets import synthetic_heavy_metals

    locs, y, X = synthetic_heavy_metals(n=400, p=2, seed=5)
    kw = dict(X_locs=X, m=5, stationary_covfun="exponential_sphere",
              n_chains=2, seed=3, verbose=False)
    runs = {}
    for d in ("cpu", dev):
        mc = nngp_tpu_torch.initialize(locs, y, device=d, **kw)
        cfg = G.UpdateConfig(
            n_iterations=3,
            shape_names=tuple(mc.space_time_model["covfun"]["shape_params"]),
            locs_cols=tuple(int(c) for c in mc.design.locs_cols))
        gen = torch.Generator().manual_seed(11)
        st = mc.states
        carry = (st, vecchia_linv(mc.graph, shape_transform(cfg.shape_names,
                                                            st.shape)),
                 torch.zeros(2, device=d), torch.zeros(2, device=d))
        for it in range(3):
            draws = G.IterationDraws.draw(gen, cfg, 2, mc.graph.n,
                                          st.beta.shape[1], "cpu")
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


def kernel_vs_plain(mc):
    """The sweep kernel against its plain version at the main path's shapes."""
    import torch

    from nngp_tpu_torch.models import gaussian as G
    from nngp_tpu_torch.ops import sweep
    from nngp_tpu_torch.experiments.timing import median_ms
    from nngp_tpu_torch.ops.covariance import shape_transform
    from nngp_tpu_torch.ops.vecchia import vecchia_linv

    g, st = mc.graph, mc.states
    names = mc.space_time_model["covfun"]["shape_params"]
    linv = vecchia_linv(g, shape_transform(names, st.shape))
    mu = G._mu_obs(mc.data, st, g)
    q, P, rs, scal = G.sweep_inputs(g, mc.data, st, linv, mu)
    C, n, S = st.field.shape[0], g.n, 10
    w0 = torch.cat([st.field, st.field.new_zeros(C, 1)], 1)
    tables = (g.color_ptr, g.color_sites, g.nbr_sites, g.nbr_edge)
    gen = torch.Generator(device=w0.device).manual_seed(0)
    out = {"max_abs_err": 0.0}
    for label, noise in (("zero noise", torch.zeros(C, S, n, device=w0.device)),
                         ("injected noise", torch.randn(C, S, n, generator=gen,
                                                        device=w0.device))):
        got = sweep.chromatic_sweeps_cuda(w0.clone(), q, P, rs, noise, scal,
                                          *tables)
        want = sweep.chromatic_sweeps_reference(w0.clone(), q, P, rs, noise,
                                                scal, *tables)
        torch.cuda.synchronize()
        diff = (got - want)[:, :n].abs()
        mx, rms = diff.max().item(), diff.pow(2).mean().sqrt().item()
        tol = TOL_REL * max(1.0, want[:, :n].abs().max().item())
        ok = bool(torch.isfinite(got).all()) and mx <= tol
        print(f"  {label}: max abs diff {mx:.3e}, rms {rms:.3e}, "
              f"tol {tol:.3e} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"kernel disagrees with plain version ({label})")
        out["max_abs_err"] = max(out["max_abs_err"], mx)
    w = w0.clone()
    out["ms"] = median_ms(lambda: sweep.chromatic_sweeps_cuda(
        w, q, P, rs, noise, scal, *tables), reps=21,
        setup=lambda: w.copy_(w0))
    out["plain_ms"] = median_ms(lambda: sweep.chromatic_sweeps_reference(
        w, q, P, rs, noise, scal, *tables), reps=5,
        setup=lambda: w.copy_(w0))
    out["shape"] = f"C={C} S={S} n={n} colors={g.n_colors} D={g.nbr_sites.shape[1]}"
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
    err["gather_sweeps"] = max(
        held(f"X1 gather_sweeps cluster {cs}",
             gather_ops.gather_sweeps(t["w0"].clone(), *args, cluster=cs),
             want, tol)
        for cs in gather_ops.CLUSTERS)
    for mod, arrays in ((gather_probe, data.probe_arrays()),
                        (gather_probe2, data.probe2_arrays())):
        for p in mod.probes(data.to_device(arrays, dev)):
            want = p.plain(*p.args)
            tol = (MM_TOL_REL * max(1.0, want.abs().max().item())
                   if p.op is gather_ops.matmul_f32 else 0.0)
            name = p.op.__name__
            err[name] = max(err.get(name, 0.0),
                            held(f"{mod.__name__.rsplit('.', 1)[1]}: "
                                 f"{p.name}", p.op(*p.args), want, tol))
    matmul_checks(dev)
    torch.cuda.synchronize()

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
    out["gather_sweeps"].update(ms=x1[gather_ops.CLUSTER],
                                plain_ms=x1["plain_ms"])
    for name in ("staged_gather", "column_scatter", "matmul_f32"):
        rows = [r for r in probes if r["op"] == name]
        out[name].update(ms=sum(r["ms"] for r in rows),
                         plain_ms=sum(r["plain_ms"] for r in rows))
    return out


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
    from nngp_tpu_torch.ops import _build, sweep
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
            "gather_sweep": gather_ops._sweep_library,
            "gather_probes": gather_ops._probe_library}
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source
        for f in [pool.submit(build) for build in libs.values()]:
            f.result()
    for name in libs:
        ptxas = [l.strip() for l in _build.build_log(name).splitlines()
                 if "registers" in l or "spill" in l]
        print(f"  {name}.cu -> sm_90a: " + " | ".join(ptxas))
    phase("build", f"{len(libs)} sources built in parallel", t)

    t = time.perf_counter()
    worst = small_parity(dev)
    phase("small parity", f"3 iterations, 400 sites, 2 chains: scaled max "
          f"diff card vs CPU {worst:.3e} <= {PARITY_TOL}", t)

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
    phase("kernel", f"{kv['shape']}: kernel {kv['ms']:.3f} ms, plain "
          f"{kv['plain_ms']:.3f} ms (median)", t)

    t = time.perf_counter()
    gp = gather_probes(dev)
    phase("gather probes", "kernel / plain ms: " + ", ".join(
        f"{k} {v['ms']:.4f} / {v['plain_ms']:.4f} ({v['launches']} launches)"
        for k, v in gp.items()), t)

    t = time.perf_counter()
    sweep.chromatic_sweeps.launches = 0
    mc = nngp_tpu_torch.run(mc, n_cycles=1, n_iterations_update=25,
                            field_thinning=0.5)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = sweep.chromatic_sweeps.launches
    est = nngp_tpu_torch.estimate(mc)
    if launches < 25:
        raise RuntimeError(f"the main path launched the sweep kernel "
                           f"{launches} times in 25 iterations")
    for f in ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
              "field", "tk_ancillary", "tk_sufficient"):
        if not bool(torch.isfinite(getattr(mc.states, f)).all()):
            raise RuntimeError(f"non-finite {f} after run")
    for rec in mc.records:
        if rec["log_scale"].shape[0] != 25 or rec["field"].shape != (12, mc.graph.n):
            raise RuntimeError("records do not hold 25 iterations")
    tab = est["covariance_params"]["GpGp_covparams"]
    if not np.isfinite(tab["table"]).all():
        raise RuntimeError("non-finite covariance estimates")
    phase("main path", f"run 25 iterations x 3 chains: {run_s:.3f} s = "
          f"{1e3 * run_s / 25:.2f} ms/iteration (cold), sweep kernel "
          f"launches {launches}", t)
    print("  GpGp_covparams " + json.dumps(
        {nm: [round(float(v), 6) for v in row]
         for nm, row in zip(tab["names"], tab["table"])}) + f" columns {tab['columns']}")

    t = time.perf_counter()
    mc = nngp_tpu_torch.run(mc, n_cycles=1, n_iterations_update=25,
                            field_thinning=0.5, verbose=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    phase("warm cycle", f"25 more iterations: {1e3 * warm_s / 25:.2f} "
          f"ms/iteration, iterations now {mc.iterations}", t)

    print(json.dumps({"kernels": [{
        "name": "chromatic_sweeps", "route": "cuda",
        "source": "nngp_tpu_torch/csrc/chromatic_sweep.cu",
        "replaces": "nngp_tpu/ops/pallas_sweep.py:159",
        "launches": launches, "max_abs_err": kv["max_abs_err"],
        "ms": kv["ms"], "plain_ms": kv["plain_ms"]}] + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **gp[name]} for name, src, rep in GATHER_KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
