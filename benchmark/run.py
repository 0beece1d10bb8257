"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell's data is made from the seed; ``nngp_tpu_torch.initialize`` and a
warm-up cycle at the cell's chains and K are the set-up (``setup_s``); the
window is whole ``nngp_tpu_torch.run`` calls of one cycle each, from the
first call to the one in progress when ``--seconds`` have passed, and
``chain_iters_per_s`` is every chain-iteration they completed over their
wall time.  ``--trace 1`` runs the same window with torch.profiler over its
first cycle and reports the per-layer metrics instead.  After the window
the plain reference (``reference/``) decides ``correct``.  The last line of
standard output is the result as one JSON object; the numbers compared,
each with its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

from benchmark import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "nngp_tpu")


def _caches():
    """Every compile cache at a fixed path inside the checkout."""
    base = os.path.join(registry.HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def leaked_modules():
    """Loaded modules whose whole top-level name is JAX's or nngp_tpu's."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _host(states) -> dict:
    """A chain state's leaves as float64 NumPy arrays (None kept)."""
    from dataclasses import fields

    return {f.name: (None if getattr(states, f.name) is None else
                     getattr(states, f.name).detach().double().cpu().numpy())
            for f in fields(states)}


def record_columns(cfg, tr):
    rng = np.random.default_rng(int(tr["field_columns_seed"]))
    return np.sort(rng.choice(int(cfg["n_sites"]), int(tr["field_columns"]),
                              replace=False))


def _cycle_records(mc, row0, frow0, T, n_saved):
    """{leaf: [T, C, ...]} and "field" [n_saved, C, w] of the cycle whose
    first record rows are ``row0`` and ``frow0`` (field)."""
    keys = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape")
    out = {k: np.stack([np.asarray(r[k][row0:row0 + T]) for r in mc.records],
                       1) for k in keys}
    out["field"] = np.stack([np.asarray(r["field"][frow0:frow0 + n_saved])
                             for r in mc.records], 1)
    return out


def _failed(mc, row0, frow0, T, n_saved):
    """Chain-iterations of the cycle from record rows ``row0`` and
    ``frow0`` whose chain recorded a non-finite value in it."""
    bad = 0
    for r in mc.records:
        vals = [np.asarray(r[k][row0:row0 + T]) for k in
                ("beta_0", "beta", "log_scale", "log_noise_variance",
                 "shape")]
        vals.append(np.asarray(r["field"][frow0:frow0 + n_saved]))
        if not all(np.isfinite(v).all() for v in vals):
            bad += T
    return bad


def _colours(graph) -> np.ndarray:
    ptr = graph.color_ptr.cpu().numpy()
    sites = graph.color_sites.cpu().numpy()
    out = np.empty(len(sites), dtype=np.int64)
    for c in range(len(ptr) - 1):
        out[sites[ptr[c]:ptr[c + 1]]] = c
    return out


def host_pace() -> dict:
    """What a run can read of its host's pace: CPU seconds of the process
    and of its main thread, involuntary context switches, garbage
    collections."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime,
            "thread_cpu_s": time.thread_time(), "nivcsw": ru.ru_nivcsw,
            "gc": sum(g["collections"] for g in gc.get_stats())}


def cpu_mhz() -> list:
    """The host's cores' clocks as /proc/cpuinfo reads them (empty where it
    cannot be read)."""
    try:
        with open("/proc/cpuinfo") as f:
            return [float(ln.split(":")[1]) for ln in f
                    if ln.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return []


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False) -> dict | None:
    """One run of the cell ``spec`` (``registry.cell``): the result, or None
    when a forbidden module was loaded.  ``control`` adds the control's
    readings of the same comparisons (``reference.check.control_gaps``)
    under "control"."""
    import torch

    import nngp_tpu_torch as nt
    from benchmark.data import heavy_metals
    from benchmark.reference import check, model, setup
    from benchmark.trace import TracedRun, breakdown, events_of, union_s

    cfg, tr, chk = spec["config"], spec["traffic"], spec["check"]
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    covfun = cfg["stationary_covfun"]
    C, K, T = int(tr["n_chains"]), int(tr["covparams_steps"]), int(
        cfg["n_iterations_update"])
    cols = record_columns(cfg, tr)
    n_saved = len(check.saved_iterations(T, float(cfg["field_thinning"])))

    t = time.perf_counter()
    data = heavy_metals.make(cfg, seed)
    _log(f"data: {len(data['observed_field'])} observations made in "
         f"{time.perf_counter() - t:.3f} s (not part of setup_s)")

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mc = nt.initialize(data["observed_locs"], data["observed_field"],
                       X_locs=data["X_locs"], m=int(cfg["m"]),
                       stationary_covfun=covfun, n_chains=C, seed=seed,
                       device=device, verbose=False)
    init_states = _host(mc.states)
    knobs = dict(n_cycles=1, field_thinning=float(cfg["field_thinning"]),
                 n_chromatic=int(tr["n_chromatic"]), covparams_steps=K,
                 field_record_columns=cols,
                 compute_diagnostics=bool(tr["diagnostics"]),
                 Gelman_Rubin_Brooks_stop=(0.0, 0.0), verbose=False)
    nt.run(mc, n_iterations_update=int(tr["warmup_iterations"]), **knobs)
    sync()
    setup_s = time.perf_counter() - t0

    calls, traced_wall, prof, cycle_cpu = [], None, None, []
    mhz0, pace0 = cpu_mhz(), host_pace()
    t_start = time.perf_counter()
    while True:
        s0, start = mc.states, mc.iterations
        row0, frow0 = (len(mc.records[0][k]) for k in ("beta_0", "field"))
        if trace and not calls:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
            with profile(activities=acts) as prof:
                t1 = time.perf_counter()
                nt.run(mc, n_iterations_update=T, **knobs)
                sync()
                traced_wall = time.perf_counter() - t1
        else:
            nt.run(mc, n_iterations_update=T, **knobs)
        calls.append((row0, frow0))
        cycle_cpu.append(time.thread_time())
        last = (s0, start, row0, frow0)
        del s0
        if time.perf_counter() - t_start >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t_start
    ends = [t for _, t in mc.records[0]["iterations"][-len(calls) - 1:]]
    _log("window: %d cycles of %d iterations, seconds each %s" % (
        len(calls), T, [round(b - a, 3) for a, b in zip(ends, ends[1:])]))
    pace, mhz = host_pace(), cpu_mhz() + mhz0
    cpu = [pace0["thread_cpu_s"]] + cycle_cpu
    _log("host pace: window %.3f s; main thread CPU %.3f s (each cycle %s), "
         "process CPU %.3f s; %d involuntary context switches; %d garbage "
         "collections; load %s; %d cores allowed; core clocks %s MHz" % (
             window_s, pace["thread_cpu_s"] - pace0["thread_cpu_s"],
             [round(b - a, 3) for a, b in zip(cpu, cpu[1:])],
             pace["cpu_s"] - pace0["cpu_s"], pace["nivcsw"] - pace0["nivcsw"],
             pace["gc"] - pace0["gc"], [round(v, 2) for v in os.getloadavg()],
             len(os.sched_getaffinity(0)),
             [round(min(mhz)), round(max(mhz))] if mhz else "unread"))

    leaked = leaked_modules()
    if leaked:
        _log(f"forbidden modules loaded: {leaked}")
        return None
    attempted = len(calls) * T * C
    failed = sum(_failed(mc, r0, f0, T, n_saved) for r0, f0 in calls)
    s0, start, row0, frow0 = last
    state0 = _host(s0)
    recs = _cycle_records(mc, row0, frow0, T, n_saved)
    prog_setup = {"locs": np.asarray(mc.locs), "NN": np.asarray(mc.NNarray),
                  "locs_match": mc.graph.locs_match.cpu().numpy(),
                  "colours": _colours(mc.graph)}
    final_shape = mc.states.shape.detach().double()
    end_adapt = {k: v for k, v in _host(mc.states).items()
                 if k in check.ADAPT_LEAVES and v is not None}
    timings = dict(mc.setup_timings)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if cuda else 0}
    del mc, s0, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # --- the reference decides correct -------------------------------
    t = time.perf_counter()
    derived = setup.derive(data, covfun, int(cfg["m"]), device)
    mdl = derived["model"]
    checks = {"setup_mismatch": (check.setup_mismatch(derived, prog_setup),
                                 0)}
    rng = np.random.default_rng(seed)
    sample = sorted({0, C - 1, int(rng.integers(0, C))})
    truth = setup.initial_states(derived, data, covfun, seed, sample, device)
    ig, ig_leaf = check.init_gap(
        truth, {k: v[sample] for k, v in init_states.items()
                if v is not None})
    checks["init_gap"] = (ig, float(chk["limits"]["init_gap"]))
    key = (seed, start, torch.arange(C, device=device))
    plan = {"K": K, "S": int(tr["n_chromatic"]), "T": T,
            "thinning": float(cfg["field_thinning"]), "columns": cols}
    f = check.follow(mdl, state0, recs, key, plan)
    lim = {k: float(v) for k, v in chk["limits"].items()}
    checks["state_gap"] = (f["state_gap"], lim["state_gap"])
    checks["decision_margin"] = (f["decision_margin"],
                                 lim["decision_margin"])
    ag, ag_leaf = check.adapt_gap(
        check.adaptation(mdl, state0, recs, key, plan), end_adapt)
    checks["adapt_gap"] = (ag, lim["adapt_gap"])
    _log(f"reference: {time.perf_counter() - t:.1f} s; init_gap leaf "
         f"{ig_leaf}, state_gap leaf {f['leaf']}, adapt_gap leaf {ag_leaf}, "
         f"{f['ties']} noise ties split, cycle from iteration {start}; "
         f"{f['disagree']} decisions taken the other way")
    for note in f["notes"]:
        _log(f"decision taken the other way: {note}")
    correct = all(np.isfinite(v) and v <= lim for v, lim in checks.values())
    control_readings = {}
    if control:
        control_readings = {"control": check.control_gaps(
            derived, data, covfun, seed, sample, truth, state0, key, plan,
            recs, lim)}

    if trace:
        events = events_of(prof) if cuda else []
        d = 1 + len(model.shape_names(covfun))
        p, S, n = mdl.X.shape[1], int(tr["n_chromatic"]), mdl.n
        shapes = {"C": C, "S": S, "n": n, "nnz": 2 * mdl.n_edges,
                  "n_colors": len(mdl.colours), "k": mdl.m + 1, "ns": d - 1,
                  "normals": 2 * K * d + 2 + 1 + (p + 1)
                  + (mdl.X_locs_u.shape[1] + 1) + S * n + model.NOISE_STEPS,
                  "uniforms": 2 * K + model.NOISE_STEPS}
        run = TracedRun(events=events, wall_s=traced_wall, iterations=T,
                        setup_timings=timings, covfun=covfun, shapes=shapes,
                        factor={"d2_pairs": mdl.d2_pairs,
                                "pair_valid": mdl.pair_valid,
                                "natural": model.natural(
                                    covfun, final_shape.to(device))})
        metrics = {}
        for m in spec["per_layer"]:
            v = registry.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = union_s(events)
        dev["window_s"] = traced_wall
        extra = {"breakdown": breakdown(events)}
    else:
        values = {"chain_iters_per_s": attempted / window_s,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
        extra = {}
    if leaked_modules():
        _log(f"forbidden modules loaded: {leaked_modules()}")
        return None
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev, **extra,
           **control_readings}
    out["checks"] = {k: {"value": float(v), "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    import torch

    spec = registry.cell(registry.benchmark(), args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"the cell needs {chips} CUDA card(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             ": no run (the benchmark measures on the card only)")
        return 2
    out = run_cell(spec, args.seed % 2**63, args.seconds, bool(args.trace))
    if out is None:
        return 3
    _log(f"card: {power_limit()}; peaks: 3.35 TB/s, 67 TFLOP/s float32, "
         "34 TFLOP/s float64 (H100 SXM data sheet, 700 W)")
    for k, c in out["checks"].items():
        _log(f"check {k}: {c['value']:.6g} (limit {c['limit']:.6g})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
