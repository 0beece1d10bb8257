"""Public API: initialize -> run -> estimate -> predict_*, save/load.

Port of ``nngp_tpu/api.py`` (the reference's mcmc_nngp_initialize,
mcmc_nngp_run, mcmc_nngp_estimate, mcmc_nngp_predict_* and saveRDS/readRDS
of the fit, Heavy_metals/run_script.R:17).  ``initialize`` runs the host
preprocessing once (the same NumPy code as ``nngp_tpu``, so the same
graph and initial states for the same inputs and seed) and puts every
tensor on the ``device`` it is given: the CUDA card by default, the CPU
only when asked (``device="cpu"``; asking for a card that is not there
raises).  ``run`` advances all chains together
and can be called again on the same ``MCMC`` object to continue sampling.
``save`` writes ``nngp_tpu.save``'s file and ``load`` reads either
package's, so a fit saved by one package resumes in the other.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from nngp_tpu_torch import interop
from nngp_tpu_torch.diagnostics.ess import ESS as _ESS
from nngp_tpu_torch.diagnostics.grb import Gelman_Rubin_Brooks as _GRB
from nngp_tpu_torch.models.gaussian import (
    ChainState,
    ModelData,
    UpdateConfig,
    run_cycle,
)
from nngp_tpu_torch.ops.covariance import require_supported, shape_param_names
from nngp_tpu_torch.preprocess.dedupe import ObsMaps, dedupe_and_match
from nngp_tpu_torch.preprocess.design import Design, build_design
from nngp_tpu_torch.preprocess.graph import VecchiaGraph, build_graph
from nngp_tpu_torch.preprocess.ordering import reorder_locations
from nngp_tpu_torch.utils import native


@dataclass
class MCMC:
    """Self-contained fit object (the reference's mcmc_nngp_list)."""

    locs: np.ndarray
    observed_locs: np.ndarray
    observed_field: np.ndarray
    graph: VecchiaGraph           # torch leaves on ``device``
    design: Design
    data: ModelData               # torch leaves on ``device``
    space_time_model: dict
    states: ChainState            # chains leading, on ``device``
    records: list                 # per-chain dicts of numpy arrays
    diagnostics: dict
    n_chains: int
    seed: int
    t_begin: float
    NNarray: np.ndarray
    device: torch.device
    # seconds of each host preprocessing stage of initialize
    setup_timings: dict
    # active lean-record column set (None = full-field records)
    field_record_columns: tuple | None = None

    @property
    def iterations(self) -> int:
        return int(self.records[0]["iterations"][-1][0])


def _full_f32_matmuls():
    """float32 products stay float32 on the card: TF32 off for matmuls and
    cuDNN, matmul precision "highest" (the interweaved beta precision is an
    n-length contraction, mcmc_nngp_update_Gaussian.R:79)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _model_data(observed_field, design, X_locs_u, dtype, range_cap,
                range_floor, device) -> ModelData:
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=dtype), device=device)
    return ModelData(
        y=t(observed_field),
        X=t(design.X if design.X is not None
            else np.zeros((len(observed_field), 0))),
        X_locs_u=t(X_locs_u),
        solve_1XT1X=t(design.solve_1XT1X if design.solve_1XT1X is not None
                      else np.zeros((1, 1))),
        chol_solve_1XT1X_lower=t(design.chol_solve_1XT1X.T
                                 if design.chol_solve_1XT1X is not None
                                 else np.zeros((1, 1))),
        var_y=t(np.var(observed_field, ddof=1)),
        range_cap=t(range_cap),
        range_floor=t(range_floor),
    )


def _range_floor_from_graph(graph) -> np.ndarray:
    """Per-range-group lower support: median nearest-parent distance / 100
    (see nngp_tpu's ModelData.range_floor) — [G]."""
    d2 = np.asarray(graph.nn_dist2, dtype=np.float64)   # [n, k, k, G]
    has_parent = np.asarray(graph.nn_mask)[:, 1] > 0 if d2.shape[1] > 1 \
        else np.zeros(d2.shape[0], dtype=bool)
    out = []
    for g in range(d2.shape[-1]):
        dp = d2[has_parent, 0, 1, g]
        dp = dp[dp > 0]
        med = np.sqrt(np.median(dp)) if len(dp) else 0.0
        out.append(med / 100.0)
    return np.asarray(out)


def _range_cap_from_coords(coords) -> float:
    """4x the bounding-box diagonal of the kernel coordinates."""
    c = np.asarray(coords, dtype=np.float64)
    diag = float(np.sqrt(((c.max(0) - c.min(0)) ** 2).sum()))
    return 4.0 * max(diag, 1e-30)


def initialize(
    observed_locs,
    observed_field,
    X_obs=None,
    X_locs=None,
    m: int = 10,
    reordering="maxmin",
    stationary_covfun: str = "exponential_isotropic",
    response_model: str = "Gaussian",
    n_chains: int = 3,
    seed: int = 1,
    dtype=np.float32,
    device="cuda",
    adaptive_proposal: bool = True,
    verbose: bool = True,
) -> MCMC:
    """Build the model state (mcmc_nngp_initialize.R:1-240) on ``device``:
    the CUDA card unless ``device="cpu"``; without a card, asking for it
    raises (there is no fallback to the CPU).

    Reordering, dedupe, neighbour search and colouring run on the host once,
    with the same NumPy code and random stream as ``nngp_tpu.initialize``.
    ``adaptive_proposal=False`` gives every chain the reference's isotropic
    (log_scale, shape) proposal instead of the adaptive-covariance one
    (nngp_tpu's states with ``prop_mean=None``).  ``dtype`` is there for
    ``nngp_tpu``'s signature: the port stores float32 only, so any other
    dtype raises.
    """
    t_begin = time.time()
    if np.dtype(dtype) != np.float32:
        raise ValueError(f"dtype {np.dtype(dtype)} is not supported: "
                         "nngp_tpu_torch stores float32 only")
    device = interop.resolve_device(device)
    _full_f32_matmuls()
    if response_model != "Gaussian":
        raise ValueError("only the Gaussian response model is implemented "
                         "(matching the reference, mcmc_nngp_initialize.R:170)")
    require_supported(stationary_covfun)
    dtype = np.float32
    rng = np.random.default_rng(seed)
    observed_locs = np.asarray(observed_locs, dtype=np.float64)
    observed_field = np.asarray(observed_field, dtype=np.float64)
    lonlat = "sphere" in stationary_covfun
    timings = {}

    def perm_fn(L):
        t = time.perf_counter()
        perm = reorder_locations(L, reordering, lonlat=lonlat, rng=rng)
        timings["ordering_s"] = time.perf_counter() - t
        return perm

    maps = dedupe_and_match(observed_locs, perm_fn=perm_fn)
    graph, NN = build_graph(maps, m=m, covfun=stationary_covfun, dtype=dtype,
                            timings=timings)
    n = graph.n
    n_dims = observed_locs.shape[1]
    names = shape_param_names(stationary_covfun, n_dims)

    design = build_design(X_locs=X_locs, X_obs=X_obs)
    p = design.p
    # location covariates at unique locations (first-obs representative row)
    h1 = np.asarray(graph.hctam_scol_1)
    if design.p_locs > 0:
        X_locs_u = design.X[h1][:, design.locs_cols]
    else:
        X_locs_u = np.zeros((n, 0))
    data = _model_data(observed_field, design, X_locs_u, dtype,
                       _range_cap_from_coords(graph.kernel_coords),
                       _range_floor_from_graph(graph), device)

    # --- per-chain overdispersed initial states (ref :143-209), the same
    # recipe and random stream as nngp_tpu.initialize ---
    t = time.perf_counter()
    n_obs = len(observed_field)
    if p > 0:
        X1 = np.concatenate([np.ones((n_obs, 1)), design.X], axis=1)
    else:
        X1 = np.ones((n_obs, 1))
    coef, *_ = np.linalg.lstsq(X1, observed_field, rcond=None)
    resid = observed_field - X1 @ coef
    dof = max(n_obs - X1.shape[1], 1)
    sigma2_hat = float(resid @ resid) / dof
    vcov = sigma2_hat * np.linalg.inv(X1.T @ X1)
    vcov_chol = np.linalg.cholesky(vcov)
    var_resid = float(np.var(resid, ddof=1))

    # shape inits: log(max kernel-coordinate distance among the first 100
    # reordered locs) - log U{20..200} per range parameter (ref :152-161)
    locs100 = maps.locs[: min(100, n)]
    kc100 = np.asarray(graph.kernel_coords, dtype=np.float64)[: min(100, n)]

    def _maxdist(cols):
        sub = kc100 if cols is None else locs100[:, cols]
        if sub.ndim == 1:
            sub = sub[:, None]
        d = np.sqrt(((sub[:, None] - sub[None]) ** 2).sum(-1))
        return d.max()

    def _draw_range(cols):
        return np.log(_maxdist(cols)) - np.log(rng.integers(20, 201))

    from nngp_tpu_torch.ops.numpy_ref import (
        np_shape_transform,
        np_solve_L,
        np_vecchia_linv,
    )

    coords_np = np.asarray(graph.kernel_coords, dtype=np.float64)
    d_am = 1 + len(names)
    chains = []
    for _ in range(n_chains):
        shape0 = []
        for nm in names:
            if nm.startswith("qlogis"):
                shape0.append(rng.normal())
            elif stationary_covfun.endswith("scaledim"):
                shape0.append(_draw_range([len(shape0)]))
            elif stationary_covfun.endswith("spacetime"):
                if len(shape0) == 0:
                    shape0.append(_draw_range(list(range(n_dims - 1))))
                else:
                    shape0.append(_draw_range([n_dims - 1]))
            else:
                shape0.append(_draw_range(None))
        shape0 = np.array(shape0)
        perturb = vcov_chol @ rng.normal(size=X1.shape[1])
        beta_0 = coef[0] + perturb[0]
        beta = coef[1:] + perturb[1:]
        log_scale = float(np.log(rng.beta(10, 10) * var_resid))
        log_noise = float(np.log(rng.beta(10, 10) * var_resid))
        # field ~ prior (ref :196-208): beta_0 + sqrt(scale) L^-1 z
        natural = np_shape_transform(names, shape0)
        linv = np_vecchia_linv(coords_np, NN, stationary_covfun, natural)
        z = rng.normal(size=n)
        fld = beta_0 + np.sqrt(np.exp(log_scale)) * np_solve_L(linv, NN, z)
        chains.append(dict(
            beta_0=beta_0, beta=beta, log_scale=log_scale,
            log_noise_variance=log_noise, shape=shape0, field=fld,
            tk_ancillary=-2.0, tk_sufficient=-2.0,
            prop_mean=np.zeros(d_am), prop_m2=np.zeros((d_am, d_am)),
            prop_count=0.0,
        ))
    timings["prior_fields_s"] = time.perf_counter() - t
    stacked = {
        k: torch.as_tensor(np.stack([np.asarray(c[k], dtype=dtype)
                                     for c in chains]), device=device)
        for k in chains[0]
    }
    if not adaptive_proposal:
        stacked.update(prop_mean=None, prop_m2=None, prop_count=None)
    states = ChainState(**stacked)

    records = []
    for _ in range(n_chains):
        records.append(
            {
                "iterations": [(0, time.time() - t_begin)],
                "saved_field": np.zeros(0, dtype=np.int64),
                "beta_0": np.zeros((0,)),
                "beta": np.zeros((0, p)) if p else None,
                "beta_names": list(design.names),
                "log_scale": np.zeros((0,)),
                "log_noise_variance": np.zeros((0,)),
                "shape": np.zeros((0, len(names))),
                "shape_names": list(names),
                "field": np.zeros((0, n)),
            }
        )

    t = time.perf_counter()
    graph_d = graph.to(device)
    timings["to_device_s"] = time.perf_counter() - t
    mc = MCMC(
        locs=maps.locs,
        observed_locs=observed_locs,
        observed_field=observed_field,
        graph=graph_d,
        design=design,
        data=data,
        space_time_model={
            "response_model": response_model,
            "covfun": {
                "stationary_covfun": stationary_covfun,
                "shape_params": names,
            },
        },
        states=states,
        records=records,
        diagnostics={"Gelman_Rubin_Brooks": [], "ESS": []},
        n_chains=n_chains,
        seed=seed,
        t_begin=t_begin,
        NNarray=NN,
        device=device,
        setup_timings=timings,
    )
    if verbose:
        parts = ", ".join(f"{k[:-2]} {v:.2f} s" for k, v in timings.items())
        print(f"Setup done, {time.time() - t_begin:.2f} s elapsed ({parts}; "
              f"maxmin/colouring path: {native.path() if n > 4000 else 'numpy'})",
              flush=True)
    return mc


def _cycle_generator(mc: MCMC, cycle_start: int) -> torch.Generator:
    """The cycle's random stream, a function of (seed, first iteration):
    resuming a fit continues the stream one long run would have used."""
    gen = torch.Generator(device=mc.device)
    gen.manual_seed(int(mc.seed) * 1_000_003 + int(cycle_start))
    return gen


def _set_record_columns(mc: MCMC, field_record_columns):
    """Validate/apply the lean-record column set; returns the column tuple
    (None = full field).  The recorded column identities may not change
    mid-chain."""
    prev_cols = mc.field_record_columns
    have_records = any(rec["field"].shape[0] > 0 for rec in mc.records)
    if field_record_columns is not None:
        field_cols = tuple(int(c) for c in np.asarray(field_record_columns))
        if prev_cols is not None and tuple(prev_cols) != field_cols:
            raise ValueError(
                "field_record_columns changed mid-chain: records were "
                f"previously taken at {len(prev_cols)} fixed columns; "
                "resume with the same column set or start a new fit"
            )
        if prev_cols is None and have_records:
            raise ValueError(
                "field_record_columns changed mid-chain: existing records "
                "hold full-width field snapshots; column subsampling can "
                "only start on a fresh fit"
            )
        for rec in mc.records:
            if rec["field"].shape[1] != len(field_cols):
                rec["field"] = np.zeros((0, len(field_cols)),
                                        dtype=rec["field"].dtype)
            rec["field_columns"] = np.asarray(field_cols, dtype=np.int64)
        mc.field_record_columns = field_cols
        return field_cols
    if prev_cols is not None:
        if have_records:
            raise ValueError(
                "field_record_columns changed mid-chain: existing records "
                f"are column-subsampled ({len(prev_cols)} columns); pass "
                "the same field_record_columns to continue, or start a new "
                "fit for full-field recording"
            )
        for rec in mc.records:
            rec["field"] = np.zeros((0, mc.graph.n), dtype=rec["field"].dtype)
            rec.pop("field_columns", None)
        mc.field_record_columns = None
    return None


def run(
    mc: MCMC,
    Gelman_Rubin_Brooks_stop=(1.1, 1.1),
    burn_in: float = 0.5,
    field_thinning: float = 1.0,
    n_iterations_update: int = 200,
    ancillary: bool = True,
    n_chromatic: int = 10,
    n_cycles: int = 1,
    verbose: bool = True,
    field_record_columns=None,
    compute_diagnostics: bool = True,
    covparams_steps: int = 1,
    save_name: str | None = None,
    log_jsonl: str | None = None,
    plot_trace: str | None = None,
    plot_beta: bool = False,
    n_cores=None,
) -> MCMC:
    """Cycle loop with per-cycle diagnostics and early stop
    (mcmc_nngp_run.R:1-52).  All chains advance together; the records of a
    cycle stay on the device and come to the host once, at its end.

    ``field_record_columns`` (site indices) records only those columns of
    each kept field snapshot; ``compute_diagnostics=False`` skips the
    per-cycle GRB/ESS (the early stop is then inert).  After each cycle, in
    this order: ``plot_trace`` (a directory) receives trace_covparms.png,
    and trace_beta.png with ``plot_beta`` (mcmc_nngp_run.R:36-37; needs
    matplotlib); the diagnostics; ``log_jsonl`` gets one JSON line (cycle,
    iteration, elapsed_s, cycle_s, R_hat); ``save_name`` receives the fit
    (:func:`save`); then the early-stop test.  ``n_cores`` is accepted for
    the reference's signature (mcmc_nngp_run.R:3) and ignored: the chains
    advance together on the device."""
    _full_f32_matmuls()
    cfg = UpdateConfig(
        n_iterations=int(n_iterations_update),
        shape_names=tuple(mc.space_time_model["covfun"]["shape_params"]),
        locs_cols=tuple(int(c) for c in mc.design.locs_cols),
        n_chromatic=int(n_chromatic),
        ancillary=bool(ancillary),
        field_cols=_set_record_columns(mc, field_record_columns),
        covparams_steps=int(covparams_steps),
    )
    T = cfg.n_iterations
    for cycle in range(1, n_cycles + 1):
        if verbose:
            print(f"cycle = {cycle}")
        t_cycle = time.time()
        cycle_start = mc.iterations
        # field thinning (ref round(it*t)==it*t rule, update_Gaussian.R:56):
        # iteration it writes its snapshot to record row slots[it-1]
        it = np.arange(1, T + 1)
        saved = it[np.round(it * field_thinning) == it * field_thinning]
        slots = np.full(T, len(saved), dtype=np.int64)
        slots[saved - 1] = np.arange(len(saved))
        states, recs = run_cycle(
            mc.graph, mc.data, replace(cfg, n_saved=len(saved)), mc.states,
            _cycle_generator(mc, cycle_start), cycle_start, saved_slots=slots)
        mc.states = states
        recs = {k: v.cpu().numpy() for k, v in recs.items()}
        for i, rec in enumerate(mc.records):
            for k in ("beta_0", "beta", "log_scale", "log_noise_variance",
                      "shape", "field"):
                if rec[k] is not None:
                    rec[k] = np.concatenate([rec[k], recs[k][:, i]])
            rec["saved_field"] = np.concatenate(
                [rec["saved_field"], cycle_start + saved])
            rec["iterations"].append((cycle_start + T,
                                      time.time() - mc.t_begin))

        if plot_trace is not None:
            from nngp_tpu_torch.diagnostics.plots import (
                raw_chains_plots_beta,
                raw_chains_plots_covparms,
            )

            os.makedirs(plot_trace, exist_ok=True)
            raw_chains_plots_covparms(
                mc.records, burn_in,
                path=os.path.join(plot_trace, "trace_covparms.png"))
            if plot_beta:
                raw_chains_plots_beta(
                    mc.records, burn_in,
                    path=os.path.join(plot_trace, "trace_beta.png"))

        # diagnostics + early stop (mcmc_nngp_run.R:36-46)
        grb = None
        if compute_diagnostics and mc.n_chains >= 2:
            grb = _GRB(mc.records, burn_in)
            mc.diagnostics["Gelman_Rubin_Brooks"].append(grb)
            mc.diagnostics["ESS"].append(_ESS(mc.records, burn_in))
            if verbose:
                with np.printoptions(precision=3, suppress=True):
                    print("Gelman-Rubin-Brooks R-hat : ")
                    print(dict(zip(grb["names"], np.round(grb["R_hat"], 3))))
        if log_jsonl is not None:
            entry = {
                "cycle": cycle,
                "iteration": mc.iterations,
                "elapsed_s": round(time.time() - mc.t_begin, 3),
                "cycle_s": round(time.time() - t_cycle, 3),
            }
            if grb is not None:
                entry["R_hat"] = dict(
                    zip(grb["names"], np.round(grb["R_hat"], 4).tolist()))
            with open(log_jsonl, "a") as f:
                f.write(json.dumps(entry) + "\n")
        if save_name:
            save(mc, save_name)
        if grb is not None and (
                grb["R_hat"][0] < Gelman_Rubin_Brooks_stop[0]
                or np.all(grb["R_hat"][1:] < Gelman_Rubin_Brooks_stop[1])):
            break
    return mc


def estimate(mc: MCMC, burn_in: float = 0.5):
    """Posterior summaries (mcmc_nngp_estimate.R)."""
    from nngp_tpu_torch.estimation import mcmc_nngp_estimate

    return mcmc_nngp_estimate(mc, burn_in)


def predict_field(mc: MCMC, predicted_locs, burn_in: float = 0.5, m: int = 10,
                  sample_chunk: int = 64, n_cores=None):
    """Conditional simulation of the latent field at ``predicted_locs``
    (mcmc_nngp_predict.R:1-60) on the fit's device.  ``n_cores`` is
    accepted for the reference's signature and ignored."""
    from nngp_tpu_torch.prediction import mcmc_nngp_predict_field

    return mcmc_nngp_predict_field(mc, predicted_locs, burn_in, m, sample_chunk)


def predict_fixed_effects(mc: MCMC, X_predicted, burn_in: float = 0.5,
                          match_field_thinning: bool = True,
                          add_intercept: bool = False, n_cores=None):
    """Fixed-effect samples at new covariates (mcmc_nngp_predict.R:67-104)."""
    from nngp_tpu_torch.prediction import mcmc_nngp_predict_fixed_effects

    return mcmc_nngp_predict_fixed_effects(
        mc, X_predicted, burn_in, match_field_thinning, add_intercept)


def save(mc: MCMC, path: str) -> None:
    """Write the whole fit (saveRDS analog, run_script.R:17) as
    ``nngp_tpu.save`` does, key for key, with NumPy leaves only: a fit
    saved here loads in either package."""
    g = mc.graph
    host = {
        "locs": mc.locs,
        "observed_locs": mc.observed_locs,
        "observed_field": mc.observed_field,
        "space_time_model": mc.space_time_model,
        "records": mc.records,
        "diagnostics": mc.diagnostics,
        "n_chains": mc.n_chains,
        "seed": mc.seed,
        "t_begin": mc.t_begin,
        "NNarray": mc.NNarray,
        "states": mc.states,
        "design": mc.design,
        "m": mc.NNarray.shape[1] - 1,
        # the observation<->location maps and NNarray let load() rebuild
        # the graph deterministically, with no float matching of locations
        "locs_match": g.locs_match.cpu().numpy(),
        "hctam_scol_1": g.hctam_scol_1.cpu().numpy(),
        "obs_per_loc": g.obs_per_loc.cpu().numpy(),
        "field_record_columns": mc.field_record_columns,
    }
    interop.dump_fit(host, path)


def load(path: str, device="cuda") -> MCMC:
    """Rebuild a fit saved by :func:`save` or by ``nngp_tpu.save`` (readRDS
    analog) on ``device``; ``run`` resumes it where it stopped.  Without a
    CUDA card, pass ``device="cpu"``: asking for the card raises."""
    device = interop.resolve_device(device)
    _full_f32_matmuls()
    host = interop.load_fit(path)
    covfun = host["space_time_model"]["covfun"]["stationary_covfun"]
    require_supported(covfun)
    timings = {}
    if "locs_match" in host:
        maps = ObsMaps(
            locs=np.asarray(host["locs"]),
            locs_match=np.asarray(host["locs_match"]),
            hctam_scol_1=np.asarray(host["hctam_scol_1"]),
            obs_per_loc=np.asarray(host["obs_per_loc"]),
        )
        graph, NN = build_graph(maps, m=host["m"], covfun=covfun,
                                NN=host["NNarray"], timings=timings)
    else:  # files written before the maps were saved
        maps = dedupe_and_match(
            host["observed_locs"],
            perm_fn=lambda L: _match_permutation(L, host["locs"]))
        graph, NN = build_graph(maps, m=host["m"], covfun=covfun,
                                timings=timings)
    design = host["design"]
    h1 = np.asarray(graph.hctam_scol_1)
    X_locs_u = (design.X[h1][:, design.locs_cols] if design.p_locs > 0
                else np.zeros((graph.n, 0)))
    data = _model_data(host["observed_field"], design, X_locs_u, np.float32,
                       _range_cap_from_coords(graph.kernel_coords),
                       _range_floor_from_graph(graph), device)
    return MCMC(
        locs=host["locs"],
        observed_locs=host["observed_locs"],
        observed_field=host["observed_field"],
        graph=graph.to(device),
        design=design,
        data=data,
        space_time_model=host["space_time_model"],
        states=interop.chain_state(host["states"], device),
        records=host["records"],
        diagnostics=host["diagnostics"],
        n_chains=host["n_chains"],
        seed=host["seed"],
        t_begin=host["t_begin"],
        NNarray=NN,
        device=device,
        setup_timings=timings,
        field_record_columns=host.get("field_record_columns"),
    )


def _match_permutation(deduped_locs, target_locs):
    """Permutation mapping first-occurrence-deduped locs onto a saved
    ordering (files without the saved index maps)."""
    key = {tuple(row): i for i, row in enumerate(np.asarray(target_locs))}
    order = np.array([key[tuple(r)] for r in np.asarray(deduped_locs)])
    perm = np.empty(len(order), dtype=np.int64)
    perm[order] = np.arange(len(order))
    return perm
