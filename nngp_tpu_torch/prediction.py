"""Posterior predictive simulation at new locations.

Port of ``nngp_tpu/prediction.py`` (the reference: mcmc_nngp_predict.R):

- ``mcmc_nngp_predict_field``: the joint ordered-NN graph over
  [training locs; predicted locs] (ref :4-8), then for every retained
  posterior sample a conditional simulation
      w_pred = sd * solve(L_joint, [L_obs (w - beta_0)/sd ; z])[n:]
  (ref :44-53).  Retained samples take the place of chains: the factor
  build, ``linv_mult`` and ``level_solve`` run batched over a chunk of
  samples on the fit's device.
- ``mcmc_nngp_predict_fixed_effects``: beta samples x model matrix with
  name matching and an optional intercept (ref :67-104), NumPy.

Smoothness transform: the sampler's nu = .5 + .5 sigmoid, as in
``nngp_tpu`` (the reference uses 1.5 sigmoid here, mcmc_nngp_predict.R:37).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nngp_tpu_torch.estimation import get_summary
from nngp_tpu_torch.ops.covariance import shape_transform
from nngp_tpu_torch.ops.trisolve import level_solve
from nngp_tpu_torch.ops.vecchia import linv_mult, vecchia_linv
from nngp_tpu_torch.preprocess.coloring import (STEP_FIELDS, dag_levels,
                                                level_segments, level_steps)
from nngp_tpu_torch.preprocess.design import _expand_columns
from nngp_tpu_torch.preprocess.graph import nn_group_sqdist
from nngp_tpu_torch.preprocess.neighbors import find_ordered_nn
from nngp_tpu_torch.preprocess.ordering import lonlat_to_xyz


def _tensor(a, device) -> torch.Tensor:
    """float32 (floats) or int64 (indices) tensor of ``a`` on ``device``."""
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.float32 if a.dtype.kind == "f"
                                    else np.int64), device=device)


@dataclass(frozen=True)
class JointGraph:
    """The graph view ``vecchia_linv``, ``linv_mult`` and ``level_solve``
    read, over [training locs; predicted locs]."""

    kernel_coords: object         # f32 [n_joint, d']
    nn_dist2: object              # f32 [n_joint, m+1, m+1, G]
    NNarray: object               # [n_joint, m+1]
    nn_mask: object               # f32 [n_joint, m+1]
    level_segs: tuple
    step_ptr: object              # i32, as VecchiaGraph's step_* fields
    step_sites: object
    step_cols: object
    covfun: str
    d_floor: float = 1e-12

    @property
    def n(self) -> int:
        return self.NNarray.shape[0]

    def to(self, device) -> "JointGraph":
        """The same graph with torch leaves on ``device`` (int64 indices,
        the level steps int32 for the kernel)."""
        t = lambda a: _tensor(a, device)  # noqa: E731
        return JointGraph(
            kernel_coords=t(self.kernel_coords), nn_dist2=t(self.nn_dist2),
            NNarray=t(self.NNarray), nn_mask=t(self.nn_mask),
            level_segs=tuple(t(s) for s in self.level_segs),
            **{f: t(getattr(self, f)).to(torch.int32) for f in STEP_FIELDS},
            covfun=self.covfun, d_floor=self.d_floor)


def _joint_graph(mc, predicted_locs, m) -> JointGraph:
    """Host tables of the joint graph, the same arrays as nngp_tpu's
    ``_joint_graph`` (which also builds the TPU's ``levels_idx``)."""
    covfun = mc.space_time_model["covfun"]["stationary_covfun"]
    lonlat = "sphere" in covfun
    joint = np.concatenate([mc.locs, np.asarray(predicted_locs, np.float64)], 0)
    NN = find_ordered_nn(joint, m, lonlat=lonlat)
    levels = dag_levels(NN)
    level_segs = level_segments(levels, n_sentinel=NN.shape[0])
    coords = lonlat_to_xyz(joint) if lonlat else joint
    return JointGraph(
        kernel_coords=np.asarray(coords, np.float32),
        nn_dist2=nn_group_sqdist(coords, NN, covfun),
        NNarray=NN,
        nn_mask=(NN >= 0).astype(np.float32),
        level_segs=level_segs,
        **dict(zip(STEP_FIELDS, level_steps(level_segs, NN, NN >= 0))),
        covfun=covfun,
        d_floor=1e-5 if covfun.startswith("matern") else 1e-12,
    )


def conditional_field(g: JointGraph, names, n: int, shape, log_scale, beta_0,
                      field, z) -> torch.Tensor:
    """Conditional draws [S, n_pred] of the field at the predicted sites for
    S retained samples: shape [S, n_shape], log_scale [S], beta_0 [S],
    field [S, n] (training sites), normals z [S, n_pred]."""
    linv_j = vecchia_linv(g, shape_transform(names, shape))
    sd = torch.exp(0.5 * log_scale)[:, None]
    # the first n rows of the joint factor reference only training sites
    # (ordered neighbours precede), so padding the field leaves them exact
    w_ext = torch.cat([(field - beta_0[:, None]) / sd, torch.zeros_like(z)], 1)
    v = linv_mult(linv_j, w_ext, g)[:, :n]
    w_joint = level_solve(linv_j, torch.cat([v, z], 1), g)
    return sd * w_joint[:, n:]


def _stored_idx(mc, burn_in):
    sf = mc.records[0]["saved_field"]
    return sf[sf > burn_in * sf.max()]


def retained_samples(rec, stored, device):
    """(shape, log_scale, beta_0, field) float32 tensors of one chain's
    retained samples ``stored`` (1-based iterations with a field record)."""
    t = lambda a: _tensor(a, device)  # noqa: E731
    rows = np.searchsorted(rec["saved_field"], stored)
    return (t(rec["shape"][stored - 1]), t(rec["log_scale"][stored - 1]),
            t(rec["beta_0"][stored - 1]), t(rec["field"][rows]))


def normals_generator(mc, chain: int, lo: int) -> torch.Generator:
    """The stream of the normals for chain ``chain``'s samples from ``lo``
    on: a function of (seed, chain, chunk start), the analogue of
    nngp_tpu's fold_in(key(seed + 777), chain * 100003 + lo)."""
    gen = torch.Generator(device=mc.device)
    gen.manual_seed((int(mc.seed) + 777) * 1_000_003 + chain * 100_003 + lo)
    return gen


def mcmc_nngp_predict_field(mc, predicted_locs, burn_in: float = 0.5,
                            m: int = 10, sample_chunk: int = 32):
    """Latent-field prediction at ``predicted_locs`` (ref :1-60): per chain
    a [n_samples, n_pred] array of conditional draws, and their pooled
    summary."""
    if getattr(mc, "field_record_columns", None) is not None:
        raise ValueError(
            "predict_field needs full-field snapshots but the records are "
            "column-subsampled (the fit was run with field_record_columns). "
            "Re-run the sampling cycles without field_record_columns to "
            "collect full field records before predicting."
        )
    predicted_locs = np.asarray(predicted_locs, dtype=np.float64)
    g = _joint_graph(mc, predicted_locs, m).to(mc.device)
    n = mc.graph.n
    n_pred = predicted_locs.shape[0]
    names = list(mc.space_time_model["covfun"]["shape_params"])
    stored = _stored_idx(mc, burn_in)
    n_samples = len(stored)

    per_chain = []
    for ci, rec in enumerate(mc.records):
        shapes, lss, b0s, fields = retained_samples(rec, stored, mc.device)
        out = np.zeros((n_samples, n_pred), dtype=np.float32)
        for lo in range(0, n_samples, sample_chunk):
            hi = min(lo + sample_chunk, n_samples)
            z = torch.randn(hi - lo, n_pred, generator=normals_generator(
                mc, ci, lo), device=mc.device)
            out[lo:hi] = conditional_field(
                g, names, n, shapes[lo:hi], lss[lo:hi], b0s[lo:hi],
                fields[lo:hi], z).cpu().numpy()
        per_chain.append(out)

    return {
        "predicted_locs": predicted_locs,
        "predicted_field_samples": per_chain,
        "predicted_field_summary": get_summary(np.concatenate(per_chain, 0)),
    }


def mcmc_nngp_predict_fixed_effects(
    mc,
    X_predicted,
    burn_in: float = 0.5,
    match_field_thinning: bool = True,
    add_intercept: bool = False,
):
    """Fixed-effect prediction = beta samples x model matrix (ref :67-104)."""
    cols, names = _expand_columns(X_predicted)
    MM = np.stack(cols, axis=1) if cols else np.zeros((0, 0))
    fixed_effects_names = list(names)
    if add_intercept:
        MM = np.concatenate([np.ones((MM.shape[0], 1)), MM], axis=1)
        fixed_effects_names = ["beta_0"] + fixed_effects_names

    if match_field_thinning:
        stored = mc.records[0]["saved_field"]
    else:
        stored = np.arange(1, mc.iterations + 1)
    stored = stored[stored > burn_in * stored.max()]

    all_names = ["beta_0"] + list(mc.design.names)
    subset = []
    for nm in fixed_effects_names:
        if nm not in all_names:
            raise ValueError(
                f"predicted covariate {nm!r} not among fitted effects {all_names}"
            )
        subset.append(all_names.index(nm))
    subset = np.asarray(subset, dtype=np.int64)

    per_chain = []
    for rec in mc.records:
        b0 = rec["beta_0"][stored - 1][:, None]
        if rec["beta"] is not None and rec["beta"].shape[1] > 0:
            b = rec["beta"][stored - 1]
            b0 = b0 - b @ mc.design.X_mean[:, None]  # de-center (ref :94)
            beta_matrix = np.concatenate([b0, b], axis=1)
        else:
            beta_matrix = b0
        per_chain.append(beta_matrix[:, subset] @ MM.T)

    allsamples = np.concatenate(per_chain, axis=0)
    return {
        "X_predicted": X_predicted,
        "predicted_fixed_effects_samples": per_chain,
        "predicted_fixed_effects_summary": get_summary(allsamples),
    }
