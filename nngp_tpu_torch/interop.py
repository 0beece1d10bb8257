"""Carry a problem and chain states between ``nngp_tpu`` and this package.

``from_numpy`` reads ``nngp_tpu``'s host objects (a ``VecchiaGraph``,
``ModelData`` and stacked ``ChainState`` with NumPy leaves, as
``nngp_tpu.initialize`` leaves them) by attribute, so it needs no jax
import, and returns this package's tensors on ``device``.
``states_to_numpy`` goes back: a dict of stacked NumPy arrays keyed like
``ChainState``'s fields, so ``nngp_tpu``'s ``ChainState(**d)`` rebuilds it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nngp_tpu_torch.models.gaussian import ChainState, ModelData
from nngp_tpu_torch.preprocess.coloring import color_csr
from nngp_tpu_torch.preprocess.graph import VecchiaGraph


def _colors_from_padded(colors_idx: np.ndarray, n: int) -> np.ndarray:
    colors = np.empty(n, dtype=np.int64)
    for c, row in enumerate(np.asarray(colors_idx)):
        colors[row[row < n]] = c
    return colors


def graph_from_numpy(graph) -> VecchiaGraph:
    """This package's host graph from ``nngp_tpu``'s (NumPy leaves)."""
    n = np.asarray(graph.NNarray).shape[0]
    color_ptr, color_sites = color_csr(_colors_from_padded(graph.colors_idx, n))
    return VecchiaGraph(
        kernel_coords=np.asarray(graph.kernel_coords),
        nn_dist2=np.asarray(graph.nn_dist2),
        NNarray=np.asarray(graph.NNarray),
        nn_mask=np.asarray(graph.nn_mask),
        pair_edge_id=np.asarray(graph.pair_edge_id),
        pair_a=np.asarray(graph.pair_a),
        pair_b=np.asarray(graph.pair_b),
        nbr_sites=np.asarray(graph.nbr_sites),
        nbr_edge=np.asarray(graph.nbr_edge),
        nbr_mask=np.asarray(graph.nbr_mask),
        color_ptr=color_ptr,
        color_sites=color_sites,
        level_segs=tuple(np.asarray(t) for t in graph.level_segs),
        locs_match=np.asarray(graph.locs_match),
        hctam_scol_1=np.asarray(graph.hctam_scol_1),
        obs_per_loc=np.asarray(graph.obs_per_loc),
        covfun=graph.covfun,
        n_edges=int(graph.n_edges),
        d_floor=float(graph.d_floor),
    )


def _tensors(obj, cls, device):
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name, None)
        out[f.name] = (None if v is None else
                       torch.as_tensor(np.asarray(v, dtype=np.float32),
                                       device=device))
    return cls(**out)


def from_numpy(graph, data, states, device="cpu"):
    """(VecchiaGraph, ModelData, ChainState) on ``device`` from
    ``nngp_tpu``'s host graph, model data and stacked chain states."""
    return (graph_from_numpy(graph).to(device),
            _tensors(data, ModelData, device),
            _tensors(states, ChainState, device))


def states_to_numpy(states: ChainState) -> dict:
    """Stacked NumPy leaves of ``states`` (None stays None)."""
    return {
        f.name: (None if getattr(states, f.name) is None
                 else getattr(states, f.name).detach().cpu().numpy())
        for f in dataclasses.fields(states)
    }
