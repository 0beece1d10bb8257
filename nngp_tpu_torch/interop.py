"""Carry a problem, chain states and whole fits between ``nngp_tpu`` and
this package, without importing jax.

``from_numpy`` reads ``nngp_tpu``'s host objects (a ``VecchiaGraph``,
``ModelData`` and stacked ``ChainState`` with NumPy leaves, as
``nngp_tpu.initialize`` leaves them) by attribute and returns this
package's tensors on ``device`` (the card unless ``device="cpu"``).
``states_to_numpy`` goes back: a dict of stacked NumPy arrays keyed like
``ChainState``'s fields, so ``nngp_tpu``'s ``ChainState(**d)`` rebuilds
it.

``dump_fit`` / ``load_fit`` read and write the pickle of ``nngp_tpu.save``,
key for key.  That pickle names two classes, ``nngp_tpu.models.gaussian.
ChainState`` and ``nngp_tpu.preprocess.design.Design``; unpickling it the
usual way would import ``nngp_tpu`` and with it jax.  ``load_fit`` maps the
two names to this package's ``ChainState`` and ``Design`` (same fields)
and refuses any other ``nngp_tpu`` or jax class; ``dump_fit`` writes the
two names for stand-in classes without importing them, so
``nngp_tpu.load`` reads the file unchanged.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from nngp_tpu_torch.models.gaussian import ChainState, ModelData
from nngp_tpu_torch.preprocess.coloring import (STEP_FIELDS, color_csr,
                                                level_steps, sweep_plan)
from nngp_tpu_torch.preprocess.design import Design
from nngp_tpu_torch.preprocess.graph import (PLAN_FIELDS, VecchiaGraph,
                                             sum_plans)


def _colors_from_padded(colors_idx: np.ndarray, n: int) -> np.ndarray:
    colors = np.empty(n, dtype=np.int64)
    for c, row in enumerate(np.asarray(colors_idx)):
        colors[row[row < n]] = c
    return colors


def graph_from_numpy(graph) -> VecchiaGraph:
    """This package's host graph from ``nngp_tpu``'s (NumPy leaves)."""
    n = np.asarray(graph.NNarray).shape[0]
    color_ptr, color_sites = color_csr(_colors_from_padded(graph.colors_idx, n))
    plan = sweep_plan(color_ptr, color_sites, graph.nbr_sites, graph.nbr_edge)
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
        **dict(zip(PLAN_FIELDS, plan)),
        level_segs=tuple(np.asarray(t) for t in graph.level_segs),
        **dict(zip(STEP_FIELDS, level_steps(graph.level_segs, graph.NNarray,
                                            graph.nn_mask))),
        locs_match=np.asarray(graph.locs_match),
        hctam_scol_1=np.asarray(graph.hctam_scol_1),
        obs_per_loc=np.asarray(graph.obs_per_loc),
        **sum_plans(graph.NNarray, graph.pair_edge_id, graph.locs_match,
                    int(graph.n_edges)),
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


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device with no card
    available raises: the entry points never fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs a CUDA card and none is available "
            "(torch.cuda.is_available() is False); pass device=\"cpu\" to "
            "run on the CPU")
    return device


def from_numpy(graph, data, states, device="cuda"):
    """(VecchiaGraph, ModelData, ChainState) on ``device`` from
    ``nngp_tpu``'s host graph, model data and stacked chain states."""
    device = resolve_device(device)
    return (graph_from_numpy(graph).to(device),
            _tensors(data, ModelData, device),
            chain_state(states, device))


def chain_state(states, device="cuda") -> ChainState:
    """This package's ``ChainState`` (float32 tensors on ``device``) from
    stacked chain states with NumPy leaves, read by attribute."""
    return _tensors(states, ChainState, resolve_device(device))


def states_to_numpy(states: ChainState) -> dict:
    """Stacked NumPy leaves of ``states`` (None stays None)."""
    return {
        f.name: (None if getattr(states, f.name) is None
                 else getattr(states, f.name).detach().cpu().numpy())
        for f in dataclasses.fields(states)
    }


# --- fits saved by either package -------------------------------------------

_JAX_STATE = ("nngp_tpu.models.gaussian", "ChainState")
_JAX_DESIGN = ("nngp_tpu.preprocess.design", "Design")
_READ_AS = {_JAX_STATE: ChainState, _JAX_DESIGN: Design}


def _standin(module: str, name: str) -> type:
    """A class that pickles as ``module.name`` (never imported here)."""
    return type(name, (), {"__module__": module, "__qualname__": name})


_STANDINS = {_JAX_STATE: _standin(*_JAX_STATE),
             _JAX_DESIGN: _standin(*_JAX_DESIGN)}


class _FitUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        cls = _READ_AS.get((module, name))
        if cls is not None:
            return cls
        if module.split(".")[0] in ("nngp_tpu", "jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"a saved fit names {module}.{name}; only nngp_tpu's "
                "ChainState and Design can be read without jax")
        return super().find_class(module, name)


class _FitPickler(pickle._Pickler):
    """The pure-Python pickler, which lets ``save_global`` write the stand-ins'
    names (the C pickler imports a class's module to check its name)."""

    def save_global(self, obj, name=None):
        if any(obj is s for s in _STANDINS.values()):
            self.write(pickle.GLOBAL
                       + f"{obj.__module__}\n{obj.__qualname__}\n".encode())
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _as_standin(key, attrs: dict):
    out = object.__new__(_STANDINS[key])
    out.__dict__.update(attrs)
    return out


def dump_fit(host: dict, path: str) -> None:
    """Write ``host`` (``nngp_tpu.save``'s dict, with this package's
    ``ChainState`` of tensors and ``Design``) as ``nngp_tpu.save`` does."""
    host = dict(host,
                states=_as_standin(_JAX_STATE, states_to_numpy(host["states"])),
                design=_as_standin(_JAX_DESIGN, vars(host["design"])))
    with open(path, "wb") as f:
        _FitPickler(f).dump(host)


def load_fit(path: str) -> dict:
    """The dict a fit file holds, written by ``nngp_tpu.save`` or
    ``dump_fit``: ``states`` is a ``ChainState`` with NumPy leaves (fields
    absent from old files are None), ``design`` a ``Design``."""
    with open(path, "rb") as f:
        return _FitUnpickler(f).load()
