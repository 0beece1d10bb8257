"""What the audit scripts and ``bigN`` share: their ``--device`` and
``--out`` arguments, the Heavy-metals graph they probe, and how a record
is written."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from nngp_tpu_torch.examples._common import device_label
from nngp_tpu_torch.interop import resolve_device

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def parser(doc: str, default_out: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` and ``--out`` (a file; default
    ``nngp_tpu_torch/experiments/out/<default_out>``, git-ignored)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, default_out),
                    help="where the record goes (default "
                         f"nngp_tpu_torch/experiments/out/{default_out})")
    return ap


def setup(args) -> tuple[torch.device, dict]:
    """(device, its fields for the record): ``backend`` (the device type,
    where the JAX scripts write ``jax.default_backend()``) and ``device``
    (the card's name and power limit, or ``"cpu"``).  A card that is not
    there raises."""
    device = resolve_device(args.device)
    return device, {"backend": device.type, "device": device_label(device)}


def write_json(path: str, record: dict) -> str:
    """``record`` as indented JSON at ``path`` (its folder made)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    print(f"wrote {path}", flush=True)
    return path


def sphere_graph(locs, covfun: str, m: int = 5):
    """The host graph (NumPy leaves), NNarray and observation maps of
    ``locs`` (lon/lat) under ``covfun``, ordered by maxmin on the sphere:
    what ``initialize(..., m=m, stationary_covfun=covfun)`` builds before it
    moves the graph to the device."""
    from nngp_tpu_torch.preprocess.dedupe import dedupe_and_match
    from nngp_tpu_torch.preprocess.graph import build_graph
    from nngp_tpu_torch.preprocess.ordering import reorder_locations

    maps = dedupe_and_match(
        np.asarray(locs, dtype=np.float64),
        perm_fn=lambda L: reorder_locations(L, "maxmin", lonlat=True))
    graph, NN = build_graph(maps, m=m, covfun=covfun)
    return graph, NN, maps


def stats(a) -> dict:
    """{"rms", "max"} of |a|."""
    a = np.asarray(a, dtype=np.float64)
    return {"rms": float(np.sqrt((a * a).mean())), "max": float(np.abs(a).max())}


def host(t) -> np.ndarray:
    """A tensor (any device) as a float64 NumPy array."""
    return t.detach().cpu().double().numpy()
