"""What the examples share: the ``--device`` and ``--out`` arguments, the
Earth radius, and the device label that goes into each summary."""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess

import torch

from nngp_tpu_torch.interop import resolve_device

EARTH_RADIUS_KM = 6371.0
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` and ``--out``."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory for logs, fits and summaries "
                         "(default nngp_tpu_torch/examples/out/)")
    return ap


def setup(args) -> tuple[torch.device, str]:
    """(device, label): the device of ``--device``, which raises for a card
    that is not there, and its label for the summary; makes ``--out``."""
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    return device, device_label(device)


def device_label(device: torch.device) -> str:
    """``"cpu"``, or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def ci_table(names, table, scale=None) -> dict:
    """{name: {"mean", "ci"}} from an estimate table (columns mean, 2.5 %,
    median, 97.5 %, sd), each row times ``scale.get(name, 1)``."""
    scale = scale or {}
    return {nm: {"mean": float(row[0]) * scale.get(nm, 1.0),
                 "ci": [float(row[1]) * scale.get(nm, 1.0),
                        float(row[3]) * scale.get(nm, 1.0)]}
            for nm, row in zip(names, table)}


def rhat(grb) -> dict:
    """{name: R-hat} of one Gelman-Rubin-Brooks entry."""
    return {nm: float(r) for nm, r in zip(grb["names"], grb["R_hat"])}


def write_summary(out: str, name: str, summary: dict) -> str:
    """Append ``summary`` as one JSON line to ``<out>/<name>.jsonl``."""
    path = os.path.join(out, name + ".jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(summary) + "\n")
    return path


def all_finite(obj) -> bool:
    """Every number in a summary (nested dicts and lists) is finite, R-hats
    aside: an R-hat is infinite while no chain has moved in the window,
    which is a diagnosis of a short run, not a fault."""
    if isinstance(obj, dict):
        return all(all_finite(v) for k, v in obj.items() if "rhat" not in k)
    if isinstance(obj, (list, tuple)):
        return all(all_finite(v) for v in obj)
    if isinstance(obj, bool) or not isinstance(obj, (int, float)):
        return True
    return math.isfinite(obj)
