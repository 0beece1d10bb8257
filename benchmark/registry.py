"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's root
names each cell's configuration and traffic; the configuration lives in
its ``file``, the traffic mix in ``traffic/<traffic>.json``, the cell's
check in ``workloads/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """{"cell", "config", "traffic", "check", "end_to_end", "per_layer"}
    of the cell ``name``; KeyError names the cells there are."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return {
        "cell": w,
        "config": _json(os.path.join(root, conf["file"])),
        "traffic": _json(os.path.join(HERE, "traffic",
                                      f"{w['traffic']}.json")),
        "check": _json(os.path.join(HERE, "workloads", f"{name}.json")),
        "end_to_end": bench["end_to_end"],
        "per_layer": bench["per_layer"],
    }


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
