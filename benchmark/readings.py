"""The readings that the limits of ``correct`` are set from, at a cell's own
size: for each seed, the sampler's numbers (a run of the cell with a short
window) and, for the seeds given with ``--control``, the control's (the
reference one precision step down in the sampler's place), each judged by
the cell's limits: ``control_correct`` should read false.  One JSON line
a seed on standard output; the benchmark's own runs never run this.

    python3 -m benchmark.readings --workload <cell> --seeds 11 12 ...
                                  [--control 11 12 13] [--seconds 5]
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import registry, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run._caches()
    spec = registry.cell(registry.benchmark(), args.workload)
    for seed in args.seeds:
        out = run.run_cell(spec, seed, args.seconds, False, args.device,
                           control=seed in args.control)
        if out is None:
            return 3
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "failed": out["failed"], "metrics": out["metrics"],
                          "checks": out["checks"],
                          "control": out.get("control"),
                          "control_correct": (out["control"]["correct"]
                                              if "control" in out else None)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
