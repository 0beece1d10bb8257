"""Halo exchange cost against owned work, per schedule stage (port of
experiments/halo_overhead_table.py; the same record keys).

    python -m nngp_tpu_torch.experiments.halo_overhead_table [--n 100000]
        [--device cpu]

Static properties of the halo plan (``parallel/halo.py:build_halo_plan``)
at n = 100,000 sites over D = 8 sites ranks on the bigN layout (uniform in
[0, 1000]^2, seed 7, middle-out, m = 5): per stage, how many sites the
ranks update (owned work) and how many values they put on the wire (halo
sends).  The stages are this package's: one per colour of the sweep plan
(a step each) and the level solve (a step per level-solve row), read from
the plan's ragged tables (``Schedule.send_ptr``, each rank's ``SubPlan``
and ``level_ptr``) where ``nngp_tpu`` pads a table per sweep class.  Every
site is updated once per sweep and sent once to each other rank whose need
set holds it, so the totals and the level solve's row equal the JAX
script's on the same plan; ``need_rows_per_device`` and the overlap
describe the need sets.  Host only: the device is recorded, the plan is
built on the host.
"""

from __future__ import annotations

import json

import numpy as np

from nngp_tpu_torch.experiments import _common

RANKS = 8


def _row(stage, steps, owned, sent):
    return {"stage": stage, "blocks": int(steps),
            "owned_site_updates": int(owned), "halo_values_sent": int(sent),
            "sent_per_owned": round(float(sent / max(owned, 1)), 4)}


def _sent(schedule, lo, hi):
    """Values every rank sends over steps lo:hi of ``schedule``."""
    return sum(int((ptr[:, hi] - ptr[:, lo]).sum())
               for ptr in schedule.send_ptr)


def overhead_rows(plan) -> dict:
    """The record's table from a ``HaloPlan``: ``per_stage`` (one row per
    sweep colour, then the level solve), ``totals``, the overlap and the
    largest need set."""
    rows = []
    n_colors = len(plan.ranks[0].sub.bounds) - 1
    for c in range(n_colors):
        owned = sum(r.sub.bounds[c + 1] - r.sub.bounds[c] for r in plan.ranks)
        rows.append(_row(f"sweep colour {c}", 1, owned,
                         _sent(plan.sweep, c, c + 1)))
    T = len(plan.ranks[0].level_ptr) - 1
    owned = sum(int(r.level_ptr[-1] - r.level_ptr[0]) for r in plan.ranks)
    rows.append(_row("level solve", T, owned, _sent(plan.level, 0, T)))
    total_owned = sum(r["owned_site_updates"] for r in rows)
    total_sent = sum(r["halo_values_sent"] for r in rows)
    need = (np.asarray(plan.need_rows) < plan.n).sum(1)
    return {
        "n": int(plan.n), "D": int(plan.D),
        "overlap_fraction": round(float(need.sum() / plan.n) - 1.0, 4),
        "need_rows_per_device": int(need.max()),
        "per_stage": rows,
        "totals": {"owned_site_updates": int(total_owned),
                   "halo_values_sent": int(total_sent),
                   "sent_per_owned": round(float(total_sent / total_owned),
                                           4)},
        "note": (
            "one chromatic sweep does `owned_site_updates` conditional "
            "draws over all ranks and moves `halo_values_sent` f32 values "
            "between them; at sent/owned ~ a few % and 4 B a value the "
            "traffic is far below the gather bytes of the update itself "
            "(m+1 neighbours and a Q row a site), so halo mode is bound by "
            "its gathers and its per-step exchange latency, not by link "
            "bandwidth, on NVLink"),
    }


def parse_args(argv=None):
    ap = _common.parser(__doc__, "halo_overhead_table.json")
    ap.add_argument("--n", type=int, default=100_000)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    import nngp_tpu_torch
    from nngp_tpu_torch.parallel.halo import build_halo_plan

    args = parse_args(argv)
    device, out = _common.setup(args)
    rng = np.random.default_rng(7)
    locs = rng.uniform(0, 1000.0, size=(args.n, 2))
    y = rng.normal(size=args.n)
    mc = nngp_tpu_torch.initialize(locs, y, m=5, reordering="middleout",
                                   n_chains=2, seed=5, device=device,
                                   verbose=False)
    out.update(overhead_rows(build_halo_plan(mc.graph, RANKS)))
    _common.write_json(args.out, out)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
