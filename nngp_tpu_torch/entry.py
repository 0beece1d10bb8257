"""Driver entry points, the port of ``__graft_entry__.py``.

- ``entry(device="cuda")`` -> (fn, example_args): one Gibbs cycle (2
  iterations) of 2 chains on the 96-site toy, on the card unless
  ``device="cpu"``.
- ``dryrun_multichip(n_devices, device_type=None)``: one sharded 8-iteration
  cycle with two chains per rank on a chains mesh of ``n_devices`` ranks,
  then the collective Gelman-Rubin-Brooks reduction over the ranks' own
  chains, which must give a finite R-hat of shape (4,).  With an even
  ``n_devices`` >= 4, halo mode: one 4-iteration cycle of 4 chains on a
  2 x (n_devices / 2) ``("chains", "sites")`` mesh, records finite.  With
  ``n_devices`` >= 8, the halo plan at scale (host only,
  ``parallel/halo.py:halo_plan_check``): 100,000 sites over 8 ranks with an
  overlap under 10 %.  Called inside a process group of that size it runs
  this rank's part; otherwise it starts ``n_devices`` local ranks
  (``launch_local``).

    python -m nngp_tpu_torch.entry [--device cuda|cpu] [--dryrun N]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _toy_problem(n=96, n_chains=3, seed=0, m=4, device="cuda"):
    """``__graft_entry__._toy_problem``: the same data and seed."""
    import nngp_tpu_torch

    rng = np.random.default_rng(seed)
    locs = rng.uniform(size=(n, 2)) * 8.0
    d = np.sqrt(((locs[:, None] - locs[None]) ** 2).sum(-1))
    K = 2.0 * np.exp(-d / 1.0)
    w = np.linalg.cholesky(K + 1e-8 * np.eye(n)) @ rng.normal(size=n)
    y = 0.5 + w + rng.normal(size=n) * 0.5
    return nngp_tpu_torch.initialize(
        locs, y, m=m, n_chains=n_chains, seed=seed + 1, device=device,
        stationary_covfun="exponential_isotropic", verbose=False)


def entry(device="cuda"):
    """(fn, example_args): ``fn(states, key, iter_start)`` runs one cycle of
    2 iterations of every chain with the draw key ``key`` and returns
    (states, records)."""
    from nngp_tpu_torch.models.gaussian import UpdateConfig, run_cycle
    from nngp_tpu_torch.ops.draws import DrawKey

    mc = _toy_problem(n=96, n_chains=2, device=device)
    cfg = UpdateConfig(
        n_iterations=2,
        shape_names=tuple(mc.space_time_model["covfun"]["shape_params"]),
        locs_cols=(),
        n_chromatic=2,
    )
    graph, data = mc.graph, mc.data

    def fn(states, key, iter_start):
        return run_cycle(graph, data, cfg, states, key, iter_start)

    return fn, (mc.states, DrawKey.of(mc.seed, 0, 0, mc.n_chains, mc.device),
                0)


def _dryrun_rank(n_devices: int, device_type: str) -> dict:
    """This rank's part of ``dryrun_multichip`` in a live group."""
    import torch.distributed as dist

    import nngp_tpu_torch
    from nngp_tpu_torch.parallel import chains_mesh, local_chain_slice
    from nngp_tpu_torch.parallel.collectives import make_collective_grb_fn

    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a group of "
                         f"{dist.get_world_size()} ranks")
    n_chains = 2 * n_devices    # two chains per rank
    mc = _toy_problem(n=64, n_chains=n_chains, m=3, device=device_type)
    mesh = chains_mesh(device_type)
    mc = nngp_tpu_torch.run(mc, n_iterations_update=8, n_chromatic=2,
                            mesh=mesh, verbose=False)
    lo, hi = local_chain_slice(n_chains, mesh)
    recs = mc.records[lo:hi]
    if not all(np.isfinite(r["log_scale"]).all() for r in mc.records):
        raise RuntimeError("dryrun_multichip: non-finite log_scale records")
    samples = torch.as_tensor(np.stack([np.stack(
        [r["beta_0"], r["log_scale"], r["log_noise_variance"]], axis=-1)
        for r in recs]))                                   # [2, 8, 3]
    r_hat = make_collective_grb_fn(mesh, n_chains)(samples).cpu().numpy()
    if r_hat.shape != (4,) or not np.isfinite(r_hat).all():
        raise RuntimeError(f"dryrun_multichip: R-hat {r_hat}")
    out = {"rank": mesh.get_rank(), "chains": [lo, hi],
           "r_hat": r_hat.tolist()}
    if n_devices >= 4 and n_devices % 2 == 0:
        out["halo"] = _dryrun_halo(n_devices, device_type)
    return out


def _dryrun_halo(n_devices: int, device_type: str) -> list:
    """Halo mode on a 2 x (n_devices / 2) mesh: 4 chains of the 64-site toy
    (seed 3), one cycle of 4 iterations and 2 sweeps; returns the mesh
    shape."""
    import nngp_tpu_torch
    from nngp_tpu_torch.parallel import halo_mesh

    mesh = halo_mesh(n_devices // 2, device_type)
    mc = _toy_problem(n=64, n_chains=4, m=3, seed=3, device=device_type)
    mc = nngp_tpu_torch.run(mc, n_iterations_update=4, n_chromatic=2,
                            mesh=mesh, verbose=False)
    if not all(np.isfinite(r["log_scale"]).all() for r in mc.records):
        raise RuntimeError("dryrun_multichip halo: non-finite log_scale "
                           "records")
    return list(mesh.shape)


def dryrun_multichip(n_devices: int, device_type: str | None = None) -> None:
    """One sharded cycle and the collective R-hat on ``n_devices`` ranks of
    ``device_type`` ("cuda" by default, one card a rank over NCCL; "cpu"
    over gloo)."""
    import torch.distributed as dist

    from nngp_tpu_torch.parallel.distributed import launch_local

    device_type = device_type or "cuda"
    if dist.is_initialized():
        out = [_dryrun_rank(n_devices, device_type)]
    else:
        lines = launch_local(["-m", "nngp_tpu_torch.entry", "--device",
                              device_type, "--dryrun", str(n_devices)],
                             n_devices, timeout=300)
        out = [json.loads(text.strip().splitlines()[-1]) for text in lines]
        if any(o["r_hat"] != out[0]["r_hat"] for o in out):
            raise RuntimeError(f"dryrun_multichip: the ranks' R-hats differ "
                               f"{[o['r_hat'] for o in out]}")
    print(f"dryrun_multichip OK: {n_devices} x 2 chains ({device_type} "
          f"ranks), R-hat head {np.round(out[0]['r_hat'][:2], 3)}")
    if "halo" in out[0]:
        print("dryrun_multichip halo OK: {} x {} (chains x sites) mesh"
              .format(*out[0]["halo"]))
    if n_devices >= 8:
        from nngp_tpu_torch.parallel.halo import halo_plan_check

        c = halo_plan_check()
        print(f"dryrun_multichip halo-plan OK: {c['n']}/D={c['D']} overlap "
              f"{c['overlap'] * 100:.2f}% < 10%")


def main(argv=None) -> int:
    from nngp_tpu_torch.parallel import initialize_distributed

    p = argparse.ArgumentParser(description="entry() and dryrun_multichip")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--dryrun", type=int, default=0,
                   help="ranks of dryrun_multichip (0: none)")
    args = p.parse_args(argv)
    if initialize_distributed(device_type=args.device):
        # one rank of a dryrun_multichip launch
        print(json.dumps(_dryrun_rank(args.dryrun, args.device)), flush=True)
        torch.distributed.destroy_process_group()
        return 0
    fn, example = entry(args.device)
    states, recs = fn(*example)
    if not torch.isfinite(recs["log_scale"]).all():
        raise RuntimeError("entry(): non-finite records")
    print("entry() run OK")
    if args.dryrun:
        dryrun_multichip(args.dryrun, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
