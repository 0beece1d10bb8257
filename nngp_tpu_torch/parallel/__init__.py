"""Chain parallelism over a ``torch.distributed`` group.

Port of ``nngp_tpu/parallel``.  The reference's only parallelism is
fork-per-chain mclapply (mcmc_nngp_update_Gaussian.R:25, joined at
mcmc_nngp_run.R:22-33).  Here each rank of a process group advances its
block of chains on its own device (``run(mc, mesh=...)``), the ranks
exchange states and records once a cycle, and the Gelman-Rubin-Brooks
moments reduce with ``all_reduce``.  Halo mode (``halo.py``,
``halo_gibbs.py``) also shards each chains block's iteration by sites over
the "sites" dimension of a ``("chains", "sites")`` mesh.
"""

from nngp_tpu_torch.parallel.chains import chains_mesh, make_sharded_cycle_fn
from nngp_tpu_torch.parallel.collectives import collective_grb
from nngp_tpu_torch.parallel.distributed import (
    global_chains_mesh,
    initialize_distributed,
    local_chain_slice,
)
from nngp_tpu_torch.parallel.halo import (
    HaloPlan,
    build_halo_plan,
    halo_chromatic_sweeps,
    halo_level_solve,
    halo_mesh,
    reconcile,
)
from nngp_tpu_torch.parallel.halo_gibbs import make_halo_cycle_fn

__all__ = [
    "chains_mesh", "make_sharded_cycle_fn", "collective_grb",
    "initialize_distributed", "global_chains_mesh", "local_chain_slice",
    "HaloPlan", "build_halo_plan", "halo_chromatic_sweeps",
    "halo_level_solve", "halo_mesh", "reconcile", "make_halo_cycle_fn",
]
