"""Chain parallelism over a ``torch.distributed`` group.

Port of ``nngp_tpu/parallel`` (chains only; the sites-sharded halo mode is
not ported yet).  The reference's only parallelism is fork-per-chain
mclapply (mcmc_nngp_update_Gaussian.R:25, joined at mcmc_nngp_run.R:22-33).
Here each rank of a process group advances its block of chains on its own
device (``run(mc, mesh=...)``), the ranks exchange states and records once
a cycle, and the Gelman-Rubin-Brooks moments reduce with ``all_reduce``.
"""

from nngp_tpu_torch.parallel.chains import chains_mesh, make_sharded_cycle_fn
from nngp_tpu_torch.parallel.collectives import collective_grb
from nngp_tpu_torch.parallel.distributed import (
    global_chains_mesh,
    initialize_distributed,
    local_chain_slice,
)

__all__ = [
    "chains_mesh", "make_sharded_cycle_fn", "collective_grb",
    "initialize_distributed", "global_chains_mesh", "local_chain_slice",
]
