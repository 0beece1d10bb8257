"""Bring-up of a ``torch.distributed`` group and the global chains mesh.

Port of ``nngp_tpu/parallel/distributed.py``.  PyTorch runs one process per
card.  Bring-up reads the environment, so one script works under any
launcher:

    NNGP_COORDINATOR=host:port  NNGP_NUM_PROCESSES=k  NNGP_PROCESS_ID=i

(``NNGP_COORDINATOR`` may also be a URL such as ``file:///path/rdzv``), or
torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` with ``MASTER_ADDR``
/ ``MASTER_PORT``.  A CUDA group uses NCCL, one process per card; a CPU
group uses gloo, which is also how several ranks can share one card (NCCL
refuses two ranks on one device).  ``launch_local`` starts k local ranks
of a Python program with the ``NNGP_*`` variables set, for tests, the
dry run and single-machine use.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from nngp_tpu_torch.parallel.chains import (CHAINS_AXIS, SITES_AXIS,
                                            chains_mesh, chains_submesh)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device_type: str = "cuda",
) -> bool:
    """Join (or start) the process group.  Returns True when the group is
    live after the call, False when running as a single process (no
    coordinator and no world size configured).  Safe to call twice.

    ``device_type`` "cuda" makes an NCCL group and first binds this
    process to its card, ``torch.cuda.set_device(LOCAL_RANK)`` (without
    ``LOCAL_RANK``: the process id modulo the cards); without a card it
    raises.  "cpu" makes a gloo group."""
    if dist.is_initialized():
        return True
    addr = coordinator_address or os.environ.get("NNGP_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("NNGP_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("NNGP_PROCESS_ID", "RANK")
    if addr is None and num_processes is None:
        return False
    if addr is None:
        init_method = "env://"          # torchrun: MASTER_ADDR, MASTER_PORT
    elif "://" in addr:
        init_method = addr
    else:
        init_method = f"tcp://{addr}"
    if device_type == "cuda":
        from nngp_tpu_torch.interop import resolve_device

        resolve_device("cuda")
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else process_id % torch.cuda.device_count())
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device_type {device_type!r}: expected 'cuda' "
                         "(NCCL) or 'cpu' (gloo)")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def global_chains_mesh():
    """1-D "chains" mesh over every rank of the group."""
    return chains_mesh()


def local_chain_slice(n_chains_total: int, mesh=None):
    """The ``[lo, hi)`` chain range this rank owns when ``n_chains_total``
    chains are sharded over ``mesh``, a 1-D "chains" mesh or a ``("chains",
    "sites")`` mesh (halo mode; the chains coordinate picks the block, and
    every sites rank of a block owns its chains): contiguous and
    block-major, the layout ``shard_states`` takes.  Uneven chains or
    another mesh raise ValueError."""
    if mesh is None:
        mesh = global_chains_mesh()
    names = tuple(mesh.mesh_dim_names or ())
    if names not in ((CHAINS_AXIS,), (CHAINS_AXIS, SITES_AXIS)):
        raise ValueError(f"expected a 1-D {CHAINS_AXIS!r} mesh or a "
                         f"({CHAINS_AXIS!r}, {SITES_AXIS!r}) mesh, got "
                         f"dimensions {names}")
    chains = chains_submesh(mesh)
    world = chains.size()
    if n_chains_total % world != 0:
        raise ValueError(
            f"n_chains={n_chains_total} must be divisible by the chains "
            f"mesh axis ({world})")
    per = n_chains_total // world
    rank = chains.get_local_rank()
    return rank * per, (rank + 1) * per


def launch_local(argv, world: int, timeout: float = 600.0,
                 env: dict | None = None) -> list:
    """Run ``python *argv`` as ``world`` local processes that form one group
    (``NNGP_COORDINATOR`` a rendezvous file in a fresh temporary directory,
    ``NNGP_NUM_PROCESSES``, ``NNGP_PROCESS_ID``; ``env`` adds variables),
    wait for all of them, and return their standard outputs in rank order.
    If one fails or the ``timeout`` (seconds, for all) passes, every rank
    still running is killed and RuntimeError names the rank and the end of
    its output."""
    with tempfile.TemporaryDirectory() as td:
        path = os.environ.get("PYTHONPATH")
        base = dict(os.environ, **(env or {}),
                    PYTHONPATH=_ROOT + (os.pathsep + path if path else ""),
                    NNGP_COORDINATOR="file://" + os.path.join(td, "rdzv"),
                    NNGP_NUM_PROCESSES=str(world))
        procs, logs = [], []
        try:
            for rank in range(world):
                out = open(os.path.join(td, f"out{rank}"), "w+")
                err = open(os.path.join(td, f"err{rank}"), "w+")
                logs.append((out, err))
                procs.append(subprocess.Popen(
                    [sys.executable, *argv], stdout=out, stderr=err,
                    env=dict(base, NNGP_PROCESS_ID=str(rank))))
            deadline = time.monotonic() + timeout
            failed = None
            # poll all: a failed rank leaves the others blocked in a
            # collective, so stop at the first failure
            while failed is None:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = (bad[0], f"exited {codes[bad[0]]}")
                elif None not in codes:
                    break
                elif time.monotonic() > deadline:
                    failed = (codes.index(None),
                              f"timed out after {timeout} s")
                else:
                    time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            texts = []
            for out, err in logs:
                out.seek(0)
                err.seek(0)
                texts.append((out.read(), err.read()))
                out.close()
                err.close()
    if failed is not None:
        rank, why = failed
        out, err = texts[rank]
        raise RuntimeError(f"rank {rank} of {world} {why}:\n{out[-2000:]}"
                           f"{err[-4000:]}")
    return [out for out, _ in texts]
