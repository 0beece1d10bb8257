"""Chains sharded over the processes of a ``torch.distributed`` group.

Port of ``nngp_tpu/parallel/chains.py``.  Chains are the data parallelism
of MCMC: a cycle of one chain never reads another, so each rank advances
its own contiguous block of chains on its own device.  The problem (graph,
data) is replicated, as every rank builds or loads the same fit.  Where
``nngp_tpu`` runs one controller over a ``shard_map`` of vmapped blocks,
PyTorch runs one process per card: the counterpart of its 1-D ``Mesh``
with a ``"chains"`` axis is a 1-D ``DeviceMesh`` named ``"chains"`` over
the process group.

At the end of a cycle the ranks exchange their chains' states and records
in one ``all_gather``, so every rank holds the whole fit, as ``nngp_tpu``'s
host holds every chain's records after a cycle.  Over gloo the exchange
moves host tensors; over NCCL, device tensors.
"""

from __future__ import annotations

import math
from dataclasses import fields, replace

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from nngp_tpu_torch.models.gaussian import ChainState, run_cycle
from nngp_tpu_torch.parallel.collectives import on_wire

CHAINS_AXIS = "chains"
SITES_AXIS = "sites"    # halo mode (parallel/halo.py)


def chains_mesh(device_type: str | None = None,
                world: int | None = None) -> DeviceMesh:
    """1-D ``DeviceMesh`` named ``"chains"`` over the process group (join it
    first: ``initialize_distributed``).  ``device_type`` defaults to the
    group's backend: "cuda" for NCCL, "cpu" for gloo; ``world`` to the
    group's size."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed() "
                           "or torch.distributed.init_process_group() first")
    if device_type is None:
        device_type = "cuda" if "nccl" in dist.get_backend() else "cpu"
    world = dist.get_world_size() if world is None else int(world)
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(CHAINS_AXIS,))


def shard_states(states: ChainState, mesh) -> ChainState:
    """This rank's chains ``[lo, hi)`` (``local_chain_slice``) of a stacked
    chain state that holds every chain."""
    from nngp_tpu_torch.parallel.distributed import local_chain_slice

    lo, hi = local_chain_slice(states.field.shape[0], mesh)
    return replace(states, **{
        f.name: getattr(states, f.name)[lo:hi] for f in fields(states)
        if getattr(states, f.name) is not None})


def gather_chains(parts, mesh) -> list:
    """Every rank's chains of each tensor, concatenated in rank order.

    ``parts`` is a list of (tensor, chain dimension); every rank passes
    tensors of the same shapes.  They travel packed in one buffer, in one
    ``all_gather`` (``on_wire``: on the host over gloo).  Each result is
    on its input's device, with its dtype (the packing promotes and casts
    back, which is exact for these float types)."""
    local = parts[0][0].shape[parts[0][1]]
    # explicit widths: reshape(local, -1) refuses tensors with no elements
    flat = [t.movedim(d, 0).reshape(local, math.prod(t.shape) // local)
            for t, d in parts]
    buf = torch.cat(flat, dim=1)
    group = mesh.get_group()
    wire = on_wire(buf, group)
    got = [torch.empty_like(wire) for _ in range(mesh.size())]
    dist.all_gather(got, wire, group=group)
    full = torch.cat(got).to(buf.device)
    out, at = [], 0
    for (t, d), f in zip(parts, flat):
        width = f.shape[1]
        shape = (full.shape[0],) + tuple(t.movedim(d, 0).shape[1:])
        out.append(full[:, at:at + width].reshape(shape).movedim(0, d)
                   .to(t.dtype).contiguous())
        at += width
    return out


def chains_submesh(mesh):
    """The "chains" dimension of ``mesh``: the mesh itself when it is 1-D,
    ``mesh["chains"]`` of a ``("chains", "sites")`` mesh."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh[CHAINS_AXIS] if len(names) > 1 else mesh


def make_sharded_cycle_fn(graph, data, cfg, mesh, cycle=run_cycle):
    """``cycle`` (``run_cycle`` by default) with the chains sharded over
    ``mesh`` (its "chains" dimension).

    ``call(states, key, iter_start, saved_slots=None)`` takes every
    chain's states and the cycle's draw key of every chain (as every rank
    holds them), advances this rank's chains ``[lo, hi)`` with their rows
    of ``key`` (``DrawKey.select``: the numbers ``run_cycle`` draws for
    them in one batch), and returns (states, records) of every chain,
    gathered from every chains block, in ``run_cycle``'s layout (records
    iterations leading, chains second)."""
    from nngp_tpu_torch.parallel.distributed import local_chain_slice

    chains = chains_submesh(mesh)

    def call(states, key, iter_start, saved_slots=None):
        lo, hi = local_chain_slice(states.field.shape[0], mesh)
        local, recs = cycle(graph, data, cfg, shard_states(states, mesh),
                            key.select(lo, hi), iter_start,
                            saved_slots=saved_slots)
        names = [f.name for f in fields(local)
                 if getattr(local, f.name) is not None]
        keys = list(recs)
        out = gather_chains([(getattr(local, k), 0) for k in names]
                            + [(recs[k], 1) for k in keys], chains)
        return (replace(local, **dict(zip(names, out))),
                dict(zip(keys, out[len(names):])))

    return call
