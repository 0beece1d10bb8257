"""Sites sharded over the ranks of a ``torch.distributed`` group: the
partition, the halo tables, the exchange and the two sharded solvers.

Port of ``nngp_tpu/parallel/halo.py``.  When one card's throughput (or
memory) is not enough for a chain's field, the sites are split over the
"sites" dimension of a ``("chains", "sites")`` ``DeviceMesh``: each rank
computes the chromatic-sweep and level-solve rows it owns, and only
boundary values cross ranks.  (The reference has no distributed mode; its
scalability is Vecchia sparsity plus chromatic blocking,
mcmc_nngp_initialize.R:93-110.)

- **The partition** (``_spatial_owner``): balanced 2-D quantile blocks of
  the kernel coordinates, as ``nngp_tpu``'s.
- **The need set** of a rank: its owned sites, their moralized neighbours
  and their DAG parents.  Each rank keeps a full-length mirror of the
  field, [C, n], fresh at its need set.
- **The schedules.**  Every rank walks the same global steps: the colour
  steps of the sweep plan (``preprocess/coloring.py:sweep_plan``) and the
  rows of the graph's ``level_segs``.  At each step it updates its own
  entries, then sends the fresh values that other ranks' need sets hold
  (``_exchange``: one ``batch_isend_irecv`` a step over every nonempty ring
  distance k, to rank d + k and from rank d - k).  All tables are static,
  built once on the host, vectorized (``build_halo_plan``); each rank moves
  only its own part to its device (``HaloPlan.for_rank(d).to(device)``).
- **The sweeps** run on each rank's owned sub-plan (``SubPlan``): its
  positions of the global plan in the plan's order, so each site keeps its
  degree, its lane group and its CSR order, and the hand-written kernel
  gives each site the bits of the unsharded launch
  (``ops/sweep.py:chromatic_sweep_step``, one launch a colour step).
- ``reconcile`` makes a mirror fresh everywhere: owned entries kept, the
  rest zeroed, one ``all_reduce``.

Where ``nngp_tpu`` pads its step tables to a rectangle and writes the pads
into a dummy slot n of an [n+1] mirror, the tables here are ragged (a
host offset array beside each index list), so a mirror is the [C, n]
field the sweep kernel takes.  Over gloo, which has no send or receive of
CUDA tensors, the exchange goes through the host; over NCCL it stays on
the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from nngp_tpu_torch.ops.sweep import SubPlan, chromatic_sweep_step
from nngp_tpu_torch.ops.trisolve import solve_rows
from nngp_tpu_torch.parallel.chains import CHAINS_AXIS, SITES_AXIS
from nngp_tpu_torch.parallel.collectives import _all_reduce
from nngp_tpu_torch.preprocess.coloring import owned_sweep_plan
from nngp_tpu_torch.preprocess.graph import (PLAN_FIELDS, OrderedSum,
                                             ordered_sum_plan)


def _host(a) -> np.ndarray:
    """A graph leaf as a host array (one copy for a device tensor)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tensor(a, device):
    return torch.as_tensor(np.asarray(a), device=device)


@dataclass(frozen=True)
class Schedule:
    """The send lists of one schedule of T steps over D ranks (host).  For
    each ring distance ``dists[j]`` = k, rank d sends at step t the values
    at ``send[j][send_ptr[j][d, t]:send_ptr[j][d, t+1]]`` to rank d + k,
    and rank d + k writes them at the same sites."""

    dists: tuple                  # ring distances with any send entry
    send_ptr: tuple               # per distance: int64 [D, T+1]
    send: tuple                   # per distance: sites, (sender, step) order

    def exchange(self, d: int, D: int) -> "Exchange":
        """Rank d's part: what it sends and what it receives."""
        send_ptr, send, recv_ptr, recv = [], [], [], []
        for k, ptr, sites in zip(self.dists, self.send_ptr, self.send):
            for r, offs, part in ((d, send_ptr, send),
                                  ((d - k) % D, recv_ptr, recv)):
                offs.append(ptr[r] - ptr[r, 0])
                part.append(sites[ptr[r, 0]:ptr[r, -1]])
        return Exchange(self.dists, tuple(send_ptr), tuple(send),
                        tuple(recv_ptr), tuple(recv))


@dataclass(frozen=True)
class Exchange:
    """Rank d's part of a ``Schedule``: for each ring distance ``dists[j]``
    = k, at step t it sends the values at ``send[j][send_ptr[j][t]:
    send_ptr[j][t+1]]`` to rank d + k and writes what rank d - k sends at
    ``recv[j][recv_ptr[j][t]:recv_ptr[j][t+1]]``.  Offsets stay on the
    host."""

    dists: tuple
    send_ptr: tuple               # per distance: int64 [T+1]
    send: tuple
    recv_ptr: tuple
    recv: tuple

    def to(self, device) -> "Exchange":
        return Exchange(self.dists, self.send_ptr,
                        tuple(_tensor(s, device) for s in self.send),
                        self.recv_ptr,
                        tuple(_tensor(s, device) for s in self.recv))


@dataclass(frozen=True)
class RankTables:
    """What rank d computes on: its need rows, owned rows and owned
    observations (ascending), the fixed-order sums restricted to them
    (``preprocess/graph.py:OrderedSum``: diag Q and Q's edges over the need
    rows' terms, the residual sums over the owned observations), its owned
    sub-plan of the sweep plan and its entries of the level solve's rows
    (row r: ``level_rows[level_ptr[r]:level_ptr[r+1]]``, offsets on the
    host)."""

    need: object                  # [N_d]
    owned: object                 # [O_d]
    obs: object                   # [n_obs_d]
    nn_sum: OrderedSum
    pair_sum: OrderedSum
    obs_sum: OrderedSum
    sub: SubPlan
    level_ptr: np.ndarray         # int64 [T+1], T = rows of level_segs
    level_rows: object            # sites, in the rows' order

    def to(self, device) -> "RankTables":
        return RankTables(_tensor(self.need, device),
                          _tensor(self.owned, device),
                          _tensor(self.obs, device),
                          self.nn_sum.to(device), self.pair_sum.to(device),
                          self.obs_sum.to(device), self.sub.to(device),
                          self.level_ptr, _tensor(self.level_rows, device))


@dataclass(frozen=True)
class HaloPlan:
    """Static partition and exchange tables of all D ranks, on the host
    (``for_rank`` gives one rank's part).  ``owner``, ``need_rows``,
    ``owned_rows`` and ``obs_owner`` hold the values of ``nngp_tpu``'s
    plan."""

    owner: np.ndarray             # i32 [n] site -> rank
    need_rows: np.ndarray         # i32 [D, Nmax] owned + halo rows; pad = n
    owned_rows: np.ndarray        # i32 [D, Omax] owned rows; pad = n
    obs_owner: np.ndarray         # i32 [n_obs] = owner[locs_match]
    sweep: Schedule               # T = colours of the sweep plan
    level: Schedule               # T = rows of graph.level_segs
    ranks: tuple                  # D RankTables
    D: int

    @property
    def n(self) -> int:
        return self.owner.shape[0]

    def for_rank(self, d: int) -> "LocalPlan":
        """What rank d reads: its tables and its part of the exchanges."""
        return LocalPlan(d, self.D, self.owner, self.ranks[d],
                         self.sweep.exchange(d, self.D),
                         self.level.exchange(d, self.D),
                         plan_overlap(self))


@dataclass(frozen=True)
class LocalPlan:
    """Rank d's part of a ``HaloPlan`` (``.to(device)`` moves only this):
    the owner map (for ``reconcile``), its ``RankTables``, its sends and
    receives of the two schedules, and the plan's overlap."""

    d: int
    D: int
    owner: object                 # i32 [n]
    rank: RankTables
    sweep: Exchange
    level: Exchange
    overlap: float

    def to(self, device) -> "LocalPlan":
        return LocalPlan(self.d, self.D, _tensor(self.owner, device),
                         self.rank.to(device), self.sweep.to(device),
                         self.level.to(device), self.overlap)


def _spatial_owner(coords: np.ndarray, n: int, D: int) -> np.ndarray:
    """Balanced 2-D block partition (``nngp_tpu``'s): quantile stripes of
    the first coordinate, each split into quantile blocks of the second;
    1-D stripes when D is prime or the data are 1-D."""
    Dx = 1
    for d in range(2, int(np.sqrt(D)) + 1):
        if D % d == 0:
            Dx = d
    if coords.shape[1] < 2:
        Dx = 1
    Dy = D // Dx
    order = np.argsort(coords[:, 0], kind="stable")
    owner = np.empty(n, dtype=np.int32)
    chunk_x = -(-n // Dx)
    for sx in range(Dx):
        stripe = order[sx * chunk_x : (sx + 1) * chunk_x]
        sub = stripe[np.argsort(coords[stripe, 1], kind="stable")]
        chunk_y = -(-len(sub) // Dy)
        for sy in range(Dy):
            owner[sub[sy * chunk_y : (sy + 1) * chunk_y]] = sx * Dy + sy
    return owner


def _split(sender, step, sites, D, T):
    """Entries (walk order) grouped by (sender, step), order kept within a
    group: (offsets int64 [D, T+1], sites)."""
    key = sender * T + step
    flat = np.concatenate([[0], np.cumsum(np.bincount(key, minlength=D * T))])
    return (flat[np.arange(D)[:, None] * T + np.arange(T + 1)],
            sites[np.argsort(key, kind="stable")])


def _schedule(step, sites, own, need_mask, D, T) -> Schedule:
    """The send lists of a schedule whose real entries are (step, site) in
    walk order, ``own`` the owner of each entry."""
    dists, send_ptr, send = [], [], []
    for k in range(1, D):
        sel = need_mask[(own + k) % D, sites]
        if not sel.any():
            continue
        ptr, s = _split(own[sel], step[sel], sites[sel], D, T)
        dists.append(k)
        send_ptr.append(ptr)
        send.append(s)
    return Schedule(tuple(dists), tuple(send_ptr), tuple(send))


def build_halo_plan(graph, D: int, owner: np.ndarray | None = None) -> HaloPlan:
    """The partition and halo tables of ``graph`` (host arrays, or a graph
    on the card, read once) over D ranks.  ``owner`` overrides the spatial
    partition (tests use adversarial ones)."""
    n = graph.n
    if owner is None:
        owner = _spatial_owner(_host(graph.kernel_coords), n, D)
    owner = np.asarray(owner, dtype=np.int32)
    NN = _host(graph.NNarray)
    nbr_sites = _host(graph.nbr_sites)
    nbr_mask = _host(graph.nbr_mask) > 0

    # need set per rank: owned + moralized neighbours + DAG parents of
    # owned, as one [D, n] membership mask
    need_mask = np.zeros((D, n), dtype=bool)
    need_mask[owner, np.arange(n)] = True
    need_mask[np.repeat(owner, nbr_mask.sum(axis=1)), nbr_sites[nbr_mask]] = True
    par_mask = NN[:, 1:] >= 0
    need_mask[np.repeat(owner, par_mask.sum(axis=1)), NN[:, 1:][par_mask]] = True

    need_sets = [np.flatnonzero(need_mask[d]) for d in range(D)]
    own_sets = [np.flatnonzero(owner == d) for d in range(D)]

    def padded(sets):
        out = np.full((D, max(len(s) for s in sets)), n, dtype=np.int32)
        for d, s in enumerate(sets):
            out[d, :len(s)] = s
        return out

    lm = _host(graph.locs_match)
    obs_owner = owner[lm]

    # the sweep plan's colour steps
    color_ptr = _host(graph.color_ptr)
    plan = [_host(getattr(graph, k)) for k in PLAN_FIELDS]
    T = len(color_ptr) - 1
    sweep = _schedule(np.repeat(np.arange(T), np.diff(color_ptr)), plan[0],
                      owner[plan[0]].astype(np.int64), need_mask, D, T)

    # the level solve's rows: every table's rows in order, pads dropped
    tabs = [_host(t) for t in graph.level_segs]
    steps, sites, r0 = [], [], 0
    for t in tabs:
        r, p = np.nonzero(t < n)
        steps.append(r + r0)
        sites.append(t[r, p])
        r0 += t.shape[0]
    steps, sites = np.concatenate(steps), np.concatenate(sites)
    own = owner[sites].astype(np.int64)
    level = _schedule(steps, sites, own, need_mask, D, r0)
    level_ptr, level_rows = _split(own, steps, sites, D, r0)

    pair_edge = _host(graph.pair_edge_id)
    pair_edge = np.where(pair_edge == graph.n_edges, -1, pair_edge)
    ranks = []
    for d in range(D):
        need, obs = need_sets[d], np.flatnonzero(obs_owner == d)
        ranks.append(RankTables(
            need=need, owned=own_sets[d], obs=obs,
            nn_sum=ordered_sum_plan(NN[need], n),
            pair_sum=ordered_sum_plan(pair_edge[need], graph.n_edges + 1),
            obs_sum=ordered_sum_plan(lm[obs], n),
            sub=SubPlan.of(*owned_sweep_plan(color_ptr, *plan, owner == d)),
            level_ptr=level_ptr[d] - level_ptr[d, 0],
            level_rows=level_rows[level_ptr[d, 0]:level_ptr[d, -1]]))

    return HaloPlan(owner=owner, need_rows=padded(need_sets),
                    owned_rows=padded(own_sets), obs_owner=obs_owner,
                    sweep=sweep, level=level, ranks=tuple(ranks), D=D)


def plan_overlap(plan: HaloPlan) -> float:
    """Need rows over owned rows, minus one: the halo's share of the work."""
    return float((plan.need_rows < plan.n).sum()) / plan.n - 1.0


# the plan at scale (``nngp_tpu``'s dryrun_multichip halo-plan part)
CHECK_SITES, CHECK_RANKS, CHECK_SEED, CHECK_OVERLAP = 100_000, 8, 7, 0.10


def halo_plan_check() -> dict:
    """The plan at scale, host only: an ``exponential_isotropic`` graph (m =
    5) of CHECK_SITES uniform sites in [0, 1000]^2, in their drawn order,
    and its plan over CHECK_RANKS ranks, whose overlap must stay under
    CHECK_OVERLAP; returns the overlap and the seconds of the graph and of
    the plan."""
    from nngp_tpu_torch.preprocess.dedupe import dedupe_and_match
    from nngp_tpu_torch.preprocess.graph import build_graph

    n, D = CHECK_SITES, CHECK_RANKS
    locs = np.random.default_rng(CHECK_SEED).uniform(0, 1000.0, size=(n, 2))
    t = time.perf_counter()
    maps = dedupe_and_match(locs, perm_fn=lambda L: np.arange(len(L)))
    graph, _ = build_graph(maps, m=5, covfun="exponential_isotropic")
    graph_s = time.perf_counter() - t
    t = time.perf_counter()
    plan = build_halo_plan(graph, D)
    plan_s = time.perf_counter() - t
    overlap = plan_overlap(plan)
    if not overlap < CHECK_OVERLAP:
        raise RuntimeError(f"halo overlap {overlap:.4f} >= {CHECK_OVERLAP} "
                           f"at {n}/D={D}")
    return {"n": n, "D": D, "overlap": overlap, "graph_s": graph_s,
            "plan_s": plan_s}


def halo_mesh(n_sites: int, device_type: str | None = None):
    """2-D ``("chains", "sites")`` ``DeviceMesh`` over the process group:
    ``n_sites`` ranks a chains block (they must divide the world).
    ``device_type`` defaults to the group's backend: "cuda" for NCCL, "cpu"
    for gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed() "
                           "first")
    world = dist.get_world_size()
    if n_sites < 1 or world % n_sites:
        raise ValueError(f"{n_sites} sites ranks do not divide the world "
                         f"({world})")
    if device_type is None:
        device_type = "cuda" if "nccl" in dist.get_backend() else "cpu"
    return init_device_mesh(device_type, (world // n_sites, n_sites),
                            mesh_dim_names=(CHAINS_AXIS, SITES_AXIS))


def _exchange(w, step, tables: Exchange, group):
    """Send the values this rank wrote at ``step`` to the ranks whose need
    sets hold them, and write what the others send into ``w`` [C, n]: one
    ``batch_isend_irecv`` over every nonempty ring distance (over gloo
    through the host).  ``_exchange.calls`` and ``_exchange.bytes`` count
    the batches and the bytes this rank sent."""
    if not tables.dists:
        return w
    D, d = dist.get_world_size(group), dist.get_rank(group)
    host = "gloo" in dist.get_backend(group)
    ops, recvs, sent = [], [], 0
    for k, sp, ss, rp, rs in zip(tables.dists, tables.send_ptr, tables.send,
                                 tables.recv_ptr, tables.recv):
        a, b = int(sp[step]), int(sp[step + 1])
        if b > a:
            vals = w[:, ss[a:b]]
            vals = vals.cpu() if host else vals
            ops.append(dist.P2POp(dist.isend, vals, dist.get_global_rank(
                group, (d + k) % D), group))
            sent += vals.numel() * vals.element_size()
        a, b = int(rp[step]), int(rp[step + 1])
        if b > a:
            buf = torch.empty(w.shape[0], b - a, dtype=w.dtype,
                              device="cpu" if host else w.device)
            ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(
                group, (d - k) % D), group))
            recvs.append((rs[a:b], buf))
    if not ops:
        return w
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for idx, buf in recvs:
        w[:, idx] = buf.to(w.device)
    _exchange.calls += 1
    _exchange.bytes += sent
    return w


_exchange.calls = 0
_exchange.bytes = 0


def reconcile(w, owner, group):
    """The mirror ``w`` [C, n] fresh everywhere: each rank keeps its owned
    entries, zeroes the rest, and one ``all_reduce`` sums them (each sum
    has one nonzero term, so it is exact)."""
    mine = owner == dist.get_rank(group)
    return _all_reduce(torch.where(mine, w, torch.zeros((), dtype=w.dtype,
                                                         device=w.device)),
                       group)


def _check_rank(plan: LocalPlan, group):
    if (plan.d, plan.D) != (dist.get_rank(group), dist.get_world_size(group)):
        raise ValueError(f"plan of rank {plan.d} of {plan.D} on rank "
                         f"{dist.get_rank(group)} of "
                         f"{dist.get_world_size(group)}")


def halo_level_solve(graph, plan: LocalPlan, linv, v, group):
    """Solve L x = v per chain with the rows sharded by owner: rank d solves
    its entries of each ``level_segs`` row with ``ops/trisolve.py:
    level_solve``'s row arithmetic on this device (``solve_rows``: on a card
    the kernel's), then exchanges them; a reconcile makes x fresh
    everywhere.  linv [C, n, m+1] must be fresh at this rank's need rows,
    v [C, n] at its owned rows."""
    _check_rank(plan, group)
    ptr, rows_all = plan.rank.level_ptr, plan.rank.level_rows
    safe_nn = torch.clamp_min(graph.NNarray, 0)
    x = torch.zeros_like(v)
    for r in range(len(ptr) - 1):
        a, b = int(ptr[r]), int(ptr[r + 1])
        if b > a:
            rows = rows_all[a:b]
            x[:, rows] = solve_rows(linv[:, rows], graph.nn_mask[rows, 1:],
                                    x[:, safe_nn[rows, 1:]], v[:, rows])
        _exchange(x, r, plan.level, group)
    return reconcile(x, plan.owner, group)


def halo_chromatic_sweeps(w, q_plan, P, rs, noise, scal, plan: LocalPlan,
                          group):
    """All sweeps of one iteration on this rank's owned sub-plan, in place
    on the mirror ``w`` [C, n] (fresh at the need set on entry): for each
    sweep s and colour c one ``chromatic_sweep_step`` with the sweep's
    normals ``noise[:, s]`` (by site, as the unsharded sweeps take them),
    then ``_exchange``.  ``q_plan`` is Q in the sub-plan's order.  Returns
    ``w`` fresh everywhere (``reconcile``)."""
    _check_rank(plan, group)
    sub = plan.rank.sub
    for s in range(noise.shape[1]):
        z = noise[:, s:s + 1].contiguous()     # one copy a sweep
        for c in range(len(sub.bounds) - 1):
            chromatic_sweep_step(w, q_plan, P, rs, z, scal, sub, c)
            _exchange(w, c, plan.sweep, group)
    return reconcile(w, plan.owner, group)
