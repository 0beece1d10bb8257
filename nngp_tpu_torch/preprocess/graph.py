"""VecchiaGraph: the static problem structure, built once on the host.

Copy of ``nngp_tpu/preprocess/graph.py`` (same arrays, bit for bit) without
the pytree registration and without the TPU's padded block schedules
(``chrom_blocks``, the degree-classed ``chrom_*`` tables, ``levels_idx``).
It adds the colour-major CSR (``color_ptr``, ``color_sites``), the
sweep plan the chromatic sweep kernel walks (``plan_*``,
``preprocess/coloring.py:sweep_plan``) and the tables of the three
scatter-sums of an iteration (``nn_sum``, ``pair_sum``, ``obs_sum``:
:class:`OrderedSum`), which add each target's terms in a fixed order, and
the level steps the level solve kernel walks (``step_*``,
``preprocess/coloring.py:level_steps``).
``build_graph`` returns NumPy leaves; ``VecchiaGraph.to(device)`` gives
the same dataclass with torch leaves: int32 for the colour, plan and step tables and the padded neighbour
lists, int64 for every other index tensor, float32 values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from nngp_tpu_torch.preprocess.coloring import (
    STEP_FIELDS,
    color_csr,
    dag_levels,
    greedy_coloring,
    level_segments,
    level_steps,
    moralized_edges,
    site_neighbor_lists,
    sweep_plan,
)
from nngp_tpu_torch.preprocess.dedupe import ObsMaps
from nngp_tpu_torch.preprocess.neighbors import find_ordered_nn
from nngp_tpu_torch.preprocess.ordering import lonlat_to_xyz
from nngp_tpu_torch.tracing import span

# index tables kept int32 on the device (the sweep kernel reads the plan,
# the level solve kernel the steps);
# every other integer leaf becomes int64
_KERNEL_I32 = ("nbr_sites", "nbr_edge", "color_ptr", "color_sites",
               "plan_sites", "plan_ptr", "plan_nbr", "plan_edge",
               *STEP_FIELDS)
# the fields of coloring.sweep_plan's result
PLAN_FIELDS = ("plan_sites", "plan_ptr", "plan_nbr", "plan_edge")


@dataclass(frozen=True)
class OrderedSum:
    """Index tables of a sum of N terms into T targets in a fixed order
    (``ops/vecchia.py:ordered_sum``): each target's terms one at a time in
    increasing term index, starting from zero — the order of ``index_add_``
    on the CPU, with no atomics on any device.

    Targets are ranked by their number of terms, most first (ties in target
    order).  Step j adds the j-th term of the ``steps[j]`` targets that have
    more than j terms, a prefix of that ranking; ``src`` lists the terms
    step by step, and ``pos[t]`` is target t's rank."""

    src: object                   # [N] term indices, step-major
    pos: object                   # [T]
    steps: tuple                  # non-increasing ints, sum N

    def to(self, device) -> "OrderedSum":
        return OrderedSum(
            src=torch.as_tensor(self.src, dtype=torch.int64, device=device),
            pos=torch.as_tensor(self.pos, dtype=torch.int64, device=device),
            steps=self.steps)


def ordered_sum_plan(targets, n_targets: int) -> OrderedSum:
    """The :class:`OrderedSum` of terms i -> ``targets[i]`` (NumPy); a term
    with a negative target is left out (the padding, whose terms are exact
    zeros: leaving out a zero term never changes a sum that starts from
    +0)."""
    targets = np.asarray(targets, dtype=np.int64).reshape(-1)
    kept = np.flatnonzero(targets >= 0)
    count = np.bincount(targets[kept], minlength=n_targets)
    rank = np.argsort(-count, kind="stable")
    pos = np.empty(n_targets, dtype=np.int64)
    pos[rank] = np.arange(n_targets)
    by_target = kept[np.argsort(targets[kept], kind="stable")]
    first = np.cumsum(count) - count
    steps = tuple(int((count > j).sum())
                  for j in range(int(count.max(initial=0))))
    src = np.concatenate([by_target[first[rank[:k]] + j]
                          for j, k in enumerate(steps)]
                         or [np.zeros(0, np.int64)])
    return OrderedSum(src=src, pos=pos, steps=steps)


def sum_plans(NN, pair_edge_id, locs_match, n_edges: int) -> dict:
    """The graph's three :class:`OrderedSum` fields: ``nn_sum`` (the
    entries of the compressed rows onto their columns, in (row, slot)
    order: diag(Q), L' z), ``pair_sum`` (the position pairs of the rows onto
    their moralized edges, in ``pair_edge_id`` order: Q's off-diagonal; the
    sentinel edge gets no term, so it sums to 0) and ``obs_sum`` (the
    observations onto their sites, in ``locs_match`` order: the residual
    sums)."""
    NN = np.asarray(NN)
    n = NN.shape[0]
    pair_edge_id = np.asarray(pair_edge_id)
    return {"nn_sum": ordered_sum_plan(NN, n),
            "pair_sum": ordered_sum_plan(
                np.where(pair_edge_id == n_edges, -1, pair_edge_id),
                n_edges + 1),
            "obs_sum": ordered_sum_plan(locs_match, n)}


@dataclass(frozen=True)
class VecchiaGraph:
    # geometry (kernel_coords: coordinates fed to the covariance function —
    # 3-D unit-sphere embedding for *_sphere families, raw otherwise)
    kernel_coords: object         # f32 [n, d']
    # per-neighbor-set pairwise squared distances by range group, computed
    # in float64 on the host (theta-independent) and stored f32
    nn_dist2: object              # f32 [n, m+1, m+1, G]
    # Vecchia DAG
    NNarray: object               # [n, m+1]  (row i = [i, parents...], pad -1)
    nn_mask: object               # f32 [n, m+1]
    # moralized graph / Q = L'L assembly
    pair_edge_id: object          # [n, P] -> edge id (sentinel = n_edges)
    pair_a: object                # [P] position pairs (a<b) used for Q scatter
    pair_b: object                # [P]
    nbr_sites: object             # i32 [n, D]  (pad = n)
    nbr_edge: object              # i32 [n, D]  (pad = n_edges)
    nbr_mask: object              # f32 [n, D]
    # chromatic schedule: sites of colour c are
    # color_sites[color_ptr[c]:color_ptr[c+1]]
    color_ptr: object             # i32 [n_colors+1]
    color_sites: object           # i32 [n]
    # sweep plan (coloring.sweep_plan): colour-major, degree-sorted sites
    # (color_ptr indexes them too) and their neighbours as a CSR
    plan_sites: object            # i32 [n]
    plan_ptr: object              # i32 [n+1]
    plan_nbr: object              # i32 [2E]
    plan_edge: object             # i32 [2E]
    # triangular-solve schedule: tuple of [k_s, W_s] tables in topological
    # order, pad = n (preprocess.coloring.level_segments)
    level_segs: tuple
    # the same schedule as the level solve kernel walks it
    # (coloring.level_steps): step s solves
    # step_sites[step_ptr[s]:step_ptr[s+1]], whose parents are step_cols
    step_ptr: object              # i32 [S+1]
    step_sites: object            # i32 [n]
    step_cols: object             # i32 [n, m]  (pad -1)
    # observation maps
    locs_match: object            # [n_obs]
    hctam_scol_1: object          # [n]
    obs_per_loc: object           # f32 [n]
    # fixed-order scatter-sums (sum_plans)
    nn_sum: OrderedSum
    pair_sum: OrderedSum
    obs_sum: OrderedSum
    # static metadata
    covfun: str
    n_edges: int
    # floor on the per-row conditional variance d_i in the factor build
    # (1e-12 for the exponential families; see nngp_tpu's VecchiaGraph)
    d_floor: float = 1e-12

    @property
    def n(self) -> int:
        return self.NNarray.shape[0]

    @property
    def m(self) -> int:
        return self.NNarray.shape[1] - 1

    @property
    def n_obs(self) -> int:
        return self.locs_match.shape[0]

    @property
    def n_colors(self) -> int:
        return self.color_ptr.shape[0] - 1

    @property
    def n_levels_rows(self) -> int:
        """Rows of the level schedule: sequential steps of one solve."""
        return sum(t.shape[0] for t in self.level_segs)

    def to(self, device) -> "VecchiaGraph":
        """The same graph with torch leaves on ``device``."""

        def conv(name, a):
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            if a.dtype.kind == "f":
                a = a.astype(np.float32)
            else:
                a = a.astype(np.int32 if name in _KERNEL_I32 else np.int64)
            return torch.as_tensor(a, device=device)

        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "level_segs":
                out[f.name] = tuple(conv(f.name, t) for t in v)
            elif isinstance(v, OrderedSum):
                out[f.name] = v.to(device)
            elif isinstance(v, (np.ndarray, torch.Tensor)):
                out[f.name] = conv(f.name, v)
            else:
                out[f.name] = v
        return VecchiaGraph(**out)


def nn_group_sqdist(coords, NN, covfun: str, dtype=np.float32) -> np.ndarray:
    """Per-row pairwise squared distances of each (m+1)-neighbor set, by
    range group: f32 [n, k, k, G].

    Computed in float64 on the host so no coordinate cancellation survives
    into the device factor build (ops/covariance.py group_sqdist); chunked
    over rows to bound peak host memory at large n."""
    from nngp_tpu_torch.ops.covariance import group_sqdist, n_range_groups

    coords = np.asarray(coords, dtype=np.float64)
    NN = np.asarray(NN)
    n, k = NN.shape
    G = n_range_groups(covfun, coords.shape[1])
    out = np.empty((n, k, k, G), dtype=dtype)
    safe = np.maximum(NN, 0)
    chunk = max(1, (64 << 20) // max(1, k * k * coords.shape[1] * 8))
    for lo in range(0, n, chunk):
        pts = coords[safe[lo : lo + chunk]]          # [c, k, d'] f64
        out[lo : lo + chunk] = group_sqdist(pts, covfun)
    return out


def build_graph(
    obs_maps: ObsMaps,
    m: int,
    covfun: str,
    dtype=np.float32,
    NN: np.ndarray | None = None,
    timings: dict | None = None,
) -> tuple[VecchiaGraph, np.ndarray]:
    """Assemble the VecchiaGraph from deduped/reordered locations.

    Returns (graph, NNarray_numpy).  Covers reference steps
    mcmc_nngp_initialize.R:93-110 plus the level schedule.  Pass a
    precomputed ``NN`` to skip the neighbor search.  ``timings``, when
    given, receives the seconds of each host stage.
    """
    timings = {} if timings is None else timings
    locs = obs_maps.locs
    lonlat = "sphere" in covfun
    with span("nn_search", timings):
        if NN is None:
            NN = find_ordered_nn(locs, m, lonlat=lonlat)
        else:
            NN = np.asarray(NN)
            if NN.shape != (locs.shape[0], m + 1):
                raise ValueError(f"NN shape {NN.shape} does not match "
                                 f"{locs.shape[0]} locations and m={m}")
    n = NN.shape[0]
    with span("coloring", timings):
        edges, pair_edge_id, pa, pb = moralized_edges(NN)
        nbr_sites, nbr_edge, nbr_mask = site_neighbor_lists(n, edges)
        colors = greedy_coloring(NN)
        color_ptr, color_sites = color_csr(colors)
        plan = sweep_plan(color_ptr, color_sites, nbr_sites, nbr_edge)
        levels = dag_levels(NN)
        level_segs = level_segments(levels, n_sentinel=n)
        steps = level_steps(level_segs, NN, NN >= 0)
    with span("nn_dist2", timings):
        coords = lonlat_to_xyz(locs) if lonlat else locs
        nn_dist2 = nn_group_sqdist(coords, NN, covfun, dtype=dtype)
    g = VecchiaGraph(
        kernel_coords=np.asarray(coords, dtype=dtype),
        nn_dist2=nn_dist2,
        NNarray=NN,
        nn_mask=(NN >= 0).astype(dtype),
        pair_edge_id=pair_edge_id,
        pair_a=np.asarray(pa),
        pair_b=np.asarray(pb),
        nbr_sites=nbr_sites,
        nbr_edge=nbr_edge,
        nbr_mask=nbr_mask.astype(dtype),
        color_ptr=color_ptr,
        color_sites=color_sites,
        **dict(zip(PLAN_FIELDS, plan)),
        level_segs=level_segs,
        **dict(zip(STEP_FIELDS, steps)),
        locs_match=obs_maps.locs_match,
        hctam_scol_1=obs_maps.hctam_scol_1,
        obs_per_loc=obs_maps.obs_per_loc.astype(dtype),
        **sum_plans(NN, pair_edge_id, obs_maps.locs_match, edges.shape[0]),
        covfun=covfun,
        n_edges=int(edges.shape[0]),
        d_floor=1e-5 if covfun.startswith("matern") else 1e-12,
    )
    return g, NN
