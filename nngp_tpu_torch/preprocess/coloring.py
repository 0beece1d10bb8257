"""Moralized-graph machinery: edges, greedy coloring, DAG levels.

Host-side copy of ``nngp_tpu/preprocess/coloring.py`` (same outputs, bit
for bit), without the padded block schedules the TPU path needed.

Reference parity:
- MRF adjacency by moralization  crossprod(L)       (mcmc_nngp_initialize.R:103)
- naive greedy coloring                              (Scripts/Coloring.R:2-20)
- DAG level schedule for the sparse triangular solve that
  replaces Matrix::solve(L, v) (mcmc_nngp_initialize.R:208,
  mcmc_nngp_update_Gaussian.R:127, mcmc_nngp_predict.R:46).

Everything here is host-side NumPy producing static index arrays:
- undirected edge list of the moralized graph + a per-row scatter map used to
  assemble the nonzeros of Q = L'L on device in one scatter-add;
- per-site padded neighbor lists (sites + edge ids) for the chromatic
  conditional-mean gather;
- the colour-major site list (CSR), the sweep plan built from it (sites
  sorted by degree within each colour, their neighbours as a CSR) that the
  chromatic sweep kernel walks, the per-level site tables walked by the
  triangular solve, and the same levels as the CSR of steps the level
  solve kernel walks.
"""

from __future__ import annotations

import numpy as np


def _pair_positions(k: int) -> tuple[np.ndarray, np.ndarray]:
    """All position pairs (a < b) of a length-k row."""
    a, b = np.triu_indices(k, k=1)
    return a.astype(np.int64), b.astype(np.int64)


def moralized_edges(NNarray: np.ndarray):
    """Undirected edges of the moralized Vecchia DAG, plus the scatter map.

    Returns
    -------
    edges : int32 [E, 2]      (r < c, lexicographically sorted)
    pair_edge_id : int32 [n, P]   P = (m+1)m/2; entry = edge id of the
        position pair (a, b) in row i, or E (sentinel) when either position
        is padding.  Scatter-adding linv[:, a]*linv[:, b] with this map into a
        length-(E+1) buffer yields the off-diagonal nonzeros of Q = L'L.
    pair_a, pair_b : int64 [P]    static position indices of the pairs.
    """
    NN = np.asarray(NNarray, dtype=np.int64)
    n, k = NN.shape
    pa, pb = _pair_positions(k)
    r = NN[:, pa]  # [n, P]
    c = NN[:, pb]
    valid = (r >= 0) & (c >= 0)
    lo = np.minimum(r, c)
    hi = np.maximum(r, c)
    key = np.where(valid, lo * n + hi, -1)
    uniq, inv = np.unique(key.ravel(), return_inverse=True)
    # uniq[0] == -1 iff any invalid pair exists
    has_pad = uniq.size > 0 and uniq[0] == -1
    E = uniq.size - (1 if has_pad else 0)
    edge_keys = uniq[1:] if has_pad else uniq
    edges = np.stack([edge_keys // n, edge_keys % n], axis=1).astype(np.int32)
    ids = inv.reshape(n, pa.size)
    if has_pad:
        ids = ids - 1
        ids = np.where(ids < 0, E, ids)
    return edges, ids.astype(np.int32), pa, pb


def site_neighbor_lists(n: int, edges: np.ndarray):
    """Padded per-site neighbor lists from the undirected edge list.

    Returns (nbr_sites [n, D], nbr_edge [n, D], nbr_mask [n, D]); pad site
    index = n, pad edge index = E.
    """
    E = edges.shape[0]
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int64)
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int64)
    eid = np.concatenate([np.arange(E), np.arange(E)]).astype(np.int64)
    order = np.argsort(src, kind="stable")
    src, dst, eid = src[order], dst[order], eid[order]
    deg = np.bincount(src, minlength=n)
    D = int(deg.max()) if n else 0
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    nbr_sites = np.full((n, max(D, 1)), n, dtype=np.int32)
    nbr_edge = np.full((n, max(D, 1)), E, dtype=np.int32)
    slot = np.arange(len(src)) - np.repeat(starts, deg)
    nbr_sites[src, slot] = dst.astype(np.int32)
    nbr_edge[src, slot] = eid.astype(np.int32)
    nbr_mask = nbr_sites < n
    return nbr_sites, nbr_edge, nbr_mask


def moralized_adjacency(NNarray: np.ndarray):
    """scipy CSR adjacency of the moralized graph (no diagonal).

    Host-side only; used by the greedy coloring and by tests.
    """
    from scipy import sparse

    NN = np.asarray(NNarray, dtype=np.int64)
    n = NN.shape[0]
    edges, _, _, _ = moralized_edges(NN)
    r = np.concatenate([edges[:, 0], edges[:, 1]])
    c = np.concatenate([edges[:, 1], edges[:, 0]])
    A = sparse.csr_matrix(
        (np.ones(len(r), dtype=np.int8), (r, c)), shape=(n, n)
    )
    return A


def greedy_coloring(NNarray: np.ndarray) -> np.ndarray:
    """Sequential greedy coloring of the moralized graph.

    Same scheme as Scripts/Coloring.R:2-20 (first-fit in site order); colors
    are 0-based ints.  Proper coloring => all sites of one color are
    conditionally independent given the rest, which is what makes the
    chromatic Gibbs block update valid.
    """
    A = moralized_adjacency(NNarray)
    n = A.shape[0]
    indptr, indices = A.indptr, A.indices
    if n > 4000:
        from nngp_tpu_torch.utils.native import greedy_coloring_native

        colors = greedy_coloring_native(indptr, indices, n)
        if colors is not None:
            return colors
    colors = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        nb = indices[indptr[i] : indptr[i + 1]]
        used = colors[nb]
        used = used[used >= 0]
        if used.size == 0:
            colors[i] = 0
            continue
        taken = np.zeros(used.max() + 2, dtype=bool)
        taken[used] = True
        colors[i] = int(np.argmin(taken))
    return colors


def color_csr(colors: np.ndarray):
    """Colour-major CSR of the sites: (color_ptr i32 [n_colors+1],
    color_sites i32 [n]); sites of colour c are
    color_sites[color_ptr[c]:color_ptr[c+1]], in increasing site order."""
    colors = np.asarray(colors)
    counts = np.bincount(colors, minlength=int(colors.max()) + 1 if colors.size else 0)
    color_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    color_sites = np.argsort(colors, kind="stable").astype(np.int32)
    return color_ptr, color_sites


def sweep_plan(color_ptr, color_sites, nbr_sites, nbr_edge):
    """The order the chromatic sweep kernel walks, as a neighbour CSR.

    Returns (plan_sites i32 [n], plan_ptr i32 [n+1], plan_nbr i32 [2E],
    plan_edge i32 [2E]).  ``plan_sites`` is colour-major (``color_ptr``
    indexes it as it indexes ``color_sites``) and, within a colour, sorted
    by degree, highest first, ties in site order.  Plan position t holds
    the neighbours ``plan_nbr[plan_ptr[t]:plan_ptr[t+1]]`` of site
    ``plan_sites[t]`` and their edge ids ``plan_edge[...]``: the non-pad
    entries of its rows of ``nbr_sites``/``nbr_edge``, in row order."""
    color_ptr = np.asarray(color_ptr, dtype=np.int64)
    color_sites = np.asarray(color_sites, dtype=np.int64)
    nbr_sites = np.asarray(nbr_sites)
    nbr_edge = np.asarray(nbr_edge)
    n = nbr_sites.shape[0]
    deg = (nbr_sites < n).sum(axis=1)
    colour = np.repeat(np.arange(len(color_ptr) - 1), np.diff(color_ptr))
    # np.lexsort sorts by its last key first
    order = np.lexsort((color_sites, -deg[color_sites], colour))
    plan_sites = color_sites[order]
    plan_ptr = np.concatenate([[0], np.cumsum(deg[plan_sites])])
    rows = nbr_sites[plan_sites]
    real = rows < n
    return (plan_sites.astype(np.int32), plan_ptr.astype(np.int32),
            rows[real].astype(np.int32),
            nbr_edge[plan_sites][real].astype(np.int32))


def owned_sweep_plan(color_ptr, plan_sites, plan_ptr, plan_nbr, plan_edge,
                     owned):
    """The positions of a sweep plan whose sites ``owned`` (bool [n]) marks,
    as a plan of their own: (color_ptr, plan_sites, plan_ptr, plan_nbr,
    plan_edge), all i32.  The positions keep the plan's order, so each
    colour stays sorted by degree and each site keeps its neighbours in
    their CSR order; the CSR is compacted to the kept rows."""
    color_ptr = np.asarray(color_ptr, dtype=np.int64)
    plan_sites = np.asarray(plan_sites, dtype=np.int64)
    plan_ptr = np.asarray(plan_ptr, dtype=np.int64)
    keep = np.asarray(owned, dtype=bool)[plan_sites]
    colour = np.repeat(np.arange(len(color_ptr) - 1), np.diff(color_ptr))
    counts = np.bincount(colour[keep], minlength=len(color_ptr) - 1)
    deg = np.diff(plan_ptr)
    entries = np.repeat(keep, deg)
    i32 = np.int32
    return (np.concatenate([[0], np.cumsum(counts)]).astype(i32),
            plan_sites[keep].astype(i32),
            np.concatenate([[0], np.cumsum(deg[keep])]).astype(i32),
            np.asarray(plan_nbr)[entries].astype(i32),
            np.asarray(plan_edge)[entries].astype(i32))


def dag_levels(NNarray: np.ndarray) -> np.ndarray:
    """Topological depth of each site in the Vecchia DAG.

    level[i] = 0 if site i has no parents, else 1 + max(level of parents).
    All sites of one level can be solved simultaneously in the triangular
    solve L x = v (parents always precede children in the ordering).
    Computed by vectorized fix-point iteration: each pass propagates levels
    one step deeper, so it terminates in depth+1 passes.
    """
    NN = np.asarray(NNarray, dtype=np.int64)
    n, k = NN.shape
    parents = NN[:, 1:]
    valid = parents >= 0
    safe = np.where(valid, parents, 0)
    level = np.zeros(n, dtype=np.int64)
    while True:
        pl = np.where(valid, level[safe], -1)
        new = pl.max(axis=1) + 1 if k > 1 else np.zeros(n, dtype=np.int64)
        if k > 1:
            new = np.maximum(new, 0)
        if np.array_equal(new, level):
            return level.astype(np.int32)
        level = new


def level_segments(levels: np.ndarray, n_sentinel=None, small: int = 128,
                   wide: int = 512):
    """Segment-classed schedule for the level solve.

    Returns a tuple of i32 tables, each ``[k, W]`` with ``W`` one of
    ``(small, wide)``: walking the tables in order and the rows of each
    table top-to-bottom visits every DAG level in topological order, each
    level padded (pad = ``n_sentinel``) only to its class width.  Narrow
    levels (``count <= small``) use the ``small`` class; all others are
    chunked into ``wide``-wide rows.  Every row holds sites of one level
    only, so a row solves in one gather + divide once the earlier rows are
    done (ops/trisolve.py).  Same tables as ``nngp_tpu``'s, so the two
    packages solve in the same order.
    """
    levels = np.asarray(levels)
    n = levels.shape[0]
    if n_sentinel is None:
        n_sentinel = n
    if n == 0:
        return ()
    order = np.argsort(levels, kind="stable").astype(np.int64)
    counts = np.bincount(levels, minlength=int(levels.max()) + 1)
    segs, pos = [], 0  # list of [W, list-of-[k_i, W] tables]
    for c in counts:
        sites = order[pos : pos + c]
        pos += c
        if c == 0:
            continue
        W = small if c <= small else wide
        k = -(-c // W)
        tab = np.full((k, W), n_sentinel, dtype=np.int32)
        tab.reshape(-1)[:c] = sites
        if segs and segs[-1][0] == W:
            segs[-1][1].append(tab)
        else:
            segs.append([W, [tab]])
    return tuple(np.concatenate(tabs, axis=0) for _, tabs in segs)


# the fields of level_steps's result, as VecchiaGraph and prediction's
# JointGraph hold them
STEP_FIELDS = ("step_ptr", "step_sites", "step_cols")


def level_steps(level_segs, NNarray, nn_mask):
    """The level schedule as the level solve kernel walks it: (step_ptr
    int32 [S+1], step_sites int32 [n], step_cols int32 [n, m]).  Step s
    holds ``step_sites[step_ptr[s]:step_ptr[s+1]]`` in increasing order, and
    ``step_cols`` each one's parent columns (-1 where ``nn_mask`` is 0).

    The rows of ``level_segs`` are walked in order (pad >= n); a row joins
    the current step unless one of its sites has a parent there, so the
    rows of one DAG level become one step and every parent lies in an
    earlier step.  Raises ValueError when a site comes twice, a parent
    comes after its child, or a site is in no row."""
    NN = np.asarray(NNarray).astype(np.int64)
    n = NN.shape[0]
    par = np.where((NN[:, 1:] >= 0) & (np.asarray(nn_mask)[:, 1:] != 0),
                   NN[:, 1:], -1)
    step_of = np.full(n, -1, dtype=np.int64)
    steps = []
    for tab in level_segs:
        for row in np.asarray(tab):
            sites = row[(row >= 0) & (row < n)].astype(np.int64)
            if sites.size == 0:
                continue
            if (step_of[sites] >= 0).any() or \
                    np.unique(sites).size != sites.size:
                raise ValueError("level_steps: a site is in two rows of the "
                                 "level schedule")
            p = par[sites]
            p = p[p >= 0]
            if (step_of[p] < 0).any():
                raise ValueError("level_steps: a parent comes after its "
                                 "child in the level schedule")
            if not steps or (p.size and step_of[p].max() == len(steps) - 1):
                steps.append([])
            step_of[sites] = len(steps) - 1
            steps[-1].append(sites)
    missing = int((step_of < 0).sum())
    if missing:
        raise ValueError(f"level_steps: {missing} of {n} sites are in no "
                         "row of the level schedule")
    order = [np.sort(np.concatenate(s)) for s in steps]
    ptr = np.zeros(len(order) + 1, dtype=np.int32)
    ptr[1:] = np.cumsum([len(s) for s in order])
    sites = (np.concatenate(order) if order
             else np.zeros(0, dtype=np.int64))
    return ptr, sites.astype(np.int32), par[sites].astype(np.int32)
