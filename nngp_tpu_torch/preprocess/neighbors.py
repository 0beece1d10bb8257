"""Ordered nearest-neighbor search -> fixed-width neighbor array.

Reference parity: GpGp::find_ordered_nn (C++ kd-tree), invoked at
mcmc_nngp_initialize.R:93 and mcmc_nngp_predict.R:5.  For each site ``i`` in
the reordered location list it finds the ``m`` nearest sites *preceding* it
in the ordering.

Output convention (the central data structure of the whole engine):

    NNarray : int32 [n, m+1]
        row i = [i, nn_1, ..., nn_m]; entries that do not exist (i < m)
        are padded with -1.
    mask : bool/float [n, m+1]  — True on valid entries.

The search runs once on the host.  It processes sites in fixed-size blocks:
sites of block [lo, hi) get m candidate neighbors from a cKDTree (C) built on
the prefix [0, lo), merged with brute-force distances to strictly-preceding
sites *inside* the block.  O(n (B + log n)) with block size B.
For *_sphere covariances, neighbors are found in chordal (3-D embedded)
geometry, matching the spherical distance used by the kernels.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from nngp_tpu_torch.preprocess.ordering import lonlat_to_xyz

_BLOCK = 1024


def find_ordered_nn(locs: np.ndarray, m: int, lonlat: bool = False) -> np.ndarray:
    """Build the [n, m+1] ordered nearest-neighbor array (pad = -1)."""
    x = lonlat_to_xyz(locs) if lonlat else np.asarray(locs, dtype=np.float64)
    n = x.shape[0]
    NN = np.full((n, m + 1), -1, dtype=np.int32)
    NN[:, 0] = np.arange(n, dtype=np.int32)
    if n <= 1:
        return NN
    # Sites 1..m: all preceding sites are neighbors (brute force).
    head = min(m + 1, n)
    for i in range(1, head):
        d = ((x[:i] - x[i]) ** 2).sum(axis=1)
        order = np.argsort(d, kind="stable")[:m]
        NN[i, 1 : 1 + len(order)] = order.astype(np.int32)
    if n <= m + 1:
        return NN
    lo = m + 1
    while lo < n:
        hi = min(lo + _BLOCK, n)
        b = hi - lo
        xb = x[lo:hi]
        # candidates from the preceding prefix [0, lo)
        tree = cKDTree(x[:lo])
        d_tree, i_tree = tree.query(xb, k=m)
        d_tree = d_tree.reshape(b, m) ** 2
        i_tree = i_tree.reshape(b, m)
        # candidates inside the block, strictly preceding (BLAS form:
        # |a-b|^2 = |a|^2 + |b|^2 - 2 a.b)
        sq = (xb * xb).sum(axis=1)
        d_blk = sq[:, None] + sq[None, :] - 2.0 * (xb @ xb.T)
        rows = np.arange(b)
        succ = rows[:, None] <= rows[None, :]  # j >= i (incl. self) -> invalid
        d_blk[succ] = np.inf
        # merge the two candidate sets, keep m nearest
        d_all = np.concatenate([d_tree, d_blk], axis=1)
        i_all = np.concatenate(
            [i_tree, np.broadcast_to(np.arange(lo, hi), (b, b))], axis=1
        )
        part = np.argpartition(d_all, m - 1, axis=1)[:, :m]
        d_top = np.take_along_axis(d_all, part, axis=1)
        order = np.argsort(d_top, axis=1, kind="stable")
        sel = np.take_along_axis(part, order, axis=1)
        NN[lo:hi, 1:] = np.take_along_axis(i_all, sel, axis=1).astype(np.int32)
        lo = hi
    return NN


def nn_mask(NNarray: np.ndarray) -> np.ndarray:
    """Boolean validity mask of the padded neighbor array."""
    return NNarray >= 0
