"""Duplicate-location handling and observation<->location index maps.

Reference parity: mcmc_nngp_initialize.R:26-91 —
- remove duplicated locations keeping first occurrences (R: locs[duplicated(locs)==F,])
- locs_match[j]   : unique-loc index of observation j            (R :85)
- hctam_scol_1[i] : first observation index at unique loc i       (R :89)
- obs_per_loc[i]  : number of observations at unique loc i        (R :91)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ObsMaps:
    locs: np.ndarray          # float [n, d] unique, reordered locations
    locs_match: np.ndarray    # int32 [n_obs] observation -> unique loc
    hctam_scol_1: np.ndarray  # int32 [n] first obs index per unique loc
    obs_per_loc: np.ndarray   # int32 [n] observation count per unique loc


def dedupe_and_match(observed_locs: np.ndarray, perm_fn) -> ObsMaps:
    """Dedupe observed locations, reorder them with ``perm_fn``, build maps.

    ``perm_fn(unique_locs) -> permutation`` is applied to the deduped
    (first-occurrence-ordered) locations, mirroring the reference which
    dedupes first (mcmc_nngp_initialize.R:28) then reorders (:29-34).
    """
    obs = np.asarray(observed_locs, dtype=np.float64)
    n_obs = obs.shape[0]
    # unique rows, keeping first-occurrence order
    _, first_idx, inverse = np.unique(
        obs, axis=0, return_index=True, return_inverse=True
    )
    order = np.argsort(first_idx, kind="stable")
    # rank[k] = position of unique-row k (np.unique order) in first-occurrence order
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    locs0 = obs[first_idx[order]]            # deduped, first-occurrence order
    match0 = rank[inverse]                    # obs -> deduped index
    # reorder unique locations
    perm = np.asarray(perm_fn(locs0), dtype=np.int64)
    locs = locs0[perm]
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(len(perm))
    locs_match = inv_perm[match0].astype(np.int32)
    n = locs.shape[0]
    obs_per_loc = np.bincount(locs_match, minlength=n).astype(np.int32)
    # first observation per unique loc (R: hctam_scol[[i]][1] with obs in order)
    hctam_scol_1 = np.full(n, n_obs, dtype=np.int64)
    np.minimum.at(hctam_scol_1, locs_match, np.arange(n_obs))
    return ObsMaps(
        locs=locs,
        locs_match=locs_match,
        hctam_scol_1=hctam_scol_1.astype(np.int32),
        obs_per_loc=obs_per_loc,
    )
