"""Regressor assembly: model-matrix expansion, centering, precomputed factors.

Reference parity: mcmc_nngp_initialize.R:116-137 —
- X = cbind(X_locs, X_obs) expanded by model.matrix(~., .) with treatment
  contrasts (factor -> k-1 dummy columns, first level dropped), intercept
  column removed;
- columns centered, with the column means kept for de-centering at
  estimation time (mcmc_nngp_estimate.R:76);
- dense p x p factors solve(X'X), chol(solve(X'X)), solve([1 X]'[1 X]),
  chol(solve([1 X]'[1 X])) precomputed once (LAPACK in the reference,
  numpy here; they are tiny).

Note on `X$locs` (mcmc_nngp_initialize.R:129): the reference records
`seq(ncol(X_locs))` — the number of *raw* X_locs columns — as the
location-indexed column set of the *expanded* matrix.  When X_locs contains
factors this under-counts (a reference bug).  Here every expanded column that
derives from X_locs is marked location-indexed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Design:
    X: np.ndarray | None          # float64 [n_obs, p] centered expanded design
    names: list                    # p column names
    X_mean: np.ndarray | None      # [p] original column means
    locs_cols: np.ndarray          # int64 indices of location-indexed columns
    solve_XTX: np.ndarray | None
    chol_solve_XTX: np.ndarray | None      # upper triangular (R chol convention)
    solve_1XT1X: np.ndarray | None
    chol_solve_1XT1X: np.ndarray | None

    @property
    def p(self) -> int:
        return 0 if self.X is None else self.X.shape[1]

    @property
    def p_locs(self) -> int:
        return len(self.locs_cols)


def _expand_columns(data, prefix_names=None):
    """Expand a table-like object into float columns with names.

    Accepts: None, 2-D ndarray, dict {name: column}, or pandas DataFrame.
    String/categorical columns become treatment-contrast dummies (first
    level dropped, levels sorted — matching R factor level order).
    """
    if data is None:
        return [], []
    cols, names = [], []

    def add(name, col):
        col = np.asarray(col)
        if col.dtype.kind in "OUS" or str(col.dtype) == "category":
            col = np.asarray(col, dtype=object)
            levels = sorted(set(col.tolist()))
            for lev in levels[1:]:
                cols.append((col == lev).astype(np.float64))
                names.append(f"{name}{lev}")
        elif col.dtype.kind == "b":
            cols.append(col.astype(np.float64))
            names.append(f"{name}TRUE")
        else:
            cols.append(col.astype(np.float64))
            names.append(str(name))

    try:
        import pandas as pd

        if isinstance(data, pd.DataFrame):
            for c in data.columns:
                add(c, data[c].to_numpy())
            return cols, names
    except ImportError:
        pass
    if isinstance(data, dict):
        for k, v in data.items():
            add(k, v)
        return cols, names
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr[:, None]
    base = prefix_names or [f"V{i+1}" for i in range(arr.shape[1])]
    for j in range(arr.shape[1]):
        add(base[j], arr[:, j])
    return cols, names


def build_design(X_locs=None, X_obs=None) -> Design:
    """Assemble the combined centered design matrix and its dense factors."""
    cols_l, names_l = _expand_columns(X_locs)
    cols_o, names_o = _expand_columns(X_obs)
    # de-collide auto-generated names between the two blocks
    if set(names_l) & set(names_o):
        names_o = [
            f"{nm}_obs" if nm in names_l else nm for nm in names_o
        ]
    cols = cols_l + cols_o
    names = names_l + names_o
    if not cols:
        return Design(
            X=None, names=[], X_mean=None,
            locs_cols=np.zeros(0, dtype=np.int64),
            solve_XTX=None, chol_solve_XTX=None,
            solve_1XT1X=None, chol_solve_1XT1X=None,
        )
    X = np.stack(cols, axis=1)
    X_mean = X.mean(axis=0)
    X = X - X_mean
    locs_cols = np.arange(len(cols_l), dtype=np.int64)
    solve_XTX = np.linalg.inv(X.T @ X)
    X1 = np.concatenate([np.ones((X.shape[0], 1)), X], axis=1)
    solve_1XT1X = np.linalg.inv(X1.T @ X1)
    return Design(
        X=X,
        names=names,
        X_mean=X_mean,
        locs_cols=locs_cols,
        solve_XTX=solve_XTX,
        chol_solve_XTX=np.linalg.cholesky(solve_XTX).T,
        solve_1XT1X=solve_1XT1X,
        chol_solve_1XT1X=np.linalg.cholesky(solve_1XT1X).T,
    )
