"""Level-scheduled sparse triangular solve over the Vecchia DAG.

Port of ``nngp_tpu/ops/trisolve.py:level_solve``, chains leading.  It
replaces the reference's sequential back-substitution Matrix::solve(L, v)
(mcmc_nngp_update_Gaussian.R:127): sites are grouped by their depth in the
DAG, no site of a level depends on another of the same level, so each row
of the graph's ``level_segs`` tables solves in one gather + divide.  A
Python loop walks the rows in topological order — a few kernel launches
per row (ROADMAP K3 plans one kernel for the whole walk).
"""

from __future__ import annotations

import torch

from nngp_tpu_torch.tracing import span


def level_solve(linv: torch.Tensor, v: torch.Tensor, graph) -> torch.Tensor:
    """Solve L x = v per chain; linv [C, n, m+1], v [C, n] -> x [C, n].

    Row i:  x_i = (v_i - sum_{j>=1} linv[i,j] x_{NN[i,j]}) / linv[i,0];
    parents always sit in strictly earlier rows of the schedule."""
    with span("level_solve"):
        n = graph.n
        C = v.shape[0]
        safe_nn = torch.clamp_min(graph.NNarray, 0)
        # slot n is the dummy that padded lanes (pad = n) write into
        x = torch.zeros(C, n + 1, dtype=v.dtype, device=v.device)
        for tab in graph.level_segs:
            for rows in tab:
                rows_safe = torch.clamp_max(rows, n - 1)
                lv = linv[:, rows_safe]                      # [C, W, m+1]
                parents = x[:, safe_nn[rows_safe, 1:]]       # [C, W, m]
                acc = torch.sum(lv[..., 1:] * graph.nn_mask[rows_safe, 1:]
                                * parents, dim=-1)
                x[:, rows] = (v[:, rows_safe] - acc) / lv[..., 0]
        return x[:, :n]
