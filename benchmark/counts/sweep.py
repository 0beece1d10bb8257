"""Bytes and operations of one call of the chromatic sweep kernel (all S
sweeps of an iteration), frozen from the sampler's bench
(``experiments/sweep_bench.py:sweep_bound``).

Bytes: what the call must move, each once: the field in and out, P and
rs, the noise [C, S, n], scal, the neighbour CSR with the colour-major
site order, and Q in its smaller form (one value per edge with the edge
ids that place it, or one per directed entry).  Operations: three float32
operations per neighbour entry and eight per site update, each sweep."""


def sweep_bytes_flops(C, S, n, nnz, n_colors):
    q_bytes = 4 * min(C * nnz, C * (nnz // 2) + nnz)
    nbytes = q_bytes + 4 * (2 * C * n + 2 * C * n + C * S * n + 3 * C
                            + nnz + (n + 1) + n + (n_colors + 1))
    return nbytes, C * S * (3 * nnz + 8 * n)
