"""The arrays of the three gather scripts, drawn as the scripts draw them.

Each function makes one ``numpy.random.default_rng(seed)`` and takes its
draws in the script's own order: first the module-level arrays, then those
that the script's ``main`` draws, in the order it draws them.  At seed 0
(the scripts' seed) every array is bit-identical to the script's.
"""

from __future__ import annotations

import numpy as np
import torch

# experiments/gather_bench.py: field size, block size, neighbours per site,
# blocks per sweep, sweeps
N, B, W, NB, SWEEPS = 65536, 1024, 16, 60, 10
# experiments/gather_probe.py and gather_probe2.py: rows, lanes, index rows
R, C, RI = 512, 128, 1024
BIG_ROWS = 4096     # gather_probe2.py's src_big


def bench_arrays(seed: int = 0) -> dict:
    """X1 (gather_bench.py:31-38): the field ``w0`` [N+1], block sites
    [NB, B], neighbours [NB, B, W], their weights ``q``, precisions ``P``
    [NB, B] and the noise [SWEEPS, NB, B]."""
    rng = np.random.default_rng(seed)
    return {
        "w0": rng.normal(size=N + 1).astype(np.float32),
        "sites": rng.integers(0, N, size=(NB, B)).astype(np.int32),
        "nbrs": rng.integers(0, N, size=(NB, B, W)).astype(np.int32),
        "q": rng.normal(size=(NB, B, W)).astype(np.float32),
        "P": rng.uniform(1.0, 2.0, size=(NB, B)).astype(np.float32),
        "noise": rng.normal(size=(SWEEPS, NB, B)).astype(np.float32),
    }


def probe_arrays(seed: int = 0) -> dict:
    """X2 (gather_probe.py): module-level ``src``, ``row_idx``,
    ``lane_idx``; then ``main``'s ``x2``, the scatter's ``scat_val`` and
    ``scat_idx``, and the matmul's ``mm_a`` [R, RI] and ``mm_b`` [RI, C]."""
    rng = np.random.default_rng(seed)
    return {
        "src": rng.normal(size=(R, C)).astype(np.float32),
        "row_idx": rng.integers(0, R, size=(RI, C)).astype(np.int32),
        "lane_idx": rng.integers(0, C, size=(RI, C)).astype(np.int32),
        "x2": rng.normal(size=(RI, C)).astype(np.float32),
        "scat_val": rng.normal(size=(RI, C)).astype(np.float32),
        "scat_idx": rng.integers(0, R, size=(RI, C)).astype(np.int32),
        "mm_a": rng.normal(size=(R, RI)).astype(np.float32),
        "mm_b": rng.normal(size=(RI, C)).astype(np.float32),
    }


def probe2_arrays(seed: int = 0) -> dict:
    """X3 (gather_probe2.py): module-level ``src``, ``idx_eq``,
    ``lane_idx``; then ``main``'s ``src_big``, ``idx_small`` and the int32
    source ``srci``."""
    rng = np.random.default_rng(seed)
    return {
        "src": rng.normal(size=(R, C)).astype(np.float32),
        "idx_eq": rng.integers(0, R, size=(R, C)).astype(np.int32),
        "lane_idx": rng.integers(0, C, size=(R, C)).astype(np.int32),
        "src_big": rng.normal(size=(BIG_ROWS, C)).astype(np.float32),
        "idx_small": rng.integers(0, BIG_ROWS, size=(R, C)).astype(np.int32),
        "srci": rng.integers(0, 99, size=(R, C)).astype(np.int32),
    }


def to_device(arrays: dict, device) -> dict:
    """The arrays as tensors on ``device``, same dtypes."""
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
