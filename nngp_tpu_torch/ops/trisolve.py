"""Level-scheduled sparse triangular solve over the Vecchia DAG: the CUDA
kernel and its plain PyTorch twin.

Port of ``nngp_tpu/ops/trisolve.py:level_solve``, chains leading.  It
replaces the reference's sequential back-substitution Matrix::solve(L, v)
(mcmc_nngp_update_Gaussian.R:127): sites are grouped by their depth in the
DAG, no site of a level depends on another of the same level, so a level
solves at once after the levels before it.

``level_solve`` launches the hand-written kernel ``csrc/level_solve.cu``
once a call on a CUDA tensor (``level_solve.launches`` counts the
launches) and runs ``level_solve_reference`` on a CPU one: a Python loop
over the rows of the graph's ``level_segs`` tables, one gather + divide a
row.  There is no fallback: on a card the kernel runs or the call raises.

The kernel walks the graph's level steps (``step_ptr``, ``step_sites``,
``step_cols``: ``preprocess/coloring.py:level_steps``, built with the
graph), one block a chain.  ``solve_rows`` is a row's arithmetic on each
device, which the twin and halo mode's solve share: on a card the
kernel's, so the twin and halo mode give the kernel's bits there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nngp_tpu_torch.ops import _build
from nngp_tpu_torch.tracing import span

# the kernel's largest neighbour count (its rows are unrolled; the factor
# build takes at most as many)
LEVEL_SOLVE_MAX_M = 16


def kernel_rows(lv: torch.Tensor, mask: torch.Tensor, parents: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """x at W sites from their factor rows lv [C, W, m+1], parent masks
    [W, m], parents' x [C, W, m] and v [C, W], in the kernel's arithmetic:
    each product of two float32 exact in float64, summed in index order
    j = 1..m over the parents whose mask is not 0, then
    (v - sum) / lv[..., 0] in float64, rounded once to v's dtype."""
    lv = lv.double()
    s = torch.zeros(v.shape, dtype=torch.float64, device=v.device)
    for j in range(mask.shape[-1]):
        s = s + torch.where(mask[:, j] != 0,
                            lv[..., j + 1] * parents[..., j].double(), 0.0)
    return ((v.double() - s) / lv[..., 0]).to(v.dtype)


def solve_rows(lv: torch.Tensor, mask: torch.Tensor, parents: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """``kernel_rows``'s x in the arithmetic ``level_solve`` has on their
    device: on a card the kernel's (``kernel_rows``), on the CPU products
    in v's dtype summed by ``torch.sum``."""
    if v.device.type == "cuda":
        return kernel_rows(lv, mask, parents, v)
    return (v - torch.sum(lv[..., 1:] * mask * parents, dim=-1)) / lv[..., 0]


def level_solve_reference(linv: torch.Tensor, v: torch.Tensor,
                          graph) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the rows of ``level_segs`` in
    order, each in one gather + ``solve_rows``."""
    n = graph.n
    C = v.shape[0]
    safe_nn = torch.clamp_min(graph.NNarray, 0)
    # slot n is the dummy that padded lanes (pad = n) write into
    x = torch.zeros(C, n + 1, dtype=v.dtype, device=v.device)
    for tab in graph.level_segs:
        for rows in tab:
            rows_safe = torch.clamp_max(rows, n - 1)
            x[:, rows] = solve_rows(linv[:, rows_safe],
                                    graph.nn_mask[rows_safe, 1:],
                                    x[:, safe_nn[rows_safe, 1:]],
                                    v[:, rows_safe])
    return x[:, :n]


@functools.cache
def _library(m: int):
    """``csrc/level_solve.cu`` at m parents a site, built and loaded."""
    lib = _build.cuda_library("level_solve", f"_m{m}",
                              (f"-DLEVEL_SOLVE_M={m}",))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.level_solve_launch.argtypes = [p] * 6 + [i] * 3 + [p]
    lib.level_solve_launch.restype = i
    return lib


def level_solve_cuda(linv: torch.Tensor, v: torch.Tensor,
                     graph) -> torch.Tensor:
    """The ``level_solve`` kernel (``csrc/level_solve.cu``) on linv [C, n,
    m+1] and v [C, n], float32 contiguous on one card, with the graph's
    tables on that card; launched on the current stream, counted in
    ``level_solve.launches``."""
    n, k = graph.NNarray.shape
    if k - 1 > LEVEL_SOLVE_MAX_M:
        raise ValueError(f"level_solve: m = {k - 1} neighbours, the kernel "
                         f"takes at most {LEVEL_SOLVE_MAX_M}")
    C = v.shape[0]
    for name, t, shape in (("linv", linv, (C, n, k)), ("v", v, (C, n))):
        if t.device.type != "cuda" or t.device != v.device \
                or t.dtype != torch.float32:
            raise TypeError(f"level_solve: {name} is {t.dtype} on "
                            f"{t.device}, expected float32 on one CUDA "
                            "device")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"level_solve: {name} has shape "
                             f"{tuple(t.shape)} (contiguous "
                             f"{t.is_contiguous()}), expected {shape} "
                             "contiguous")
    if n * k >= 2 ** 31:
        raise ValueError(f"level_solve: {n} sites x {k} entries a row "
                         "exceed the kernel's 32-bit offsets")
    steps = (graph.step_ptr, graph.step_sites, graph.step_cols)
    for t in steps:
        if t.device != v.device or t.dtype != torch.int32:
            raise TypeError(f"level_solve: the graph's level steps are "
                            f"{t.dtype} on {t.device}, expected int32 on "
                            f"{v.device}")
    x = torch.empty_like(v)
    if C == 0 or n == 0:
        return x
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = _library(k - 1).level_solve_launch(
        linv.data_ptr(), v.data_ptr(), x.data_ptr(),
        *(t.data_ptr() for t in steps), C, n, graph.step_ptr.shape[0] - 1,
        stream)
    if err != 0:
        raise RuntimeError(f"level_solve kernel launch failed: CUDA error "
                           f"{err}")
    level_solve.launches += 1
    return x


def level_solve(linv: torch.Tensor, v: torch.Tensor, graph) -> torch.Tensor:
    """Solve L x = v per chain; linv [C, n, m+1], v [C, n] -> x [C, n].

    Row i:  x_i = (v_i - sum_{j>=1} linv[i,j] x_{NN[i,j]}) / linv[i,0];
    parents always sit in strictly earlier rows of the schedule.  A CUDA
    ``v`` launches the kernel (float32; ``level_solve_cuda``), a CPU one
    runs ``level_solve_reference``."""
    with span("level_solve"):
        if v.device.type == "cuda":
            return level_solve_cuda(linv.contiguous(), v.contiguous(), graph)
        return level_solve_reference(linv, v, graph)


level_solve.launches = 0
