"""Batched Vecchia sparse inverse-Cholesky operations, chains leading.

Port of ``nngp_tpu/ops/vecchia.py``.  Every function takes the chains as
the leading tensor dimension (``nngp_tpu`` vmaps over them): ``linv`` is
[C, n, m+1], fields are [C, n].

- ``vecchia_linv``: for every site i, the (m+1)x(m+1) correlation of its
  neighbour set, an m x m Cholesky unrolled over the static neighbour count
  and row i of L.  Each multiply-subtract rounds once, as XLA fuses them in
  ``nngp_tpu``'s jitted iteration.  On a card it is one launch of the
  hand-written kernel ``csrc/factor_rows.cu:factor_build`` (one thread a
  (chain, row), each correlation computed where the Cholesky uses it, so K
  is never written); on the CPU its plain twin ``vecchia_linv_reference``
  (``correlation_from_sqdist``, then ``linv_rows_reference``: the
  subtractions in float64, where float32 products are exact).  The
  Matérn families build each row wholly in float64 (distances, K_nu,
  Cholesky and solves) and round it once to float32; the exponential
  families stay in float32.
- ``linv_rows_from_K``: the factor rows from a given K (the audits' same-K
  comparisons): on a card the kernel's K-input entry ``factor_rows``.
- ``linv_mult`` / ``linv_t_mult``: L x by gather, L' z by a sum onto the
  columns.
- ``precision_diag_and_q_edges``: the nonzeros of Q = L'L by sums over the
  compressed rows' entries and over the moralized-edge map.
- ``nngp_loglik`` / ``nngp_loglik_diff``: the Vecchia log-density, and the
  MH ratio of two factors as one sum of per-site differences computed in
  float64 (``loglik_diff_terms``; ``nngp_tpu`` takes float32 terms into
  its double-float ``df_sum``).

Compressed-row convention (same as GpGp): row i of L has entries at columns
NNarray[i, :] = [i, parents...]; linv[..., i, 0] is the diagonal.

Every scatter-sum (``linv_t_mult``, ``precision_diag_and_q_edges``, and
the residual sums of ``models/gaussian.py:sweep_inputs``) is an
``ordered_sum`` over index tables the graph built on the host: each target
adds its terms in increasing term index, the order of ``index_add_`` on
the CPU, with no atomics.  So the same inputs give the same bits on every
run, on the card as on the CPU, and the CPU's bits equal ``index_add_``'s.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nngp_tpu_torch.ops import _build
from nngp_tpu_torch.ops.covariance import (correlation_from_sqdist,
                                           require_supported)
from nngp_tpu_torch.tracing import span


def sum64(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """Sum accumulated in float64, returned in x's dtype."""
    return x.double().sum(dim).to(x.dtype)


def _msub(s, a, b):
    """s - a*b rounded once, as one fused multiply-add: two float32 factors
    multiply exactly in float64, so only the subtraction rounds (then the
    cast).  On float64 tensors the casts do nothing: s - a*b op by op."""
    return (s.double() - a.double() * b.double()).to(s.dtype)


def _sqrt(x):
    """IEEE square root: in float64, then rounded (innocuously) to x's
    dtype.  torch's vectorised float32 ``sqrt`` on the CPU is not always
    correctly rounded."""
    return torch.sqrt(x.double()).to(x.dtype)


def _unrolled_cholesky(K: torch.Tensor, k: int) -> list:
    """Cholesky of [..., k, k] SPD matrices, unrolled over the static k;
    the lower factor as a k x k list of [...] tensors (None above the
    diagonal)."""
    L = [[None] * k for _ in range(k)]
    for j in range(k):
        s = K[..., j, j]
        for t in range(j):
            s = _msub(s, L[j][t], L[j][t])
        L[j][j] = _sqrt(torch.clamp_min(s, 1e-12))
        inv_ljj = 1.0 / L[j][j]
        for i in range(j + 1, k):
            s = K[..., i, j]
            for t in range(j):
                s = _msub(s, L[i][t], L[j][t])
            L[i][j] = s * inv_ljj
    return L


def _forward_solve(L: list, b: list, k: int) -> list:
    """Solve L y = b with the unrolled lower factor."""
    y = [None] * k
    for i in range(k):
        s = b[i]
        for t in range(i):
            s = _msub(s, L[i][t], y[t])
        y[i] = s / L[i][i]
    return y


def _backward_solve(L: list, y: list, k: int) -> list:
    """Solve L' z = y."""
    z = [None] * k
    for i in range(k - 1, -1, -1):
        s = y[i]
        for t in range(i + 1, k):
            s = _msub(s, L[t][i], z[t])
        z[i] = s / L[i][i]
    return z


def linv_rows_reference(K: torch.Tensor, mask: torch.Tensor,
                        d_floor: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version of the ``factor_rows`` kernel: ``nngp_tpu``'s
    unrolled build (``nngp_tpu/ops/vecchia.py:linv_rows_from_K``) with every
    multiply-subtract rounded once (``_msub``), as XLA fuses them inside
    ``nngp_tpu``'s jitted iteration, and the square roots and 1/sqrt(d)
    correctly rounded (``_sqrt``, then a division; CUDA's float32
    ``torch.rsqrt`` may be approximate), as the kernel's ``sqrtf`` and
    divisions are."""
    k = K.shape[-1]
    m = k - 1
    # force padded rows/cols to identity
    valid2 = mask[..., :, None] * mask[..., None, :]
    eye = torch.eye(k, dtype=K.dtype, device=K.device)
    K = K * valid2 + eye * (1.0 - valid2)
    if m == 0:
        return torch.ones(K.shape[:-2] + (1,), dtype=K.dtype, device=K.device)
    L = _unrolled_cholesky(K[..., 1:, 1:], m)
    kni = [K[..., 1 + j, 0] for j in range(m)]
    u = _forward_solve(L, kni, m)
    d = K[..., 0, 0]
    for j in range(m):
        d = _msub(d, u[j], u[j])
    d = torch.clamp_min(d, d_floor)
    b = _backward_solve(L, u, m)
    inv_sqrt_d = 1.0 / _sqrt(d)
    rows = [inv_sqrt_d] + [
        -b[j] * inv_sqrt_d * mask[..., 1 + j] for j in range(m)
    ]
    return torch.stack(rows, dim=-1)


FACTOR_ROWS_MAX_M = 16     # csrc/factor_rows.cu's kMaxM: m = 0..16 instantiated


# csrc/factor_rows.cu is built by part and by m, one small library each on
# first use (its FACTOR_PART bits and FACTOR_M): the K-input entry, and the
# fused build's exponential and Matérn instantiations.  Whole, its 51
# unrolled kernels take nvcc minutes; one takes seconds.
FACTOR_PARTS = {"": 1, "_exponential": 2, "_matern": 4}


@functools.cache
def _factor_library(part: str, m: int):
    """The part ``part`` of ``csrc/factor_rows.cu`` at m neighbours, built
    and loaded: ``factor_rows_launch`` ("") or ``factor_build_launch`` for
    one family ("_exponential", "_matern")."""
    lib = _build.cuda_library("factor_rows", f"{part}_m{m}",
                              (f"-DFACTOR_PART={FACTOR_PARTS[part]}",
                               f"-DFACTOR_M={m}"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if part:
        lib.factor_build_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            ctypes.c_double, p]
        lib.factor_build_launch.restype = i
    else:
        lib.factor_rows_launch.argtypes = [p, p, p, ctypes.c_longlong, i, i,
                                           f, p]
        lib.factor_rows_launch.restype = i
    return lib


def linv_rows_cuda(K: torch.Tensor, mask: torch.Tensor,
                   d_floor: float = 1e-12) -> torch.Tensor:
    """The ``factor_rows`` kernel (``csrc/factor_rows.cu``) on K [..., R, k,
    k] and mask [R, k], float32 contiguous on one card; launched on the
    current stream, counted in ``linv_rows_from_K.launches``."""
    k = K.shape[-1]
    if k - 1 > FACTOR_ROWS_MAX_M:
        raise ValueError(f"factor_rows: m = {k - 1} neighbours, the kernel "
                         f"takes at most {FACTOR_ROWS_MAX_M}")
    if K.dim() < 3 or K.shape[-2] != k:
        raise ValueError(f"factor_rows: K has shape {tuple(K.shape)}, "
                         "expected [..., R, k, k]")
    R = K.shape[-3]
    for name, t, shape in (("K", K, K.shape), ("mask", mask, (R, k))):
        if t.device != K.device or t.dtype != torch.float32:
            raise TypeError(f"factor_rows: {name} is {t.dtype} on "
                            f"{t.device}, expected float32 on {K.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"factor_rows: {name} has shape "
                             f"{tuple(t.shape)} (contiguous "
                             f"{t.is_contiguous()}), expected {tuple(shape)}"
                             " contiguous")
    lib = _factor_library("", k - 1)
    rows = torch.empty(K.shape[:-1], dtype=K.dtype, device=K.device)
    B = rows.numel() // k
    if B == 0:
        return rows
    stream = torch.cuda.current_stream(K.device).cuda_stream
    err = lib.factor_rows_launch(K.data_ptr(), mask.data_ptr(),
                                 rows.data_ptr(), B, R, k - 1, d_floor,
                                 stream)
    if err != 0:
        raise RuntimeError(f"factor_rows kernel launch failed: CUDA error "
                           f"{err}")
    linv_rows_from_K.launches += 1
    return rows


def linv_rows_from_K(K: torch.Tensor, mask: torch.Tensor,
                     d_floor: float = 1e-12) -> torch.Tensor:
    """Compressed factor rows [..., m+1] from neighbour-set correlations
    K [..., m+1, m+1] and the validity mask [n, m+1]: the conditional of
    position 0 given positions 1..m, with the conditional variance floored
    at ``d_floor``.  float32 on a card launches the ``factor_rows`` kernel;
    float32 on the CPU, and float64 anywhere, run ``linv_rows_reference``
    (float64 has nothing to fuse).  ``linv_rows_from_K.launches`` counts
    kernel launches."""
    if K.dtype == torch.float32 and K.device.type == "cuda":
        return linv_rows_cuda(K.contiguous(), mask.contiguous(), d_floor)
    if K.dtype in (torch.float32, torch.float64) and K.device.type in (
            "cpu", "cuda"):
        return linv_rows_reference(K, mask, d_floor)
    raise TypeError(f"linv_rows_from_K: no implementation for {K.dtype} on "
                    f"{K.device}")


linv_rows_from_K.launches = 0


def vecchia_linv_reference(covfun: str, nn_dist2: torch.Tensor,
                           nn_mask: torch.Tensor, natural: torch.Tensor,
                           d_floor: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version of the ``factor_build`` kernel: the
    correlations K [C, R, k, k] (``correlation_from_sqdist``) of the rows'
    squared distances nn_dist2 [R, k, k, G], then ``linv_rows_reference``
    with the rows' mask nn_mask [R, k].

    The Matérn families on float32 distances run in float64 from the
    widened (exact) distances and the shape params (float32 widened, or
    float64) through K, the Cholesky and the solves, and round each row
    once to float32: near singular, an ulp of a float32 K amplified by 1/d
    decides the rows' error, so K must not be rounded to float32 before
    the Cholesky.  The exponential families run in their inputs' dtype,
    and float64 distances give float64 rows."""
    if covfun.startswith("matern") and nn_dist2.dtype == torch.float32:
        K = correlation_from_sqdist(covfun, nn_dist2.double(),
                                    natural.double())
        return linv_rows_reference(K, nn_mask.double(), d_floor).float()
    K = correlation_from_sqdist(covfun, nn_dist2, natural)
    return linv_rows_reference(K, nn_mask, d_floor)


def factor_build_cuda(graph, natural: torch.Tensor,
                      rows: torch.Tensor | None = None) -> torch.Tensor:
    """The ``factor_build`` kernel (``csrc/factor_rows.cu``): the factor
    [C, R, m+1] at the graph's rows (all n, or the R rows of ``rows``, an
    int32/int64 index in [0, n)) from its
    ``nn_dist2`` [n, k, k, G] and ``nn_mask`` [n, k], float32, and natural
    shape params [C, n_shape], float32 (the Matérn families: float64, or
    float32 widened), contiguous on one card; launched on the current
    stream, counted in ``vecchia_linv.launches`` (the Matérn families'
    launches also in ``factor_build_cuda.matern_launches``)."""
    covfun, d2g, mask = graph.covfun, graph.nn_dist2, graph.nn_mask
    require_supported(covfun)
    matern = covfun.startswith("matern")
    if matern and natural.dtype == torch.float32:
        natural = natural.double()     # exact: the build runs in float64
    if d2g.dim() != 4 or d2g.shape[1] != d2g.shape[2]:
        raise ValueError(f"factor_build: nn_dist2 has shape "
                         f"{tuple(d2g.shape)}, expected [n, k, k, G]")
    n, k, _, G = d2g.shape
    if k - 1 > FACTOR_ROWS_MAX_M:
        raise ValueError(f"factor_build: m = {k - 1} neighbours, the kernel "
                         f"takes at most {FACTOR_ROWS_MAX_M}")
    if natural.dim() != 2 or natural.shape[1] < G + matern:
        raise ValueError(f"factor_build: natural has shape "
                         f"{tuple(natural.shape)}, expected [C, >= "
                         f"{G + matern}] for {covfun}")
    for name, t, shape, dtype in (
            ("nn_dist2", d2g, d2g.shape, torch.float32),
            ("nn_mask", mask, (n, k), torch.float32),
            ("natural", natural, natural.shape,
             torch.float64 if matern else torch.float32)):
        if t.dtype != dtype or t.device != natural.device:
            raise TypeError(f"factor_build: {name} is {t.dtype} on "
                            f"{t.device}, expected {dtype} on "
                            f"{natural.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"factor_build: {name} has shape "
                             f"{tuple(t.shape)} (contiguous "
                             f"{t.is_contiguous()}), expected {tuple(shape)}"
                             " contiguous")
    if rows is not None:
        if rows.dim() != 1 or rows.dtype not in (torch.int32, torch.int64) \
                or rows.device != natural.device:
            raise TypeError(f"factor_build: rows is {rows.dtype} "
                            f"{tuple(rows.shape)} on {rows.device}, expected "
                            f"a 1-D int32/int64 index on {natural.device}")
        rows = rows.to(torch.int64).contiguous()
        lo, hi = (torch.stack(torch.aminmax(rows)).tolist() if len(rows)
                  else (0, 0))
        if lo < 0 or hi >= n:
            raise ValueError(f"factor_build: rows holds {lo}..{hi}, "
                             f"expected indices in [0, {n})")
    if natural.device.type != "cuda":
        raise TypeError(f"factor_build: the tensors are on "
                        f"{natural.device}, the kernel takes a CUDA device's")
    C, R = natural.shape[0], n if rows is None else rows.shape[0]
    lib = _factor_library("_matern" if matern else "_exponential", k - 1)
    out = torch.empty((C, R, k), dtype=torch.float32, device=natural.device)
    if C == 0 or R == 0:
        return out
    stream = torch.cuda.current_stream(natural.device).cuda_stream
    err = lib.factor_build_launch(
        d2g.data_ptr(), mask.data_ptr(), natural.data_ptr(),
        None if rows is None else rows.data_ptr(), out.data_ptr(), C, R,
        k - 1, G, natural.shape[1], int(matern), graph.d_floor, stream)
    if err != 0:
        raise RuntimeError(f"factor_build kernel launch failed: CUDA error "
                           f"{err}")
    vecchia_linv.launches += 1
    factor_build_cuda.matern_launches += int(matern)
    return out


factor_build_cuda.matern_launches = 0


def vecchia_linv(graph, natural_shape: torch.Tensor,
                 rows: torch.Tensor | None = None) -> torch.Tensor:
    """Compressed inverse-Cholesky factor [C, n, m+1] for natural shape
    params [C, n_shape] (or [C, R, m+1] at the graph rows ``rows``).

    Row i encodes the conditional N(x_i | x_parents):
      linv[i, 0]   = 1/sqrt(d_i)
      linv[i, 1:j] = -b_ij / sqrt(d_i)
    where b = Knn^-1 Kni and d = 1 - Kni' b.  Padded parent slots produce
    exact zeros.  The correlations come from the host-f64 ``nn_dist2``, so
    no coordinate cancellation enters the factor; the Matérn families
    build each float32 row in float64 (from float64 natural params where
    given: the sampler's, ``models/gaussian.py:_natural_shape``) and round
    it once.  A float32 graph on a card is one ``factor_build`` launch
    (``vecchia_linv.launches`` counts them) for float32 natural params, and
    for the Matérn families' float64 ones; the CPU, and float64 otherwise,
    run ``vecchia_linv_reference``."""
    with span("factor"):
        matern64 = (natural_shape.dtype == torch.float64
                    and graph.covfun.startswith("matern"))
        if natural_shape.device.type == "cuda" and (
                graph.nn_dist2.dtype == torch.float32) and (
                natural_shape.dtype == torch.float32 or matern64):
            return factor_build_cuda(graph, natural_shape.contiguous(), rows)
        d2g, mask = graph.nn_dist2, graph.nn_mask
        if rows is not None:
            d2g, mask = d2g[rows], mask[rows]
        return vecchia_linv_reference(graph.covfun, d2g, mask, natural_shape,
                                      graph.d_floor)


vecchia_linv.launches = 0


def ordered_sum(vals: torch.Tensor, plan) -> torch.Tensor:
    """out[:, t] = the sum of vals[:, i] over the terms i whose target is t,
    added one at a time in increasing i from zero; vals [C, N] -> [C, T].
    ``plan`` is the graph's ``preprocess.graph.OrderedSum`` of the map
    i -> t: one gather, one add per step (a prefix of the targets ranked by
    their number of terms), one gather back to target order."""
    terms = vals.index_select(1, plan.src)
    acc = vals.new_zeros(vals.shape[0], plan.pos.shape[0])
    lo = 0
    for k in plan.steps:
        acc.narrow(1, 0, k).add_(terms.narrow(1, lo, k))
        lo += k
    return acc.index_select(1, plan.pos)


def linv_mult(linv: torch.Tensor, x: torch.Tensor, graph) -> torch.Tensor:
    """y = L x per chain (GpGp::Linv_mult, mcmc_nngp_update_Gaussian.R:10).
    x: [C, n] -> [C, n], or [C, n, c] -> [C, n, c]."""
    nn = torch.clamp_min(graph.NNarray, 0)
    if x.dim() == 2:
        vals = x[:, nn] * graph.nn_mask                    # [C, n, k]
        return torch.sum(linv * vals, dim=-1)
    vals = x[:, nn] * graph.nn_mask[..., None]             # [C, n, k, c]
    return torch.sum(linv[..., None] * vals, dim=-2)


def linv_t_mult(linv: torch.Tensor, z: torch.Tensor, graph) -> torch.Tensor:
    """y = L' z per chain: the compressed rows' entries summed onto their
    columns in (row, slot) order."""
    vals = (linv * graph.nn_mask * z[..., None]).reshape(z.shape[0], -1)
    return ordered_sum(vals, graph.nn_sum)


def precision_diag_and_q_edges(linv: torch.Tensor, graph):
    """Nonzeros of Q = L'L per chain: (diagonal [C, n], moralized-edge
    values [C, E+1]).  The trailing slot E, the padded position pairs'
    sentinel, is 0.  Each sum adds its terms in a
    fixed order: a site's entries in (row, slot) order, an edge's position
    pairs in ``pair_edge_id`` order."""
    C = linv.shape[0]
    masked = linv * graph.nn_mask
    pdiag = ordered_sum((masked * masked).reshape(C, -1), graph.nn_sum)
    prods = masked[:, :, graph.pair_a] * masked[:, :, graph.pair_b]   # [C, n, P]
    q_edges = ordered_sum(prods.reshape(C, -1), graph.pair_sum)
    return pdiag, q_edges


def nngp_loglik(linv: torch.Tensor, field: torch.Tensor, graph,
                log_scale: torch.Tensor) -> torch.Tensor:
    """Vecchia log-density [C] of centered fields [C, n] under scale
    exp(log_scale) (ll_compressed_sparse_chol,
    mcmc_nngp_update_Gaussian.R:8-12; the -n/2 log(2 pi) constant dropped):
      sum(log diag(L)) - n/2 log_scale - 0.5 ||L field||^2 / exp(log_scale)
    """
    z = linv_mult(linv, field, graph)
    return (sum64(torch.log(linv[..., 0]))
            - 0.5 * graph.n * log_scale
            - 0.5 * sum64(z * z) * torch.exp(-log_scale))


def loglik_diff_terms(linv_new, log_scale_new, linv_old, log_scale_old,
                      field, graph, rows=None) -> torch.Tensor:
    """The per-site summands of ``nngp_loglik_diff``, float64 [C, n] (at
    ``rows`` only: [C, len(rows)]).  The rows and the field are widened, so
    z = L field, exp(-log_scale) and each summand are float64: where the
    scale has collapsed (exp(-log_scale) ~ 1e7, z'z exp(-log_scale) ~ 1e8)
    a float32 rounding of z or of exp would move the ratio by whole units."""
    nn, mask = graph.NNarray, graph.nn_mask
    if rows is not None:
        nn, mask = nn[rows], mask[rows]
        linv_new, linv_old = linv_new[:, rows], linv_old[:, rows]
    # float32 values times a 0/1 mask, widened: exact; each float32 row
    # entry times them is then exact in float64 (promoted, not copied)
    vals = (field[:, torch.clamp_min(nn, 0)] * mask).double()
    z_new = torch.sum(linv_new * vals, dim=-1)
    z_old = torch.sum(linv_old * vals, dim=-1)
    c_new = torch.exp(-log_scale_new.double())[:, None]
    c_old = torch.exp(-log_scale_old.double())[:, None]
    # log(a/b) for a ~ b as log1p((a-b)/b): the subtraction is exact
    a, b = linv_new[..., 0].double(), linv_old[..., 0].double()
    return (torch.log1p((a - b) / b)
            - 0.5 * (z_new * z_new * c_new - z_old * z_old * c_old))


def nngp_loglik_diff(linv_new, log_scale_new, linv_old, log_scale_old,
                     field, graph) -> torch.Tensor:
    """nngp_loglik(new) - nngp_loglik(old) per chain, float64 [C], as ONE
    sum of the per-site differences ``loglik_diff_terms``: each summand
    stays proposal-sized, so no ~1e4-magnitude totals cancel
    (mcmc_nngp_update_Gaussian.R:184-186 computes this in doubles)."""
    terms = loglik_diff_terms(linv_new, log_scale_new, linv_old,
                              log_scale_old, field, graph)
    return terms.sum(-1) - 0.5 * graph.n * (log_scale_new.double()
                                            - log_scale_old.double())
