"""The gather probes' CUDA kernels and their plain PyTorch twins.

Four wrappers, each with a ``.launches`` count of kernel launches:

``gather_sweeps``  the whole-sweep field update of gather_bench.py (X1):
                   ``csrc/gather_sweep.cu``, field in a cluster's DSMEM
``staged_gather``  take_along_axis chains, roll and transpose of
                   gather_probe.py/gather_probe2.py: ``csrc/gather_probes.cu``
``column_scatter`` the scatter ``out[idx[:, 0], 0] = val[:, 0]`` into zeros
``matmul_f32``     the float32 product of k_mm: 3xTF32 on the tensor cores
                   (TMA-fed wgmma, deterministic split-K cluster sum)

On a CUDA tensor a wrapper launches its kernel (built with nvcc on first
use) or raises; on a CPU tensor it runs the plain twin.  Where an index
repeats, the last occurrence wins, as in XLA's scatter, on both paths.
Indices must lie in range: the kernels do not check them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nngp_tpu_torch.ops import _build
from nngp_tpu_torch.ops.sweep import _check

# Blocks in the DSMEM cluster that holds X1's field: the fastest of
# CLUSTERS at the script's shapes on an H100 (PERF.md, PR 2).
CLUSTERS = (2, 4, 8, 16)
CLUSTER = 16
_SMEM_FLOATS = 232448 // 4   # shared memory one block may hold
_W = 16                      # neighbours per site that the kernel takes
_KINDS = {"rows": 0, "cols": 1, "roll": 2, "trans": 3}
_MAX_STAGES = 4


def last_occurrence(x):
    """Bool mask over the last dimension of integer ``x``: true where the
    entry does not occur again later in its row (deterministic, no host
    synchronisation)."""
    s, perm = torch.sort(x, dim=-1, stable=True)
    last = torch.ones_like(s, dtype=torch.bool)
    last[..., :-1] = s[..., :-1] != s[..., 1:]
    return torch.empty_like(last).scatter_(-1, perm, last)


def _dispatch(name, t, cuda_fn, plain_fn, *args, **kw):
    if t.device.type == "cuda":
        return cuda_fn(*args, **kw)
    if t.device.type == "cpu":
        return plain_fn(*args)
    raise ValueError(f"{name}: no implementation for {t.device}")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# ------------------------------------------------------------------- X1

def gather_sweeps_reference(w, sites, nbrs, q, P, noise, keep):
    """Plain PyTorch version: a Python loop over sweeps and block steps."""
    kept = [k.nonzero().squeeze(1) for k in keep]
    dst = [s[k].long() for s, k in zip(sites, kept)]
    nbrs = nbrs.long()
    rs = torch.rsqrt(P)
    for s in range(noise.shape[0]):
        for b in range(sites.shape[0]):
            mean = torch.sum(q[b] * w[nbrs[b]], dim=1) / P[b]
            w[dst[b]] = (mean + noise[s, b] * rs[b])[kept[b]]
    return w


@functools.cache
def _sweep_library():
    lib = _build.cuda_library("gather_sweep")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gather_sweeps_launch.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, p]
    lib.gather_sweeps_launch.restype = ctypes.c_int
    return lib


def gather_sweeps_cuda(w, sites, nbrs, q, P, noise, keep, cluster=CLUSTER):
    """Launch the DSMEM kernel on the current stream (no synchronise)."""
    lib = _sweep_library()
    dev = w.device
    n = w.shape[0]
    S, NB, B = noise.shape
    f32, i32 = torch.float32, torch.int32
    _check("w", w, f32, (n,), dev)
    _check("sites", sites, i32, (NB, B), dev)
    _check("nbrs", nbrs, i32, (NB, B, _W), dev)
    _check("q", q, f32, (NB, B, _W), dev)
    _check("P", P, f32, (NB, B), dev)
    _check("noise", noise, f32, (S, NB, B), dev)
    _check("keep", keep, torch.bool, (NB, B), dev)
    if cluster not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS}, got {cluster}")
    if -(-n // cluster) > _SMEM_FLOATS:
        raise ValueError(f"a field of {n} floats does not fit in the shared "
                         f"memory of a cluster of {cluster} blocks")
    if -(-B // cluster) > 512:
        raise ValueError(f"{B} sites per block step need more than 512 "
                         f"threads per block at cluster {cluster}")
    if nbrs.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("nbrs and q must be 16-byte aligned")
    err = lib.gather_sweeps_launch(
        w.data_ptr(), n, sites.data_ptr(), keep.data_ptr(), nbrs.data_ptr(),
        q.data_ptr(), P.data_ptr(), noise.data_ptr(), NB, B, S, cluster,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "gather_sweeps")
    gather_sweeps.launches += 1
    return w


def gather_sweeps(w, sites, nbrs, q, P, noise, keep, cluster=CLUSTER):
    """All sweeps of gather_bench.py's field update, in place on ``w``
    [n]: sites/keep [NB, B], nbrs/q [NB, B, 16], P [NB, B], noise
    [S, NB, B]; ``keep = last_occurrence(sites)``.  ``cluster`` (one of
    CLUSTERS) is the kernel's cluster size."""
    return _dispatch("gather_sweeps", w, gather_sweeps_cuda,
                     gather_sweeps_reference, w, sites, nbrs, q, P, noise,
                     keep, cluster=cluster)


gather_sweeps.launches = 0


# ---------------------------------------------------------------- X2, X3

def _stage_shapes(src, stages):
    """The output shape after each stage; raises on a malformed chain."""
    if len(stages) > _MAX_STAGES:
        raise ValueError(f"at most {_MAX_STAGES} stages, got {len(stages)}")
    rows, cols = src.shape
    shapes = []
    for st in stages:
        kind = st[0]
        if kind in ("rows", "cols"):
            ir, ic = st[1].shape
            if (kind == "rows" and ic != cols) or (kind == "cols" and ir != rows):
                raise ValueError(f"{kind} index of shape {(ir, ic)} does not "
                                 f"fit an input of shape {(rows, cols)}")
            rows, cols = ir, ic
        elif kind == "trans":
            rows, cols = cols, rows
        elif kind != "roll":
            raise ValueError(f"unknown stage {kind!r}")
        shapes.append((rows, cols))
    return shapes


def staged_gather_reference(src, stages):
    """Plain PyTorch version: the stages in order."""
    _stage_shapes(src, stages)
    x = src
    for st in stages:
        if st[0] == "rows":
            x = torch.gather(x, 0, st[1].long())
        elif st[0] == "cols":
            x = torch.gather(x, 1, st[1].long())
        elif st[0] == "roll":
            x = torch.roll(x, st[1], 0)
        else:
            x = x.T.contiguous()
    return x


@functools.cache
def _probe_library():
    lib = _build.cuda_library("gather_probes")
    p, i = ctypes.c_void_p, ctypes.c_int
    pi = ctypes.POINTER(ctypes.c_int)
    lib.staged_gather_launch.argtypes = [
        p, p, i, i, i, i, i, pi, ctypes.POINTER(ctypes.c_void_p), pi, pi, pi, p]
    lib.column_scatter_launch.argtypes = [p, p, i, i, p, i, p]
    lib.matmul_f32_launch.argtypes = [p, p, p, i, i, i, p]
    lib.matmul_f32_split.argtypes = [i, i, i]
    for fn in (lib.staged_gather_launch, lib.column_scatter_launch,
               lib.matmul_f32_launch, lib.matmul_f32_split):
        fn.restype = ctypes.c_int
    return lib


def staged_gather_cuda(src, stages):
    """Launch the staged-gather kernel on the current stream."""
    lib = _probe_library()
    dev = src.device
    if src.dtype not in (torch.float32, torch.int32) or src.dim() != 2:
        raise TypeError(f"src must be a 2-D float32 or int32 tensor, got "
                        f"{src.dtype} of shape {tuple(src.shape)}")
    _check("src", src, src.dtype, src.shape, dev)
    shapes = _stage_shapes(src, stages)
    n = len(stages)
    kinds, idx, cols, in_rows, shifts = [], [], [], [], []
    rows_in = src.shape[0]
    for st, (r, c) in zip(stages, shapes):
        kinds.append(_KINDS[st[0]])
        if st[0] in ("rows", "cols"):
            _check(f"{st[0]} index", st[1], torch.int32, (r, c), dev)
            idx.append(st[1].data_ptr())
        else:
            idx.append(None)
        shifts.append(int(st[1]) % rows_in if st[0] == "roll" else 0)
        cols.append(c)
        in_rows.append(rows_in)
        rows_in = r
    out_rows, out_cols = shapes[-1] if shapes else tuple(src.shape)
    out = torch.empty(out_rows, out_cols, dtype=src.dtype, device=dev)
    ints = ctypes.c_int * n
    err = lib.staged_gather_launch(
        src.data_ptr(), out.data_ptr(), int(src.dtype == torch.int32),
        src.shape[1], out_rows, out_cols, n, ints(*kinds),
        (ctypes.c_void_p * n)(*idx), ints(*cols), ints(*in_rows), ints(*shifts),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "staged_gather")
    staged_gather.launches += 1
    return out


def staged_gather(src, stages):
    """``src`` [r, c] (float32 or int32) through up to four stages, first
    stage first: ``("rows", idx)`` is take_along_axis(x, idx, axis=0),
    ``("cols", idx)`` axis=1 (idx int32, the stage's output shape),
    ``("roll", shift)`` is jnp.roll(x, shift, 0), ``("trans",)`` is x.T."""
    return _dispatch("staged_gather", src, staged_gather_cuda,
                     staged_gather_reference, src, stages)


staged_gather.launches = 0


def column_scatter_reference(val, idx, n_rows):
    """Plain PyTorch version: zeros, then a masked scatter of the last
    occurrences (the rest go to a spare row that is dropped)."""
    col = idx[:, 0].long()
    out = val.new_zeros(n_rows + 1, val.shape[1])
    out[torch.where(last_occurrence(col), col, n_rows), 0] = val[:, 0]
    return out[:n_rows]


def column_scatter_cuda(val, idx, n_rows):
    """Launch the column-scatter kernel on the current stream."""
    lib = _probe_library()
    dev = val.device
    if val.dim() != 2:
        raise ValueError(f"val must be 2-D, got shape {tuple(val.shape)}")
    _check("val", val, torch.float32, val.shape, dev)
    _check("idx", idx, torch.int32, val.shape, dev)
    n_in, cols = val.shape
    out = torch.empty(n_rows, cols, dtype=torch.float32, device=dev)
    err = lib.column_scatter_launch(
        val.data_ptr(), idx.data_ptr(), n_in, cols, out.data_ptr(), n_rows,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "column_scatter")
    column_scatter.launches += 1
    return out


def column_scatter(val, idx, n_rows):
    """[n_rows, c] zeros with ``out[idx[i, 0], 0] = val[i, 0]``, the last
    ``i`` winning; val float32 and idx int32, both [n, c]."""
    return _dispatch("column_scatter", val, column_scatter_cuda,
                     column_scatter_reference, val, idx, n_rows)


column_scatter.launches = 0


def matmul_f32_reference(a, b):
    """Plain PyTorch version (float32; TF32 must be off on a card:
    ``torch.backends.cuda.matmul.allow_tf32`` is False by default)."""
    return a @ b


# The kernel's tiles of C (rows, columns), its stage depth, its largest
# depth split (blocks of a cluster) and the SMs it fills (an H100 SXM's).
MM_TILE = (64, 128)
MM_DEPTH = 32
MM_MAX_SPLIT = 8
MM_SMS = 132


def matmul_split_k(M, N, K):
    """The kernel's depth split for C [M, N] with depth K (the C side's
    ``matmul_f32_split``): the largest power of two up to MM_MAX_SPLIT, and
    up to the number of MM_DEPTH-deep tiles, for which the blocks (tiles of
    C times the split) fit on MM_SMS SMs at once."""
    tiles = -(-M // MM_TILE[0]) * -(-N // MM_TILE[1])
    depth_tiles = -(-K // MM_DEPTH)
    ks = 1
    while (2 * ks <= MM_MAX_SPLIT and 2 * ks <= depth_tiles
           and tiles * 2 * ks <= MM_SMS):
        ks *= 2
    return ks


def tf32_round(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to
    nearest, ties away from zero, low 13 bits zero (a magnitude that rounds
    past the largest finite float becomes infinite).  For tests."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32_emulated(a, b):
    """The kernel's numeric scheme in plain float32: hi = tf32(x), lo =
    tf32(x - hi) for both operands, and C = a_lo b_hi + a_hi b_lo +
    a_hi b_hi, each product in float32.  For tests."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def matmul_f32_cuda(a, b):
    """Launch the 3xTF32 wgmma kernel on the current stream."""
    lib = _probe_library()
    dev = a.device
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"cannot multiply shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    _check("a", a, torch.float32, a.shape, dev)
    _check("b", b, torch.float32, b.shape, dev)
    (M, K), N = a.shape, b.shape[1]
    if K % 4 or N % 4 or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("matmul_f32 needs K and N multiples of 4 and "
                         "16-byte aligned operands")
    out = torch.empty(M, N, dtype=torch.float32, device=dev)
    err = lib.matmul_f32_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                M, N, K,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err < 0:
        raise RuntimeError(f"matmul_f32: cuTensorMapEncodeTiled failed with "
                           f"CUresult {-err}")
    _raise_on(err, "matmul_f32")
    matmul_f32.launches += 1
    return out


def matmul_f32(a, b):
    """``a @ b`` in float32, a [M, K] and b [K, N]."""
    return _dispatch("matmul_f32", a, matmul_f32_cuda, matmul_f32_reference,
                     a, b)


matmul_f32.launches = 0
