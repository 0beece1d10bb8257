"""The gather probes' CUDA kernels and their plain PyTorch twins.

Four wrappers, each with a ``.launches`` count of kernel launches:

``gather_sweeps``  the whole-sweep field update of gather_bench.py (X1):
                   ``csrc/gather_sweep.cu``, field in a cluster's DSMEM,
                   each product pushed to its site's owner (a plan from
                   ``gather_sweeps_plan``)
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
from typing import NamedTuple

import torch

from nngp_tpu_torch.ops import _build
from nngp_tpu_torch.ops.sweep import _check

# Blocks in the DSMEM cluster that holds X1's field: the fastest of
# CLUSTERS at the script's shapes on an H100 (gather_bench, PERF.md §6).
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


class SweepPlan(NamedTuple):
    """X1's routing for one cluster size (``gather_sweeps_plan``).  Rank r
    of the cluster owns the field entries k with k % cluster == r, at slot
    k // cluster; row g = b * cluster + r of each table is block step b on
    rank r, padded to the longest row.  A rank's partials buffer holds one
    segment per source rank, in rank order, so that the products one rank
    pushes to another in a step land side by side."""
    cluster: int
    # [NB * cluster, n_pushes, 4] int32: the neighbour's slot on rank r,
    # q's bits, the rank that owns the site (-1: padding), the product's
    # slot in that rank's partials buffer
    pushes: torch.Tensor
    # [NB * cluster, n_owned, 2] int32: a kept site of rank r (its slot,
    # -1: padding; its i), in order of i
    owned: torch.Tensor
    # [NB * cluster, n_owned, W] int16: the partial slot of each of those
    # sites' products, in neighbour order
    where: torch.Tensor
    # the (sites, nbrs, q, keep) it was built from, each beside its
    # version count: a call must pass these tensors, unchanged since
    source: tuple = ()

    @property
    def slots(self):
        """Floats of one partials buffer: the longest owned row times W."""
        return self.owned.shape[1] * _W


def _padded(rows, n_rows, fill, values):
    """``values`` [m, ...] (sorted by ``rows``) laid out as [n_rows, longest
    row, ...], each row left-aligned and padded with ``fill``."""
    counts = torch.bincount(rows, minlength=n_rows)
    start = torch.cumsum(counts, 0) - counts
    width = int(counts.max()) if len(rows) else 0
    out = values.new_full((n_rows, width, *values.shape[1:]), fill)
    out[rows, torch.arange(len(rows), device=rows.device) - start[rows]] = values
    return out


def _exclusive_cumsum(x, dim):
    return torch.cumsum(x, dim) - x


def gather_sweeps_plan(sites, nbrs, q, keep, cluster=CLUSTER):
    """The kernel's plan from the static inputs, built once with torch ops
    on their device (sorts of unique keys: deterministic).  Each kept site
    goes to its owner's row of block step b in order of i; each of its
    pairs (i, j) goes to the pushes of the rank that owns nbrs[b, i, j],
    ordered by destination rank, then i, then j, and its product to the
    next slot of that source rank's segment of the owner's buffer.  Pairs
    of sites that are not kept are dropped."""
    if cluster not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS}, got {cluster}")
    sources = (sites, nbrs, q, keep)
    NB, B = sites.shape
    W = nbrs.shape[-1]
    dev, cs, groups = sites.device, cluster, NB * cluster
    b = torch.arange(NB, device=dev)[:, None].expand(NB, B)
    i = torch.arange(B, device=dev)[None, :].expand(NB, B)
    sites, nbrs = sites.long(), nbrs.long()
    owner = sites % cs
    key, _ = torch.sort(((b * cs + owner) * B + i)[keep])
    group, ki = key // B, key % B
    kb = group // cs
    owned = _padded(group, groups, -1, torch.stack([sites[kb, ki] // cs, ki], 1))

    nb = nbrs[kb, ki]                                    # [K, W]
    src, dst = nb % cs, owner[kb, ki][:, None].expand(-1, W)
    run = ((kb[:, None] * cs + src) * cs + dst).flatten()   # (b, src, dst)
    order = torch.argsort(run * (B * W) + (ki[:, None] * W
                                           + torch.arange(W, device=dev)).flatten())
    count = torch.bincount(run, minlength=groups * cs)       # [b, src, dst]
    segment = _exclusive_cumsum(count.view(NB, cs, cs), 1).flatten()
    at = torch.empty_like(run)                               # place in its run
    at[order] = torch.arange(len(run), device=dev) - _exclusive_cumsum(
        count, 0)[run[order]]
    slot = segment[run] + at
    pushes = torch.stack([nb.flatten() // cs, q[kb, ki].view(torch.int32)
                          .long().flatten(), dst.flatten(), slot], -1)
    rows = (kb[:, None] * cs + src).flatten()
    # a plan that fits in shared memory has fewer than 2^15 slots a buffer
    where = slot.view(-1, W).to(torch.int16)
    return SweepPlan(cs, _padded(rows[order], groups, -1, pushes[order])
                     .to(torch.int32), owned.to(torch.int32),
                     _padded(group, groups, 0, where),
                     tuple((t, t._version) for t in sources))


def gather_sweeps_smem_floats(n, plan):
    """Floats of shared memory a block of the kernel takes: its part of
    the field, rounded up to 4, and two partials buffers."""
    return (-(-n // plan.cluster) + 3) // 4 * 4 + 2 * plan.slots


@functools.cache
def _sweep_library():
    lib = _build.cuda_library("gather_sweep")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gather_sweeps_launch.argtypes = [p, i, p, i, p, p, i, p, p] + [i] * 5 + [p]
    lib.gather_sweeps_launch.restype = ctypes.c_int
    return lib


def _launch_sweeps(w, P, noise, plan, barriers_only):
    S, NB, B = noise.shape
    err = _sweep_library().gather_sweeps_launch(
        w.data_ptr(), w.shape[0], plan.pushes.data_ptr(), plan.pushes.shape[1],
        plan.owned.data_ptr(), plan.where.data_ptr(), plan.owned.shape[1],
        P.data_ptr(), noise.data_ptr(), NB, B, S, plan.cluster,
        int(barriers_only),
        torch.cuda.current_stream(w.device).cuda_stream)
    _raise_on(err, "gather_sweeps")


def _check_plan_source(plan, sites, nbrs, q, keep, cluster):
    """Raise unless ``plan`` was built for ``cluster`` from these very
    tensors and none of them changed since: the kernel reads the plan
    alone, the plain version the tensors alone."""
    if not isinstance(plan, SweepPlan):
        raise TypeError(f"plan must be a SweepPlan, got {type(plan).__name__}")
    if plan.cluster != cluster:
        raise ValueError(f"the plan is for cluster {plan.cluster}, not "
                         f"{cluster}")
    given = (sites, nbrs, q, keep)
    if len(plan.source) != len(given) or not all(
            isinstance(t, torch.Tensor) and t.data_ptr() == s.data_ptr()
            and t.shape == s.shape and t.stride() == s.stride()
            and t._version == v for t, (s, v) in zip(given, plan.source)):
        raise ValueError("the plan was not built from these sites, nbrs, q "
                         "and keep, or they changed since: build it with "
                         "gather_sweeps_plan from the tensors of the call")


def _check_plan(plan, n, NB, dev):
    if not isinstance(plan, SweepPlan):
        raise TypeError(f"plan must be a SweepPlan, got {type(plan).__name__}")
    rows = NB * plan.cluster
    _check("plan.pushes", plan.pushes, torch.int32,
           (rows, plan.pushes.shape[1], 4), dev)
    _check("plan.owned", plan.owned, torch.int32,
           (rows, plan.owned.shape[1], 2), dev)
    _check("plan.where", plan.where, torch.int16,
           (rows, plan.owned.shape[1], _W), dev)
    # the kernel reads pushes and where as 16-byte vectors, owned as 8-byte
    for name, t, align in (("pushes", plan.pushes, 16),
                           ("where", plan.where, 16),
                           ("owned", plan.owned, 8)):
        if t.data_ptr() % align:
            raise ValueError(f"plan.{name} must be {align}-byte aligned")
    if gather_sweeps_smem_floats(n, plan) > _SMEM_FLOATS:
        raise ValueError(f"a field of {n} floats and partials of "
                         f"{plan.slots} floats do not fit in the shared "
                         f"memory of a cluster of {plan.cluster} blocks")


def gather_sweeps_cuda(w, sites, nbrs, q, P, noise, keep, cluster=CLUSTER,
                       plan=None):
    """Launch the DSMEM kernel on the current stream (no synchronise);
    builds the plan first when none is given."""
    _sweep_library()
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
    if plan is None:
        plan = gather_sweeps_plan(sites, nbrs, q, keep, cluster)
    _check_plan_source(plan, sites, nbrs, q, keep, cluster)
    _check_plan(plan, n, NB, dev)
    _launch_sweeps(w, P, noise, plan, False)
    gather_sweeps.launches += 1
    return w


def gather_sweeps_floor(w, P, noise, plan):
    """The kernel's step loop with its cluster and block barriers alone,
    nothing loaded or stored (``w`` is left as it is): X1's dependency
    floor, for timing.  Not counted in ``gather_sweeps.launches``."""
    S, NB, B = noise.shape
    _check("P", P, torch.float32, (NB, B), w.device)
    _check("noise", noise, torch.float32, (S, NB, B), w.device)
    _check_plan(plan, w.shape[0], NB, w.device)
    _launch_sweeps(w, P, noise, plan, True)


def gather_sweeps(w, sites, nbrs, q, P, noise, keep, cluster=CLUSTER,
                  plan=None):
    """All sweeps of gather_bench.py's field update, in place on ``w``
    [n]: sites/keep [NB, B], nbrs/q [NB, B, 16], P [NB, B], noise
    [S, NB, B]; ``keep = last_occurrence(sites)``.  ``cluster`` (one of
    CLUSTERS) is the kernel's cluster size; ``plan`` is
    ``gather_sweeps_plan(sites, nbrs, q, keep, cluster)`` of these very
    tensors, built here when not given; any other plan raises, on every
    device."""
    if plan is not None:
        _check_plan_source(plan, sites, nbrs, q, keep, cluster)
    return _dispatch("gather_sweeps", w, gather_sweeps_cuda,
                     gather_sweeps_reference, w, sites, nbrs, q, P, noise,
                     keep, cluster=cluster, plan=plan)


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
    lib.column_scatter_rows.argtypes = [i]
    lib.matmul_f32_launch.argtypes = [p, p, p, i, i, i, p]
    lib.matmul_f32_split.argtypes = [i, i, i]
    for fn in (lib.staged_gather_launch, lib.column_scatter_launch,
               lib.column_scatter_rows, lib.matmul_f32_launch,
               lib.matmul_f32_split):
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
    if max([src.numel()] + [r * c for r, c in shapes]) >= 2**31:
        raise ValueError("staged_gather indexes with 32 bits: every tensor "
                         "of the chain must hold fewer than 2^31 elements")
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


# The kernel's launch: threads a block, index loads in flight a thread,
# the least and most rows a block owns, and the blocks of one wave (an
# H100 SXM's SMs).
SCATTER_THREADS = 256
SCATTER_LOADS = 4
SCATTER_ROWS = (8, 6144)
SCATTER_WAVE = 132


def scatter_rows_per_block(n_rows):
    """Rows of out one block of the kernel owns (the C side's
    ``column_scatter_rows``): one wave of blocks where the rows allow it."""
    lo, hi = SCATTER_ROWS
    return min(hi, max(lo, -(-n_rows // SCATTER_WAVE)))


def column_scatter_emulated(val, idx, n_rows):
    """The kernel's algorithm on the CPU: per block of
    ``scatter_rows_per_block`` rows, the index column in the kernel's
    batches of SCATTER_LOADS x SCATTER_THREADS, each index naming a row of
    the block giving the key (i + 1) << 32 | bits(val[i, 0]) and each row
    taking the largest key; column 0 is the low 32 bits of a row's key, 0
    where none named it.  For tests."""
    n_in, cols = val.shape
    col = idx[:, 0].long()
    bits = val[:, 0].contiguous().view(torch.int32).long() & 0xFFFFFFFF
    keys = (torch.arange(1, n_in + 1) << 32) | bits
    R = scatter_rows_per_block(n_rows)
    batch = SCATTER_LOADS * SCATTER_THREADS
    out = torch.zeros(n_rows, cols, dtype=torch.float32)
    for r0 in range(0, n_rows, R):
        rows = min(R, n_rows - r0)
        best = torch.zeros(rows, dtype=torch.int64)
        for b in range(0, n_in, batch):
            for u in range(SCATTER_LOADS):
                lo = min(n_in, b + u * SCATTER_THREADS)
                i = torch.arange(lo, min(n_in, lo + SCATTER_THREADS))
                off = col[i] - r0
                hit = (off >= 0) & (off < rows)
                best.scatter_reduce_(0, off[hit], keys[i[hit]], "amax")
        low = best & 0xFFFFFFFF
        low = torch.where(low >= 2**31, low - 2**32, low).to(torch.int32)
        out[r0:r0 + rows, 0] = torch.where(best != 0, low.view(torch.float32),
                                           torch.zeros(()))
    return out


def column_scatter_cuda(val, idx, n_rows):
    """Launch the column-scatter kernel on the current stream."""
    lib = _probe_library()
    dev = val.device
    if val.dim() != 2:
        raise ValueError(f"val must be 2-D, got shape {tuple(val.shape)}")
    _check("val", val, torch.float32, val.shape, dev)
    _check("idx", idx, torch.int32, val.shape, dev)
    n_in, cols = val.shape
    if max(val.numel(), n_rows * cols) >= 2**31:
        raise ValueError("column_scatter indexes with 32 bits: val, idx and "
                         "out must each hold fewer than 2^31 elements")
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
