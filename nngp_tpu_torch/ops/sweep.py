"""Chromatic Gibbs sweeps of the latent field: the CUDA kernel and its plain
PyTorch twin.

``chromatic_sweeps`` runs all S sweeps of one iteration for a batch of
chains, updating ``w`` in place.  On a CUDA tensor it launches the
hand-written kernel ``csrc/chromatic_sweep.cu`` (the port of the Pallas
kernel ``nngp_tpu/ops/pallas_sweep.py``), built with nvcc on first use; if
that kernel cannot be built or launched it raises.  On a CPU tensor it runs
``chromatic_sweeps_reference``, the same arithmetic as plain tensor ops,
which the tests hold against ``nngp_tpu``.

Inputs (C chains, n sites, nnz = 2E directed neighbour entries), all in the
order of the graph's sweep plan (``preprocess/coloring.py:sweep_plan``):
  w           f32 [C, n]      field, updated in place
  q_plan      f32 [C, nnz]    Q values in plan order (q_edges[:, plan_edge])
  P           f32 [C, n]      posterior precision per site
  rs          f32 [C, n]      residual sum per site
  noise       f32 [C, S, n]   standard normals, indexed by site
  scal        f32 [C, 3]      (beta_0, e^-log_scale, e^-log_noise_variance)
  color_ptr   i32 [n_colors+1]  colour c is plan positions
                                color_ptr[c]:color_ptr[c+1]
  plan_sites  i32 [n]         the site at each plan position
  plan_ptr    i32 [n+1]       CSR offsets of each plan position's neighbours
  plan_nbr    i32 [nnz]       the neighbours, row by row

The kernel walks a lane table (``lane_table``) that this module builds from
the plan once per ``plan_ptr`` tensor, with the kernel's entries a lane.

``chromatic_sweep_step`` runs one colour step of one sweep on a
``SubPlan``, a rank's positions of the plan (halo mode,
``parallel/halo.py``): the same kernel, launched with one sweep, one
colour and the two lane offsets of that colour, so that a halo exchange
can sit between colour steps.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from nngp_tpu_torch.ops import _build


def chromatic_sweeps_reference(w, q_plan, P, rs, noise, scal, color_ptr,
                               plan_sites, plan_ptr, plan_nbr):
    """Plain PyTorch version: colour by colour, every chain at once, the
    neighbour sums as segment sums over ``plan_ptr``."""
    C = w.shape[0]
    beta0, inv_scale, inv_noise = (scal[:, j, None] for j in range(3))
    cptr, ptr = color_ptr.tolist(), plan_ptr.long()
    per_color = []
    for c in range(len(cptr) - 1):
        a, b = cptr[c], cptr[c + 1]
        sites = plan_sites[a:b].long()
        lo, hi = int(ptr[a]), int(ptr[b])
        seg = torch.repeat_interleave(
            torch.arange(b - a, device=w.device), ptr[a + 1:b + 1] - ptr[a:b])
        per_color.append((sites, seg, plan_nbr[lo:hi].long(),
                          q_plan[:, lo:hi], P[:, sites], rs[:, sites]))
    for s in range(noise.shape[1]):
        for sites, seg, nbrs, q, Ps, rss in per_color:
            terms = q * (w[:, nbrs] - beta0)
            prior = w.new_zeros(C, len(sites)).index_add_(1, seg, terms)
            mean = beta0 - (inv_scale * prior - inv_noise * rss) / Ps
            w[:, sites] = mean + noise[:, s, sites] * torch.rsqrt(Ps)
    return w


def lane_table(color_ptr, plan_sites, plan_ptr, per_lane):
    """The kernel's lane table, NumPy in and out: (lane_ptr i32
    [n_colors+1], lane_tab i32 [4, L]).

    A plan position of degree d takes a group of the least power of two, at
    most 32, of lanes that hold d entries at ``per_lane`` each.  Colour c
    owns the lane slots lane_ptr[c]:lane_ptr[c+1], a multiple of 32; each
    of its positions t owns its group's slots in a row, and the u-th of
    those holds, in ``lane_tab``'s four rows, (plan_sites[t], plan_ptr[t] +
    u, plan_ptr[t+1], width): the site, the lane's first CSR entry (the
    lane takes every width-th entry from there), the site's CSR end and the
    group's width.  The colour's padding holds (-1, 0, 0, 1).  The plan
    sorts each colour by degree, highest first, so the widths never grow
    along a colour: every group starts at a multiple of its width and none
    crosses a 32-lane warp."""
    color_ptr = np.asarray(color_ptr, dtype=np.int64)
    plan_sites = np.asarray(plan_sites, dtype=np.int64)
    plan_ptr = np.asarray(plan_ptr, dtype=np.int64)
    lanes = np.maximum(1, -(-np.diff(plan_ptr) // per_lane))
    widths = np.minimum(32, 1 << np.ceil(np.log2(lanes)).astype(np.int64))
    lane_ptr, pos = [0], []
    for c in range(len(color_ptr) - 1):
        a, b = color_ptr[c], color_ptr[c + 1]
        wc = widths[a:b]
        start = np.cumsum(wc) - wc
        if np.any(start % wc):
            raise ValueError("lane groups must not grow along a colour: "
                             "sort each colour's sites by degree first")
        used = int(wc.sum())
        t = np.repeat(np.arange(a, b), wc)
        u = np.arange(used) - np.repeat(start, wc)
        tab = np.zeros((4, -(-used // 32) * 32), dtype=np.int32)
        tab[0], tab[3] = -1, 1
        tab[:, :used] = (plan_sites[t], plan_ptr[t] + u, plan_ptr[t + 1],
                         widths[t])
        pos.append(tab)
        lane_ptr.append(lane_ptr[-1] + tab.shape[1])
    return (np.asarray(lane_ptr, dtype=np.int32),
            np.concatenate(pos, axis=1) if pos
            else np.zeros((4, 0), dtype=np.int32))


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.cache
def _library():
    lib = _build.cuda_library("chromatic_sweep")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chromatic_sweeps_launch.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.chromatic_sweeps_grid.argtypes = []
    for fn in (lib.chromatic_sweeps_launch, lib.chromatic_sweeps_grid,
               lib.chromatic_sweeps_lane_entries):
        fn.restype = i
    return lib


def grid_threads() -> int:
    """Threads of the kernel's cooperative grid on the current card."""
    return _library().chromatic_sweeps_grid()


# id(plan_ptr) -> (weak reference to plan_ptr, lane_ptr, lane_tab)
_LANES: dict = {}


def lanes(color_ptr, plan_sites, plan_ptr):
    """The lane table of a plan on the plan's device, built on the host the
    first time this ``plan_ptr`` tensor is seen and kept while it lives."""
    hit = _LANES.get(id(plan_ptr))
    if hit is not None and hit[0]() is plan_ptr:
        return hit[1:]
    per_lane = _library().chromatic_sweeps_lane_entries()
    tables = tuple(
        torch.as_tensor(t, device=plan_ptr.device) for t in lane_table(
            color_ptr.cpu().numpy(), plan_sites.cpu().numpy(),
            plan_ptr.cpu().numpy(), per_lane))
    _LANES[id(plan_ptr)] = (weakref.ref(plan_ptr),) + tables
    weakref.finalize(plan_ptr, _LANES.pop, id(plan_ptr), None)
    return tables


def launch(w, q_plan, P, rs, noise, scal, plan_nbr, lane_ptr, lane_tab):
    """Check the kernel's arguments and launch it on the current stream (no
    synchronise); ``chromatic_sweeps.launches`` counts the launch."""
    lib = _library()
    dev = w.device
    C, n = w.shape
    S = noise.shape[1]
    n_colors = lane_ptr.shape[0] - 1
    nnz = plan_nbr.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check("w", w, f32, (C, n), dev)
    _check("q_plan", q_plan, f32, (C, nnz), dev)
    _check("P", P, f32, (C, n), dev)
    _check("rs", rs, f32, (C, n), dev)
    _check("noise", noise, f32, (C, S, n), dev)
    _check("scal", scal, f32, (C, 3), dev)
    _check("plan_nbr", plan_nbr, i32, (nnz,), dev)
    _check("lane_ptr", lane_ptr, i32, (n_colors + 1,), dev)
    L = lane_tab.shape[-1]
    _check("lane_tab", lane_tab, i32, (4, L), dev)
    barrier = torch.empty(1, dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.chromatic_sweeps_launch(
        w.data_ptr(), q_plan.data_ptr(), P.data_ptr(), rs.data_ptr(),
        noise.data_ptr(), scal.data_ptr(), plan_nbr.data_ptr(),
        lane_ptr.data_ptr(), lane_tab.data_ptr(), barrier.data_ptr(), C, n,
        nnz, S, L, n_colors, stream)
    if err != 0:
        raise RuntimeError(f"chromatic_sweeps kernel launch failed: CUDA "
                           f"error {err}")
    chromatic_sweeps.launches += 1
    return w


def chromatic_sweeps_cuda(w, q_plan, P, rs, noise, scal, color_ptr,
                          plan_sites, plan_ptr, plan_nbr):
    """The CUDA kernel on the plan's lane table (``lanes``)."""
    _library()
    dev, n = w.device, w.shape[-1]
    i32 = torch.int32
    _check("color_ptr", color_ptr, i32, (len(color_ptr),), dev)
    _check("plan_sites", plan_sites, i32, (n,), dev)
    _check("plan_ptr", plan_ptr, i32, (n + 1,), dev)
    return launch(w, q_plan, P, rs, noise, scal, plan_nbr,
                  *lanes(color_ptr, plan_sites, plan_ptr))


def chromatic_sweeps(w, q_plan, P, rs, noise, scal, color_ptr, plan_sites,
                     plan_ptr, plan_nbr):
    """All sweeps of one iteration, in place on ``w``: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor.
    ``chromatic_sweeps.launches`` counts kernel launches."""
    args = (w, q_plan, P, rs, noise, scal, color_ptr, plan_sites, plan_ptr,
            plan_nbr)
    if w.device.type == "cuda":
        return chromatic_sweeps_cuda(*args)
    if w.device.type == "cpu":
        return chromatic_sweeps_reference(*args)
    raise ValueError(f"chromatic_sweeps: no implementation for {w.device}")


chromatic_sweeps.launches = 0


@dataclass(frozen=True)
class SubPlan:
    """Some positions of a sweep plan as a plan of their own
    (``preprocess/coloring.py:owned_sweep_plan``): the plan's arrays, with
    ``bounds``, the host copy of ``color_ptr``, so that a step knows
    without a device read whether its colour has a position."""

    bounds: tuple                 # host ints [n_colors+1]
    color_ptr: object             # i32 [n_colors+1]
    plan_sites: object            # i32 [k]
    plan_ptr: object              # i32 [k+1]
    plan_nbr: object              # i32 [nnz_k]
    plan_edge: object             # i32 [nnz_k]

    @classmethod
    def of(cls, color_ptr, plan_sites, plan_ptr, plan_nbr, plan_edge):
        return cls(tuple(int(v) for v in np.asarray(color_ptr)), color_ptr,
                   plan_sites, plan_ptr, plan_nbr, plan_edge)

    def to(self, device) -> "SubPlan":
        return SubPlan(self.bounds, *(
            torch.as_tensor(np.asarray(getattr(self, k)), device=device)
            for k in ("color_ptr", "plan_sites", "plan_ptr", "plan_nbr",
                      "plan_edge")))


def chromatic_sweep_step(w, q_plan, P, rs, noise_s, scal, sub_plan, c):
    """Colour c of one sweep over the positions of ``sub_plan``, in place on
    ``w`` [C, n]: ``q_plan`` [C, nnz] is Q in the sub-plan's order, ``P``
    and ``rs`` [C, n] are read at its sites, ``noise_s`` [C, 1, n] holds
    the sweep's normals.  On a CUDA tensor one launch of the kernel with
    S = 1 and the colour's two lane offsets ``lane_ptr[c:c+2]`` (the
    kernel reads them as offsets into the sub-plan's lane table); on a CPU
    tensor the plain version on the same colour.  A colour with no
    position launches nothing.  Each site gets the bits of the full plan's
    step: it keeps its degree, its lane group and its CSR order."""
    if sub_plan.bounds[c] == sub_plan.bounds[c + 1]:
        return w
    if w.device.type == "cuda":
        lane_ptr, lane_tab = lanes(sub_plan.color_ptr, sub_plan.plan_sites,
                                   sub_plan.plan_ptr)
        return launch(w, q_plan, P, rs, noise_s, scal, sub_plan.plan_nbr,
                      lane_ptr[c:c + 2], lane_tab)
    if w.device.type == "cpu":
        return chromatic_sweeps_reference(
            w, q_plan, P, rs, noise_s, scal, sub_plan.color_ptr[c:c + 2],
            sub_plan.plan_sites, sub_plan.plan_ptr, sub_plan.plan_nbr)
    raise ValueError(f"chromatic_sweep_step: no implementation for "
                     f"{w.device}")
