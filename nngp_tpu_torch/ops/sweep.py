"""Chromatic Gibbs sweeps of the latent field: the CUDA kernel and its plain
PyTorch twin.

``chromatic_sweeps`` runs all S sweeps of one iteration for a batch of
chains, updating ``w`` in place.  On a CUDA tensor it launches the
hand-written kernel ``csrc/chromatic_sweep.cu`` (the port of the Pallas
kernel ``nngp_tpu/ops/pallas_sweep.py``), built with nvcc on first use; if
that kernel cannot be built or launched it raises.  On a CPU tensor it runs
``chromatic_sweeps_reference``, the same arithmetic as plain tensor ops,
which the tests hold against ``nngp_tpu``.

Inputs (C chains, n sites, E moralized edges, D = max degree):
  w           f32 [C, n+1]   field, slot n a zero dummy; updated in place
  q_edges     f32 [C, E+1]   Q values on the edges, slot E = 0
  P           f32 [C, n]     posterior precision per site
  rs          f32 [C, n]     residual sum per site
  noise       f32 [C, S, n]  standard normals, indexed by site
  scal        f32 [C, 3]     (beta_0, e^-log_scale, e^-log_noise_variance)
  color_ptr   i32 [n_colors+1], color_sites i32 [n]   colour-major CSR
  nbr_sites   i32 [n, D] (pad n), nbr_edge i32 [n, D] (pad E)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nngp_tpu_torch.ops import _build


def chromatic_sweeps_reference(w, q_edges, P, rs, noise, scal, color_ptr,
                               color_sites, nbr_sites, nbr_edge):
    """Plain PyTorch version: colour by colour, every chain at once."""
    beta0, inv_scale, inv_noise = (scal[:, j, None] for j in range(3))
    ptr = color_ptr.tolist()
    per_color = []
    for c in range(len(ptr) - 1):
        sites = color_sites[ptr[c]:ptr[c + 1]].long()
        per_color.append((sites, nbr_sites[sites].long(),
                          q_edges[:, nbr_edge[sites].long()],
                          P[:, sites], rs[:, sites]))
    for s in range(noise.shape[1]):
        for sites, nbrs, q, Ps, rss in per_color:
            prior = torch.sum(q * (w[:, nbrs] - beta0[..., None]), dim=-1)
            mean = beta0 - (inv_scale * prior - inv_noise * rss) / Ps
            w[:, sites] = mean + noise[:, s, sites] * torch.rsqrt(Ps)
    return w


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
    lib.chromatic_sweeps_launch.argtypes = [
        p, p, p, i, p, p, i, p, i, p, p, p, p, i, i, i, p]
    lib.chromatic_sweeps_launch.restype = ctypes.c_int
    return lib


def chromatic_sweeps_cuda(w, q_edges, P, rs, noise, scal, color_ptr,
                          color_sites, nbr_sites, nbr_edge):
    """Launch the CUDA kernel on the current stream (no synchronise)."""
    lib = _library()
    dev = w.device
    C, n1 = w.shape
    n = n1 - 1
    S = noise.shape[1]
    n_colors = color_ptr.shape[0] - 1
    D = nbr_sites.shape[1]
    n_q = q_edges.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check("w", w, f32, (C, n + 1), dev)
    _check("q_edges", q_edges, f32, (C, n_q), dev)
    _check("P", P, f32, (C, n), dev)
    _check("rs", rs, f32, (C, n), dev)
    _check("noise", noise, f32, (C, S, n), dev)
    _check("scal", scal, f32, (C, 3), dev)
    _check("color_ptr", color_ptr, i32, (n_colors + 1,), dev)
    _check("color_sites", color_sites, i32, (n,), dev)
    _check("nbr_sites", nbr_sites, i32, (n, D), dev)
    _check("nbr_edge", nbr_edge, i32, (n, D), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.chromatic_sweeps_launch(
        w.data_ptr(), color_ptr.data_ptr(), color_sites.data_ptr(), n_colors,
        nbr_sites.data_ptr(), nbr_edge.data_ptr(), D, q_edges.data_ptr(), n_q,
        P.data_ptr(), rs.data_ptr(), noise.data_ptr(), scal.data_ptr(),
        C, n, S, stream)
    if err != 0:
        raise RuntimeError(f"chromatic_sweeps kernel launch failed: CUDA "
                           f"error {err}")
    chromatic_sweeps.launches += 1
    return w


def chromatic_sweeps(w, q_edges, P, rs, noise, scal, color_ptr, color_sites,
                     nbr_sites, nbr_edge):
    """All sweeps of one iteration, in place on ``w``: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor.
    ``chromatic_sweeps.launches`` counts kernel launches."""
    if w.device.type == "cuda":
        return chromatic_sweeps_cuda(w, q_edges, P, rs, noise, scal,
                                     color_ptr, color_sites, nbr_sites,
                                     nbr_edge)
    if w.device.type == "cpu":
        return chromatic_sweeps_reference(w, q_edges, P, rs, noise, scal,
                                          color_ptr, color_sites, nbr_sites,
                                          nbr_edge)
    raise ValueError(f"chromatic_sweeps: no implementation for {w.device}")


chromatic_sweeps.launches = 0
