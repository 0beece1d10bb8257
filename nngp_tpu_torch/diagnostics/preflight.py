"""Card preflight: the sweep kernel K1 against its plain twin on the fit
being timed.

Port of ``nngp_tpu/diagnostics/preflight.py``.  With the innovation noise
zeroed, the chromatic sweeps are the deterministic mean-field map
(mcmc_nngp_update_Gaussian.R:261-274 with the N(0, P^-1) draw suppressed),
so the CUDA kernel (``ops/sweep.py:chromatic_sweeps_cuda``) and its plain
twin (``chromatic_sweeps_reference``, run on CPU copies of the same
inputs) must give the same field from the same state.  Both walk the
graph's sweep plan, colour by colour, so they are the same Gibbs order.
The bench (``nngp_tpu_torch/bench.py``) runs this before its timed legs and
stops when it fails: there is no plain fallback for the card.
"""

from __future__ import annotations

from dataclasses import fields, replace

import torch


def chromatic_sweep_parity(mc, n_sweeps: int = 2, tol: float = 2e-3):
    """Run ``n_sweeps`` zero-noise chromatic sweeps of chain 0 of ``mc``
    through the kernel on the card and through the plain twin on the CPU,
    both from the same ``sweep_inputs``, and compare the fields.

    Returns {"max_abs_diff", "rms_diff", "rel_tol_used", "ok", "device"}:
    ``ok`` is max_abs_diff <= tol * max(1, |f|_inf) of the twin's field.
    Raises ValueError for a fit that is not on a CUDA card."""
    from nngp_tpu_torch.models.gaussian import _mu_obs, sweep_inputs
    from nngp_tpu_torch.ops.covariance import shape_transform
    from nngp_tpu_torch.ops.sweep import (chromatic_sweeps_cuda,
                                          chromatic_sweeps_reference)
    from nngp_tpu_torch.ops.vecchia import vecchia_linv

    if mc.device.type != "cuda":
        raise ValueError(f"the sweep parity preflight holds the CUDA kernel "
                         f"against its twin; this fit is on {mc.device}, "
                         "which has no kernel")
    g = mc.graph
    st = replace(mc.states, **{
        f.name: getattr(mc.states, f.name)[:1] for f in fields(mc.states)
        if getattr(mc.states, f.name) is not None})
    names = mc.space_time_model["covfun"]["shape_params"]
    linv = vecchia_linv(g, shape_transform(names, st.shape))
    _, q_plan, P, rs, scal = sweep_inputs(g, mc.data, st, linv,
                                          _mu_obs(mc.data, st, g))
    noise = torch.zeros(1, int(n_sweeps), g.n, device=mc.device)
    args = (q_plan, P, rs, noise, scal, g.color_ptr, g.plan_sites,
            g.plan_ptr, g.plan_nbr)
    w0 = st.field.contiguous()
    f_k = chromatic_sweeps_cuda(w0.clone(), *args).cpu()
    f_p = chromatic_sweeps_reference(w0.cpu(), *(a.cpu() for a in args))
    diff = (f_k - f_p).abs()
    worst = diff.max().item()
    scale = max(1.0, f_p.abs().max().item())
    return {
        "max_abs_diff": worst,
        "rms_diff": diff.pow(2).mean().sqrt().item(),
        "rel_tol_used": tol,
        "ok": bool(torch.isfinite(f_k).all()) and worst <= tol * scale,
        "device": torch.cuda.get_device_name(mc.device),
    }
