"""nngp_tpu_torch — the NNGP sampler of ``nngp_tpu`` on PyTorch and CUDA.

A port of ``nngp_tpu`` (JAX/Pallas on a TPU) for one NVIDIA Hopper GPU.
It imports torch and never jax: the host preprocessing is a NumPy copy of
``nngp_tpu``'s, the device code is plain PyTorch with chains as the leading
tensor dimension, and the chromatic Gibbs sweep — a Pallas kernel in
``nngp_tpu`` — is a hand-written CUDA kernel (``csrc/chromatic_sweep.cu``)
with a plain PyTorch twin for CPU tensors.  ``nngp_tpu_torch.experiments``
runs the gather microbenchmarks of ``experiments/`` on CUDA kernels.

Public API: ``initialize`` -> ``run`` -> ``estimate`` -> ``predict_field``
/ ``predict_fixed_effects``, ``save`` / ``load`` (files shared with
``nngp_tpu``), plus the diagnostics ``Gelman_Rubin_Brooks`` and ``ESS``.
"""

from nngp_tpu_torch.api import (
    estimate,
    initialize,
    load,
    predict_field,
    predict_fixed_effects,
    run,
    save,
)
from nngp_tpu_torch.diagnostics.ess import ESS
from nngp_tpu_torch.diagnostics.grb import Gelman_Rubin_Brooks

__all__ = ["initialize", "run", "estimate", "predict_field",
           "predict_fixed_effects", "save", "load", "Gelman_Rubin_Brooks",
           "ESS"]
