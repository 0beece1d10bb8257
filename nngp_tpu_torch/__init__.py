"""nngp_tpu_torch — the NNGP sampler of ``nngp_tpu`` on PyTorch and CUDA.

A port of ``nngp_tpu`` (JAX/Pallas on a TPU) for one NVIDIA Hopper GPU.
It imports torch and never jax: the host preprocessing is a NumPy copy of
``nngp_tpu``'s, the device code is plain PyTorch with chains as the leading
tensor dimension, and the chromatic Gibbs sweep — a Pallas kernel in
``nngp_tpu`` — is a hand-written CUDA kernel (``csrc/chromatic_sweep.cu``)
with a plain PyTorch twin for CPU tensors.

Public API: ``initialize`` -> ``run`` -> ``estimate``, plus the diagnostics
``Gelman_Rubin_Brooks`` and ``ESS``.
"""

from nngp_tpu_torch.api import estimate, initialize, run
from nngp_tpu_torch.diagnostics.ess import ESS
from nngp_tpu_torch.diagnostics.grb import Gelman_Rubin_Brooks

__all__ = ["initialize", "run", "estimate", "Gelman_Rubin_Brooks", "ESS"]
