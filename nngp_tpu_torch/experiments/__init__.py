"""The scripts of ``experiments/`` on one CUDA card.

The gather microbenchmarks: ``experiments/gather_bench.py`` (X1),
``gather_probe.py`` (X2) and ``gather_probe2.py`` (X3) are JAX scripts that
time Pallas kernels on a TPU.  This package runs the same arrays, drawn in
the same order from the same seed (``data.py``), through hand-written CUDA
kernels (``csrc/gather_sweep.cu``, ``csrc/gather_probes.cu``, wrapped in
``gather_ops.py``) and their plain PyTorch twins:

    python -m nngp_tpu_torch.experiments.gather_bench
    python -m nngp_tpu_torch.experiments.gather_probe
    python -m nngp_tpu_torch.experiments.gather_probe2

Each prints what its JAX script prints; without a CUDA card it raises.

The numeric audits (``ratio_audit``, ``factor_probe``,
``cotransform_probe``, ``op_probe``, ``matern_probe``) and the large-n run
(``bigN``) take the JAX scripts' draws and write their record keys, the
device side in float32, the float64 oracles on the host (``_oracles.py``);
each takes ``--device`` (default ``cuda``) and ``--out``.  Records:
``records/``.  ``sweep_bench`` times the sweep kernel.
"""
