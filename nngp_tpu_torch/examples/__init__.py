"""The user scripts of ``examples/`` on PyTorch, on one CUDA card.

Each script is a port of the file of the same name in ``examples/`` and
prints what that file prints, in the same order:

    python -m nngp_tpu_torch.examples.vignette_toy [--quick]
    python -m nngp_tpu_torch.examples.heavy_metals [--quick] [--save FIT]
    python -m nngp_tpu_torch.examples.heavy_metals_96
    python -m nngp_tpu_torch.examples.heavy_metals_analysis FIT [GRID_DEG]
    python -m nngp_tpu_torch.examples.matern_fit [--quick]
    python -m nngp_tpu_torch.examples.synthetic_families [--quick]

Every script runs on the card unless it is given ``--device cpu`` (asked
for the card where there is none, it raises), writes its logs and its
summary under ``--out`` (default ``nngp_tpu_torch/examples/out/``), and
exposes ``main(argv=None) -> dict``, which returns the summary.
"""
