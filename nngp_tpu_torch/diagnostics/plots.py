"""Trace plots (reference: raw_chains_plots_* in Scripts/mcmc_nngp_diagnose.R:27-103).

Copy of ``nngp_tpu/diagnostics/plots.py``.  Headless-friendly: matplotlib
Agg, written to files instead of an interactive device.  Same content: one
panel per parameter, one line per chain, post-burn-in slice.  matplotlib is
imported when a plot is drawn; without it a plot raises ImportError.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or a clear ImportError."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("trace plots (run(plot_trace=...)) need matplotlib, "
                          "which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _collect(records, name, col=None):
    out = []
    for rec in records:
        arr = np.asarray(rec[name])
        out.append(arr[:, col] if (arr.ndim == 2 and col is not None) else arr)
    return out


def raw_chains_plots_covparms(records, burn_in=0.5, path="trace_covparms.png"):
    """Trace panels for beta_0, log_scale, log_noise_variance and each shape
    parameter (diagnose.R:43-76)."""
    plt = _pyplot()

    T = len(records[0]["beta_0"])
    lo = max(int(burn_in * (T - 1)), 0)
    panels = [("beta_0", None), ("log_scale", None), ("log_noise_variance", None)]
    shape_names = records[0].get("shape_names") or [
        f"shape_{j}" for j in range(np.asarray(records[0]["shape"]).shape[1])
    ]
    for j, nm in enumerate(shape_names):
        panels.append((nm, j))
    fig, axes = plt.subplots(len(panels), 1, figsize=(8, 2.2 * len(panels)),
                             squeeze=False)
    x = np.arange(lo, T)
    for ax, (nm, col) in zip(axes[:, 0], panels):
        series = _collect(records, "shape" if col is not None else nm, col)
        for s in series:
            ax.plot(x, s[lo:T], lw=0.6)
        ax.set_ylabel(nm)
    axes[-1, 0].set_xlabel("iteration")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def raw_chains_plots_beta(records, burn_in=0.5, path="trace_beta.png"):
    """Trace panels for the regression coefficients (diagnose.R:79-103)."""
    plt = _pyplot()

    if records[0].get("beta") is None:
        return None
    beta = np.asarray(records[0]["beta"])
    T, p = beta.shape
    lo = max(int(burn_in * (T - 1)), 0)
    names = records[0].get("beta_names") or [f"beta_{j}" for j in range(p)]
    fig, axes = plt.subplots(p, 1, figsize=(8, 2.2 * p), squeeze=False)
    x = np.arange(lo, T)
    for j in range(p):
        for rec in records:
            axes[j, 0].plot(x, np.asarray(rec["beta"])[lo:T, j], lw=0.6)
        axes[j, 0].set_ylabel(names[j])
    axes[-1, 0].set_xlabel("iteration")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def raw_chains_plots_one_param(records, name="beta_0", begin=0, end=None,
                               path=None):
    """Single-parameter trace plot (diagnose.R:27-41)."""
    plt = _pyplot()

    series = _collect(records, name)
    if end is None:
        end = len(series[0])
    fig, ax = plt.subplots(figsize=(8, 3))
    x = np.arange(begin, end)
    for s in series:
        ax.plot(x, np.asarray(s)[begin:end], lw=0.6)
    ax.set_xlabel("iteration")
    ax.set_ylabel(name)
    path = path or f"trace_{name}.png"
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
