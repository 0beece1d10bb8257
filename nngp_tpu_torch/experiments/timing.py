"""Timing on the card with CUDA events.  Both helpers need a CUDA card."""

from __future__ import annotations

import time

import torch

_SPIN_CYCLES_PER_MS = 2_000_000   # at least 1 ms at an H100's 1.98 GHz boost


def cuda_device() -> torch.device:
    """The first CUDA card; raises without one (no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the gather probes time CUDA kernels and need a "
                           "CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def median_ms(fn, reps, setup=lambda: None):
    """Median over ``reps`` calls of ``fn``'s time between two CUDA events,
    ``setup`` run before each call outside the events."""
    times = []
    for _ in range(reps):
        setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def per_call_ms(fn, reps=100):
    """Time of one call of ``fn`` from ``reps`` calls enqueued back to back
    between two CUDA events.  A spin kernel ahead of the first event holds
    the card until every call is enqueued, so the events see the device's
    time, not the host's enqueue time, unless ``fn`` waits on the device.
    Returns (device ms per call, host enqueue ms per call)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_SPIN_CYCLES_PER_MS * (2 * host_ms + 1)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, host_ms / reps
