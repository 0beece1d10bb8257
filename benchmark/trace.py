"""Device operations of a traced stretch, from torch.profiler's CUPTI trace,
and the arithmetic over them: the union of their intervals (busy time,
overlaps counted once), mean time a call of a kernel, and the breakdown of
the longest operations and idle gaps."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Event:
    name: str
    start_ns: int
    end_ns: int
    kind: str            # "kernel", "memcpy" or "memset"


@dataclass
class TracedRun:
    """What the per-layer readers read (``metrics/<name>.py: read(run)``)."""

    events: list                 # Event of the traced stretch, by start
    wall_s: float                # the stretch's host wall time
    iterations: int              # Gibbs iterations in the stretch
    setup_timings: dict          # the sampler's initialize stages
    covfun: str
    shapes: dict = field(default_factory=dict)
    factor: dict = field(default_factory=dict)


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def events_of(prof) -> list:
    """Device operations recorded by a finished ``torch.profiler.profile``,
    sorted by start."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        out.append(Event(e.name(), start, end, _kind(e.name())))
    out.sort(key=lambda e: e.start_ns)
    return out


def union_s(events) -> float:
    """Seconds covered by at least one event."""
    total, cur_s, cur_e = 0, None, None
    for e in sorted(events, key=lambda e: e.start_ns):
        if cur_e is None or e.start_ns > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = e.start_ns, e.end_ns
        else:
            cur_e = max(cur_e, e.end_ns)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-9


def mean_call_s(events, kernel: str):
    """Mean device seconds a call of the kernels whose name holds
    ``kernel``, or None when none ran."""
    ts = [e.end_ns - e.start_ns for e in events
          if e.kind == "kernel" and kernel in e.name]
    return sum(ts) * 1e-9 / len(ts) if ts else None


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    name = name.split("(")[0]
    return name[:80]


def breakdown(events, top: int = 10) -> dict:
    """{"device_ops": [[name, seconds]] of the operations that took most
    time, "idle_gaps": [[what came before and after, seconds]] of the
    longest gaps with no device operation}."""
    by = defaultdict(int)
    for e in events:
        by[_short(e.name)] += e.end_ns - e.start_ns
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps, end, last = [], None, None
    for e in sorted(events, key=lambda e: e.start_ns):
        if end is not None and e.start_ns > end:
            gaps.append((f"after {_short(last)} before {_short(e.name)}",
                         e.start_ns - end))
        if end is None or e.end_ns > end:
            end, last = e.end_ns, e.name
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[k, v * 1e-9] for k, v in ops],
            "idle_gaps": [[k, v * 1e-9] for k, v in gaps[:top]]}
