"""The chain_draws kernel timed on one CUDA card, and the floors of its
Philox calls of normals counted in the SASS of the kernel that runs.

    python -m nngp_tpu_torch.experiments.draws_bench [--chains 3 96]
        [--sites 64274] [--covariates 14] [--key 1 25 7] [--rounds 5]
        [--sass] [--json PATH]

The layout is one main-path iteration (K = 1, 10 sweeps, 10 noise steps)
of a fit with one shape parameter and ``--covariates`` covariates at the
sites; the defaults are the Heavy-metals fit's (64,274 sites, 14
covariates), at the key (seed, cycle start, iteration) of chip_smoke.py's
``draws`` phase, chains [0, C).  For each chain count it prints one JSON
line: the kernel's device time back to back (``timing.per_call_ms``: 50
calls behind a spin kernel; each of ``--rounds`` runs and their median),
the median around the wrapper (CUDA events, 21 calls), the median of
``torch.randn`` + ``torch.rand`` of the same shapes, the bytes written and
their time at the card's memory rate, and a SHA-256 of the fields' bytes,
so that two checkouts run under this script in one call can be compared
bit for bit:

    cd other_checkout && PYTHONPATH=$PWD python /path/to/draws_bench.py

It calls only ``ops/draws.py:chain_draws_cuda``, ``models/gaussian.py``'s
``UpdateConfig`` and ``IterationDraws.layout`` and ``timing``, which every
checkout with the kernel has.  ``--sass`` adds, for the kernel the launch
runs (``chain_draws_kernel<1>`` or ``<4>``, ``tile_calls``), the count of
its instructions a Philox call of normals (``sass_counts``) and the floors
they give at the card's highest SM clock (``floors``).  Raises without a
CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import glob
import hashlib
import json
import math
import os
import re
import shutil
import subprocess

import torch

from nngp_tpu_torch.experiments import timing
from nngp_tpu_torch.experiments.sweep_bench import HBM_BYTES_PER_S

SMS = 132                   # H100 SXM streaming multiprocessors
FP64_LANES = 64             # FP64 results a clock an SM (Hopper)
SCHEDULER_LANES = 128       # 4 warp instructions a clock an SM, 32 lanes each
# SASS opcodes on the FP64 pipe: the float64 arithmetic, and conversions
# from or to a 64-bit float
F64_OPS = {"DFMA", "DADD", "DMUL", "DSETP", "DSET", "DMNMX"}
F64_CONV = re.compile(r"^(F2F|I2F|F2I|FRND)\.(.*\.)?F64")


def main_path_layout(sites, covariates):
    """{field: per-chain shape} of one main-path iteration (K = 1) of a fit
    with one shape parameter at ``sites`` sites and ``covariates``
    covariates there."""
    from nngp_tpu_torch.models import gaussian as G

    cfg = G.UpdateConfig(n_iterations=1, shape_names=("log_range",),
                         locs_cols=tuple(range(covariates)))
    return G.IterationDraws.layout(cfg, sites, covariates)


def shapes(layout):
    """(normals, uniforms, Philox calls of normals, Philox calls) a chain
    of ``layout``."""
    from nngp_tpu_torch.ops import draws

    count = {k: math.prod(v) for k, v in layout.items()}
    normal = [k for k in layout if draws.FIELDS[k][1] == draws.NORMAL]
    n_norm = sum(count[k] for k in normal)
    return (n_norm, sum(count.values()) - n_norm,
            sum(-(-count[k] // 4) for k in normal),
            sum(-(-n // 4) for n in count.values()))


def tile_calls(C, layout):
    """Philox calls a thread in the launch for C chains of ``layout`` (the
    launcher's own choice)."""
    from nngp_tpu_torch.ops import draws

    return draws._library().chain_draws_tile_calls(C * shapes(layout)[3])


def time_draws(C, layout, key, rounds=5, device=None):
    """One JSON-ready dict of times for ``chain_draws_cuda`` at C chains of
    ``layout`` under ``key`` (seed, cycle start, iteration)."""
    from nngp_tpu_torch.ops import draws

    dev = device or timing.cuda_device()
    ids = torch.arange(C, device=dev)
    seed, start, it = key
    call = functools.partial(draws.chain_draws_cuda, seed, start, ids, it,
                             layout)
    got = call()
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for k in layout:
        digest.update(got[k].cpu().numpy().tobytes())
    del got
    n_norm, n_unif = shapes(layout)[:2]
    runs = [timing.per_call_ms(call, 50)[0] for _ in range(rounds)]
    nbytes = 4 * C * (n_norm + n_unif) + 8 * C
    return {
        "chains": C, "device_ms": sorted(runs)[len(runs) // 2],
        "device_ms_runs": runs, "ms": timing.median_ms(call, 21),
        "library_ms": timing.median_ms(
            lambda: (torch.randn(C, n_norm, device=dev),
                     torch.rand(C, n_unif, device=dev)), 21),
        "bytes": nbytes, "bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
        "sha256": digest.hexdigest()[:16]}


def max_sm_clock_mhz():
    """The card's highest SM clock (MHz), as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


def cuobjdump_path():
    """cuobjdump from the CUDA toolkit, or the copy Triton ships; None
    where there is neither."""
    cands = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin",
                                     "cuobjdump"))
    try:
        import triton
        cands += glob.glob(os.path.join(os.path.dirname(triton.__file__),
                                        "backends", "nvidia", "bin",
                                        "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if c and os.access(c, os.X_OK)), None)


def library_sass(lib_path):
    """``cuobjdump -sass`` of the library at ``lib_path``."""
    tool = cuobjdump_path()
    if tool is None:
        raise RuntimeError("no cuobjdump to read the kernel's SASS")
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def _function(sass, pattern):
    """[(address, predicated, op, operands)] of the one function of the
    ``cuobjdump -sass`` listing whose name matches ``pattern``."""
    parts = re.split(r"\n\s*Function : (\S+)", sass)
    found = [body for name, body in zip(parts[1::2], parts[2::2])
             if re.search(pattern, name)]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} functions match {pattern!r}")
    ins = []
    for line in found[0].splitlines():
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m:
            ins.append((int(m[1], 16), bool(m[2]), m[3], m[4]))
    return ins


def _target(operands):
    return int(re.findall(r"0x([0-9a-f]+)", operands)[-1], 16)


def sass_counts(sass, calls):
    """The instructions a Philox call of normals of ``chain_draws_kernel<
    calls>`` in the listing ``sass`` (``library_sass``), counted on the
    path that the data takes in the kernel's straight normal tile (its
    ``calls`` calls unrolled, no loop):

    - the tile is the most code reachable from one branch target, the
      CALLs to out-of-line slow paths not followed, with no backward
      branch (no loop), 2 x ``calls`` MUFU.RSQ64H (one a square root) and
      ``calls`` STG.E.128 (one a call: no other kind's code);
    - left out: each block that a conditional branch jumps over to reach
      past a CALL (the slow paths of sqrt and of sin and cos's reduction,
      and the zero or infinite angle, for arguments the kernel never
      gives them), and each that a conditional branch jumps over to reach
      an STG.E.128 (the scalar stores of a row off a 16-byte boundary;
      every row of the sweep normals is on one).

    {"f64": float64 arithmetic, "f64_conv": conversions from or to a
    64-bit float, "mufu64": float64 SFU seeds, "total": all but NOPs, a
    call each; "skipped": instructions of the tile left out, "tile": its
    first address}.  Raises where there is no such tile, or the path
    through it holds other than 2 x ``calls`` MUFU.RSQ64H."""
    ins = _function(sass, rf"chain_draws_kernelILi{int(calls)}E")
    at = {a: i for i, (a, *_) in enumerate(ins)}

    def reach(start):
        seen, todo = set(), [at[start]]
        while todo:
            i = todo.pop()
            if i in seen or i >= len(ins):
                continue
            seen.add(i)
            _, cond, op, text = ins[i]
            if op.startswith("BRA"):
                todo.append(at[_target(text)])
                cond = cond or bool(re.match(r"\s*!?U?P[T0-9]+\s*,", text))
                if not cond:
                    continue
            elif op in ("EXIT", "RET.REL.NODEC", "RET") and not cond:
                continue
            todo.append(i + 1)
        return sorted(seen)

    def ops(idx, op):
        return sum(ins[i][2] == op for i in idx)

    tiles = []
    for start in {_target(t) for _, _, op, t in ins if op.startswith("BRA")}:
        idx = reach(start)
        if (ops(idx, "MUFU.RSQ64H") == 2 * calls
                and ops(idx, "STG.E.128") == calls
                and not any(ins[i][2].startswith("BRA")
                            and _target(ins[i][3]) <= ins[i][0]
                            for i in idx)):
            tiles.append((len(idx), start, idx))
    if not tiles:
        raise RuntimeError(f"chain_draws_kernel<{calls}>: no straight tile "
                           f"of {calls} calls of normals in the SASS")
    _, start, idx = max(tiles)
    skip = set()
    for k, i in enumerate(idx):
        a, _, op, text = ins[i]
        if op.startswith("BRA") and ins[at[_target(text)]][2] == "STG.E.128" \
                and _target(text) > a:
            skip.update(j for j in idx if a < ins[j][0] < _target(text))
        if not op.startswith("CALL"):
            continue
        for j in reversed(idx[:k]):
            b, cond, bop, btext = ins[j]
            if bop.startswith("BRA") and cond and _target(btext) > a:
                skip.update(m for m in idx if b < ins[m][0] < _target(btext))
                break
    kept = [ins[i][2] for i in idx
            if i not in skip and not ins[i][2].startswith("NOP")]
    if kept.count("MUFU.RSQ64H") != 2 * calls:
        raise RuntimeError(f"chain_draws_kernel<{calls}>: the path through "
                           f"the tile at {start:#x} holds "
                           f"{kept.count('MUFU.RSQ64H')} MUFU.RSQ64H, not "
                           f"{2 * calls}")
    return {"f64": sum(op.split(".")[0] in F64_OPS for op in kept) / calls,
            "f64_conv": sum(bool(F64_CONV.match(op)) for op in kept) / calls,
            "mufu64": sum(op.startswith("MUFU.") and op.endswith("64H")
                          for op in kept) / calls,
            "total": len(kept) / calls, "skipped": len(skip),
            "tile": start}


def floors(normal_calls, counts, sm_mhz):
    """(FP64 floor ms, issue floor ms) of ``normal_calls`` Philox calls of
    normals: their FP64-pipe instructions (arithmetic and conversions) at
    SMS x FP64_LANES a clock, and all their instructions at SMS x
    SCHEDULER_LANES a clock, at ``sm_mhz``."""
    hz = sm_mhz * 1e6
    f64 = counts["f64"] + counts["f64_conv"]
    return (1e3 * normal_calls * f64 / (SMS * FP64_LANES * hz),
            1e3 * normal_calls * counts["total"]
            / (SMS * SCHEDULER_LANES * hz))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chains", type=int, nargs="*", default=[3, 96])
    ap.add_argument("--sites", type=int, default=64_274)
    ap.add_argument("--covariates", type=int, default=14)
    ap.add_argument("--key", type=int, nargs=3, default=[1, 25, 7],
                    metavar=("SEED", "START", "IT"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--sass", action="store_true",
                    help="count the kernel's SASS and give the floors")
    ap.add_argument("--json", default=None, help="append the lines here")
    a = ap.parse_args(argv)
    dev = timing.cuda_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    import nngp_tpu_torch
    from nngp_tpu_torch.ops import draws

    layout = main_path_layout(a.sites, a.covariates)
    sass = library_sass(draws._library()._name) if a.sass else None
    lines = []
    for C in a.chains:
        line = {"package": os.path.dirname(nngp_tpu_torch.__file__),
                "card": smi,
                **time_draws(C, layout, tuple(a.key), a.rounds, dev)}
        if sass:
            calls = tile_calls(C, layout)
            counts = sass_counts(sass, calls)
            mhz = max_sm_clock_mhz()
            line.update(sass=counts, tile_calls=calls, max_sm_clock_mhz=mhz,
                        normal_calls=C * shapes(layout)[2])
            line["f64_floor_ms"], line["issue_floor_ms"] = floors(
                line["normal_calls"], counts, mhz)
        lines.append(line)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    if a.json:
        with open(a.json, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return lines


if __name__ == "__main__":
    main()
