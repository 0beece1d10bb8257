"""Build-on-first-use of the port's native libraries.

Every library is compiled from sources in this checkout into
``nngp_tpu_torch/_build/`` (git-ignored), under a file name that carries a
hash of its source and flags, so an edited source is rebuilt and a stale
binary is never loaded.  The CUDA kernels are plain-C-interface shared
libraries built by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``;
nothing here includes PyTorch's headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str | None:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location; None when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def _compile(compiler: str, flags, src: str, name: str) -> str:
    """Compile ``src`` into BUILD_DIR/lib<name>-<hash>.so unless it exists;
    returns the library path.  The compiler's output (ptxas register and
    spill report for CUDA) is kept beside it as ``.log``."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run([compiler, *flags, "-o", tmp, src],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(
            f"building {name} from {src} failed (exit {r.returncode}):\n"
            f"{r.stdout}{r.stderr}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, out)   # atomic: concurrent builders never load a torn file
    return out


def build_log(name: str) -> str:
    """Compiler output of the newest build of ``name`` ('' if none)."""
    if not os.path.isdir(BUILD_DIR):
        return ""
    logs = sorted(
        (os.path.join(BUILD_DIR, f) for f in os.listdir(BUILD_DIR)
         if f.startswith(f"lib{name}-") and f.endswith(".log")),
        key=os.path.getmtime)
    if not logs:
        return ""
    with open(logs[-1]) as f:
        return f.read()


@functools.cache
def cuda_library(name: str, part: str = "",
                 defines: tuple = ()) -> ctypes.CDLL:
    """Build (first use) and load ``csrc/<name>.cu``, compiled with the
    preprocessor ``defines`` as the library ``<name><part>`` (one source
    built in parts, one nvcc each).  Raises RuntimeError when there is no
    nvcc or the build fails; there is no fallback."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            f"the CUDA kernel {name} needs nvcc to build "
            f"csrc/{name}.cu (none found on PATH, in $CUDA_HOME or in "
            "/usr/local/cuda)")
    return ctypes.CDLL(_compile(nvcc, NVCC_FLAGS + tuple(defines),
                                os.path.join(CSRC_DIR, f"{name}.cu"),
                                name + part))


def host_library(src: str, name: str, flags) -> str:
    """Build a host C++ library from ``src`` (g++); returns its path."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    return _compile(cxx, flags, src, name)
