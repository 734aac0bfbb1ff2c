"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source compiles with nvcc into its own shared library with
a plain C interface under `build/repro_torch_kernels/` at the checkout's root
(or `$REPRO_TORCH_BUILD_DIR`; an installed package, outside any checkout,
uses the per-user cache `$XDG_CACHE_HOME/repro_torch_kernels`), at first
use, and is loaded with ctypes. The
library's file name carries a hash of its source, so an edited source builds
anew. All sources build in parallel, one nvcc process each.

Nothing here runs at import time: the CPU tests import every module on a
host without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}     # source name -> nvcc's output (ptxas -v)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = Path(__file__).resolve().parents[3]
    if (root / "src" / "repro_torch").is_dir():          # a checkout
        return root / "build" / "repro_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch_kernels"


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cands.append(os.path.join(cuda_home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built on the machine with the card")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return build_dir() / f"lib{src.stem}_{digest}.so"


def build_all(extra=()) -> float:
    """Compile every source whose library is missing, all at once, and the
    `extra` sources (other builds of a kernel, e.g. a parent commit's for
    a same-call comparison: load those with `load_path`). Returns the wall
    seconds spent; raises with nvcc's output if one fails."""
    t0 = time.perf_counter()
    jobs = []
    for src in [*sorted(CSRC.glob("*.cu")), *map(Path, extra)]:
        out = _lib_path(src)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOG[src.stem if src.parent == CSRC else str(src)] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {src.name} exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(CSRC / f"{name}.cu")
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def load_path(src) -> ctypes.CDLL:
    """The library of a source outside csrc/ that `build_all(extra=...)`
    built; the wrappers never load it."""
    return ctypes.CDLL(str(_lib_path(Path(src))))


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return value is
    cudaGetLastError() right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
