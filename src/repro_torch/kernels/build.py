"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library ``build/kernels/lib<name>.so`` under the repository root, at
first use, and is loaded with ``ctypes``: a plain C interface builds in
seconds, where a source that includes PyTorch's headers takes minutes.
``csrc/sm90.cuh`` holds the Hopper helpers (mbarriers, TMA, wgmma) the
sources share; libcuda's ``cuTensorMapEncodeTiled`` is looked up at
run time with ``dlsym``, so nothing links beyond the CUDA runtime.
Nothing here touches CUDA when the module is imported, so the package
imports on a machine without a card or a toolkit.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> Dict[str, Path]:
    """Kernel name -> CUDA source, for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the port's CUDA kernels build only where the CUDA toolkit is")
    return path


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any shared
    header (``csrc/*.cuh``)."""
    lib = library_path(name)
    newest = max(p.stat().st_mtime
                 for p in [sources()[name], *CSRC.glob("*.cuh")])
    return not lib.exists() or lib.stat().st_mtime < newest


def build(names: Iterable[str] = ()) -> Dict[str, str]:
    """Compile the named kernels (all when empty) that are missing or
    older than their source, one ``nvcc`` per source, all started
    together. Returns name -> ptxas report. Raises on any failure."""
    srcs = sources()
    todo = [n for n in (list(names) or list(srcs)) if _stale(n)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))  # atomic for concurrent loads
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))

