"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/``
at the repository root (git-ignored). The library's file name carries a
hash of the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it is. Only the repository's own sources are
built. ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills)
is kept beside each library as ``<library>.log``. A source may also be
built with preprocessor macros defined (``defines``), into a library of its
own: ``fused_mlp.cu`` with ``WO_PROBE`` adds the streaming core's probe
instances, which only ``chip_smoke.py --phases wo_probe`` loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + tuple(f"-D{d}" for d in defines))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + flags.encode()).hexdigest()[:16]
    tag = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"{name}{tag}-{digest}.so"


def build(names: Iterable[str], defines: Tuple[str, ...] = ()
          ) -> Dict[str, float]:
    """Compile every named source that has no library yet (with the
    macros ``defines``), one ``nvcc`` per source, all started together.
    Returns seconds per source built; raises with nvcc's output if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: List = []
    for name in names:
        out = library_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc, time.perf_counter()))
    seconds: Dict[str, float] = {}
    failed = []
    for name, out, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(name: str, defines: Tuple[str, ...] = ()) -> str:
    log = library_path(name, defines).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with the macros
    ``defines``), built first if needed."""
    lib = _loaded.get((name, defines))
    if lib is None:
        build([name], defines)
        lib = ctypes.CDLL(str(library_path(name, defines)))
        _loaded[(name, defines)] = lib
    return lib


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
