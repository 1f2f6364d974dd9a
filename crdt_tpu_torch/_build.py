"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` holds one kernel behind a plain ``extern "C"``
launcher, so it compiles with ``nvcc`` alone (no PyTorch headers: a
few seconds per file) into ``build/<name>-<hash>.so``, which is loaded
with ``ctypes``. The hash covers the source and the flags, so an edited
source never loads a stale library. Libraries are built at first use;
`build` compiles every missing one at once, one ``nvcc`` per source,
all started together. Nothing here runs at import time: the CPU tests
import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fanin_batch", "ingest_scatter")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "crdt_tpu_torch/csrc at first use and need the "
                       "CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, all in
    parallel. Returns ``{name: compiler output}`` for the ones it built
    (``-Xptxas=-v`` prints registers and spills per kernel); raises
    with the compiler's output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = {}, []
    for name, tmp, out, proc in procs:
        logs[name] = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)    # atomic: readers never see half a file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The launcher ``symbol`` of kernel library ``name``, built if
    needed, with its ``argtypes`` set and an int return (the launch's
    ``cudaGetLastError()``)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
