"""The C HLC string codec of the JSON wire (host side).

Port of ``crdt_tpu/native/__init__.py`` with its C source,
`hlccodec.c`, copied verbatim. The JSON boundary (crdt_json.dart:8-37)
is scalar string work where CPython is the bottleneck, so its hot
primitives (the per-record HLC string codec, the one-pass wire scan and
assembly, the batch node-ordinal lookup) have a C implementation,
compiled on first use with the system C compiler.

One difference from the JAX loader: the library is built into
``crdt_tpu_torch/build/`` (git-ignored, beside the CUDA kernels),
never next to its source. Its name carries a hash of the source, so an
edited source never loads a stale library.

Everything degrades silently: no compiler, a failed build, or
``CRDT_TPU_NO_NATIVE=1`` all fall back to the pure-Python codec, whose
semantics are identical (the C path accepts only the canonical wire
shape and defers everything else to Python item by item). This is host
string work, not the device path.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "hlccodec.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

_mod = None
_tried = False


def library_path() -> Path:
    """Where the extension for the current source lives once built."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"_hlccodec_{tag}{suffix}"


def load() -> Optional[object]:
    """The `_hlccodec` extension module, or None when unavailable."""
    global _mod, _tried
    if _tried:
        return _mod
    _tried = True
    if os.environ.get("CRDT_TPU_NO_NATIVE"):
        return None
    try:
        so = library_path()
        if not so.exists():
            cc = (os.environ.get("CC") or sysconfig.get_config_var("CC")
                  or "cc").split()[0]
            include = sysconfig.get_paths()["include"]
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build to a private temp path and rename into place: the
            # rename is atomic, so a concurrent process never loads a
            # half-written library.
            tmp = so.with_name(f"{so.name}.build{os.getpid()}")
            subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", f"-I{include}",
                 str(SOURCE), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        spec = importlib.util.spec_from_file_location(
            "crdt_tpu_torch.native._hlccodec", str(so))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _mod = mod
    except Exception:
        _mod = None
    return _mod
