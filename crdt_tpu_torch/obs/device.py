"""Kernel launch counters — the port's reduced dispatch ledger.

``crdt_tpu/obs/device.py`` records every device dispatch with its
shape and donation; the port keeps only what a run needs to prove that
its main path went through the hand-written kernels: one plain integer
per kernel, bumped by the kernel's wrapper where it launches (never by
the plain torch version the wrapper takes for CPU tensors).
``chip_smoke.py`` zeroes the counts before it drives the main path and
reads them after.
"""

from __future__ import annotations

from typing import Dict

KERNELS = ("fanin_batch", "ingest_scatter")

_LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def note_launch(name: str) -> None:
    """Count one launch of kernel ``name`` (a `KERNELS` entry)."""
    _LAUNCHES[name] += 1


def launches() -> Dict[str, int]:
    """Launch count per kernel since the last `reset`."""
    return dict(_LAUNCHES)


def reset() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
