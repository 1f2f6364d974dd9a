"""The bytes a fan-in merge must move, and the card's peaks.

The count is frozen from the kernel table's accounting for the batch
merge (``PERF.md`` section 6, "bytes in 32-B sectors"): a merge of an
``[R, N]`` changeset into an ``N``-slot store must read every entry's
``valid`` byte, the ``lt`` and ``node`` sectors that hold a valid
entry, and the ``val`` and ``tomb`` sectors of the entry that wins its
slot; it reads the store's ``lt``, ``node`` and ``occupied`` lanes, its
``val`` and ``tomb`` sectors where the store keeps the slot, writes six
output lanes (``lt``, ``node``, ``val``, ``occupied``, ``tomb`` and the
win mask) once, and writes the ``modified`` lanes (``mod_lt``,
``mod_node``) of the slots it wins. It follows from the inputs' shapes,
valid masks and winners alone, whichever code computes the merge.
"""

from __future__ import annotations

import torch

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes/s (700 W part).
PEAK_HBM_BYTES_PER_S = 3.35e12
SECTOR = 32


def sector_bytes(mask: torch.Tensor, elem_bytes: int) -> int:
    """Bytes of the 32-B sectors of a lane of ``elem_bytes``-wide
    entries that hold at least one entry where ``mask`` is set. The last
    axis must fill whole sectors."""
    per = SECTOR // elem_bytes
    if mask.shape[-1] % per:
        raise ValueError(f"a row of {mask.shape[-1]} entries does not fill "
                         f"whole {SECTOR}-B sectors of {elem_bytes}-B entries")
    return SECTOR * int(mask.reshape(-1, per).any(-1).sum().item())


def merge_bytes(valid: torch.Tensor, final: torch.Tensor,
                win: torch.Tensor) -> int:
    """The least bytes of one merge: ``valid`` and ``final`` (the entry
    whose payload lands in its slot) are ``[R, N]``, ``win`` the ``[N]``
    slots the merge takes."""
    r, n = valid.shape
    changeset = (r * n + sector_bytes(valid, 8) + sector_bytes(valid, 4)
                 + sector_bytes(final, 8) + sector_bytes(final, 1))
    store = (n * (8 + 4 + 1) + sector_bytes(~win, 8) + sector_bytes(~win, 1)
             + n * (8 + 4 + 8 + 1 + 1 + 1)
             + sector_bytes(win, 8) + sector_bytes(win, 4))
    return changeset + store
