"""The port's default device: the CUDA card, and no silent host path.

`resolve_device` is shared by the models, the store helpers of
`ops.dense`, the snapshot loaders and the bench helpers, so every entry
point places its lanes as the JAX package places its arrays on the
default accelerator. It lives apart from the models so that `ops.dense`
can import it without an import cycle.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA card, and raises without one: the port
    never carries on silently on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "DenseCrdt runs on the CUDA card by default and this host "
                "has none; pass device='cpu' to run the plain torch path")
        device = "cuda"
    return torch.device(device)
