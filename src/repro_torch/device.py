"""The port's device rule: the CUDA card by default, the CPU only when the
caller asks for it, and an error (not a quiet fall-back) when the card is
wanted and missing.  The oracles and the selector share it."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The CUDA card by default; ``"cpu"`` only when asked for.  Raises
    when CUDA is wanted and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
