"""Where the port's tensors live: the card unless the caller asks for the CPU.

Every constructor of scene state takes ``device=None``, and ``None`` means
the CUDA card.  Without a card that raises: the port never moves to the
CPU on its own.  Tests and CPU runs pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is the CUDA card, and raises
    when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device=\"cpu\" to build the scene on the CPU")
    return torch.device("cuda")
