"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Without CUDA, ``None`` raises: the port runs on the card unless the
    caller asks for the CPU with ``device="cpu"``, and it never falls back
    to the CPU by itself.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device=\"cpu\" to build on the CPU")
    return torch.device("cuda")
