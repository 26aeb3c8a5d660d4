"""Where the port's entry points put their tensors, and the constant
tensors an evaluation reads."""

from __future__ import annotations

from functools import lru_cache

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


def device_key(device) -> torch.device:
    """``device`` as the key of a constant cache: a CUDA device without an
    index names the current card, so that both spellings share one entry."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@lru_cache(maxsize=None)
def _constant(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype, device) -> torch.Tensor:
    """``values`` (a sequence of numbers, or of equal-length tuples of
    them) as a tensor on ``device``, copied there once per (values, dtype,
    device) and kept.

    This is how the package holds every constant an energy evaluation or a
    neighbor rebuild reads (grids, slack, patch origins, kernel tables):
    an evaluation then makes no host-to-device copy, so a trajectory chunk
    can be captured into a CUDA graph, and the graph finds each constant
    where it was at capture (the caches are unbounded for that reason;
    they hold a few small tensors per system).  The tensors are shared: do
    not write to them.  The first call for a key copies, so make it before
    a capture (a chunk's warm-up does)."""
    return _constant(tuple(values), dtype, device_key(device))
