"""Where the port's entry points put their tensors, the constant tensors
an evaluation reads, and the f32 products held to IEEE f32."""

from __future__ import annotations

import contextlib
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


def _flag_owners():
    """The objects whose ``fp32_precision`` a matmul precision setter
    writes (the CUDA and the oneDNN matmul switches), where this PyTorch
    has them."""
    owners = [torch.backends.cuda.matmul]
    mkldnn = getattr(torch.backends, "mkldnn", None)
    if mkldnn is not None and hasattr(mkldnn, "matmul"):
        owners.append(mkldnn.matmul)
    return [o for o in owners if getattr(o, "fp32_precision", None)
            is not None]


@contextlib.contextmanager
def ieee_f32():
    """cuBLAS f32 products in IEEE f32, whatever the caller's TF32 switches
    say (``torch.backends.cuda.matmul.allow_tf32``,
    ``torch.set_float32_matmul_precision``, ``fp32_precision``); the
    caller's switches are restored on exit.  cuBLAS reads them when a
    product is enqueued, so a CUDA graph captured inside keeps IEEE f32
    at every replay."""
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:      # the caller mixed the old and the new API
        legacy = None
    saved = [(o, o.fp32_precision) for o in _flag_owners()]
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        for owner, value in saved:
            owner.fp32_precision = value


class _IeeeMatmul(torch.autograd.Function):
    """``torch.matmul`` whose forward and backward products both run under
    :func:`ieee_f32` (a backward runs inside ``torch.autograd.grad``,
    outside any context opened around the forward)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with ieee_f32():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with ieee_f32():
            if ctx.needs_input_grad[0]:
                ga = torch.matmul(g, b.transpose(-1, -2))
            if ctx.needs_input_grad[1]:
                gb = torch.matmul(a.transpose(-1, -2), g)
        return ga, gb


def ieee_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` ([M, K] @ [K, N], or batched alike) in IEEE f32 on the
    card, forward and backward: the product of every accuracy path (the
    JAX package pins these products' precision)."""
    return _IeeeMatmul.apply(a, b)
