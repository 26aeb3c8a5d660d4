"""Fixed-order row gathers and scatter-adds for the remainder terms (rows
no molecule template covers).

``src[idx]`` backpropagates through a scatter-add, and ``index_add`` sums
with float atomics on the card, so a run would not give the same bits
twice.  A :class:`RowPlan`, made once on the host when the system or the
bonded terms are built, fixes the order in which each row's terms are
summed: :func:`gather_planned` and :func:`scatter_add_planned` sum in that
order, forward or backward, and so are deterministic on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RowPlan(NamedTuple):
    """Fixed summation order of an index vector ``idx`` [M] into rows:
    ``occ`` [n, m_max] lists, per row, the positions j with idx[j] == row
    in increasing j, padded with M (a zero row appended to the values)."""

    idx: torch.Tensor
    occ: torch.Tensor


def row_plan(idx, device) -> RowPlan:
    """The :class:`RowPlan` of the nonempty int array ``idx`` (any shape,
    flattened) into rows 0..max(idx), built once on the host (NumPy)."""
    idx = np.asarray(idx, np.int64).reshape(-1)
    m, n = idx.size, int(idx.max()) + 1
    order = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=n)
    rank = np.arange(m) - (np.cumsum(counts) - counts)[idx[order]]
    occ = np.full((n, int(counts.max())), m, np.int64)
    occ[idx[order], rank] = order
    return RowPlan(torch.as_tensor(idx, device=device),
                   torch.as_tensor(occ, device=device))


def _sum_rows(vals, occ, n: int):
    """out[i] = sum of vals[occ[i, :]] in column order (pad entries hit a
    zero row), [n, ...]; rows past occ's are zero."""
    vp = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])
    out = torch.sum(vp[occ], dim=1)
    if out.shape[0] < n:
        out = torch.cat([out, out.new_zeros((n - out.shape[0],)
                                            + out.shape[1:])])
    return out


class _PlannedGather(torch.autograd.Function):
    """``src[idx]`` whose backward sums each source row's cotangents in the
    plan's fixed order (no scatter-add, so no float atomics on the card)."""

    @staticmethod
    def forward(ctx, src, idx, occ):
        ctx.save_for_backward(occ)
        ctx.nrow = src.shape[0]
        return src[idx]

    @staticmethod
    def backward(ctx, ct):
        (occ,) = ctx.saved_tensors
        return _sum_rows(ct, occ, ctx.nrow), None, None


class _PlannedScatterAdd(torch.autograd.Function):
    """``base`` plus ``vals`` summed into rows ``idx`` in the plan's fixed
    order; the backward is a plain gather."""

    @staticmethod
    def forward(ctx, base, vals, idx, occ):
        ctx.save_for_backward(idx)
        return base + _sum_rows(vals, occ, base.shape[0])

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return ct, ct[idx], None, None


def gather_planned(src, plan: RowPlan):
    """``src[plan.idx]``, deterministic in its backward."""
    return _PlannedGather.apply(src, plan.idx, plan.occ)


def scatter_add_planned(base, vals, plan: RowPlan):
    """``base.index_add(0, plan.idx, vals)`` with a fixed summation order."""
    return _PlannedScatterAdd.apply(base, vals, plan.idx, plan.occ)
