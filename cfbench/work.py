"""The yardstick of the roofline metrics: the chip's published peaks and
the work each stage needs, counted from the physical problem (atoms,
in-cutoff pairs, spline order, mesh), never from the
program's layout (columns, padded rows, cell capacity, sentinel slots),
so that a count reads the same whatever implements the stage.

A count is a lower bound of what any implementation must do: each input
read once, each output written once, and only the arithmetic the
equations need.  So a share computed from it cannot pass 100 % unless the
measured time leaves out part of the work.
"""

from __future__ import annotations

import torch

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit: float32 on the
#: CUDA cores (no tensor cores) and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def least_seconds(flops: float, nbytes: float) -> float:
    """The larger of flops / peak and bytes / bandwidth."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def spread(n_atoms: int, order: int, mesh) -> float:
    """Least seconds of one SPME spread and its backward at n atoms, spline
    order p, mesh K^3.  Forward: per atom q w_x (p), times w_y (p^2),
    times w_z and added onto the mesh (2 p^3); the positions and charge
    in, the mesh out.  Backward: per atom the p^3 mesh values against the
    three derivative products and the charge's (8 p^3); the mesh and the
    atoms in, the forces and dE/dq out."""
    p = order
    cells = mesh[0] * mesh[1] * mesh[2]
    fwd = least_seconds(n_atoms * (p + p * p + 2 * p ** 3),
                        F32 * (4 * n_atoms + cells))
    bwd = least_seconds(n_atoms * 8 * p ** 3,
                        F32 * (cells + 4 * n_atoms + 4 * n_atoms))
    return fwd + bwd


#: flops of one in-cutoff pair in the fused walk: the displacement and its
#: minimum image (9), r^2 (5), 1/r and r (2), erfc(alpha r) / r and its
#: derivative (8), the Lennard-Jones energy and derivative (10), the pair
#: force on both atoms (9) and dE/dq of both (4)
PAIR_FLOPS = 47


def walk(n_pairs: int, n_atoms: int) -> float:
    """Least seconds of one direct-space walk: every in-cutoff pair of
    different molecules once; per atom its position, charge and two
    Lennard-Jones parameters in, its force and dE/dq out."""
    return least_seconds(n_pairs * PAIR_FLOPS, F32 * n_atoms * (6 + 4))


@torch.no_grad()
def pairs_within_cutoff(x: torch.Tensor, box, cutoff: float,
                        chunk: int = 1024) -> int:
    """Unordered pairs of atoms of different molecules (O, H, H triples)
    closer than ``cutoff`` under the minimum image of an orthorhombic
    ``box``."""
    box = torch.as_tensor(box, dtype=x.dtype, device=x.device)
    n = x.shape[0]
    cols = torch.arange(n, device=x.device)
    count = 0
    for i0 in range(0, n, chunk):
        rows = cols[i0:i0 + chunk]
        d = x[None, :, :] - x[rows][:, None, :]
        d = d - box * torch.round(d / box)
        close = torch.sum(d * d, dim=-1) < cutoff * cutoff
        close &= rows[:, None] < cols[None, :]
        close &= (rows[:, None] // 3) != (cols[None, :] // 3)
        count += int(close.sum())
    return count
