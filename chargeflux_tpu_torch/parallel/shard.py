"""Work sharding over ``torch.distributed`` ranks (torch counterpart of
``chargeflux_tpu.parallel.shard``).

The energy is additive over work items (atom rows, cell rows, k-space
structure-factor contributions, exclusion pairs), so each rank of a group
computes a chunk against replicated positions and the total is assembled
by an all-reduce.  A group is one axis of a
``torch.distributed.device_mesh.DeviceMesh`` (``init_device_mesh``), or a
process group where one axis is enough; a rank's index in it takes the
place of ``lax.axis_index``.

Forces come from autograd through two functions that stand where the JAX
package has the shard_map transpose:

* :func:`replicated_in`: forward the identity, backward an all-reduce of
  the cotangent (each rank's partial forces summed into the total);
* :func:`sum_out`: forward an all-reduce, backward the identity (each rank
  differentiates its own share).

A term computed from an all-reduced partial (the structure factors, the
charge mesh) is replicated and added once, outside the sum-out, as in the
JAX package; its gradient flows back through the sum-out into each rank's
partial, so nothing is counted once per rank.  :func:`ppermute` is the
JAX ``ppermute``: paired sends and receives, whose backward sends the
cotangents back along the reverse permutation; a rank that is its own peer
(a group of one) copies locally.  Every collective counts itself in
:data:`COLLECTIVES`.

The cell-route fallback walks gather-based cell rows
(:func:`_cell_rows_direct_energy`, the JAX package's
``cells.cell_rows_direct_energy``): a correctness and coverage path.  The
halo decomposition (``halo.py``) is tried first and is the scale-out path.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..cells import build_cell_list, half_shell_tables, wrap_offsets
from ..charges import effective_charges
from ..energy import _lj_pair_terms, dispersion_energy
from ..ewald import reciprocal_energy_from_sf, self_energy, structure_factors
from ..ops.erfc import erf_over_r_eval, erfc_fast
from ..pairs import displacement, lattice_cart
from ..units import ONE_4PI_EPS0

#: Collectives issued since the last reset, by kind ("all_reduce",
#: "ppermute"; a local copy of a group of one counts as "ppermute_local").
COLLECTIVES = {"all_reduce": 0, "ppermute": 0, "ppermute_local": 0}


def reset_collectives():
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _axis(mesh, axis_name):
    """(process group, this rank's index in it, its size) of ``mesh``'s
    axis ``axis_name``: a ``DeviceMesh`` axis by name, or ``mesh`` itself
    as a process group (``None``: the default group)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        dim = names.index(axis_name)
        return (mesh.get_group(dim), mesh.get_local_rank(dim),
                mesh.size(dim))
    return mesh, dist.get_rank(mesh), dist.get_world_size(mesh)


def _all_reduce(t, group):
    out = t.clone()
    dist.all_reduce(out, group=group)
    COLLECTIVES["all_reduce"] += 1
    return out


class _SumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct.contiguous(), ctx.group), None


def sum_out(t, group):
    """The sum over the group's ranks of each rank's ``t``, on every rank;
    its backward hands each rank's cotangent to its own ``t``."""
    return _SumOut.apply(t, group)


def replicated_in(t, group):
    """``t``, held alike by every rank; its backward sums the ranks'
    cotangents."""
    return _ReplicatedIn.apply(t, group)


def all_reduce_sum(t, group):
    """The group's sum of ``t`` with no gradient (counts, observables)."""
    return _all_reduce(t.detach(), group)


def _exchange(t, group, rank: int, perm, tag: int):
    """Send ``t`` to this rank's destination in ``perm`` [(src, dst)] and
    return what its source sends (group ranks)."""
    dst = dict(perm).get(rank)
    src = {d: s for s, d in perm}.get(rank)
    if dst == rank and src == rank:
        COLLECTIVES["ppermute_local"] += 1
        return t.clone()
    out = torch.empty_like(t)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, t.contiguous(),
                              dist.get_global_rank(group, dst)
                              if group is not None else dst, group, tag))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src)
                              if group is not None else src, group, tag))
    else:
        out.zero_()
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COLLECTIVES["ppermute"] += 1
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, rank, perm, tag):
        ctx.args = (group, rank, [(d, s) for s, d in perm], tag)
        return _exchange(t, group, rank, perm, tag)

    @staticmethod
    def backward(ctx, ct):
        group, rank, rev, tag = ctx.args
        return _exchange(ct, group, rank, rev, tag), None, None, None, None


def ppermute(t, group, rank: int, perm, tag: int = 0):
    """The JAX ``ppermute`` over ``group``: ``perm`` lists (source,
    destination) group ranks; each rank returns what its source sent
    (zeros where none does).  Differentiable: the backward runs the
    reverse permutation.  ``tag`` keeps concurrent exchanges apart."""
    return _PPermute.apply(t, group, rank, tuple(perm), tag)


def _rows_pair_energy(x_rows, gi, positions, q_rows, q, system):
    """Energy of pairs (i in rows, j in all atoms) with global i < j,
    including excluded pairs (the subtract route).  gi: global row
    indices (>= N for padding rows)."""
    spec = system.spec
    n = positions.shape[0]
    d = displacement(x_rows[:, None, :], positions[None, :, :], system.box,
                     spec.pbc)
    r2 = torch.sum(d * d, dim=-1)
    gj = torch.arange(n, device=positions.device)
    mask = (gi[:, None] < n) & (gi[:, None] < gj[None, :])
    if spec.pbc:
        mask = mask & (r2 < spec.cutoff * spec.cutoff)
    r2s = torch.where(mask, r2, 1.0)
    inv_r = torch.rsqrt(r2s)
    r = r2s * inv_r
    qq = q_rows[:, None] * q[None, :]
    if spec.pbc:
        coul = ONE_4PI_EPS0 * qq * inv_r * erfc_fast(spec.alpha * r)
    else:
        coul = ONE_4PI_EPS0 * qq * inv_r
    gim = gi % n
    half_sig = 0.5 * (system.sigma[gim][:, None] + system.sigma[None, :])
    eps = 4.0 * torch.sqrt(system.epsilon[gim][:, None]
                           * system.epsilon[None, :])
    lj = _lj_pair_terms(half_sig, eps, inv_r)
    return torch.sum(torch.where(mask, coul + lj, 0.0))


def _excl_chunk_energy(positions, q, system, e_start: int, e_chunk: int):
    """Exclusion corrections of the exclusion rows [e_start, e_start +
    e_chunk) (padded past the list): remove the short-range term the pair
    sum added and, under PBC, add the reciprocal-space -erf/r."""
    spec = system.spec
    n_excl = system.n_exclusions
    if n_excl == 0:
        return positions.new_zeros(())
    ids = e_start + torch.arange(e_chunk, device=positions.device)
    valid = ids < n_excl
    ids = torch.where(valid, ids, 0)
    idx_i = system.exclusions[ids, 0]
    idx_j = system.exclusions[ids, 1]
    d = displacement(positions[idx_i], positions[idx_j], system.box,
                     spec.pbc)
    r2 = torch.sum(d * d, dim=-1)
    inv_r = torch.rsqrt(r2)
    r = r2 * inv_r
    qq = q[idx_i] * q[idx_j]
    half_sig = 0.5 * (system.sigma[idx_i] + system.sigma[idx_j])
    eps = 4.0 * torch.sqrt(system.epsilon[idx_i] * system.epsilon[idx_j])
    lj = _lj_pair_terms(half_sig, eps, inv_r)
    if spec.pbc:
        erfc_ar = erfc_fast(spec.alpha * r)
        in_cut = r < spec.cutoff
        e = -ONE_4PI_EPS0 * qq * inv_r * (1.0 - erfc_ar)
        e = e - torch.where(in_cut, ONE_4PI_EPS0 * qq * inv_r * erfc_ar + lj,
                            0.0)
    else:
        e = -(ONE_4PI_EPS0 * qq * inv_r + lj)
    return torch.sum(torch.where(valid, e, 0.0))


def _pair_block_energy(pos_i, q_i, hs_i, se_i, mask_i, pos_j, q_j, hs_j,
                       se_j, mask_j, alpha, cutoff, extra_mask=None):
    """Masked pair energy between an i-block and a j-block [C, cap, 3] of
    cell-centred coordinates (f32: erfc/r as 1/r - P(r^2))."""
    r2 = 0.0
    for k in range(3):
        dk = pos_i[:, :, None, k] - pos_j[:, None, :, k]
        r2 = r2 + dk * dk
    mask = mask_i[:, :, None] & mask_j[:, None, :] & (r2 < cutoff * cutoff)
    if extra_mask is not None:
        mask = mask & extra_mask
    r2s = torch.where(mask, r2, 1.0)
    inv_r = torch.rsqrt(r2s)
    qq = q_i[:, :, None] * q_j[:, None, :]
    if r2s.dtype == torch.float64:
        coul = ONE_4PI_EPS0 * qq * inv_r * erfc_fast(alpha * (r2s * inv_r))
    else:
        coul = ONE_4PI_EPS0 * qq * (inv_r
                                    - erf_over_r_eval(r2s, alpha, cutoff))
    sig2 = ((hs_i[:, :, None] + hs_j[:, None, :]) * inv_r) ** 2
    sig6 = sig2 * sig2 * sig2
    lj = (se_i[:, :, None] * se_j[:, None, :]) * sig6 * (sig6 - 1.0)
    return torch.sum(torch.where(mask, coul + lj, 0.0))


def _cell_rows_direct_energy(positions, q, system, slots, nbr_ids, offsets,
                             row_start: int, n_rows: int):
    """Direct-space energy of the cell rows [row_start, row_start +
    n_rows) over the full binning ``slots`` [C, cap] and the (padded)
    half-shell tables ``nbr_ids`` [C_pad, 14], ``offsets`` [C_pad, 14, 3]
    (NumPy): the self cell by global atom id, then the 13 half-shell
    shifts with their lattice image offsets."""
    spec = system.spec
    n = positions.shape[0]
    dtype, dev = positions.dtype, positions.device
    box = system.box
    grid = np.asarray(spec.cell_grid)
    pos_w = positions - wrap_offsets(positions.detach(), box)

    def pad(a):
        return torch.cat([a, a.new_zeros((1,) + a.shape[1:])])

    pos_p, q_p = pad(pos_w), pad(q)
    hs_p = pad(0.5 * system.sigma.to(dtype))
    se_p = pad(2.0 * torch.sqrt(system.epsilon.to(dtype)))
    c_pad = nbr_ids.shape[0]
    rows = np.arange(row_start, row_start + n_rows)
    coords = np.stack([np.minimum(rows // (grid[1] * grid[2]), grid[0] - 1),
                       (rows // grid[2]) % grid[1], rows % grid[2]], axis=-1)
    centers = lattice_cart(torch.as_tensor((coords + 0.5) / grid, dtype=dtype,
                                           device=dev), box)
    slots_p = torch.cat([slots, slots.new_full(
        (c_pad - slots.shape[0], slots.shape[1]), n)]).long()
    my_slots = slots_p[row_start:row_start + n_rows]
    pos_i = pos_p[my_slots] - centers[:, None, :]
    ii = (q_p[my_slots], hs_p[my_slots], se_p[my_slots], my_slots < n)
    alpha, cutoff = spec.alpha, spec.cutoff
    same = my_slots[:, :, None] < my_slots[:, None, :]
    total = _pair_block_energy(pos_i, *ii, pos_i, *ii, alpha, cutoff,
                               extra_mask=same)
    my_nbrs = torch.as_tensor(nbr_ids[row_start:row_start + n_rows],
                              device=dev).long()
    my_offs = torch.as_tensor(offsets[row_start:row_start + n_rows],
                              dtype=dtype, device=dev)
    for s in range(1, 14):
        j_slot = slots_p[my_nbrs[:, s]]
        shift = lattice_cart(my_offs[:, s, :], box)
        pos_j = pos_p[j_slot] + shift[:, None, :] - centers[:, None, :]
        total = total + _pair_block_energy(
            pos_i, *ii, pos_j, q_p[j_slot], hs_p[j_slot], se_p[j_slot],
            j_slot < n, alpha, cutoff)
    return total


def make_sharded_energy_fn(system, mesh, axis_name: str = "space"):
    """``energy(positions) -> scalar`` with the work shared by the ranks of
    ``mesh``'s ``axis_name``; positions and result alike on every rank.
    Cell-route systems whose cell grid factors over the ranks take the
    halo decomposition (``halo.py``); anything else the work sharding of
    this module.  Differentiable: autograd gives every rank the whole
    forces."""
    from .halo import halo_compatible, make_halo_energy_fn

    group, rank, size = _axis(mesh, axis_name)
    if halo_compatible(system, size):
        return make_halo_energy_fn(system, mesh, axis_name)
    return _local_energy_builder(system, group, rank, size)


def _local_energy_builder(system, group, dev: int, ndev: int):
    """This rank's energy program: replicated positions in, the
    group-summed energy out, work chunked by the rank ``dev`` of ``ndev``."""
    n = system.n_atoms
    spec = system.spec
    n_pad = _ceil_to(n, ndev)
    row_chunk = n_pad // ndev
    e_chunk = _ceil_to(max(system.n_exclusions, 1), ndev) // ndev
    use_cells = spec.pbc and spec.direct_method.startswith("cell")
    if use_cells:
        n_cells = math.prod(spec.cell_grid)
        c_chunk = _ceil_to(n_cells, ndev) // ndev
        nbr_np, off_np = half_shell_tables(spec.cell_grid)
        extra = ndev * c_chunk - n_cells
        nbr_np = np.concatenate([nbr_np, np.zeros((extra, 14), np.int32)])
        off_np = np.concatenate([off_np, np.zeros((extra, 14, 3), np.int8)])

    def local_energy(positions):
        positions = replicated_in(positions, group)
        dtype = positions.dtype
        q = effective_charges(positions, system)
        x_pad = torch.cat([positions, positions.new_zeros((n_pad - n, 3))])
        q_pad = torch.cat([q, q.new_zeros((n_pad - n,))])
        rows = slice(dev * row_chunk, (dev + 1) * row_chunk)
        if use_cells:
            slots, _overflow = build_cell_list(
                positions.detach(), system.box, spec.cell_grid,
                spec.cell_capacity, plain=not system.uses_kernels)
            e_dir = _cell_rows_direct_energy(positions, q, system, slots,
                                             nbr_np, off_np, dev * c_chunk,
                                             c_chunk)
        else:
            gi = dev * row_chunk + torch.arange(row_chunk,
                                                device=positions.device)
            e_dir = _rows_pair_energy(x_pad[rows], gi, positions, q_pad[rows],
                                      q, system)
        e_excl = _excl_chunk_energy(positions, q, system, dev * e_chunk,
                                    e_chunk)
        if not spec.pbc:
            return sum_out(e_dir + e_excl, group)
        sc, ss = structure_factors(x_pad[rows], q_pad[rows], system.box,
                                   spec.kmax, method="xla")
        e_rec = reciprocal_energy_from_sf(sum_out(sc, group),
                                          sum_out(ss, group), system.box,
                                          spec.alpha, spec.kmax)
        e_self = self_energy(q_pad[rows], spec.alpha)
        if spec.tail_coeff is not None:
            # replicated (outside the sum), like e_rec: added once
            e_rec = e_rec + dispersion_energy(system.box, spec, dtype)
        return e_rec + sum_out(e_dir + e_excl + e_self, group)

    return local_energy


def make_sharded_energy_and_forces_fn(system, mesh,
                                      axis_name: str = "space"):
    """``(positions) -> (energy, forces)``, both alike on every rank, the
    work shared."""
    e_fn = make_sharded_energy_fn(system, mesh, axis_name)

    def ef(positions):
        x = positions.detach().requires_grad_(True)
        with torch.enable_grad():
            e = e_fn(x)
            (g,) = torch.autograd.grad(e, x)
        return e.detach(), -g
    return ef


def make_replica_sharded_energy_fn(system, mesh,
                                   replica_axis: str = "replica",
                                   space_axis: str = "space"):
    """2-D engine: replicas over ``replica_axis``, each replica's work
    shared by the ranks of ``space_axis``.  Returns ``energy_batch(x)``
    for this rank's block of replicas [R_local, N, 3] (``shard_replicas``)
    -> [R_local]; differentiable."""
    from .halo import _halo_local_energy_builder, halo_compatible

    group, rank, size = _axis(mesh, space_axis)
    if halo_compatible(system, size):
        inner = _halo_local_energy_builder(system, group, rank, size)
    else:
        inner = _local_energy_builder(system, group, rank, size)

    def energy_batch(positions):
        return torch.stack([inner(positions[r])
                            for r in range(positions.shape[0])])
    return energy_batch

