"""ctypes bindings to the repository's native C++ host runtime
(``csrc/chargeflux_host.cpp``; counterpart of
``chargeflux_tpu.runtime.native``).

A host-side f64 oracle and helper, not an accelerator path: a cell
histogram, the flux charges, the direct and reciprocal energies, the
flux chain-rule forces and a DCD writer.  The source is built with ``g++``
on first use into the port's ``_build/`` directory (plain C ABI through
ctypes).  The functions take NumPy arrays or tensors on any device, and
work in f64 NumPy on the host, as the JAX package's do.  Without a
compiler :func:`native_available` is False, :func:`cell_histogram` falls
back to NumPy and the other entry points raise.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "chargeflux_host.cpp"
_SO = Path(__file__).resolve().parents[1] / "_build" / "chargeflux_host.so"


def _f64(a) -> np.ndarray:
    """``a`` (an array, a tensor on any device, a sequence) as contiguous
    f64 NumPy on the host."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().double().numpy()
    return np.ascontiguousarray(a, np.float64)


def _i32(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, np.int32)


def _build() -> bool:
    if not _SRC.exists():
        return False
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, _SO)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not _SO.exists() or (_SRC.exists() and _SRC.stat().st_mtime
                            > _SO.stat().st_mtime):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    iptr = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.cf_cell_histogram.restype = ctypes.c_int
    lib.cf_cell_histogram.argtypes = [dptr, ctypes.c_int64, dptr, iptr, iptr]
    lib.cf_flux_charges.restype = None
    lib.cf_flux_charges.argtypes = [
        dptr, ctypes.c_int64, dptr, ctypes.c_int, dptr,
        iptr, dptr, ctypes.c_int64,
        iptr, dptr, ctypes.c_int64,
        iptr, dptr, ctypes.c_int64,
        dptr]
    lib.cf_direct_energy.restype = ctypes.c_double
    lib.cf_direct_energy.argtypes = [
        dptr, ctypes.c_int64, dptr, dptr, dptr, dptr,
        iptr, ctypes.c_int64, ctypes.c_double, ctypes.c_double, dptr, dptr]
    lib.cf_recip_self_energy.restype = ctypes.c_double
    lib.cf_recip_self_energy.argtypes = [
        dptr, ctypes.c_int64, dptr, dptr, iptr, ctypes.c_double,
        dptr, dptr]
    lib.cf_flux_chain_forces.restype = None
    lib.cf_flux_chain_forces.argtypes = [
        dptr, ctypes.c_int64, dptr, ctypes.c_int, dptr,
        iptr, dptr, ctypes.c_int64,
        iptr, dptr, ctypes.c_int64,
        iptr, dptr, ctypes.c_int64,
        dptr]
    lib.cf_dcd_open.restype = ctypes.c_void_p
    lib.cf_dcd_open.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                ctypes.c_double, ctypes.c_int32,
                                ctypes.c_int32]
    lib.cf_dcd_write_frame.restype = ctypes.c_int
    lib.cf_dcd_write_frame.argtypes = [ctypes.c_void_p, dptr,
                                       ctypes.c_void_p]
    lib.cf_dcd_close.restype = ctypes.c_int
    lib.cf_dcd_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def dcd_native_handle(path: str, n_atoms: int, dt_ps: float, nsavc: int,
                      with_cell: bool):
    """(lib, handle) for the native DCD writer, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.cf_dcd_open(str(path).encode(), int(n_atoms), float(dt_ps),
                        int(nsavc), int(bool(with_cell)))
    if not h:
        raise OSError(f"cannot open {path!r} for DCD writing")
    return lib, h


def native_available() -> bool:
    return _load() is not None


def cell_histogram(positions, box, grid):
    """Per-cell occupancy counts and max occupancy.  Native if available,
    NumPy fallback otherwise.  Returns (counts [gx*gy*gz], max)."""
    pos = _f64(positions)
    box = _f64(box)
    g = _i32(grid)
    lib = _load()
    if lib is not None:
        counts = np.zeros(int(g[0] * g[1] * g[2]), np.int32)
        mx = lib.cf_cell_histogram(pos, len(pos), box, g, counts)
        return counts, int(mx)
    frac = pos / box
    frac -= np.floor(frac)
    ci = np.minimum((frac * g).astype(np.int64), np.asarray(g, np.int64) - 1)
    flat = (ci[:, 0] * g[1] + ci[:, 1]) * g[2] + ci[:, 2]
    counts = np.bincount(flat, minlength=int(g[0] * g[1] * g[2])).astype(np.int32)
    return counts, int(counts.max())


def native_flux_charges(positions, box, pbc, q0, bonds, angles, waters):
    """Effective charges from the native oracle.  bonds: (idx [B,2], kb [B,2]);
    angles: (idx [A,3], kt [A,2]); waters: (idx [W,3], p [W,5])."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime not available")
    pos = _f64(positions)
    n = len(pos)
    q_out = np.zeros(n)
    b_idx, b_p = bonds
    a_idx, a_p = angles
    w_idx, w_p = waters
    lib.cf_flux_charges(
        pos, n, _f64(box), int(pbc),
        _f64(q0),
        _i32(b_idx).reshape(-1),
        _f64(b_p).reshape(-1), len(b_idx),
        _i32(a_idx).reshape(-1),
        _f64(a_p).reshape(-1), len(a_idx),
        _i32(w_idx).reshape(-1),
        _f64(w_p).reshape(-1), len(w_idx),
        q_out)
    return q_out


def native_recip_self_energy(positions, box, q, kmax, alpha, forces, dedq):
    """Classical-Ewald self + brute half-space reciprocal term (f64,
    native).  Adds the fixed-charge force and dE/dq contributions INTO
    ``forces``/``dedq`` in place; returns E_self + E_recip."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime not available")
    pos = _f64(positions)
    assert forces.flags.c_contiguous and dedq.flags.c_contiguous
    return float(lib.cf_recip_self_energy(
        pos, len(pos), _f64(box),
        _f64(q),
        _i32(kmax), float(alpha),
        forces.reshape(-1), dedq))


def native_flux_chain_forces(positions, box, pbc, dedq, bonds, angles,
                             waters, forces):
    """Contract dE/dq against the analytic dq/dx (the multdQdX chain rule)
    and subtract from ``forces`` in place.  Argument conventions match
    :func:`native_flux_charges`."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime not available")
    pos = _f64(positions)
    b_idx, b_p = bonds
    a_idx, a_p = angles
    w_idx, w_p = waters
    lib.cf_flux_chain_forces(
        pos, len(pos), _f64(box), int(pbc),
        _f64(dedq),
        _i32(b_idx).reshape(-1),
        _f64(b_p).reshape(-1), len(b_idx),
        _i32(a_idx).reshape(-1),
        _f64(a_p).reshape(-1), len(a_idx),
        _i32(w_idx).reshape(-1),
        _f64(w_p).reshape(-1), len(w_idx),
        forces.reshape(-1))


def native_full_energy_forces(positions, box, q0, sigma, epsilon,
                              exclusions, bonds, angles, waters,
                              cutoff, alpha, kmax):
    """Full charge-flux Ewald ground truth, all-native: flux charges ->
    direct + exclusion -> self + reciprocal -> dE/dq chain rule.  The
    complete contract of ReferenceCoulKernels.cpp:424-636 at scales where
    the Python oracle is too slow.  Returns (energy, forces [N,3])."""
    q = native_flux_charges(positions, box, True, q0, bonds, angles,
                            waters)
    e_dir, forces, dedq = native_direct_energy(
        positions, box, q, sigma, epsilon, exclusions, cutoff, alpha)
    e_rs = native_recip_self_energy(positions, box, q, kmax, alpha,
                                    forces, dedq)
    native_flux_chain_forces(positions, box, True, dedq, bonds, angles,
                             waters, forces)
    return e_dir + e_rs, forces


def native_direct_energy(positions, box, q, sigma, epsilon, exclusions,
                         cutoff, alpha):
    """Direct-space + exclusion-correction energy/forces/dedq (f64, native).
    Returns (energy, forces [N,3], dedq [N])."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime not available")
    pos = _f64(positions)
    n = len(pos)
    forces = np.zeros((n, 3))
    dedq = np.zeros(n)
    excl = _i32(exclusions).reshape(-1)
    e = lib.cf_direct_energy(
        pos, n, _f64(box),
        _f64(q),
        _f64(sigma),
        _f64(epsilon),
        excl, len(exclusions), float(cutoff), float(alpha),
        forces.reshape(-1), dedq)
    return float(e), forces, dedq
