"""Trajectory IO of the port (``chargeflux_tpu_torch.utils.trajectory``)
held against the JAX package's: the XYZ, PDB and DCD files it writes are
byte-equal to the JAX package's for the same frames (its DCD writer is the
native C++ one where it builds), and the readers give back exactly what
the JAX package's readers give."""

import numpy as np
import pytest
import torch

from chargeflux_tpu.utils import trajectory as jtraj
from chargeflux_tpu_torch.utils import trajectory as ptraj

RNG = np.random.default_rng(1301)
FRAMES = RNG.uniform(-0.5, 2.5, (3, 7, 3))
MASSES = [15.999, 1.008, 1.008, 12.011, 14.007, 22.99, 35.45]
ORTHO = np.array([2.3, 2.6, 2.9])
TRI = np.array([[2.0, 0.0, 0.0], [0.5, 2.2, 0.0], [0.3, -0.2, 2.4]])


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


PDB_CASES = {
    "one frame, ortho box, masses": dict(frames=FRAMES[0], box=ORTHO,
                                         masses=MASSES),
    "three frames, triclinic": dict(frames=FRAMES, box=TRI,
                                    symbols=["O", "H", "H", "C", "N", "Na",
                                             "Cl"]),
    "names, residues, wrapped serials": dict(
        frames=FRAMES[1], names=["OW", "HW1", "HW2", "CA", "N", "NA", "CL"],
        resnames=["HOH"] * 3 + ["GLY", "GLY", "ION", "ION"],
        resseq=[9998, 9998, 9998, 9999, 9999, 10000, 10001]),
    "vacuum": dict(frames=FRAMES[2]),
}


@pytest.mark.parametrize("case", sorted(PDB_CASES))
def test_write_pdb_bytes_and_read_pdb_equal_jax(tmp_path, case):
    kw = PDB_CASES[case]
    pj, pp = str(tmp_path / "j.pdb"), str(tmp_path / "p.pdb")
    assert jtraj.write_pdb(pj, **kw) == ptraj.write_pdb(pp, **kw)
    assert _bytes(pj) == _bytes(pp)
    a, b = jtraj.read_pdb(pj), ptraj.read_pdb(pp)
    np.testing.assert_array_equal(a.frames, b.frames)
    for field in ("symbols", "names", "resnames", "resseq"):
        assert getattr(a, field) == getattr(b, field)
    if a.box is None:
        assert b.box is None
    else:
        np.testing.assert_array_equal(a.box, b.box)


def test_write_pdb_takes_tensors(tmp_path):
    pj, pp = str(tmp_path / "j.pdb"), str(tmp_path / "p.pdb")
    jtraj.write_pdb(pj, FRAMES, box=TRI, masses=MASSES)
    ptraj.write_pdb(pp, torch.tensor(FRAMES), box=torch.tensor(TRI),
                    masses=torch.tensor(MASSES))
    assert _bytes(pj) == _bytes(pp)


@pytest.mark.parametrize("symbols,masses,comments", [
    (None, None, None),
    (None, MASSES, None),
    (list("OHHCNXY"), None, ["a", "b", "c"]),
])
def test_write_xyz_bytes_and_read_xyz_equal_jax(tmp_path, symbols, masses,
                                                comments):
    pj, pp = str(tmp_path / "j.xyz"), str(tmp_path / "p.xyz")
    for append in (False, True):
        kw = dict(symbols=symbols, masses=masses, comments=comments,
                  append=append)
        assert (jtraj.write_xyz(pj, FRAMES, **kw)
                == ptraj.write_xyz(pp, torch.tensor(FRAMES), **kw))
    assert _bytes(pj) == _bytes(pp)
    (fa, sa, ca), (fb, sb, cb) = jtraj.read_xyz(pj), ptraj.read_xyz(pp)
    np.testing.assert_array_equal(fa, fb)
    assert (sa, ca) == (sb, cb)


@pytest.mark.parametrize("with_cell", [True, False])
def test_dcd_bytes_and_read_dcd_equal_jax(tmp_path, with_cell):
    """The port's struct writer against the JAX package's DCDWriter (its
    native C++ writer where that builds, else its Python fallback, which
    tests/test_utils.py holds bit-equal to the native one)."""
    def write(mod, path, frames):
        with mod.DCDWriter(path, 7, dt_ps=0.002, interval=10,
                           with_cell=with_cell) as w:
            for i, f in enumerate(frames):
                box = (ORTHO, TRI, ORTHO)[i] if with_cell else None
                w.write(f, box=box)
        return path

    pj = write(jtraj, str(tmp_path / "j.dcd"), FRAMES)
    pp = write(ptraj, str(tmp_path / "p.dcd"),
               [torch.tensor(f) for f in FRAMES])
    assert _bytes(pj) == _bytes(pp)
    (fa, ca), (fb, cb) = jtraj.read_dcd(pj), ptraj.read_dcd(pp)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_allclose(fb, FRAMES, atol=2e-7 * np.abs(FRAMES).max())
    if with_cell:
        np.testing.assert_array_equal(ca, cb)
    else:
        assert ca is None and cb is None


def test_dcd_writer_checks_its_inputs(tmp_path):
    with ptraj.DCDWriter(str(tmp_path / "x.dcd"), 7) as w:
        with pytest.raises(ValueError, match="expected"):
            w.write(FRAMES[0][:5], box=ORTHO)
        with pytest.raises(ValueError, match="needs a box"):
            w.write(FRAMES[0])


def test_symbols_and_element_fallback_equal_jax():
    masses = [1.0, 1.008, 12.0, 14.0, 16.0, 23.0, 35.5, 40.0, 200.0]
    assert ptraj.symbols_from_masses(masses) == jtraj.symbols_from_masses(
        masses)
    for name4 in (" OW ", "HW1 ", "CL  ", "NA  ", " CA ", "MG  ", "1HB ",
                  "ZN  ", "    "):
        assert (ptraj._element_from_name(name4)
                == jtraj._element_from_name(name4))
