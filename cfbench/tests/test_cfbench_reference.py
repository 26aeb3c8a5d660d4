"""The float64 reference agrees with the program's plain route on a tiny
box, on the route the cells run, and stands apart from the program:
it imports none of it and nothing of JAX."""

from __future__ import annotations

import ast
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from cfbench import spec, water
from cfbench.reference.water import Model, tf32_round
from cfbench.tests.small import small_cell

REF_DIR = Path(spec.HERE) / "reference"


def _port_energy_forces(cfg, x):
    import chargeflux_tpu_torch as port

    system = water.port_system(cfg, "cpu", torch.float64)
    bonded = water.port_bonded(cfg, "cpu", torch.float64)
    xg = torch.tensor(x).requires_grad_(True)
    e = port.energy(xg, system) + port.bonded_energy(xg, bonded)
    (g,) = torch.autograd.grad(e, xg)
    return float(e.detach()), -g


def test_reference_matches_the_plain_route_in_f64():
    cfg = copy.deepcopy(small_cell("water96k.nve")["config"])
    x = water.lattice_waters(cfg, np.random.default_rng(11))
    e, f = _port_energy_forces(cfg, x)
    model = Model(cfg["water"], cfg["system"], water.box_of(cfg), "f64",
                  "cpu")
    e_ref, f_ref, _scale = model.energy_forces(x)
    assert abs(e - float(e_ref)) <= 1e-10 * abs(float(e_ref))
    rms = torch.sqrt(torch.mean((f - f_ref) ** 2) / torch.mean(f_ref ** 2))
    assert float(rms) <= 1e-10


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.14159265,
                      1e-30], dtype=torch.float32)
    r = tf32_round(t)
    assert float(r[0]) == 1.0                         # tie to even
    assert float(r[1]) == 1.0 + 2.0 ** -9
    bits = r.view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0
    assert torch.allclose(r, t, rtol=2.0 ** -11)


def _imported_roots(path: Path) -> set:
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(REF_DIR.glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_only_torch_and_numpy(path):
    assert _imported_roots(path) <= {"__future__", "math", "numpy", "torch"}


@pytest.mark.parametrize("path", sorted(Path(spec.HERE).rglob("*.py")),
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_nothing_in_cfbench_imports_jax(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "flax", "chargeflux_tpu"}
