"""Checkpoints of the port (``utils.checkpoint``) held against the JAX
package's: an ``MDState`` saved by each package from the same arrays
gives ``.npz`` files with the same leaf names, order and values, and each
package loads the other's; the port's own states round-trip bit for bit;
a template of another shape, leaf count or structure raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu.integrate import MDState as JMDState
from chargeflux_tpu.utils import checkpoint as jckpt
from chargeflux_tpu_torch.integrate import MDState, MDStateNB
from chargeflux_tpu_torch.neighbors import build_neighbor_state
from chargeflux_tpu_torch.utils import checkpoint as pckpt

from torch_helpers import jax_water

RNG = np.random.default_rng(5)
ARRAYS = [RNG.standard_normal((6, 3)) for _ in range(3)] + [np.array(-3.25)]


def _npz(path):
    with np.load(path) as z:
        return list(z.files), [z[f] for f in z.files]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mdstate_npz_equals_jax_and_cross_loads(tmp_path, dtype):
    arrs = [a.astype(dtype) for a in ARRAYS]
    jstate = JMDState(*map(jnp.asarray, arrs))
    pstate = MDState(*map(torch.tensor, arrs))
    jckpt.save_checkpoint(str(tmp_path / "j"), jstate, step=7)
    pckpt.save_checkpoint(str(tmp_path / "p"), pstate, step=7)
    names_j, vals_j = _npz(tmp_path / "j.npz")
    names_p, vals_p = _npz(tmp_path / "p.npz")
    assert names_j == names_p == [f"leaf_{i}" for i in range(4)]
    for a, b in zip(vals_j, vals_p):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # each package reads the other's arrays (its own sidecar's structure)
    loaded, step = pckpt.load_checkpoint(str(tmp_path / "p"), pstate)
    assert step == 7
    for a, b in zip(loaded.__dict__.values(), arrs):
        np.testing.assert_array_equal(a.numpy(), b)
    (tmp_path / "j.meta.json").write_text(
        (tmp_path / "p.meta.json").read_text())
    back, _ = pckpt.load_checkpoint(str(tmp_path / "j"), pstate)
    assert all(torch.equal(u, v) for u, v in
               zip(back.__dict__.values(), pstate.__dict__.values()))


def test_mdstate_nb_and_system_round_trip_bit_for_bit(tmp_path):
    _, psys, pos, _ = jax_water(5, 0.45, direct_method="cell",
                                recip_method="pme")
    x = torch.tensor(pos)
    state = MDStateNB(x, torch.tensor(RNG.standard_normal(pos.shape)),
                      -x, torch.tensor(1.5), build_neighbor_state(x, psys))
    pckpt.save_checkpoint(tmp_path / "s.npz", state, step=3,
                          extra={"dt": 5e-4})
    back, step = pckpt.load_checkpoint(tmp_path / "s.npz", state)
    assert step == 3
    for f in ("positions", "velocities", "forces", "potential"):
        assert torch.equal(getattr(back, f), getattr(state, f))
    for f in ("slots", "inv_slot", "wrap", "x_ref", "overflow"):
        a, b = getattr(back.nb, f), getattr(state.nb, f)
        assert a.dtype == b.dtype and torch.equal(a, b)
    pckpt.save_checkpoint(tmp_path / "sys", psys)
    sys_back, _ = pckpt.load_checkpoint(tmp_path / "sys", psys)
    assert sys_back.spec == psys.spec
    assert torch.equal(sys_back.q0, psys.q0)


def test_wrong_templates_raise(tmp_path):
    state = MDState(*map(torch.tensor, ARRAYS))
    pckpt.save_checkpoint(tmp_path / "s", state)
    wrong_shape = MDState(torch.zeros(7, 3), *map(torch.tensor, ARRAYS[1:]))
    with pytest.raises(ValueError, match="leaf 0 has shape"):
        pckpt.load_checkpoint(tmp_path / "s", wrong_shape)
    more = MDStateNB(*map(torch.tensor, ARRAYS), torch.zeros(2))
    with pytest.raises(ValueError, match="5"):
        pckpt.load_checkpoint(tmp_path / "s", more)
    with pytest.raises(ValueError, match="structure"):
        pckpt.load_checkpoint(tmp_path / "s", tuple(map(torch.tensor,
                                                        ARRAYS)))
