"""PyTorch port: ``chargeflux_tpu_torch.bench``, the JAX package's bench.py
on the card.  On the CPU: the configs are built as bench.py builds them
(its ``build_full`` and ``bench_hetero``), a small 216 run prints a line
with bench.py's keys, as do the npt line at a small box and the replicas
line on a small ensemble, every bench.py config is ported, and without
CUDA the bench raises unless ``--device cpu`` is given."""

import json
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chargeflux_tpu_torch import bench
from chargeflux_tpu_torch.utils import measure

torch.set_num_threads(2)


def _jax_bench():
    sys.path.insert(0, ".")
    import bench as jax_bench
    return jax_bench


def test_216_line_has_the_bench_keys(capsys):
    """``main(["216", "--device", "cpu", "--steps", "4"])``: one JSON line
    named as bench.py names it, with its fields, a finite value and
    energy, and the device."""
    bench.main(["216", "--device", "cpu", "--steps", "4"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "ms_per_md_step_216_ewald_f32"
    for key in ("value", "unit", "ns_per_day", "dt_fs", "atoms",
                "cell_capacity", "cell_grid", "energy", "device"):
        assert key in line, key
    assert line["unit"] == "ms" and line["dt_fs"] == 0.5
    assert line["atoms"] == 648 and line["device"] == "cpu"
    assert line["value"] > 0 and np.isfinite(line["energy"])
    assert line["ns_per_day"] == pytest.approx(43.2 / line["value"])


@pytest.mark.parametrize("config,item", [("replicas", "A.9")])
def test_unported_configs_exit_naming_their_item(config, item):
    """Every config of bench.py is ported: ``replicas``, the last one
    (ROADMAP ``item``), is a config and nothing is left unported; a name
    bench.py does not have exits non-zero."""
    assert config in bench.CONFIGS and not bench.NOT_PORTED
    with pytest.raises(SystemExit) as exc:
        bench.main(["no-such-config", "--device", "cpu"])
    assert exc.value.code != 0


def test_npt_line_has_the_bench_keys(monkeypatch):
    """npt is a bench config now: its line (``bench_npt`` on the small
    rehearsal path of ``utils.measure.npt_path``, one timing repetition,
    four acceptance attempts) carries bench.py's npt keys, a finite value
    and energies, and the acceptance statistics."""
    assert "npt" in bench.CONFIGS and "npt" not in bench.NOT_PORTED
    paired = bench.paired_ms
    monkeypatch.setattr(bench, "paired_ms",
                        lambda d, k1, k2, dev: paired(d, k1, k2, dev, reps=1))
    monkeypatch.setattr(bench, "NPT_ATTEMPTS", 4)
    cpu = torch.device("cpu")
    path = measure.npt_path(cpu, n_side=6, cutoff=0.55, grid=(3, 3, 3),
                            burn_steps=40)
    line = bench.bench_npt(cpu, None, path)
    assert line["metric"] == "ms_per_npt_md_step_30k_ewald_f32"
    for key in ("value", "unit", "ns_per_day", "dt_fs", "barostat_interval",
                "atoms", "cell_capacity", "cell_grid", "accept_fraction",
                "poisoned"):
        assert key in line, key
    assert line["barostat_interval"] == path["rebuild_every"]
    assert line["atoms"] == 648 and line["attempts"] == 4
    assert line["value"] > 0 and np.isfinite(line["energy"])
    assert line["energies_finite"] and 0.0 <= line["accept_fraction"] <= 1.0
    json.dumps(line)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is here")
def test_without_cuda_the_bench_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["216", "--steps", "1"])


def test_paired_timing_is_the_median_of_the_differences():
    """t(k2) - t(k1) over (k2 - k1) per repetition, median: a drive whose
    call costs a fixed overhead plus a cost per step gives the cost per
    step."""
    calls = []

    def drive(n):
        calls.append(n)
        time.sleep(0.005 + 0.002 * n)
        return None, torch.zeros(n)

    ms, last = bench.paired_ms(drive, 2, 12, torch.device("cpu"), reps=3)
    assert calls[:2] == [2, 12] and calls[2:] == [12, 2] * 3
    assert 1.0 < ms < 4.0 and last == 0.0
    with pytest.raises(RuntimeError, match="NaN"):
        bench.paired_ms(lambda n: (None, torch.full((n,), float("nan"))),
                        1, 6, torch.device("cpu"), reps=1)


@pytest.mark.parametrize("config,cutoff", [("4k", None), ("tri30k", None),
                                           ("30k", 0.9)])
def test_bench_paths_are_bench_py_configs(config, cutoff):
    """``utils.measure.bench_path`` builds the system bench.py's
    ``build_full`` builds: the same positions, masses and box, and the same
    cutoff, cell grid, capacity, PME mesh and slack, Ewald parameters."""
    jbench = _jax_bench()
    xj, sj, mj, _ = jbench.build_full(config, cutoff=cutoff)
    _, x, m, box, _, st = measure.bench_path(config, "cpu", cutoff)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    np.testing.assert_allclose(st.box.double().numpy(),
                               np.asarray(sj.box, np.float64), rtol=1e-7)
    for f in ("cutoff", "cell_grid", "cell_capacity", "pme_grid",
              "pme_order", "pme_slack", "kmax", "alpha", "direct_method"):
        assert getattr(st.spec, f) == getattr(sj.spec, f), f
    assert st.spec.recip_method == "pme"


def test_hetero_path_is_bench_hetero():
    """bench.py's hetero30k: solvated_chain_box(n_side=22,
    n_solute_sites=100, cutoff=0.72) on the forced 8^3 grid with the
    capacity from suggest_capacity(margin=1.05); 299 remainder flux bonds,
    the chain's bonded rows."""
    from chargeflux_tpu.cells import suggest_capacity
    from chargeflux_tpu.models import solvated_chain_box

    force, pos, masses, box, kw = solvated_chain_box(
        n_side=22, n_solute_sites=100, cutoff=0.72)
    sj = force.create_system(box=box, dtype=jnp.float32,
                             direct_method="cell", cell_grid=(8, 8, 8))
    cap = suggest_capacity(pos, box, sj.spec.cell_grid, margin=1.05)
    _, x, m, _, bonded, st = measure.bench_path("hetero30k", "cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(pos, np.float32))
    np.testing.assert_array_equal(m.numpy(), np.asarray(masses, np.float32))
    assert st.spec.cell_grid == (8, 8, 8) and st.spec.cell_capacity == cap
    assert st.spec.pme_grid == sj.spec.pme_grid
    assert dict(st.spec.flux_template.remainder)["bonds"] == 299
    assert bonded.bond_idx.shape[0] == kw["bond_idx"].shape[0]


def test_replicas_line_has_the_bench_keys(monkeypatch):
    """The replicas line on a small ensemble (2 replicas of the 216 box,
    one repetition of 1 and 4 steps): bench.py's metric, both reciprocal
    routes timed, "auto" on the JAX package's "xla" pin, finite
    energies that agree between the routes."""
    monkeypatch.setattr(bench, "REPLICA_REPS", 1)
    cpu = torch.device("cpu")
    line = bench.bench_replicas(cpu, steps=1, n_replicas=2)
    assert line["metric"] == "ms_per_step_2x216_replica_ensemble"
    assert line["route"] == "xla" and set(line["route_ms"]) == {"xla",
                                                                "pallas"}
    assert line["steps"] == [1, 4] and line["atoms"] == 648
    assert line["value"] == line["route_ms"]["xla"] > 0
    assert np.isfinite(line["energy"])
    assert line["energy_other_route"] == pytest.approx(line["energy"],
                                                       rel=1e-5)
    json.dumps(line)
