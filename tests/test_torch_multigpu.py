"""PyTorch port: ``utils.measure multigpu`` rehearsed on four gloo ranks
on the CPU at small sizes (``--device cpu``): every route (halo on (4, 1)
slabs and (2, 2) bricks with both reciprocal routes and the overflow
poison, NVE and NPT over the halo energy, work sharding on a grid no
halo decomposition fits, the replica and multislice meshes) agrees with
the single-system route that rank 0 computes, and the ranks agree bit
for bit.  No JAX in the ranks or here."""

import json

from chargeflux_tpu_torch.utils.multigpu import halo_decomps, run


def test_halo_decomps_are_the_slabs_and_bricks_that_divide():
    assert halo_decomps(4, (8, 8, 8)) == [(4, 1), (2, 2)]
    assert halo_decomps(1, (8, 8, 8)) == [(1, 1)]
    assert halo_decomps(2, (8, 8, 8)) == [(2, 1), (1, 2)]
    assert halo_decomps(4, (6, 6, 6)) == [(2, 2)]


def test_multigpu_rehearsal_on_four_gloo_ranks(capsys):
    res = run(small=True)
    assert res["ok"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert res["world"] == 4 and res["device"] == "cpu"
    rows = res["halo"]["rows"]
    assert set(rows) == {"4x1_pme", "2x2_pme", "4x1_xla", "2x2_xla"}
    for key, row in rows.items():
        assert row["ranks_apart"] == 0.0 and row["d_f"] <= 1e-5
        # a slab exchanges its two x planes, a brick two y rows first
        assert row["collectives"]["ppermute"] == (2 if "4x1" in key else 4)
    assert res["halo"]["overflow_poisons"]
    assert all(r["bit_equal"] for r in res["nve"]["rows"].values())
    assert res["nve"]["one_card"]["halo_1"]["bit_equal"]
    assert res["shard"]["grid"] == [3, 3, 3]
    assert set(res["replicas"]) == {"replica", "multislice"}
