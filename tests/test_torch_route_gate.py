"""PyTorch port: which route takes the CUDA kernels, and what each kernel
refuses.

A system records its ``kernel_route`` when it is built: "cuda" (the walk
and spread kernels) for f32 on the card, "plain" for f64 or the CPU.
Each wrapper module keeps one function, ``_refusal``, with the conditions
its kernels put on types, devices and sizes; the wrappers raise with its
reason, so an f32 input past a kernel's limits raises rather than running
another route.  ``recip_method="auto"`` takes the structure-factor kernels
only for a k grid they take.  The kernels' limits come from the built
library (``native.limits``), which needs nvcc, so here they are the
values the CUDA sources compile in (``torch_helpers.KERNEL_LIMITS``).
"""

import dataclasses

import pytest
import torch

from chargeflux_tpu_torch.energy import resolve_recip_method
from chargeflux_tpu_torch.models import water_box
from chargeflux_tpu_torch.ops import bonded_terms as bt
from chargeflux_tpu_torch.ops import direct_walk as dw
from chargeflux_tpu_torch.ops import exclusion as ex
from chargeflux_tpu_torch.ops import pme_spread as ps
from chargeflux_tpu_torch.ops import structure_factor as sf

from torch_helpers import fake_kernel_limits

CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")
F32, F64 = torch.float32, torch.float64


@pytest.fixture
def limits(monkeypatch):
    fake_kernel_limits(monkeypatch)


def _kind(refusal):
    return None if refusal is None else refusal[0]


# (id, dtype, device, Wx, Wyp, order, Gz (None: the backward), refusal)
SPREAD = [
    ("f32-card-30k", F32, CUDA, 20, 24, 8, 64, None),
    ("f64-card", F64, CUDA, 20, 24, 8, 64, TypeError),
    ("f32-cpu", F32, CPU, 20, 24, 8, 64, TypeError),
    ("limits", F32, CUDA, 36, 32, 16, 8, None),
    ("wyp-33", F32, CUDA, 20, 33, 8, 64, ValueError),
    ("order-17", F32, CUDA, 20, 24, 17, 64, ValueError),
    ("wx-37", F32, CUDA, 37, 24, 8, None, ValueError),
    ("wx-37-forward", F32, CUDA, 37, 24, 8, 64, None),
    ("gz-7-forward", F32, CUDA, 20, 24, 8, 7, ValueError),
    ("gz-7-backward", F32, CUDA, 20, 24, 8, None, None),
]


@pytest.mark.parametrize("case", SPREAD, ids=[c[0] for c in SPREAD])
def test_spread_gate(limits, case):
    """The forward refuses Gz < 8, the backward Wx > 36 (its tile holds
    every x); both refuse Wyp > 32, order > 16 and anything but f32 on
    the card."""
    _, dtype, dev, wx, wyp, order, gz, want = case
    named = [(n, dtype, dev) for n in ("qwlxt", "wlyt", "wzt")]
    assert _kind(ps._refusal(named, wx, wyp, order, gz)) is want


# (id, dtype, device, block shape, cutoff, refusal)
WALK = [
    ("f32-card-30k", F32, CUDA, (8, 8, 8, 88), 0.72, None),
    ("f64-card", F64, CUDA, (8, 8, 8, 88), 0.72, TypeError),
    ("cap-1", F32, CUDA, (3, 3, 3, 1), 0.72, None),
    ("grid-3-4-5", F32, CUDA, (3, 4, 5, 97), 0.72, None),
    ("cap-1024", F32, CUDA, (3, 3, 3, 1024), 0.72, None),
    ("cap-1025", F32, CUDA, (3, 3, 3, 1025), 0.72, ValueError),
    ("two-cells", F32, CUDA, (8, 2, 8, 88), 0.72, ValueError),
]


@pytest.mark.parametrize("case", WALK, ids=[c[0] for c in WALK])
def test_walk_gate(limits, case):
    _, dtype, dev, shape, cutoff, want = case
    named = [("x", dtype, dev), ("box", dtype, dev)]
    assert _kind(dw._refusal(named, shape, 3.4, cutoff)) is want


# (id, dtype, device, Ky, 2Kz, N, refusal)
SF = [
    ("f32-card-216", F32, CUDA, 13, 26, 648, None),
    ("f64-card", F64, CUDA, 13, 26, 648, TypeError),
    ("ky-64", F32, CUDA, 64, 128, 100, None),
    ("ky-65", F32, CUDA, 65, 26, 648, ValueError),
    ("2kz-130", F32, CUDA, 13, 130, 648, ValueError),
    ("no-atoms", F32, CUDA, 13, 26, 0, ValueError),
]


@pytest.mark.parametrize("case", SF, ids=[c[0] for c in SF])
def test_structure_factor_gate(limits, case):
    _, dtype, dev, ky, kz2, n, want = case
    named = [(k, dtype, dev) for k in ("cxT", "cyT", "zq")]
    assert _kind(sf._refusal(named, ky, kz2, n)) is want


# (id, dtype, device, refusal)
EXCLUSION = [
    ("f32-card", F32, CUDA, None),
    ("f64-card", F64, CUDA, TypeError),
    ("f32-cpu", F32, CPU, TypeError),
]


@pytest.mark.parametrize("case", EXCLUSION, ids=[c[0] for c in EXCLUSION])
def test_exclusion_gate(case):
    """The exclusion kernels take f32 on the card only (no size limit: a
    template's rows are read from a table)."""
    _, dtype, dev, want = case
    named = [(n, dtype, dev) for n in ("positions", "q", "box")]
    assert _kind(ex._refusal(named)) is want


@pytest.mark.parametrize("case", EXCLUSION, ids=[c[0] for c in EXCLUSION])
def test_bonded_gate(case):
    """The bonded kernels take f32 on the card only (no size limit: a
    template's rows are read from a table)."""
    _, dtype, dev, want = case
    named = [(n, dtype, dev) for n in ("positions", "bond_k", "box")]
    assert _kind(bt._refusal(named)) is want


def test_predicates_on_cpu_tensors_and_the_wrappers_reason():
    """On CPU tensors each refusal is the type's, read before any limit
    (nothing is built), and a wrapper's own check raises that same
    reason: the refusal is one condition, read by both."""
    named = [("x", F64, CPU)]
    assert _kind(dw._refusal(named, (3, 3, 3, 8), 3.4, 0.72)) is TypeError
    assert _kind(sf._refusal(named, 5, 6, 5)) is TypeError
    w = [torch.zeros((2, k, 16), dtype=F64) for k in (6, 8, 4)]
    zorg = torch.zeros((2, 1, 16), dtype=torch.int32)
    reason = ps._refusal(ps._named(("qwlxt", w[0])), 6, 8, 4, 16)
    assert reason[0] is TypeError
    with pytest.raises(reason[0], match="float32 CUDA tensor"):
        ps._check(*w, zorg, ((0, 4), (0, 4)), (10, 12, 16))


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_system_records_its_kernel_route(dtype):
    """A system built on the CPU records the plain route at either type;
    ``astype`` records the route of the cast system.  (The card's f32
    "cuda" and f64 "plain" are checked in the CUDA test file.)"""
    force, _, _, box = water_box(n_side=3, cutoff=0.4)
    system = force.create_system(box=box, dtype=dtype, device="cpu")
    assert system.kernel_route == "plain"
    assert "kernel_route='plain'" in repr(system)
    assert system.astype(F64).kernel_route == "plain"


@pytest.mark.parametrize("kmax, want", [
    ((7, 7, 7), "pallas"),     # 216: Ky 13, 2Kz 26
    ((1, 33, 1), "xla"),       # an elongated box: Ky 65 > 64, 65 k-vectors
    ((1, 1, 33), "xla"),       # 2Kz 130 > 128
    ((9, 17, 9), "xla"),       # within the limits; 9*33*17 k >= 4000
])
def test_auto_takes_the_kernels_only_for_a_grid_they_take(limits, kmax,
                                                          want):
    force, _, _, box = water_box(n_side=6, cutoff=0.9)
    spec = dataclasses.replace(
        force.create_system(box=box, direct_method="dense",
                            device="cpu").spec, kmax=kmax)
    assert resolve_recip_method(spec, F32, CUDA) == want
    assert resolve_recip_method(spec, F64, CUDA) == "xla"
