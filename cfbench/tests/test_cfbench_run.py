"""The command refuses to fall back: without the cards a cell asks for, or
without the program beside it, it exits non-zero and prints no result;
and nothing a run loads is JAX or the JAX package."""

from __future__ import annotations

import shutil
import subprocess
import sys
import time

import pytest
import torch

from cfbench import harness, spec
from cfbench.tests.small import small_cell

CMD = [sys.executable, "-m", "cfbench.run", "--workload", "water96k.nve",
       "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")


def test_without_a_card_the_command_fails(no_card):
    res = subprocess.run(CMD, cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "needs 1 CUDA card" in res.stderr


def test_without_the_program_the_command_fails(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "cfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = (
        "import time, torch; torch.set_num_threads(2)\n"
        "from cfbench import harness\n"
        "from cfbench.tests.small import small_cell\n"
        "out = harness.run_cell(small_cell('water96k.nve'), 3, 0.1, False, "
        "'cpu', time.perf_counter(), log=lambda m: None)\n"
        "print(harness.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "chargeflux_tpu.cells", object())
    assert harness.forbidden_modules() == ["chargeflux_tpu.cells"]
    monkeypatch.delitem(sys.modules, "chargeflux_tpu.cells")
    import chargeflux_tpu_torch  # noqa: F401  (begins with the name)
    assert harness.forbidden_modules() == []


@pytest.mark.cuda
def test_small_cells_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run_cell(small_cell("water96k.nve"), 11, 1.0, True,
                           torch.device("cuda", 0), time.perf_counter(),
                           log=lambda m: None)
    assert out["correct"], out["compared"]
    assert out["device"]["busy_s"] > 0
