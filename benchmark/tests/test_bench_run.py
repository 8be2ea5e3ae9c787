"""run.py as the driver runs it: without a card it exits non-zero and
prints no result. On a card (marked `cuda`, skipped here): one short run
of a cell prints a correct result line in the contract's shape, and the
control of each cell, judged as a run is, is not correct where the
program meets every limit."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["large-v3-turbo.archive-greedy"]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def test_exits_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
         "2147483700", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_short_run_on_the_card():
    _card()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
         "2147483701", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"xrt", "setup_s"}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check mean_gap")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    _card()
    from benchmark import harness
    from benchmark.tools import limits

    cell = harness.load_cell(name)
    row = limits.readings(cell, 2147483702, "cuda")
    for side in ("program", "control"):
        assert row[side]["failed"] == row[side]["wrong"] == 0, row
    for number, entry in cell.limits["numbers"].items():
        assert row["program"][number] <= entry["limit"], row
    assert row["control_correct"] is False, row
