"""The control at a size the CPU holds: the program with its own int8 path
switched on (int8 weights in every block, int8 activations, int8 cross
and self caches) serves the same call as the program, decoding for real,
and lands further from the reference than the program on one of the
cell's numbers at least (under beam search the per-token gaps below the
5th best read 0 on both sides here; the deficits of the hypotheses do
not). At the cells' sizes on the card it must fail a cell's limit
that the program meets (test_bench_run.py, marked `cuda`);
`benchmark/tools/limits.py` takes the readings the limits were set
from."""

import pytest

from bench_tiny import tiny_cell
from benchmark.tools import limits


@pytest.mark.parametrize("name", ["large-v3-turbo.archive-greedy",
                                  "large-v3-turbo.archive-beam5"])
def test_int8_control_reads_further_from_the_reference(name, tmp_path,
                                                       monkeypatch):
    from benchmark import harness

    monkeypatch.setattr(harness, "CACHE", tmp_path)
    cell = tiny_cell(name, depth=12, d=256, layers=2, check_windows=6)
    rows = [limits.readings(cell, seed, "cpu") for seed in (1, 2)]
    for r in rows:
        for side in ("program", "control"):
            assert r[side]["failed"] == r[side]["wrong"] == 0, r
    numbers = [k for k in rows[0]["program"]
               if k not in ("call_s", "failed", "wrong", "error")]
    assert ("mean_deficit" in numbers) == ("beam" in name)
    further = [n for n in numbers
               if sum(r["control"][n] for r in rows)
               > 2 * sum(r["program"][n] for r in rows)]
    assert sorted(further) == (["logit_noise", "mean_gap", "widest_gap"]
                               if "greedy" in name
                       else ["mean_deficit", "widest_deficit"]), rows
    assert limits.summary(name, rows)["mean_gap"]["upper"] is not None
