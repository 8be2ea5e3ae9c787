"""The readings a cell's correctness limits are set from, on the card, in
one process. For each seed the program serves the rotation's first call
of the cell, and the control serves the same call; each is then judged
as a run judges itself (`check.numbers`, `check_windows` windows drawn
from the seed, the reference remade from the seed after the program is
freed), and the control through `check.judge` with the cell's limits
where it has them. A limit's lower reading is the largest of the
program's over the seeds, its upper the smallest of the control's.

    python3 benchmark/tools/limits.py --workload large-v2.archive-beam5 \
        [--seeds 12] [--control-seeds 4] [--first-seed 7001] \
        [--check-windows N] [--control '{"options": {"kv_quant": false}}'] \
        [--no-program]

A cell that BENCHMARK.json does not list is named `<config>.<traffic>`
by its files. The control is the program with its own int8 path switched
on, the next precision below the configuration's bf16, decoding for real
through the same entry: `quantize` {"bits": 8, "encoder": true}
(per-channel int8 weights in every block), `knobs` {"int8_impl":
"pallas"} (the W8A8 kernels: activations quantized per row), and int8
cross and self caches (`options` kv_quant and self_quant "int8");
`--control` lays other keys over these (a cell whose int8 cross cache
does not fit the card), and `--no-program` reads the control alone.
Prints one JSON line a seed and a summary line.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CONTROL = {"quantize": {"bits": 8, "encoder": True},
           "knobs": {"int8_impl": "pallas"},
           "options": {"kv_quant": "int8", "self_quant": "int8"}}


def control_cell(cell, control=None):
    """The cell with the program's int8 path switched on."""
    config = {**copy.deepcopy(cell.config), **copy.deepcopy(CONTROL)}
    for key, value in (control or {}).items():
        config[key] = {**config.get(key, {}), **value}
    return dataclasses.replace(cell, config=config)


def serve(cell, seed: int, device):
    """The rotation's first call served by a fresh program, which is freed
    before this returns."""
    import torch

    from benchmark import harness
    from benchmark import traffic as tr

    program_cls, _ = harness.entry(cell)
    program = program_cls(cell, seed, device)
    record = harness.timed_call(program, tr.Call(0, tr.rotation(cell.traffic)[0]),
                                seed, device)
    del program
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return record


def readings(cell, seed: int, device, control: bool = True,
             program: bool = True, control_keys=None) -> dict:
    """{"seed", "program": {number: value}, "control": {...}, ...} of one
    seed."""
    from benchmark import check

    out = {"seed": seed}
    runs = (([("program", cell)] if program else [])
            + ([("control", control_cell(cell, control_keys))]
               if control else []))
    for name, c in runs:
        record = serve(c, seed, device)
        values, failed, wrong = check.numbers([record], c.config, c.traffic,
                                              seed, device)
        out[name] = dict(values)
        out[name].update(call_s=record.wall_s, failed=failed, wrong=wrong,
                         error=record.error)
        if name == "control" and cell.limits["numbers"]:
            checks = {k: {"value": values[k], "limit": e["limit"]}
                      for k, e in cell.limits["numbers"].items()}
            out["control_correct"] = all(
                v["value"] <= v["limit"] for v in checks.values()) and not (
                    failed or wrong)
    return out


def summary(workload: str, rows) -> dict:
    out = {"workload": workload, "seeds": len(rows),
           "control_seeds": sum("control" in r for r in rows)}
    first = rows[0].get("program") or rows[0]["control"]
    names = [k for k in first if k not in ("call_s", "failed", "wrong", "error")]
    for name in names:
        lower = max((r["program"][name] for r in rows if "program" in r),
                    default=None)
        ctl = [r["control"][name] for r in rows if name in r.get("control", {})]
        upper = min(ctl) if ctl else None
        out[name] = {"lower": lower, "upper": upper,
                     "ratio": upper / lower if upper is not None and lower
                     else None}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True,
                    help="<config>.<traffic>, listed in BENCHMARK.json or not")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=4,
                    help="read the control on the first N seeds")
    ap.add_argument("--first-seed", type=int, default=7001)
    ap.add_argument("--check-windows", type=int, default=None,
                    help="sample this many windows instead of the traffic's")
    ap.add_argument("--control", type=json.loads, default=None,
                    help="JSON laid over the control's configuration keys")
    ap.add_argument("--no-program", action="store_true",
                    help="read the control alone")
    args = ap.parse_args()
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != Path(__file__).resolve().parent]
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("limits: no CUDA card", file=sys.stderr)
        return 2
    config, traffic = args.workload.split(".", 1)
    cell = harness.make_cell(config, traffic)
    if args.check_windows:
        cell.traffic["check_windows"] = args.check_windows
    rows = []
    for i in range(args.seeds):
        row = readings(cell, args.first_seed + 7919 * i, "cuda",
                       control=i < args.control_seeds,
                       program=not args.no_program, control_keys=args.control)
        rows.append(row)
        print(json.dumps({"workload": args.workload, **row}), flush=True)
    print(json.dumps(summary(args.workload, rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
