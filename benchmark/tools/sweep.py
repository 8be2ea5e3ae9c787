"""Windows per second of a cell's program at several batch sizes, on the
card: the sweep that chose a traffic's `batch_size`.

    python3 benchmark/tools/sweep.py --workload large-v2.archive-greedy \
        --batches 32,64,128,256 [--batches-per-call 3] [--seed 1]

For each batch size, one recording of exactly `--batches-per-call` full
batches of windows (and the 3 s tail every recording ends in) is
transcribed twice through the cell's entry; the second call is timed.
Prints one JSON line per batch size.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", default="32,64,128,256")
    ap.add_argument("--batches-per-call", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != Path(__file__).resolve().parent]
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness
    from benchmark import traffic as tr

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    base = harness.make_cell(*args.workload.split(".", 1))
    geo = tr.geometry(base.config, base.traffic)
    for b in (int(x) for x in args.batches.split(",")):
        traffic = dict(base.traffic, batch_size=b)
        cell = dataclasses.replace(base, traffic=traffic)
        program = harness.Program(cell, args.seed, "cuda")
        full = b * args.batches_per_call
        n = (full - 1) * geo.shift + geo.window
        wave = [tr.host_audio(n, args.seed, 0, 0, "cuda")]
        program.call(wave)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.call(wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"workload": args.workload, "batch_size": b,
                          "full_windows": full, "tails": 1, "wall_s": wall,
                          "windows_per_s": (full + 1) / wall,
                          "xrt": n / tr.SAMPLE_RATE / wall,
                          "memory_peak_bytes": torch.cuda.max_memory_allocated()}),
              flush=True)
        del program, wave
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
