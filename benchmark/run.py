"""The benchmark of whisper_tpu_torch on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json in this process on this machine's cards:
sets the program up (the kernel library from the checkout's build cache,
the tokenizer, weights made on the card from the seed, a warm-up of the
cell's shapes), measures whole rotations of the cell's traffic for about
`--seconds`, profiles one call with `--trace 1`, then judges the answers
against the plain reference and prints one JSON line: the end-to-end
metrics with `--trace 0`, the per-layer metrics with `--trace 1`. The
numbers compared and their limits are the last lines on standard error
and the last key of the line.

Exits non-zero, printing no result, without enough CUDA cards, and if the
JAX stack or the JAX package was loaded into this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FOREIGN = {"jax", "jaxlib", "flax", "whisper_tpu"}


def foreign_modules():
    """Loaded modules of the JAX stack or the JAX package, by whole
    top-level name (whisper_tpu_torch is not whisper_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & FOREIGN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "benchmark" / sub)
    # the package by its name from the checkout's root, not this folder's
    # modules by their bare names (trace.py would shadow the stdlib's)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), "cuda", T_START)
    found = foreign_modules()
    if found:
        print(f"run.py: the process loaded {', '.join(found)}; the benchmark "
              "runs whisper_tpu_torch alone", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
