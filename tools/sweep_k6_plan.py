"""Time K6 (the W8A8 GEMM) at the decode rows under every K split on the card.

    python3 tools/sweep_k6_plan.py [--rows] [--root DIR] [--label NAME]

Large-v2's four decoder weight shapes (K x N: 1280 x 3840 qkv, 1280 x 1280
attn_o / cross_q / cross_o, 1280 x 5120 mlp1, 5120 x 1280 mlp2) at M = 1,
5 and 20 rows (greedy, one window's beam, four windows' beam) and M = 40,
int8 and packed-int4 weights, a bf16 x. For each shape: the device ms of
one call (CUDA events around a replayed CUDA graph, chip_smoke.py's
`time_ms`) under every cluster size the one-launch split-K kernel takes
(`quantized_matmul(..., plan=(ksplit, whole))`), each with the rows'
absmax exchanged through the cluster and read whole by every block
(where whole rows fit), under ksplit = 0 (the row-quantize pass + tile
kernel), and the plan `plan_small` picks: the data behind it in
`ops/kernels/dequant_matmul.py`.

With `--rows`, only the wrapper's own plan (`quantized_matmul` called as
the model calls it), at M = 5 and 20, over four x's that differ in their
first two rows: normal rows only, a zero row, a row of exact half
quantization steps (chip_smoke.py's K6 rows hold both), and both. It
imports `whisper_tpu_torch` from `--root` (default: this checkout), so
the same rows can be timed on another commit unpacked beside it.

Every output is checked bit-equal to the plain version first. Prints one
JSON line per shape and the card's name and power limit. Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280))


def _edge_x(x: torch.Tensor, zero: bool, half: bool) -> torch.Tensor:
    """x with row 0 zeroed and/or row 1 made of exact half steps (absmax
    127: the scale is 1), as chip_smoke.py's K6 rows."""
    x = x.clone()
    if zero:
        x[0] = 0
    if half:
        x[1] = 0
        x[1, 0] = 127
        x[1, 1:41] = torch.arange(40, device=x.device) + 0.5
    return x


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", action="store_true")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, HERE)
    from chip_smoke import time_ms

    sys.path.insert(0, os.path.abspath(args.root))
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ
    from whisper_tpu_torch.quantize import pack_int4

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for bits in (8, 4):
        for k, n in SHAPES:
            lim = 2 ** (bits - 1) - 1
            wq = torch.randint(-lim, lim + 1, (k, n), generator=gen,
                               device="cuda", dtype=torch.int8)
            if bits == 4:
                wq = pack_int4(wq)
            ws = 0.001 + 0.01 * torch.rand(n, generator=gen, device="cuda")
            for m in ((5, 20) if args.rows else (1, 5, 20, 40)):
                x = torch.randn((m, k), generator=gen,
                                device="cuda").bfloat16()
                if args.rows:
                    ms = {}
                    for label, zero, half in (
                            ("normal", False, False), ("zero row", True, False),
                            ("half-step row", False, True),
                            ("both", True, True)):
                        xe = _edge_x(x, zero, half)
                        got = KQ.quantized_matmul(xe, wq, ws)
                        torch.cuda.synchronize()
                        if not torch.equal(
                                got, KQ.quantized_matmul_plain(xe, wq, ws)):
                            raise AssertionError(f"{label} at M={m} K={k} "
                                                 f"N={n} bits {bits} differs")
                        ms[label] = time_ms(
                            lambda: KQ.quantized_matmul(xe, wq, ws))
                    print(json.dumps({"label": args.label, "bits": bits,
                                      "m": m, "k": k, "n": n,
                                      "ms_by_rows": ms}), flush=True)
                    continue
                want = KQ.quantized_matmul_plain(x, wq, ws)
                steps = k // 32
                splits = [0] + [s for s in range(1, KQ.MAX_KSPLIT + 1)
                                if steps % s == 0 and k // s <= KQ.MAX_SLICE]
                ms = {}
                wholes = (False, True) if m * k * 2 <= 65536 else (False,)
                plans = [(0, False)] + [(s, w) for s in splits if s
                                        for w in wholes]
                for plan in plans:
                    got = KQ.quantized_matmul(x, wq, ws, plan=plan)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"plan {plan} at M={m} K={k} "
                                             f"N={n} bits {bits} differs")
                    ms[f"{plan[0]}{'w' if plan[1] else ''}"] = time_ms(
                        lambda: KQ.quantized_matmul(x, wq, ws, plan=plan))
                print(json.dumps({
                    "bits": bits, "m": m, "k": k, "n": n,
                    "plan": KQ.plan_small(m, k, n), "ms_by_plan": ms,
                    "bound_ms": (k * n * bits / 8 + m * (k + n) * 2)
                    / 3.35e12 * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
