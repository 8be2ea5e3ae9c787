"""Time the large-M W8A8 route (K7, and K6 above 64 rows) at both tile
widths on the card.

    python3 tools/sweep_k7_plan.py

Large-v2's encoder weight shapes (K x N: 1280 x 3840 qkv, 1280 x 1280
attn_o, 1280 x 5120 mlp1, 5120 x 1280 mlp2) at M = 65 (the fewest rows
the route takes), 750 (one window: K6), 1500 and 3000 (two and four
windows batched: K7), int8 and packed-int4 weights, a bf16 x. For each
shape: the device ms of one call (the prep pass and the tile kernel;
CUDA events around a replayed CUDA graph, chip_smoke.py's `time_ms`) with
128 x 256 and 128 x 128 tiles (`plan_big` patched to return each), the
width `plan_big` picks, the prep pass's own device ms (`prep_ms`: the
row quantization and the per-call K-major copy of the weight, from
`torch.profiler` over 20 calls; at M = 65 nearly all of it is the
copy), and a bf16 `torch.mm` of the same (M, K, N) as a yardstick: the
data behind `ops/kernels/dequant_matmul.py::plan_big`. Every output is
checked bit-equal to the plain version first. Prints the card's name and
power limit, then one JSON line per shape. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280))


def prep_ms(call, calls: int = 20) -> float:
    """Mean device ms of the prep pass over `calls` calls, from the
    profiler's kernel rows (after a warm-up session: a process's first
    session may record no device events)."""
    from torch.profiler import ProfilerActivity, profile

    total = 0.0
    for runs in (1, calls):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                call()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "prep_kernel" in e.key)
    return total / 1e3 / calls


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, HERE)
    from chip_smoke import time_ms
    from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ
    from whisper_tpu_torch.quantize import pack_int4

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for bits in (8, 4):
        for m in (65, 750, 1500, 3000):
            for k, n in SHAPES:
                lim = 2 ** (bits - 1) - 1
                wq = torch.randint(-lim, lim + 1, (k, n), generator=gen,
                                   device="cuda", dtype=torch.int8)
                if bits == 4:
                    wq = pack_int4(wq)
                ws = 0.001 + 0.01 * torch.rand(n, generator=gen,
                                               device="cuda")
                x = torch.randn((m, k), generator=gen,
                                device="cuda").bfloat16()
                fn = KQ.quantized_matmul if m <= 1024 else \
                    KQ.quantized_matmul_big
                plain = KQ.quantized_matmul_plain if m <= 1024 else \
                    KQ.quantized_matmul_big_plain
                want = plain(x, wq, ws)
                row = {"bits": bits, "m": m, "k": k, "n": n,
                       "plan": KQ.plan_big(m, n)}
                plan_big = KQ.plan_big
                try:
                    for bn in (256, 128):
                        if n % bn:
                            continue
                        KQ.plan_big = lambda m, n, bn=bn: bn
                        got = fn(x, wq, ws)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise AssertionError(f"{row} tile {bn}: not "
                                                 "bit-equal")
                        row[f"ms_{bn}"] = time_ms(lambda: fn(x, wq, ws))
                finally:
                    KQ.plan_big = plan_big
                row["ms_plan"] = time_ms(lambda: fn(x, wq, ws))
                row["prep_ms"] = prep_ms(lambda: fn(x, wq, ws))
                w16 = torch.randn((k, n), generator=gen,
                                  device="cuda").bfloat16()
                row["mm_bf16_ms"] = time_ms(lambda: torch.mm(x, w16))
                print(json.dumps(row), flush=True)
                del wq, x, w16, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
