"""Time the split decode-attention kernels at every cluster size on the card.

    python3 tools/sweep_k3g_splits.py

Large-v2 widths (20 heads of 64), layer 3 of a 32-layer stack (4 for the
f32 cache), every row visible. First K3g (grouped cross attention): beam
lanes R against W windows' cross caches of Sa rows. Then K3 per lane:
B lanes against their own layer-major cross caches, and B lanes of a
batch-major self cache (C = 128 and 448). For each shape: the device ms
of one call with the cluster size forced to 1, 2, 4 and 8
(`decode_attention_stacked(..., splits=)`; per lane, 1 is the one-block
kernel; CUDA events around a replayed CUDA graph, chip_smoke.py's
`time_ms`), and the size the planner picks (`plan_splits`,
`plan_lane_splits`). The data behind both planners in
`ops/kernels/decode_attention.py`. Prints one JSON line. Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from chip_smoke import time_ms
    from whisper_tpu_torch.ops.kernels import decode_attention as KC
    from whisper_tpu_torch.quantize import pack_int4

    gen = torch.Generator(device="cuda").manual_seed(0)
    d, heads = 1280, 20
    rows = []
    for w, rep, c, st, n_layer in (
            (1, 5, 750, "bf16", 32), (4, 5, 750, "bf16", 32),
            (8, 5, 1500, "bf16", 32), (1, 16, 750, "bf16", 32),
            (1, 5, 300, "bf16", 32), (1, 5, 160, "bf16", 32),
            (1, 5, 40, "bf16", 32), (2, 5, 128, "f32", 4)):
        dt = torch.float32 if st == "f32" else torch.bfloat16
        shape = (n_layer, w, c, d)
        kc = torch.randn(shape, generator=gen, device="cuda").to(dt)
        vc = (torch.randn(shape, generator=gen, device="cuda") + 1).to(dt)
        q = (torch.randn((w * rep, d), generator=gen, device="cuda")
             * 0.125).to(dt)
        pos = torch.full((w * rep,), c - 1, dtype=torch.int32, device="cuda")
        row = {"shape": f"cross {st} W={w} R={rep} C={c}",
               "planned": KC.plan_splits(heads, w, rep, c)}
        for splits in (1, 2, 4, 8):
            row[f"ms_{splits}"] = time_ms(
                lambda: KC.decode_attention_stacked(
                    q, kc, vc, pos, 3 % n_layer, heads, kv_rep=rep,
                    splits=splits))
        rows.append(row)
        del kc, vc
    for b, c, st, bm in ((1, 750, "bf16", False), (2, 750, "bf16", False),
                         (4, 750, "bf16", False), (8, 750, "bf16", False),
                         (6, 750, "bf16", False), (16, 750, "bf16", False),
                         (1, 1500, "bf16", False), (4, 1500, "bf16", False),
                         (8, 1500, "bf16", False), (16, 1500, "bf16", False),
                         (1, 750, "int8", False),
                         (1, 750, "int4", False), (1, 300, "bf16", False),
                         (1, 160, "bf16", False), (5, 128, "bf16", True),
                         (1, 448, "bf16", True), (2, 128, "f32", False)):
        dt = torch.float32 if st == "f32" else torch.bfloat16
        n_layer = 4 if st == "f32" else 32
        shape = (b, n_layer, c, d) if bm else (n_layer, b, c, d)
        if st in ("int8", "int4"):
            kc, vc = (torch.randint(-7, 8, shape, generator=gen, device="cuda",
                                    dtype=torch.int8) for _ in "kv")
            if st == "int4":
                kc, vc = pack_int4(kc), pack_int4(vc)
        else:
            kc = torch.randn(shape, generator=gen, device="cuda").to(dt)
            vc = (torch.randn(shape, generator=gen, device="cuda") + 1).to(dt)
        q = (torch.randn((b, d), generator=gen, device="cuda")
             * 0.125).to(torch.bfloat16 if st in ("int8", "int4") else dt)
        pos = torch.full((b,), c - 1, dtype=torch.int32, device="cuda")
        row = {"shape": f"{'self' if bm else 'cross'} {st} B={b} C={c}",
               "planned": KC.plan_lane_splits(heads, b, c)}
        for splits in (1, 2, 4, 8):
            row[f"ms_{splits}"] = time_ms(
                lambda: KC.decode_attention_stacked(
                    q, kc, vc, pos, 3 % n_layer, heads, batch_major=bm,
                    splits=splits))
        rows.append(row)
        del kc, vc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
