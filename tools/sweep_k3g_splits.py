"""Time K3g (grouped cross attention) at every cluster size on the card.

    python3 tools/sweep_k3g_splits.py

Large-v2 widths (20 heads of 64), beam lanes R against W windows' cross
caches of Sa rows, every row visible, layer 3 of a 32-layer stack (4 for
the f32 cache). For each shape: the device ms of one call with the cluster
size forced to 1, 2, 4 and 8 (`decode_attention_stacked(...,
splits=)`; CUDA events around a replayed CUDA graph,
chip_smoke.py's `time_ms`), and the size `plan_splits` picks. The data
behind `ops/kernels/decode_attention.py::plan_splits`. Prints one JSON
line. Needs a CUDA card and nvcc.
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
