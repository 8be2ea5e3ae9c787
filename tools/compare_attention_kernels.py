"""Run chip_smoke.py's kernel phase on one checkout of the port and print
its rows: every kernel, the ones redesigned for Hopper
(chip_smoke.REDESIGNED: K1, K9, K3g, K2, K3 with K3s and K8, K6 and K5)
first.

    python3 tools/compare_attention_kernels.py [--root DIR] [--label NAME]

Imports `whisper_tpu_torch` from DIR (default: this checkout), builds its
kernels (into DIR/build/) and runs this checkout's `chip_smoke.phase_kernels`
over it: every kernel against its plain version at chip_smoke's shapes,
with CUDA-event times of the kernel, its plain version and its library
call on the same inputs. Prints one JSON line {"label", "device", "rows":
{kernel: [row, ...]}} with the rows as chip_smoke records them. To compare two commits on one card, unpack the
other one (`git archive`) into a directory that .gitignore lists and run
the script on both, in turns: other, this, this, other. Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke  # this checkout's shapes and timer

    # the package under test; chip_smoke imports it only inside its phases
    sys.path.insert(0, os.path.abspath(args.root))
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    rows = chip_smoke.phase_kernels()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "device": smi,
                      "rows": {**{n: rows[n] for n in chip_smoke.REDESIGNED},
                               **rows}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
