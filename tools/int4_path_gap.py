"""Find which int4 storage widens the gap between the port's kernel path
and its plain path on chip_smoke's int4 agreement window.

    python3 tools/int4_path_gap.py

Large-v2 with chip_smoke's seeded random weights and its first window of
synthetic audio, int8_impl="pallas" and an int4 cross cache throughout.
For the weights quantized to int4 or int8 (encoder too) and a self cache
of int4, int8 or bf16, runs chip_smoke's `compare_kernel_and_plain_paths`
(prefill + 8 greedy steps, the kernel path's tokens fed to both paths)
twice: each path on its own encoder output, and both decoders on the
kernel path's. Prints one JSON line per configuration with the relative
L2s (encoder, prefill logits, worst step logits), then the card's name
and power limit. Nothing is held to a limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    import chip_smoke
    import torch

    from whisper_tpu_torch.config import KernelKnobs
    from whisper_tpu_torch.ops import audio
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions
    from whisper_tpu_torch.quantize import quantize_params

    chip_smoke.phase_device()
    chip_smoke.phase_build()
    params, tr, wave = chip_smoke.slice_setup()
    cfg = dataclasses.replace(tr.cfg, knobs=KernelKnobs(int8_impl="pallas"))
    for bits in (4, 8):
        qparams = quantize_params(params, quantize_encoder=True, bits=bits)
        for self_quant in ("int4", "int8", False):
            opts = DecodeOptions(kv_quant="int4", self_quant=self_quant)
            window = wave[:audio.max_waveform_samples(
                cfg.encoder_ctx_size - opts.padding)]
            res = {}
            for shared in (False, True):
                res["shared_encoder" if shared else "own_encoder"] = \
                    chip_smoke.compare_kernel_and_plain_paths(
                        qparams, cfg, tr.tok, window, opts,
                        shared_encoder=shared, limit=None,
                        label=f"weights int{bits}, self cache "
                              f"{self_quant or 'bf16'}, "
                              + ("shared" if shared else "own")
                              + " encoder output")
            print(json.dumps({"weights": f"int{bits}", "cross_cache": "int4",
                              "self_cache": self_quant or "bf16", **res}),
                  flush=True)
        del qparams
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
