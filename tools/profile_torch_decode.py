"""Where a decode step's time goes on the card, for the PyTorch port.

    python3 tools/profile_torch_decode.py [--depth 30] [--root DIR]

Large-v2 bf16 with random weights from a seed, one 14.9 s window of
synthetic audio (the chip_smoke slice's first window): the encoder once,
then greedy decoding and beam search (5 beams) of `--depth` steps each,
after a warm-up run of each; then the same two over int8 weight-only
`quantize_params` of those weights with quantized caches (greedy: int8
cross and self caches; beam: the bench's int4 cross and int8 self
caches, through the fused reshuffle), first with the dequant-in-matmul
products (int8_impl="xla"), then with the W8A8 kernels K6/K7
(int8_impl="pallas", encoder weights int8 too); then the W8A8 beam over
4 windows at once (`beam_search_batched`, 20 lanes: the full windows of
chip_smoke's two 35 s streams); last greedy and beam over packed-int4
weights under int8_impl="pallas" with int4 cross and self caches (K6, K3
/ K3g over int4, K3s and K5 over the int4 self cache). Each decode runs once under the host clock
alone and once under `torch.profiler`; the profile gives the device time
per kernel name, the number of kernel launches (in all and by kernel
name), and the device's busy
share (summed kernel time over the host-clock wall time of the unprofiled
run; kernels do not overlap on one stream). Prints one JSON line per
decoder. Then the encoder alone, once under the host clock and once
profiled the same way: one window and the 4 full windows batched, bf16
and W8A8 (int8 weights, int8_impl="pallas": K6 at one window's 750 rows,
K7 at four windows' 3000), one JSON line each with its device ms and
launches per window. `--root` imports `whisper_tpu_torch` from another
checkout (default: this one), so two commits can be profiled by the same
script in one call. Needs a CUDA card; it exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=30)
    ap.add_argument("--root", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device", file=sys.stderr)
        return 1
    if args.root:  # the package under test; chip_smoke's helpers import it
        sys.path.insert(0, os.path.abspath(args.root))

    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SEED, _full_windows, _window_mel, synthetic_speech
    from whisper_tpu_torch.config import KernelKnobs, preset
    from whisper_tpu_torch.decode.beam import beam_search, beam_search_batched
    from whisper_tpu_torch.decode.greedy import greedy_decode
    from whisper_tpu_torch.models.whisper import encoder_forward
    from whisper_tpu_torch.ops.audio import max_waveform_samples, prep_audio
    from whisper_tpu_torch.params import init_params
    from whisper_tpu_torch.quantize import quantize_params
    from whisper_tpu_torch.text.tokenizer import (
        WhisperTokenizer, build_full_scale_tokenizer_json)

    from whisper_tpu_torch.ops.kernels._build import BUILD_DIR
    from whisper_tpu_torch.pipeline.transcribe import DecodeOptions

    cfg = dataclasses.replace(preset("large-v2"), attention="flash")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tok_path = str(BUILD_DIR / "tokenizer_large_v2.json")
    build_full_scale_tokenizer_json(tok_path)
    tok = WhisperTokenizer(tok_path)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         dtype=torch.bfloat16)
    n = max_waveform_samples(cfg.encoder_ctx_size - 10)
    wave = torch.from_numpy(synthetic_speech(n, SEED)).cuda()[None]
    suppress = torch.as_tensor(tok.suppress_mask(), device="cuda")
    prompt = torch.tensor(tok.prompt_ids("en"), device="cuda")
    with torch.inference_mode():
        mel = prep_audio(wave)
        mel = torch.nn.functional.pad(mel[:, :, :cfg.encoder_ctx_size - 10],
                                      (0, 10))
        enc = encoder_forward(params, mel, cfg)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    common = dict(eot_id=tok.eot, suppress_mask=suppress,
                  max_depth=args.depth)
    qparams = quantize_params(params, bits=8)
    wparams = quantize_params(params, quantize_encoder=True, bits=8)
    w4params = quantize_params(params, quantize_encoder=True, bits=4)
    w8a8 = dataclasses.replace(cfg, knobs=KernelKnobs(int8_impl="pallas"))
    waves = [synthetic_speech(35 * 16000, SEED + s) for s in (0, 1)]
    with torch.inference_mode():
        enc4 = encoder_forward(wparams, _window_mel(
            _full_windows(waves, cfg, DecodeOptions()), cfg,
            DecodeOptions()), w8a8)
    runs = {"greedy": lambda: greedy_decode(params, enc, prompt, cfg,
                                            **common),
            "beam5": lambda: beam_search(params, enc, prompt, cfg,
                                         beam_size=5, **common),
            "greedy_int8": lambda: greedy_decode(
                qparams, enc, prompt, cfg, kv_quant=True, self_quant=True,
                **common),
            "beam5_int8_int4kv": lambda: beam_search(
                qparams, enc, prompt, cfg, beam_size=5, kv_quant="int4",
                self_quant=True, **common),
            "greedy_w8a8": lambda: greedy_decode(
                wparams, enc, prompt, w8a8, kv_quant=True, self_quant=True,
                **common),
            "beam5_w8a8_int4kv": lambda: beam_search(
                wparams, enc, prompt, w8a8, beam_size=5, kv_quant="int4",
                self_quant=True, **common),
            "beam5_w8a8_int4kv_4windows": lambda: beam_search_batched(
                wparams, enc4, prompt, w8a8, beam_size=5, kv_quant="int4",
                self_quant=True, **common),
            "greedy_w4a8_int4kv_int4self": lambda: greedy_decode(
                w4params, enc, prompt, w8a8, kv_quant="int4",
                self_quant="int4", **common),
            "beam5_w4a8_int4kv_int4self": lambda: beam_search(
                w4params, enc, prompt, w8a8, beam_size=5, kv_quant="int4",
                self_quant="int4", **common)}
    def measure(fn):
        """(wall s of an unprofiled run, device events of a profiled one),
        after a warm-up run."""
        with torch.inference_mode():
            fn()  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        # the device-side rows: kernels, copies and sets themselves (an
        # aten op's row also carries its kernels' time, so it is left out)
        return wall, [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]

    for name, fn in runs.items():
        wall, events = measure(fn)
        device_us = sum(e.self_device_time_total for e in events)
        launches = sum(e.count for e in events)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        print(json.dumps({
            "decoder": name, "steps": args.depth, "wall_ms": wall * 1e3,
            "wall_ms_per_step": wall * 1e3 / args.depth,
            "device_ms": device_us / 1e3,
            "device_ms_per_step": device_us / 1e3 / args.depth,
            "device_busy_share": device_us / 1e6 / wall,
            "kernel_launches": launches,
            "launches_per_step": launches / args.depth,
            "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                               for e in top},
            "launches_by_kernel": {e.key[:80]: e.count for e in sorted(
                events, key=lambda e: -e.count)}}), flush=True)
    with torch.inference_mode():
        mel4 = _window_mel(_full_windows(waves, cfg, DecodeOptions()), cfg,
                           DecodeOptions())
    for name, p, c in (("bf16", params, cfg), ("w8a8", wparams, w8a8)):
        for windows, m in ((1, mel), (4, mel4)):
            wall, events = measure(lambda: encoder_forward(p, m, c))
            device_us = sum(e.self_device_time_total for e in events)
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
            print(json.dumps({
                "encoder": name, "windows": windows, "wall_ms": wall * 1e3,
                "device_ms": device_us / 1e3,
                "device_ms_per_window": device_us / 1e3 / windows,
                "kernel_launches": sum(e.count for e in events),
                "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                                   for e in top}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
