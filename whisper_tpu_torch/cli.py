"""Command-line interface of the PyTorch/CUDA port.

    python -m whisper_tpu_torch.cli transcribe <model> <audio.wav> <lang> <out.txt>
    python -m whisper_tpu_torch.cli transcribe-many <model> <lang> <out dir> <wav...>

Keeps the reference's positional contract (whisper-burn
src/bin/transcribe/main.rs:85-94) and its progress lines, as
`whisper_tpu.cli transcribe` does: loads `<model>.cfg` + weights through
`io.checkpoint.load_params` and `tokenizer.json` (next to the model, then
the working directory), asserts 16 kHz audio unless `--resample`, writes
the transcription file. It decodes with beam search (`--beam-size`,
default 5) unless `--greedy`, on the CUDA card unless `--device cpu`:
without a card it exits non-zero rather than fall back to the CPU.
`--kv-quant` / `--self-quant` make the cross / self KV caches int8.
`transcribe-many` (as `whisper_tpu.cli transcribe-many`) decodes several
files' full windows together in batches of `--batch-size` and writes
`<stem>.txt` per input into the output directory.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def cmd_transcribe(argv) -> int:
    p = argparse.ArgumentParser(
        prog="whisper_tpu_torch transcribe",
        description="Transcribe a WAV file on the PyTorch/CUDA port "
                    "(reference CLI contract).")
    p.add_argument("model", help="model name: <name>.cfg + <name>.safetensors/"
                                 ".mpk.gz, or a npy dump directory")
    p.add_argument("audio", help="16 kHz mono WAV file")
    p.add_argument("lang", help="language code, e.g. en")
    p.add_argument("out", help="output transcription text file")
    p.add_argument("--tokenizer", default=None,
                   help="path to tokenizer.json (default: next to model, "
                        "then CWD)")
    p.add_argument("--greedy", action="store_true",
                   help="greedy decoding instead of beam search")
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--max-depth", type=int, default=100)
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 cross-KV cache (faster decode, tiny accuracy "
                        "cost)")
    p.add_argument("--self-quant", action="store_true",
                   help="int8 self-KV cache with per-row scales (the fused "
                        "beam reshuffle)")
    p.add_argument("--resample", action="store_true",
                   help="resample input to 16 kHz instead of rejecting it")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (default: the CUDA card; the "
                        "CPU only when asked for)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="weight dtype (default: bfloat16 on the card, whose "
                        "kernels take only bfloat16; float32 on the CPU)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("No CUDA device: whisper_tpu_torch runs on the card by "
              "default; pass --device cpu to run on the CPU.", file=sys.stderr)
        return 1

    from .config import SAMPLE_RATE, WhisperConfig
    from .io import checkpoint, native as wav_native, wav
    from .pipeline.transcribe import DecodeOptions, Transcriber
    from .text.tokenizer import LANGUAGES_V3, WhisperTokenizer

    logging.basicConfig(
        stream=sys.stderr, format="[%(asctime)s %(name)s %(levelname)s] "
        "%(message)s", datefmt="%H:%M:%S",
        level=[logging.WARNING, logging.INFO, logging.DEBUG][
            min(args.verbose, 2)])
    print("Loading waveform...")  # main.rs:109 contract
    try:
        waveform, rate = wav_native.load_audio(args.audio)
    except Exception as e:  # the CLI boundary: report, exit non-zero
        print(f"Failed to load audio file: {e}", file=sys.stderr)
        return 1
    if rate != SAMPLE_RATE:
        if not args.resample:
            print(f"The audio sample rate must be 16k (got {rate}); pass "
                  "--resample to convert.", file=sys.stderr)
            return 1
        waveform = wav.resample(waveform, rate, SAMPLE_RATE)
        rate = SAMPLE_RATE

    tok_path = args.tokenizer
    if tok_path is None:
        model_dir = os.path.dirname(os.path.abspath(args.model))
        cands = (os.path.join(model_dir, "tokenizer.json"), "tokenizer.json")
        tok_path = next((c for c in cands if os.path.exists(c)), None)
        if tok_path is None:
            print("Failed to load tokenizer: tokenizer.json not found",
                  file=sys.stderr)
            return 1
    try:
        tokenizer = WhisperTokenizer(tok_path)
    except Exception as e:
        print(f"Failed to load tokenizer: {e}", file=sys.stderr)
        return 1
    if args.lang not in LANGUAGES_V3:
        print(f"Invalid language abbreviation: {args.lang}", file=sys.stderr)
        return 1

    cfg_path = f"{args.model}.cfg"
    cfg = WhisperConfig.load(cfg_path) if os.path.exists(cfg_path) else None
    print("Loading model...")  # main.rs:134 contract
    try:
        params, cfg = checkpoint.load_params(args.model, cfg)
    except Exception as e:
        print(f"Failed to load whisper model file: {e}", file=sys.stderr)
        return 1

    device = args.device
    dtype_name = args.dtype or ("bfloat16" if device == "cuda" else "float32")
    dtype = getattr(torch, dtype_name)
    t0 = time.perf_counter()
    try:
        t = Transcriber(params, cfg, tokenizer, dtype=dtype, device=device)
    except ValueError as e:
        print(f"Failed to set up the model: {e}", file=sys.stderr)
        return 1
    text, _ = t.transcribe(waveform, rate, DecodeOptions(
        lang=args.lang, strategy="greedy" if args.greedy else "beam",
        beam_size=args.beam_size, max_depth=args.max_depth,
        kv_quant=args.kv_quant, self_quant=args.self_quant))
    dt = time.perf_counter() - t0
    with open(args.out, "w") as f:
        f.write(text)
    if args.verbose:
        audio_sec = len(waveform) / rate
        print(f"[{audio_sec:.1f}s audio in {dt:.1f}s on {device}]",
              file=sys.stderr)
    print("Transcription finished.")  # main.rs:159 contract
    return 0


def cmd_transcribe_many(argv) -> int:
    p = argparse.ArgumentParser(
        prog="whisper_tpu_torch transcribe-many",
        description="Batched multi-stream transcription on the PyTorch/CUDA "
                    "port: the full windows of N WAVs decode together.")
    p.add_argument("model")
    p.add_argument("lang")
    p.add_argument("out_dir", help="one <stem>.txt per input is written here")
    p.add_argument("wavs", nargs="+", help="16 kHz mono WAV files")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--resample", action="store_true")
    p.add_argument("--vad", action="store_true",
                   help="energy VAD pre-filter: silent windows never reach "
                        "the batch queue")
    p.add_argument("--vad-threshold-db", type=float, default=-40.0,
                   help="VAD silence threshold in dBFS (with --vad)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (default: the CUDA card; the "
                        "CPU only when asked for)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="weight dtype (default: bfloat16 on the card, "
                        "float32 on the CPU)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("No CUDA device: whisper_tpu_torch runs on the card by "
              "default; pass --device cpu to run on the CPU.", file=sys.stderr)
        return 1

    from .config import SAMPLE_RATE
    from .io import checkpoint, native as wav_native, wav
    from .pipeline.batch import BatchTranscriber
    from .pipeline.transcribe import DecodeOptions
    from .text.tokenizer import WhisperTokenizer

    logging.basicConfig(
        stream=sys.stderr, format="[%(asctime)s %(name)s %(levelname)s] "
        "%(message)s", datefmt="%H:%M:%S",
        level=[logging.WARNING, logging.INFO, logging.DEBUG][
            min(args.verbose, 2)])
    tok_path = args.tokenizer or os.path.join(
        os.path.dirname(os.path.abspath(args.model)), "tokenizer.json")
    tokenizer = WhisperTokenizer(tok_path)
    params, cfg = checkpoint.load_params(args.model)
    dtype_name = args.dtype or ("bfloat16" if args.device == "cuda"
                                else "float32")
    try:
        bt = BatchTranscriber(params, cfg, tokenizer,
                              batch_size=args.batch_size,
                              dtype=getattr(torch, dtype_name),
                              device=args.device)
    except ValueError as e:
        print(f"Failed to set up the model: {e}", file=sys.stderr)
        return 1

    waves = []
    for path in args.wavs:
        w, rate = wav_native.load_audio(path)
        if rate != SAMPLE_RATE:
            if not args.resample:
                print(f"{path}: sample rate must be 16k (got {rate}); "
                      "pass --resample.", file=sys.stderr)
                return 1
            w = wav.resample(w, rate, SAMPLE_RATE)
        waves.append(w)

    t0 = time.perf_counter()
    results = bt.transcribe_many(
        waves, SAMPLE_RATE,
        DecodeOptions(lang=args.lang,
                      strategy="greedy" if args.greedy else "beam",
                      beam_size=args.beam_size, vad=args.vad,
                      vad_threshold_db=args.vad_threshold_db))
    dt = time.perf_counter() - t0

    os.makedirs(args.out_dir, exist_ok=True)
    for path, (text, _toks) in zip(args.wavs, results):
        stem = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(args.out_dir, stem + ".txt"), "w") as f:
            f.write(text)
    audio_sec = sum(len(w) for w in waves) / SAMPLE_RATE
    print(f"Transcribed {len(waves)} files ({audio_sec:.0f}s audio) "
          f"in {dt:.1f}s ({audio_sec / dt:.1f}x RT) on {args.device}.")
    return 0


COMMANDS = {"transcribe": cmd_transcribe,
            "transcribe-many": cmd_transcribe_many}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m whisper_tpu_torch.cli transcribe <model> "
              "<audio> <lang> <out> [--greedy | --beam-size K] [--max-depth N]"
              " [--kv-quant] [--self-quant] [--resample] [--device cuda|cpu] "
              "[--dtype float32|bfloat16] [--tokenizer PATH]\n"
              "       python -m whisper_tpu_torch.cli transcribe-many <model> "
              "<lang> <out_dir> <wav...> [--greedy | --beam-size K] "
              "[--batch-size B] [--resample] [--vad] [--vad-threshold-db DB] "
              "[--device cuda|cpu] [--dtype float32|bfloat16] "
              "[--tokenizer PATH]", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
