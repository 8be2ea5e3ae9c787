"""Command-line interface of the PyTorch/CUDA port.

    python -m whisper_tpu_torch.cli transcribe <model> <audio.wav> <lang> <out.txt>
    python -m whisper_tpu_torch.cli transcribe-many <model> <lang> <out dir> <wav...>
    python -m whisper_tpu_torch.cli detect-lang <model> <audio.wav>
    python -m whisper_tpu_torch.cli eval <model> <dataset> [lang]
    python -m whisper_tpu_torch.cli quant-check <model>
    python -m whisper_tpu_torch.cli convert <dump dir> [--out NAME] [--mpk]
    python -m whisper_tpu_torch.cli convert-pt <model.pt> <out name>
    python -m whisper_tpu_torch.cli serve <model> [--port 8000] ...

Keeps the reference's positional contract (whisper-burn
src/bin/transcribe/main.rs:85-94) and its progress lines, as
`whisper_tpu.cli transcribe` does: loads `<model>.cfg` + weights through
`io.checkpoint.load_params` and `tokenizer.json` (next to the model, then
the working directory), asserts 16 kHz audio unless `--resample`, writes
the transcription file. It decodes with beam search (`--beam-size`,
default 5) unless `--greedy`, on the CUDA card unless `--device cpu`:
without a card it exits non-zero rather than fall back to the CPU.
`--kv-quant` / `--self-quant` make the cross / self KV caches int8. The
JAX CLI's other `transcribe` flags are kept with its error exits and
messages: `lang auto`, `--task`, `--temperature` (a comma list is the
fallback ladder), `--no-speech-threshold`, `--vad`, `--timestamps` with
`--json` / `--format {txt,json,srt,vtt,tsv}`, `--condition-on-previous-text`,
`--clip`, `--initial-prompt`, `--parallel-windows` (the batched path, its
fallback ladder with `--temperature a,b` or `--no-speech-threshold`) and
`--words` (word timings with `--timestamps`: a `words` list per JSON
segment, word lines in the text form, highlighted cues with `--format
vtt`) and `--draft MODEL --draft-k N` (speculative greedy decoding with a
smaller model sharing the tokenizer; requires `--greedy`, refused with
`--parallel-windows`). `detect-lang`
prints the JSON line of `whisper_tpu.cli detect-lang`.
`transcribe-many` (as `whisper_tpu.cli transcribe-many`) decodes several
files' full windows together in batches of `--batch-size` and writes
`<stem>.txt` per input into the output directory. `eval` (WER over a
LibriSpeech-layout directory or a manifest) and `quant-check` (the
quantization agreement gate: int8 weights and quantized caches against
the bf16 path on seeded audio, exit 1 unless tokens match) keep the JAX
commands' flags, JSON line and exit codes, plus `--device`. `convert`
(a npy dump tree to `<name>.safetensors` + `<name>.cfg`, `--mpk` adding
the reference's Burn `<name>.mpk.gz`) and `convert-pt` (an OpenAI or
HuggingFace `.pt`/`.bin` checkpoint to the same pair, `--dump-tree` adding
the npy tree, `--alignment-heads` the word-timing heads) run on the host
and write what `whisper_tpu.cli` writes, with its progress lines and exit
codes. `serve` runs the HTTP server of `whisper_tpu_torch.serve` (its
flags, `--device` included).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time


def _load_tokenizer(path, model: str):
    """The tokenizer at `path`, else tokenizer.json next to the model, then
    in the working directory; (tokenizer, None) or (None, error message)."""
    from .text.tokenizer import WhisperTokenizer

    if path is None:
        model_dir = os.path.dirname(os.path.abspath(model))
        cands = (os.path.join(model_dir, "tokenizer.json"), "tokenizer.json")
        path = next((c for c in cands if os.path.exists(c)), None)
        if path is None:
            return None, "Failed to load tokenizer: tokenizer.json not found"
    try:
        return WhisperTokenizer(path), None
    except Exception as e:  # the CLI boundary: report, exit non-zero
        return None, f"Failed to load tokenizer: {e}"


def _load_audio(path: str, resample: bool):
    """(waveform, 16000, None) or (None, None, error message)."""
    from .config import SAMPLE_RATE
    from .io import native as wav_native, wav

    try:
        waveform, rate = wav_native.load_audio(path)
    except Exception as e:  # the CLI boundary: report, exit non-zero
        return None, None, f"Failed to load audio file: {e}"
    if rate != SAMPLE_RATE:
        if not resample:
            return None, None, (f"The audio sample rate must be 16k (got "
                                f"{rate}); pass --resample to convert.")
        waveform = wav.resample(waveform, rate, SAMPLE_RATE)
    return waveform, SAMPLE_RATE, None


def _configure_logging(verbose: int) -> None:
    logging.basicConfig(
        stream=sys.stderr, format="[%(asctime)s %(name)s %(levelname)s] "
        "%(message)s", datefmt="%H:%M:%S",
        level=[logging.WARNING, logging.INFO, logging.DEBUG][min(verbose, 2)])


def _no_card(device: str) -> bool:
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("No CUDA device: whisper_tpu_torch runs on the card by "
              "default; pass --device cpu to run on the CPU.", file=sys.stderr)
        return True
    return False


def _add_device_args(p, what: str = "weight dtype") -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (default: the CUDA card; the "
                        "CPU only when asked for)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help=f"{what} (default: bfloat16 on the card, whose "
                        "kernels take only bfloat16; float32 on the CPU)")


def _dtype(args):
    import torch

    return getattr(torch, args.dtype or ("bfloat16" if args.device == "cuda"
                                         else "float32"))


def _segments_output(text, segments, out_format: str, words: bool) -> str:
    """The --timestamps output file (cli.py:279-317 of the JAX package);
    `words`: --words was given (vtt highlights each word)."""
    if out_format == "json":
        def seg_doc(seg):
            d = {"start": round(seg.start, 3), "end": round(seg.end, 3),
                 "text": seg.text}
            for key in ("avg_logprob", "compression_ratio", "no_speech_prob"):
                if getattr(seg, key) is not None:
                    d[key] = round(getattr(seg, key), 4)
            if seg.words is not None:
                d["words"] = [{"word": w.word, "start": round(w.start, 3),
                               "end": round(w.end, 3)} for w in seg.words]
            return d

        return json.dumps({"text": text,
                           "segments": [seg_doc(s) for s in segments]},
                          ensure_ascii=False, indent=1)
    if out_format in ("srt", "vtt", "tsv"):
        from .pipeline import formats

        if out_format == "vtt":
            return formats.to_vtt(segments, highlight_words=words)
        return {"srt": formats.to_srt,
                "tsv": formats.to_tsv}[out_format](segments)
    lines = []
    for seg in segments:
        lines.append(f"[{seg.start:.2f} -> {seg.end:.2f}] {seg.text}")
        lines += [f"  {w.word} [{w.start:.2f} -> {w.end:.2f}]"
                  for w in seg.words or ()]
    return "\n".join(lines)


def cmd_transcribe(argv) -> int:
    p = argparse.ArgumentParser(
        prog="whisper_tpu_torch transcribe",
        description="Transcribe a WAV file on the PyTorch/CUDA port "
                    "(reference CLI contract).")
    p.add_argument("model", help="model name: <name>.cfg + <name>.safetensors/"
                                 ".mpk.gz, or a npy dump directory")
    p.add_argument("audio", help="16 kHz mono WAV file")
    p.add_argument("lang", help="language code, e.g. en, or 'auto' to "
                                "detect the spoken language (multilingual "
                                "models)")
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
    p.add_argument("--task", choices=["transcribe", "translate"],
                   default="transcribe",
                   help="translate: X->English translation (multilingual "
                        "models; the <|translate|> task token)")
    p.add_argument("--temperature", default="0",
                   help="decode temperature; a comma list (e.g. "
                        "'0,0.2,0.4,0.6,0.8,1.0') enables the quality "
                        "fallback ladder (compression-ratio + logprob "
                        "checks; sampling at temps > 0)")
    p.add_argument("--no-speech-threshold", type=float, default=None,
                   help="skip windows whose p(<|nospeech|>) exceeds this "
                        "and whose logprob check failed")
    p.add_argument("--vad", action="store_true",
                   help="energy VAD pre-filter: skip windows with < 100 ms "
                        "of audio above the threshold before any device work")
    p.add_argument("--vad-threshold-db", type=float, default=-40.0,
                   help="VAD energy threshold in dBFS (default -40)")
    p.add_argument("--timestamps", action="store_true",
                   help="write '[start -> end] text' segment lines instead "
                        "of plain text (timestamped decoding)")
    p.add_argument("--words", action="store_true",
                   help="with --timestamps: per-word timings "
                        "(cross-attention DTW alignment) as "
                        "'  word [start -> end]' lines, a words list per "
                        "JSON segment, highlighted cues with --format vtt")
    p.add_argument("--json", action="store_true",
                   help="with --timestamps: a JSON document {text, "
                        "segments} (alias for --format json)")
    p.add_argument("--format", choices=["txt", "json", "srt", "vtt", "tsv"],
                   default=None, dest="out_format",
                   help="output format; srt/vtt/tsv/json require "
                        "--timestamps (vtt + --words emits per-word "
                        "highlight cues)")
    p.add_argument("--condition-on-previous-text", action="store_true",
                   help="feed each window the previously decoded text as "
                        "<|startofprev|> context")
    p.add_argument("--clip", default=None, metavar="S0,E0[,S1,E1...]",
                   help="transcribe only these time ranges (seconds); an "
                        "odd count leaves the last clip open-ended")
    p.add_argument("--initial-prompt", default=None,
                   help="condition the decoder on this text via "
                        "<|startofprev|>; applied to every window, stripped "
                        "from the output")
    p.add_argument("--parallel-windows", action="store_true",
                   help="decode all windows of the file as one batch "
                        "(BatchTranscriber; identical output; a temperature "
                        "list runs the batched fallback ladder)")
    p.add_argument("--draft", default=None, metavar="MODEL",
                   help="speculative decoding (with --greedy): a smaller "
                        "model sharing the tokenizer (e.g. multilingual "
                        "tiny for large-v2) drafts tokens, the main model "
                        "verifies them in one step -- identical output, "
                        "fewer large-model steps on the B=1 latency path")
    p.add_argument("--draft-k", type=int, default=4,
                   help="speculative block size: 1 committed + k-1 drafted "
                        "tokens per verify step (default 4)")
    p.add_argument("--resample", action="store_true",
                   help="resample input to 16 kHz instead of rejecting it")
    _add_device_args(p)
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)

    if _no_card(args.device):
        return 1

    from .config import WhisperConfig
    from .io import checkpoint
    from .pipeline.transcribe import (DecodeOptions, Transcriber,
                                      parse_clip_timestamps)
    from .text.tokenizer import LANGUAGES_V3

    _configure_logging(args.verbose)
    print("Loading waveform...")  # main.rs:109 contract
    waveform, rate, err = _load_audio(args.audio, args.resample)
    if err is None:
        tokenizer, err = _load_tokenizer(args.tokenizer, args.model)
    if err is not None:
        print(err, file=sys.stderr)
        return 1

    cfg_path = f"{args.model}.cfg"
    cfg = WhisperConfig.load(cfg_path) if os.path.exists(cfg_path) else None
    print("Loading model...")  # main.rs:134 contract
    try:
        params, cfg = checkpoint.load_params(args.model, cfg)
    except Exception as e:
        print(f"Failed to load whisper model file: {e}", file=sys.stderr)
        return 1
    draft = None
    if args.draft is not None:
        if not args.greedy:
            print("--draft requires --greedy (speculative decoding is "
                  "exact only at temperature-0 greedy)", file=sys.stderr)
            return 1
        if args.parallel_windows:
            print("--draft is incompatible with --parallel-windows "
                  "(speculative decoding is the B=1 latency path)",
                  file=sys.stderr)
            return 1
        d_cfg_path = f"{args.draft}.cfg"
        d_cfg = (WhisperConfig.load(d_cfg_path)
                 if os.path.exists(d_cfg_path) else None)
        try:
            draft = checkpoint.load_params(args.draft, d_cfg)
        except Exception as e:
            print(f"Failed to load draft model file: {e}", file=sys.stderr)
            return 1
    if args.lang != "auto" and args.lang not in LANGUAGES_V3:
        print(f"Invalid language abbreviation: {args.lang}", file=sys.stderr)
        return 1

    try:
        t = Transcriber(params, cfg, tokenizer, dtype=_dtype(args),
                        device=args.device, draft=draft,
                        draft_k=args.draft_k)
    except ValueError as e:
        print(f"Failed to set up the model: {e}", file=sys.stderr)
        return 1
    if args.lang == "auto":
        try:
            code, dist = t.detect_language(waveform, rate)
        except ValueError as e:
            print(f"Language detection failed: {e}", file=sys.stderr)
            return 1
        print(f"Detected language: {code} (p={dist[code]:.2f})")
        args.lang = code
    opts = DecodeOptions(
        lang=args.lang, task=args.task,
        strategy="greedy" if args.greedy else "beam",
        beam_size=args.beam_size, max_depth=args.max_depth,
        kv_quant=args.kv_quant, self_quant=args.self_quant,
        initial_prompt=args.initial_prompt,
        condition_on_previous_text=args.condition_on_previous_text,
        temperature=(tuple(float(x) for x in args.temperature.split(","))
                     if "," in args.temperature
                     else float(args.temperature)),
        no_speech_threshold=args.no_speech_threshold,
        clip_timestamps=args.clip, vad=args.vad,
        vad_threshold_db=args.vad_threshold_db)
    if args.clip:
        try:
            parse_clip_timestamps(args.clip, len(waveform) / rate)
        except ValueError as e:
            print(f"Bad --clip: {e}", file=sys.stderr)
            return 1
    for flag, on, why in (
            ("--clip", args.clip, ""),
            ("--condition-on-previous-text", args.condition_on_previous_text,
             " (windows must decode sequentially)"),
            ("--timestamps", args.timestamps, "")):
        if on and args.parallel_windows:
            print(f"{flag} is incompatible with --parallel-windows{why}",
                  file=sys.stderr)
            return 1
    out_format = args.out_format or ("json" if args.json else "txt")
    if out_format != "txt" and not args.timestamps:
        print(f"--format {out_format} requires --timestamps", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if args.timestamps:
        text, segments = t.transcribe_with_timestamps(
            waveform, rate, opts, word_timestamps=args.words)
        text = _segments_output(text, segments, out_format, args.words)
    elif args.parallel_windows:
        from .pipeline.batch import BatchTranscriber

        bt = BatchTranscriber(t.params, cfg, tokenizer, device=args.device)
        (text, _), = bt.transcribe_many([waveform], rate, opts)
    else:
        text, _ = t.transcribe(waveform, rate, opts)
    dt = time.perf_counter() - t0
    with open(args.out, "w") as f:
        f.write(text)
    if args.verbose:
        audio_sec = len(waveform) / rate
        print(f"[{audio_sec:.1f}s audio in {dt:.1f}s on {args.device}]",
              file=sys.stderr)
    print("Transcription finished.")  # main.rs:159 contract
    return 0


def cmd_detect_lang(argv) -> int:
    p = argparse.ArgumentParser(
        prog="whisper_tpu_torch detect-lang",
        description="Identify the spoken language of an audio file "
                    "(multilingual models); scans for speech-bearing "
                    "windows (energy VAD). Prints a JSON line "
                    "{language, probs: {code: p, ...top-k}}.")
    p.add_argument("model", help="checkpoint (.safetensors/.cfg, npy dir, "
                                 "or .mpk.gz)")
    p.add_argument("audio", help="16 kHz mono WAV/FLAC file")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--resample", action="store_true")
    p.add_argument("--top", type=int, default=5,
                   help="number of candidate languages to report")
    p.add_argument("--vote-windows", type=int, default=1,
                   help="average the distribution over up to this many "
                        "speech-bearing windows")
    _add_device_args(p)
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)

    if _no_card(args.device):
        return 1
    from .io import checkpoint
    from .pipeline.transcribe import Transcriber

    _configure_logging(args.verbose)
    waveform, rate, err = _load_audio(args.audio, args.resample)
    if err is None:
        tok, err = _load_tokenizer(args.tokenizer, args.model)
    if err is not None:
        print(err, file=sys.stderr)
        return 1
    params, cfg = checkpoint.load_params(args.model)
    try:
        t = Transcriber(params, cfg, tok, dtype=_dtype(args),
                        device=args.device)
        code, dist = t.detect_language(waveform, rate,
                                       vote_windows=args.vote_windows)
    except ValueError as e:
        print(f"Language detection failed: {e}", file=sys.stderr)
        return 1
    top = sorted(dist.items(), key=lambda kv: -kv[1])[:max(1, args.top)]
    print(json.dumps({"language": code,
                      "probs": {c: round(p, 4) for c, p in top}}))
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
    _add_device_args(p)
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)

    if _no_card(args.device):
        return 1
    from .config import SAMPLE_RATE
    from .io import checkpoint, native as wav_native, wav
    from .pipeline.batch import BatchTranscriber
    from .pipeline.transcribe import DecodeOptions
    from .text.tokenizer import WhisperTokenizer

    _configure_logging(args.verbose)
    tok_path = args.tokenizer or os.path.join(
        os.path.dirname(os.path.abspath(args.model)), "tokenizer.json")
    tokenizer = WhisperTokenizer(tok_path)
    params, cfg = checkpoint.load_params(args.model)
    try:
        bt = BatchTranscriber(params, cfg, tokenizer,
                              batch_size=args.batch_size, dtype=_dtype(args),
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


def cmd_eval(argv) -> int:
    p = argparse.ArgumentParser(
        prog="whisper_tpu_torch eval",
        description="WER evaluation over a local dataset (LibriSpeech layout "
                    "or manifest file) on the PyTorch/CUDA port.")
    p.add_argument("model")
    p.add_argument("dataset", help="LibriSpeech-style directory, or a "
                                   ".tsv/.jsonl manifest (audio<TAB>text)")
    p.add_argument("lang", nargs="?", default="en")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--basic-normalizer", action="store_true",
                   help="language-agnostic normalization instead of the "
                        "OpenAI-style English rules")
    _add_device_args(p)
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)

    if _no_card(args.device):
        return 1
    from .config import SAMPLE_RATE
    from .eval import wer as werlib
    from .io import checkpoint, native as wav_native, wav
    from .pipeline.transcribe import DecodeOptions, Transcriber
    from .text.tokenizer import WhisperTokenizer

    _configure_logging(args.verbose)
    tok_path = args.tokenizer or os.path.join(
        os.path.dirname(os.path.abspath(args.model)), "tokenizer.json")
    tokenizer = WhisperTokenizer(tok_path)
    params, cfg = checkpoint.load_params(args.model)
    t = Transcriber(params, cfg, tokenizer, dtype=_dtype(args),
                    device=args.device)
    opts = DecodeOptions(lang=args.lang,
                         strategy="greedy" if args.greedy else "beam")

    def transcribe_path(path: str) -> str:
        waveform, rate = wav_native.load_audio(path)  # WAV or FLAC
        if rate != SAMPLE_RATE:
            waveform = wav.resample(waveform, rate, SAMPLE_RATE)
        text, _ = t.transcribe(waveform, SAMPLE_RATE, opts,
                               on_chunk=lambda *a: None)
        return text

    if os.path.isdir(args.dataset):
        items = werlib.iter_librispeech(args.dataset)
    else:
        items = werlib.iter_manifest(args.dataset)

    def progress(i, audio, ref, hyp, res):
        print(f"[{i}] WER so far: {res.wer:.4f} ({res.errors}/{res.words})",
              file=sys.stderr)

    result = werlib.evaluate(transcribe_path, items, limit=args.limit,
                             on_item=progress if args.verbose else None,
                             english=not args.basic_normalizer)
    print(json.dumps({"wer": round(result.wer, 5), "errors": result.errors,
                      "words": result.words,
                      "utterances": result.utterances}))
    return 0


def cmd_quant_check(argv) -> int:
    p = argparse.ArgumentParser(
        prog="whisper_tpu_torch quant-check",
        description="Quantization agreement gate: decode with int8 weights "
                    "(+ optional int8 cross-KV) vs the bf16 reference path "
                    "on fixed synthetic inputs; fails unless tokens match.")
    p.add_argument("model", help="checkpoint (.safetensors/.cfg, npy dir, "
                                 "or .mpk.gz)")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--kv", choices=["int8", "int4", "none"], default="int8",
                   help="also quantize the cross-attention KV cache")
    p.add_argument("--self-kv", choices=["int8", "none"], default="int8",
                   help="also quantize the self-attention KV cache")
    p.add_argument("--windows", type=int, default=8)
    p.add_argument("--max-depth", type=int, default=32)
    p.add_argument("--min-token-match", type=float, default=0.99)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (default: the CUDA card, "
                        "through the port's kernels; the CPU, on the plain "
                        "path, only when asked for)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)

    if _no_card(args.device):
        return 1
    import dataclasses

    import torch

    from .eval import agreement
    from .io import checkpoint
    from .params import from_numpy_tree
    from .quantize import quantize_params
    from .text.tokenizer import WhisperTokenizer

    _configure_logging(args.verbose)
    tree, cfg = checkpoint.load_params(args.model)
    # bf16 weights, as the JAX command casts them; the kernels on the card
    params = from_numpy_tree(tree, args.device, torch.bfloat16)
    cfg = dataclasses.replace(
        cfg, attention="flash" if args.device == "cuda" else "xla")
    tok_path = args.tokenizer or os.path.join(
        os.path.dirname(os.path.abspath(args.model)), "tokenizer.json")
    if os.path.exists(tok_path):
        tok = WhisperTokenizer(tok_path)
        prompt = tok.prompt_ids("en")
        suppress = tok.suppress_mask()
        eot = tok.eot
    else:  # no tokenizer next to the weights: structural ids still gate
        print(f"# no tokenizer at {tok_path}; using synthetic prompt",
              file=sys.stderr)
        v = cfg.text_decoder_config.n_vocab
        prompt, suppress, eot = [v - 8, v - 7, v - 6, v - 5], None, v - 1

    report = agreement.decode_agreement(
        params, quantize_params(params), cfg, eot_id=eot, prompt=prompt,
        suppress_mask=suppress, max_depth=args.max_depth,
        n_windows=args.windows,
        kv_quant_test=False if args.kv == "none" else args.kv,
        self_quant_test=args.self_kv == "int8")
    print(json.dumps(report))
    try:
        agreement.gate(report, min_token_match=args.min_token_match)
    except AssertionError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("PASS", file=sys.stderr)
    return 0


def cmd_convert(argv) -> int:
    p = argparse.ArgumentParser(
        prog="whisper_tpu_torch convert",
        description="Convert a npy dump tree to the fast-load format "
                    "(reference convert CLI parity; runs on the host).")
    p.add_argument("dump_dir", help="npy dump directory (python/dump.py "
                                    "output)")
    p.add_argument("--out", default=None,
                   help="output basename (default: <dump_dir>)")
    p.add_argument("--mpk", action="store_true",
                   help="also write the reference's Burn <name>.mpk.gz "
                        "record (convert main.rs:17-19 output)")
    args = p.parse_args(argv)

    from .io import checkpoint, mpk, npy_tree

    name = args.out or args.dump_dir.rstrip("/")
    try:
        params, cfg = npy_tree.load_whisper(args.dump_dir)
    except Exception as e:  # the CLI boundary: report, exit non-zero
        print(f"Error loading model {args.dump_dir}: {e}", file=sys.stderr)
        return 1
    print("Saving model...")  # convert main.rs:44 contract
    checkpoint.save_safetensors(params, cfg, f"{name}.safetensors")
    if args.mpk:
        mpk.save_whisper_record(params, cfg, f"{name}.mpk.gz")
    print("Saving config...")  # convert main.rs:50 contract
    cfg.save(f"{name}.cfg")
    print("Finished.")  # convert main.rs:56 contract
    return 0


def _alignment_heads_arg(value: str):
    """--alignment-heads: JSON [[layer, head], ...] or a path to a JSON
    file (an HF generation_config.json gives its `alignment_heads` key);
    (heads, None) or (None, error message)."""
    try:
        if os.path.exists(value):
            with open(value) as f:
                heads = json.load(f)
            if isinstance(heads, dict):  # a generation_config.json
                heads = heads.get("alignment_heads")
                if heads is None:
                    return None, f"{value}: no alignment_heads key"
            return heads, None
        return json.loads(value), None
    except ValueError as e:
        return None, f"Bad --alignment-heads: {e}"


def cmd_convert_pt(argv) -> int:
    p = argparse.ArgumentParser(
        prog="whisper_tpu_torch convert-pt",
        description="Convert an OpenAI or HuggingFace Whisper .pt/.bin "
                    "checkpoint (replaces the reference's python/dump.py + "
                    "convert_huggingface_model.py; runs on the host).")
    p.add_argument("pt_file", help="OpenAI {dims, model_state_dict} .pt or "
                                   "HF pytorch_model.bin")
    p.add_argument("out", help="output basename: writes <out>.safetensors "
                               "+ <out>.cfg")
    p.add_argument("--dump-tree", action="store_true",
                   help="also write the reference-format npy dump tree at "
                        "<out>/")
    p.add_argument("--alignment-heads", default=None, metavar="JSON",
                   help="word-timing alignment heads as JSON [[layer, head],"
                        " ...] or a path to a JSON file (e.g. an HF "
                        "generation_config.json); auto-detected from a "
                        "sibling generation_config.json when omitted. "
                        "OpenAI .pt files do not embed the mask -- pass it "
                        "here for best word timestamps.")
    args = p.parse_args(argv)

    from .io import checkpoint, convert_pt, npy_tree

    heads = None
    if args.alignment_heads:
        heads, err = _alignment_heads_arg(args.alignment_heads)
        if err is not None:
            print(err, file=sys.stderr)
            return 1
    try:
        params, cfg = convert_pt.load_pt(args.pt_file, alignment_heads=heads)
    except Exception as e:  # the CLI boundary: report, exit non-zero
        print(f"Error loading checkpoint {args.pt_file}: {e}", file=sys.stderr)
        return 1
    if cfg.alignment_heads:
        print(f"Alignment heads: {len(cfg.alignment_heads)} baked "
              "(word timings will use them)")
    print("Saving model...")
    checkpoint.save_safetensors(params, cfg, f"{args.out}.safetensors")
    print("Saving config...")
    cfg.save(f"{args.out}.cfg")
    if args.dump_tree:
        print("Saving npy dump tree...")
        npy_tree.save_whisper(params, cfg, args.out)
    print("Finished.")
    return 0


def cmd_serve(argv) -> int:
    """The HTTP server (`whisper_tpu_torch.serve.main`)."""
    from .serve import main as serve_main

    return serve_main(argv)


COMMANDS = {"transcribe": cmd_transcribe,
            "transcribe-many": cmd_transcribe_many,
            "detect-lang": cmd_detect_lang,
            "eval": cmd_eval,
            "quant-check": cmd_quant_check,
            "convert": cmd_convert,
            "convert-pt": cmd_convert_pt, "serve": cmd_serve}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m whisper_tpu_torch.cli transcribe <model> "
              "<audio> <lang|auto> <out> [--greedy | --beam-size K] "
              "[--max-depth N] [--task transcribe|translate] [--temperature "
              "T[,T...]] [--no-speech-threshold P] [--vad] "
              "[--vad-threshold-db DB] [--timestamps [--words] [--json | "
              "--format "
              "txt|json|srt|vtt|tsv]] [--condition-on-previous-text] "
              "[--clip S0,E0,...] [--initial-prompt TEXT] "
              "[--parallel-windows] [--draft MODEL [--draft-k N]] "
              "[--kv-quant] [--self-quant] [--resample] "
              "[--device cuda|cpu] [--dtype float32|bfloat16] "
              "[--tokenizer PATH]\n"
              "       python -m whisper_tpu_torch.cli transcribe-many <model> "
              "<lang> <out_dir> <wav...> [--greedy | --beam-size K] "
              "[--batch-size B] [--resample] [--vad] [--vad-threshold-db DB] "
              "[--device cuda|cpu] [--dtype float32|bfloat16] "
              "[--tokenizer PATH]\n"
              "       python -m whisper_tpu_torch.cli detect-lang <model> "
              "<audio> [--top N] [--vote-windows N] [--resample] "
              "[--device cuda|cpu] [--dtype float32|bfloat16] "
              "[--tokenizer PATH]\n"
              "       python -m whisper_tpu_torch.cli eval <model> <dataset> "
              "[lang] [--greedy] [--limit N] [--basic-normalizer] "
              "[--device cuda|cpu] [--dtype float32|bfloat16] "
              "[--tokenizer PATH]\n"
              "       python -m whisper_tpu_torch.cli quant-check <model> "
              "[--kv int8|int4|none] [--self-kv int8|none] [--windows N] "
              "[--max-depth N] [--min-token-match R] [--device cuda|cpu] "
              "[--tokenizer PATH]\n"
              "       python -m whisper_tpu_torch.cli convert <dump dir> "
              "[--out NAME] [--mpk]\n"
              "       python -m whisper_tpu_torch.cli convert-pt <model.pt> "
              "<out name> [--dump-tree] [--alignment-heads JSON|PATH]\n"
              "       python -m whisper_tpu_torch.cli serve <model> "
              "[--port N] [--batch-size B] [--device cuda|cpu] ...",
              file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
