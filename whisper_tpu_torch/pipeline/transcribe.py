"""Long-form transcription: windowing, per-window decode, stitching.

Counterpart of `whisper_tpu/pipeline/transcribe.py` (reference:
whisper-burn `src/transcribe.rs`) for the beam (the default) and greedy
paths at temperature 0: ~14.9 s windows
(`max_waveform_samples(encoder_ctx - 10)` samples) with a 3 s overlap,
each window's mel clipped to (encoder_ctx - padding) frames and
zero-padded by `padding` frames, the [SOT, lang, task, notimestamps]
prompt, suppression while seq len <= 5, token-overlap stitching, and the
`Chunk {i}: {text}` progress contract.

The JAX pipeline dispatches window i+1 before fetching window i; this port
runs windows one after another (the result is the same: windows are
independent unless `condition_on_previous_text` chains them). Options of
`DecodeOptions` that the port does not cover yet raise
NotImplementedError naming their ROADMAP item -- none is silently
ignored.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SAMPLE_RATE, WhisperConfig
from ..decode.beam import beam_search
from ..decode.greedy import greedy_decode
from ..models.whisper import encoder_forward
from ..ops.audio import max_waveform_samples, prep_audio
from ..params import ParamTree, from_numpy_tree
from . import vad

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Decoding knobs: the fields and defaults of the JAX package's
    `DecodeOptions` (redefined because that module imports jax): beam
    search with 5 beams by default, or strategy="greedy"."""

    lang: str = "en"
    task: str = "transcribe"
    strategy: str = "beam"
    beam_size: int = 5
    max_depth: int = 100
    padding: int = 10
    chunk_overlap_seconds: float = 3.0
    stitch_max_offsets: int = 40
    stitch_min_overlaps: int = 3
    suppress_until_len: int = 5
    timestamps: bool = False
    max_initial_timestamp: float = 1.0
    kv_quant: bool = False  # cross-KV cache quant: True/"int8", or "int4"
    self_quant: bool = False  # int8 self-KV cache with per-row scales
    temperature: object = 0.0
    compression_ratio_threshold: Optional[float] = 2.4
    logprob_threshold: Optional[float] = -1.0
    no_speech_threshold: Optional[float] = None
    seed: int = 0
    initial_prompt: Optional[str] = None
    condition_on_previous_text: bool = False
    prompt_length_bucket: int = 1
    vad: bool = False
    vad_threshold_db: float = -40.0
    vad_min_speech_seconds: float = 0.1
    clip_timestamps: Optional[object] = None


def _check_supported(opt: DecodeOptions) -> None:
    """Raise for every option the port's beam and greedy paths do not
    cover."""
    todo = []
    if opt.strategy not in ("beam", "greedy"):
        todo.append(f"strategy={opt.strategy!r} (ROADMAP queue 1 item 7)")
    if opt.timestamps:
        todo.append("timestamps (ROADMAP queue 1 item 8)")
    if opt.self_quant == "int4":
        todo.append("self_quant='int4' (ROADMAP queue 1 item 9)")
    if (isinstance(opt.temperature, (tuple, list))
            or float(opt.temperature) != 0.0
            or opt.no_speech_threshold is not None):
        todo.append("temperature > 0, a temperature tuple or "
                    "no_speech_threshold (the fallback ladder: ROADMAP queue "
                    "1 items 5 and 8)")
    if opt.clip_timestamps is not None:
        todo.append("clip_timestamps (ROADMAP queue 1 item 8)")
    if todo:
        raise NotImplementedError(
            "not ported to whisper_tpu_torch yet: " + "; ".join(todo))


def find_chunk_overlap(prev_tokens: Sequence[int], curr_tokens: Sequence[int],
                       max_n_offsets: int, min_n_overlaps: int
                       ) -> Optional[Tuple[int, int]]:
    """Best suffix(prev)/prefix(curr) token alignment
    (src/transcribe.rs:76-110): (prev_index, curr_index) to splice at, or
    None. Matching positions need not be contiguous."""
    max_overlap = 0
    best = (0, 0)
    n_offsets = min(len(prev_tokens), len(curr_tokens), max_n_offsets)
    for offset in range(n_offsets):
        prev_start = len(prev_tokens) - 1 - offset
        matches = [i for i, (old, new) in enumerate(
            zip(prev_tokens[prev_start:], curr_tokens)) if old == new]
        if len(matches) > max_overlap:
            max_overlap = len(matches)
            best = (prev_start + matches[0], matches[0])
    return best if max_overlap >= min_n_overlaps else None


def window_waveform(waveform: np.ndarray, sample_rate: int,
                    window_samples: int, overlap_samples: int):
    """Yield (start, end) window bounds (src/transcribe.rs:114-138)."""
    shift = max(window_samples - overlap_samples, 1)
    n = max(len(waveform) - 1, 0) // shift + 1
    for i in range(n):
        start = i * shift
        yield start, min(start + window_samples, len(waveform))


class Transcriber:
    """Loads once, transcribes many: params on one device, one window after
    another.

    `params`: a ParamTree (moved to `device`) or the JAX package's numpy
    pytree (converted with `from_numpy_tree`), either of them possibly
    quantized (`quantize.quantize_params`; QTensor weights keep their
    integer `q` and f32 scales under `dtype`). `device` is "cuda" unless
    given: without a CUDA device the constructor raises, and the CPU runs
    only when asked for with device="cpu". `dtype` casts the floating
    parameters. `attention="auto"` is "flash" (the hand-written kernels)
    on a CUDA device and "xla" (plain PyTorch) on the CPU; the kernels take
    bfloat16, so "flash" on CUDA with other weights raises ValueError.
    `matmul_precision="highest"` is the f32 parity mode: it turns TF32 off
    for matmuls and cuDNN convolutions, process-wide.
    """

    def __init__(self, params, cfg: WhisperConfig, tokenizer, dtype=None,
                 attention: str = "auto",
                 matmul_precision: Optional[str] = None, device=None,
                 draft=None):
        if draft is not None:
            raise NotImplementedError(
                "speculative decoding (draft=) is ROADMAP queue 1 item 11, "
                "not ported yet")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the Transcriber runs on the card by default; "
                "pass device='cpu' to run on the CPU")
        if isinstance(params, ParamTree):
            params = params.to(device=self.device)
            if dtype is not None:
                params = params.to(dtype=dtype)
        else:
            params = from_numpy_tree(params, self.device, dtype)
        if attention == "auto":
            attention = "flash" if self.device.type == "cuda" else "xla"
        if attention not in ("flash", "xla"):
            raise ValueError(f"attention must be auto/flash/xla: {attention!r}")
        weight_dtype = params["encoder"]["conv1_w"].dtype
        if (attention == "flash" and self.device.type == "cuda"
                and weight_dtype != torch.bfloat16):
            raise ValueError(
                f"attention='flash' on CUDA runs the port's kernels, which "
                f"take bfloat16; the weights are {weight_dtype}: pass "
                "dtype=torch.bfloat16, or attention='xla' for the plain path")
        if matmul_precision in ("highest", "float32"):
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        elif matmul_precision is not None:
            raise ValueError(f"unsupported matmul_precision {matmul_precision!r}")
        if tokenizer.vocab_size != cfg.text_decoder_config.n_vocab:
            raise ValueError(
                f"tokenizer vocab size {tokenizer.vocab_size} does not match "
                f"model n_vocab {cfg.text_decoder_config.n_vocab} -- wrong "
                "tokenizer.json for this checkpoint?")
        self.params = params
        self.cfg = dataclasses.replace(cfg, attention=attention)
        self.tok = tokenizer
        self._suppress = torch.as_tensor(
            np.asarray(tokenizer.suppress_mask(), np.float32),
            device=self.device)

    def _build_prompt(self, opt: DecodeOptions, prev_tokens=()):
        """Prompt ids (P,) plus the conditioning-prefix length: with
        `initial_prompt` or previous text the prompt is
        [<|startofprev|>, *text][-cap:] + the standard prompt."""
        ids = self.tok.prompt_ids(opt.lang, task=opt.task,
                                  timestamps=opt.timestamps)
        n_cond = 0
        text = []
        if opt.initial_prompt:
            text += self.tok.encode(" " + opt.initial_prompt.strip())
        text += [int(t) for t in prev_tokens]
        if text:
            cap = self.cfg.decoder_ctx_size // 2 - 1
            text = text[-(cap - 1):]
            bucket = max(int(opt.prompt_length_bucket), 8 if prev_tokens else 1)
            if bucket > 1 and len(text) > bucket:
                text = text[len(text) % bucket:]
            cond = [self.tok.start_of_prev] + text
            ids = cond + ids
            n_cond = len(cond)
        return torch.tensor(ids, dtype=torch.long, device=self.device), n_cond

    def _decode_window(self, window: np.ndarray, prompt: torch.Tensor,
                       suppress_until_len: int, opt: DecodeOptions
                       ) -> List[int]:
        """One window: log-mel, clip + pad, encoder, then beam search
        (as whisper_tpu/pipeline/transcribe.py:559-572) or greedy decode;
        returns the decoded sequence (prompt included)."""
        cfg = self.cfg
        wave = torch.from_numpy(window).to(self.device)
        mel = prep_audio(wave[None, :], n_mels=cfg.n_mels)
        keep = min(mel.shape[2], cfg.encoder_ctx_size - opt.padding)
        mel = F.pad(mel[:, :, :keep], (0, opt.padding))
        enc = encoder_forward(self.params, mel, cfg)
        common = dict(eot_id=self.tok.eot, suppress_mask=self._suppress,
                      max_depth=opt.max_depth,
                      suppress_until_len=suppress_until_len,
                      kv_quant=opt.kv_quant, self_quant=opt.self_quant)
        if opt.strategy == "beam":
            toks, length, _ = beam_search(self.params, enc, prompt, cfg,
                                          beam_size=opt.beam_size, **common)
            return toks[: int(length)].tolist()
        toks, length, _ = greedy_decode(self.params, enc, prompt, cfg,
                                        **common)
        return toks[0, : int(length[0])].tolist()

    def transcribe(self, waveform: np.ndarray, sample_rate: int = SAMPLE_RATE,
                   options: Optional[DecodeOptions] = None,
                   on_chunk: Optional[Callable[[int, str], None]] = None
                   ) -> Tuple[str, List[int]]:
        """Full long-form pipeline (src/transcribe.rs:23-74). Returns
        (text, tokens)."""
        opt = options or DecodeOptions()
        _check_supported(opt)
        cfg, tok = self.cfg, self.tok
        n_window = max_waveform_samples(cfg.encoder_ctx_size - opt.padding)
        overlap = int(sample_rate * opt.chunk_overlap_seconds)
        if overlap >= n_window:
            log.warning("chunk overlap (%d samples) >= window (%d); clamping "
                        "overlap to half a window", overlap, n_window)
            overlap = n_window // 2
        prompt, n_cond = self._build_prompt(opt)
        tokens: List[int] = []
        text = ""
        total_t0 = time.perf_counter()
        windows = window_waveform(waveform, sample_rate, n_window, overlap)
        with torch.inference_mode():
            for i, (start, end) in enumerate(windows):
                t0 = time.perf_counter()
                window = np.ascontiguousarray(waveform[start:end],
                                              dtype=np.float32)
                if len(window) < 400:  # < n_fft: no STFT frame
                    log.warning("skipping %d-sample tail window (< n_fft)",
                                len(window))
                    continue
                if opt.vad and vad.is_silent(
                        window, sample_rate, opt.vad_threshold_db,
                        opt.vad_min_speech_seconds):
                    log.info("chunk %d: silent window skipped by VAD", i)
                    continue
                prompt_i, n_cond_i = prompt, n_cond
                if opt.condition_on_previous_text:
                    prompt_i, n_cond_i = self._build_prompt(opt, prev_tokens=[
                        t for t in tokens if not tok.is_special(t)])
                new_tokens = self._decode_window(
                    window, prompt_i, opt.suppress_until_len + n_cond_i,
                    opt)[n_cond_i:]
                spliced = find_chunk_overlap(tokens, new_tokens,
                                             opt.stitch_max_offsets,
                                             opt.stitch_min_overlaps)
                if spliced is not None:
                    prev_index, curr_index = spliced
                    tokens = tokens[:prev_index] + new_tokens[curr_index:]
                else:
                    tokens.extend(new_tokens)
                text = tok.decode(tokens, skip_special=True)
                dt = time.perf_counter() - t0
                window_sec = (end - start) / sample_rate
                log.info("chunk %d: %.1fs audio in %.2fs (%.1fx RT), %d tokens",
                         i, window_sec, dt, window_sec / dt if dt > 0 else 0.0,
                         len(new_tokens))
                if on_chunk is not None:
                    on_chunk(i, text)
                else:
                    print(f"Chunk {i}: {text}\n")  # src/transcribe.rs:68
        total = time.perf_counter() - total_t0
        audio_sec = len(waveform) / sample_rate
        log.info("transcribed %.1fs audio in %.2fs (%.1fx RT)", audio_sec,
                 total, audio_sec / total if total > 0 else 0.0)
        return text, tokens
