"""Long-form transcription: windowing, per-window decode, stitching.

Counterpart of `whisper_tpu/pipeline/transcribe.py` (reference:
whisper-burn `src/transcribe.rs`): ~14.9 s windows (`window_samples`:
a mel of encoder_ctx - 10 frames) with a 3 s overlap,
each window's mel clipped to (encoder_ctx - padding) frames and
zero-padded by `padding` frames, the [SOT, lang, task, notimestamps]
prompt, suppression while seq len <= 5, token-overlap stitching, and the
`Chunk {i}: {text}` progress contract; beam search (the default) or
greedy, plus what the JAX `Transcriber` adds beyond the reference: the
temperature fallback ladder with its quality gates, timestamped segments
(`transcribe_with_timestamps`) with word timings (`align.py`), clip
ranges, language detection, `initial_prompt`,
`condition_on_previous_text` and speculative greedy decoding with a draft
model (`draft=`); and `waveform_to_text`, the reference's one-shot entry.

The JAX pipeline dispatches window i+1 before fetching window i; this port
runs windows one after another (the result is the same: windows are
independent unless `condition_on_previous_text` chains them). Every path
cuts its windows with `plan_windows`. A documented difference: a
`strategy` other than "beam" or "greedy" raises ValueError, where JAX
decodes it greedily (transcribe.py:559).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import logging
import threading
import time
import zlib
from typing import (Callable, Iterator, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from ..align import WordTiming, find_word_timings
from ..config import N_FFT, SAMPLE_RATE, WhisperConfig
from ..decode.beam import beam_search
from ..decode.greedy import greedy_decode
from ..decode.speculative import speculative_greedy_decode
from ..models.whisper import encoder_forward
from ..ops.audio import max_waveform_samples, prep_audio
from ..parallel.context import kernel_mesh
from ..parallel.sharding import shard_params, validate_tp
from ..params import ParamTree, from_numpy_tree
from ..text.tokenizer import SpecialToken
from ..utils.profiling import scope
from . import vad

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Decoding knobs: the fields and defaults of the JAX package's
    `DecodeOptions` (redefined because that module imports jax; its
    comments explain each): beam search with 5 beams by default, or
    strategy="greedy". A `temperature` tuple (or a non-zero float, or a
    `no_speech_threshold`) turns on the fallback ladder; `seed` seeds its
    sampling rungs."""

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
    self_quant: bool = False  # self-KV cache quant: True/"int8", or "int4"
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
    """Raise ValueError for a strategy other than "beam" or "greedy" (JAX
    decodes any other strategy greedily, transcribe.py:559)."""
    if opt.strategy not in ("beam", "greedy"):
        raise ValueError(
            f'strategy must be "beam" or "greedy", got {opt.strategy!r}')


def parse_clip_timestamps(clips: object, total_seconds: float
                          ) -> List[Tuple[float, float]]:
    """"s0,e0,..." or [s0, e0, ...] -> [(start, end)] clamped to the audio
    (transcribe.py:133). An odd count means the final clip runs to the
    end. Raises ValueError on unordered or out-of-range values."""
    if isinstance(clips, str):
        vals = [float(x) for x in clips.split(",") if x.strip() != ""]
    else:
        vals = [float(x) for x in clips]
    if not vals:
        return [(0.0, total_seconds)]
    if len(vals) % 2 == 1:
        vals.append(total_seconds)
    out: List[Tuple[float, float]] = []
    prev_end = 0.0
    for s, e in zip(vals[::2], vals[1::2]):
        e = min(e, total_seconds)
        if s < 0 or s >= e:
            raise ValueError(f"bad clip range [{s}, {e}]")
        if s < prev_end:
            raise ValueError("clip ranges must be sorted and disjoint")
        if s >= total_seconds:
            break
        out.append((s, e))
        prev_end = e
    return out


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


def compression_ratio(text: str) -> float:
    """len(utf-8) / len(zlib-compressed): > ~2.4 flags a repetition loop
    (transcribe.py:198)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def evaluate_window_quality(opt: DecodeOptions, tok, toks, n_sampled,
                            sum_logp, ns_prob):
    """The decode-quality gates of one window (transcribe.py:209, OpenAI's
    needs_fallback). Returns (ok, silence, avg_logprob,
    compression_ratio): silence when p(<|nospeech|>) is above
    `no_speech_threshold` and the logprob check failed (or logprob gating
    is off), ok when both the logprob and the compression-ratio checks
    pass. `ns_prob` < 0 means the tokenizer has no <|nospeech|>."""
    avg_lp = float(sum_logp) / max(int(n_sampled), 1)
    ns = float(ns_prob)
    lp_failed = (opt.logprob_threshold is not None
                 and avg_lp < opt.logprob_threshold)
    if (opt.no_speech_threshold is not None and ns >= 0.0
            and ns > opt.no_speech_threshold
            and (opt.logprob_threshold is None or lp_failed)):
        return False, True, avg_lp, 0.0
    cr = compression_ratio(tok.decode(toks, skip_special=True))
    ok = not lp_failed and not (
        opt.compression_ratio_threshold is not None
        and cr > opt.compression_ratio_threshold)
    return ok, False, avg_lp, cr


def window_waveform(waveform: np.ndarray, sample_rate: int,
                    window_samples: int, overlap_samples: int):
    """Yield (start, end) window bounds (src/transcribe.rs:114-138)."""
    shift = max(window_samples - overlap_samples, 1)
    n = max(len(waveform) - 1, 0) // shift + 1
    for i in range(n):
        start = i * shift
        yield start, min(start + window_samples, len(waveform))


def window_samples(cfg: WhisperConfig, opt: DecodeOptions) -> int:
    """The samples of a full window: a mel of (encoder_ctx - padding)
    frames."""
    return max_waveform_samples(cfg.encoder_ctx_size - opt.padding)


def under_n_fft(samples) -> bool:
    """Too short for one STFT frame (< n_fft samples): not decoded."""
    return len(samples) < N_FFT


class Window(NamedTuple):
    """One window of a stream, as `plan_windows` cuts it."""

    i: int  # its index in the stream
    start: int  # its bounds in the stream's samples
    end: int
    samples: np.ndarray  # the stream's float32 samples [start, end), a view
    kind: str  # decoded: "full" or "tail"; skipped: "short" or "silent"


def plan_windows(waveform, sample_rate: int, cfg: WhisperConfig,
                 opt: DecodeOptions) -> Iterator[Window]:
    """Every window of one stream, in order: `window_waveform`'s bounds of
    `window_samples` windows that overlap by `opt.chunk_overlap_seconds`
    (clamped to half a window, with a warning). A window is "full" or a
    "tail", or skipped: "short" (`under_n_fft`) or, with `opt.vad`,
    "silent". Skipped windows count in the stream's windows and splice as
    gaps. The samples are views of the stream as contiguous float32 (a
    stream that is not is converted once)."""
    n_window = window_samples(cfg, opt)
    overlap = int(sample_rate * opt.chunk_overlap_seconds)
    if overlap >= n_window:
        log.warning("chunk overlap (%d samples) >= window (%d); clamping "
                    "overlap to half a window", overlap, n_window)
        overlap = n_window // 2
    wave = np.ascontiguousarray(waveform, dtype=np.float32)
    for i, (start, end) in enumerate(
            window_waveform(wave, sample_rate, n_window, overlap)):
        samples = wave[start:end]
        if under_n_fft(samples):
            log.warning("skipping %d-sample tail window (< n_fft)",
                        len(samples))
            kind = "short"
        elif opt.vad and vad.is_silent(samples, sample_rate,
                                       opt.vad_threshold_db,
                                       opt.vad_min_speech_seconds):
            log.info("chunk %d: silent window skipped by VAD", i)
            kind = "silent"
        else:
            kind = "full" if len(samples) == n_window else "tail"
        yield Window(i, start, end, samples, kind)


def _rung_generator(device, seed: int, stream: int) -> torch.Generator:
    """The explicit generator of one sampling rung, seeded from
    (seed, stream) -- the JAX ladder folds `i * 131 + ti` into
    PRNGKey(seed) -- so a rerun draws the same tokens."""
    state = np.random.SeedSequence((seed, stream)).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _meshed(method):
    """Run `method` under `kernel_mesh(self.mesh)`: the model functions it
    calls read the mesh (local heads, the tp sums)."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with kernel_mesh(self.mesh):
            return method(self, *args, **kwargs)

    return run


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

    `draft`: optional (params, cfg) of a smaller model sharing the
    tokenizer (multilingual tiny for large-v2). Greedy temperature-0
    windows then decode speculatively (`decode/speculative.py`, the draft
    proposing `draft_k - 1` tokens a target step) with the same output;
    beam search, sampling rungs and the batched paths ignore it, as in
    JAX. The draft's weights go to `device` and `dtype`.

    `mesh`: a ("dp", "tp") mesh of SPMD ranks (`parallel/mesh.py`), every
    rank building its Transcriber from the same full params. Each rank
    keeps its Megatron shard of them (`parallel/sharding.py`; quantized
    trees are refused, as in JAX) and runs every window program under
    `kernel_mesh(mesh)`: the kernels at n_head / tp local heads, the tp
    sums after the row-parallel projections. This single-window path
    decodes the same window on every dp rank (JAX's `dp_axis` is None at
    batch 1); `BatchTranscriber` splits its batches over dp. `draft=` with
    `mesh=` raises ValueError, as in JAX.
    """

    def __init__(self, params, cfg: WhisperConfig, tokenizer, dtype=None,
                 attention: str = "auto",
                 matmul_precision: Optional[str] = None, device=None,
                 draft=None, draft_k: int = 4, mesh=None):
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
        self.mesh = mesh
        if mesh is not None:
            validate_tp(cfg, mesh.shape.get("tp", 1))
            params = shard_params(params, mesh, cfg)
        self.params = params
        self.cfg = dataclasses.replace(cfg, attention=attention)
        self.tok = tokenizer
        mask = np.asarray(tokenizer.suppress_mask(), np.float32)
        self._suppress = torch.as_tensor(mask, device=self.device)
        # timestamped decoding keeps the timestamp tokens emittable: the
        # timestamp rules govern them instead (transcribe.py:320-330)
        try:
            self._ts_begin: Optional[int] = tokenizer.timestamp_begin
            mask = mask.copy()
            mask[self._ts_begin:] = 0.0
            self._suppress_ts = torch.as_tensor(mask, device=self.device)
        except KeyError:
            self._ts_begin = None
            self._suppress_ts = self._suppress
        # serializes decodes from threads that share this Transcriber (the
        # streaming sessions of one server, pipeline/streaming.py)
        self._decode_lock = threading.Lock()
        self._draft_params = None
        self._draft_cfg: Optional[WhisperConfig] = None
        self._draft_k = int(draft_k)
        if draft is not None:
            if mesh is not None:
                raise ValueError(
                    "draft= does not compose with mesh= yet: speculative "
                    "decoding is the B=1 single-chip latency path")
            self._draft_params, self._draft_cfg = self._load_draft(
                draft, dtype, attention)

    def _load_draft(self, draft, dtype, attention: str):
        """(params, cfg) of the draft model, on the Transcriber's device and
        dtype, after the JAX checks (transcribe.py:334-370): a shared
        vocabulary, the same mel frontend and draft_k >= 1."""
        d_params, d_cfg = draft
        cfg = self.cfg
        if d_cfg.text_decoder_config.n_vocab != cfg.text_decoder_config.n_vocab:
            raise ValueError(
                f"draft model vocab {d_cfg.text_decoder_config.n_vocab} != "
                f"target vocab {cfg.text_decoder_config.n_vocab} -- the "
                "draft must share the tokenizer (e.g. multilingual tiny for "
                "large-v2, NOT tiny.en)")
        if d_cfg.n_mels != cfg.n_mels:
            raise ValueError(
                f"draft n_mels {d_cfg.n_mels} != target n_mels {cfg.n_mels}: "
                "both models must consume the same mel frontend")
        if self._draft_k < 1:
            raise ValueError("draft_k must be >= 1")
        if isinstance(d_params, ParamTree):
            d_params = d_params.to(device=self.device)
            if dtype is not None:
                d_params = d_params.to(dtype=dtype)
        else:
            d_params = from_numpy_tree(d_params, self.device, dtype)
        d_dtype = d_params["encoder"]["conv1_w"].dtype
        if (attention == "flash" and self.device.type == "cuda"
                and d_dtype != torch.bfloat16):
            raise ValueError(
                f"the draft's weights are {d_dtype}; the kernels take "
                "bfloat16: pass dtype=torch.bfloat16")
        return d_params, dataclasses.replace(d_cfg, attention=attention)

    def _speculates(self, opt: DecodeOptions, temperature: float,
                    n_prompt: int) -> bool:
        """Whether a window decodes speculatively (transcribe.py:507-523):
        a draft is attached, the window is greedy at temperature 0, and
        prompt + max_depth + draft_k fits both decoder contexts; an
        oversized prompt takes the plain greedy loop instead."""
        if (self._draft_cfg is None or opt.strategy != "greedy"
                or temperature != 0.0):
            return False
        room = min(self.cfg.text_decoder_config.n_text_ctx,
                   self._draft_cfg.text_decoder_config.n_text_ctx)
        return n_prompt + opt.max_depth + self._draft_k <= room

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

    def _window_mel(self, waves, opt: DecodeOptions) -> torch.Tensor:
        """(B, n) windows (numpy, or a tensor already on the device) ->
        log-mel with a per-window dynamic-range clamp (a window's mel does
        not depend on its batch mates), clipped to (encoder_ctx - padding)
        frames and zero-padded by `padding` frames (transcribe.py:548-560,
        batch.py:114-122)."""
        cfg = self.cfg
        if isinstance(waves, torch.Tensor):
            x = waves.to(self.device)
        else:
            x = torch.from_numpy(np.ascontiguousarray(waves)).to(self.device)
        mel = prep_audio(x, per_sample_max=True, n_mels=cfg.n_mels)
        keep = min(mel.shape[2], cfg.encoder_ctx_size - opt.padding)
        return F.pad(mel[:, :, :keep], (0, opt.padding))

    @_meshed
    def _encode_windows(self, waves, opt: DecodeOptions) -> torch.Tensor:
        """(B, n) windows (numpy or a device tensor) -> encoder output of
        `_window_mel`."""
        with scope("whisper.encode"):
            return encoder_forward(self.params, self._window_mel(waves, opt),
                                   self.cfg)

    def _decode_args(self, opt: DecodeOptions, suppress_until_len: int,
                     timestamps: bool, max_initial_ts_idx: int,
                     quality: bool, sot_pos: int) -> dict:
        """The keyword arguments both decode loops take: `timestamps` runs
        the timestamp rules with the timestamp tokens unsuppressed;
        `quality` asks for p(<|nospeech|>) at `sot_pos` (None when the
        tokenizer lacks the token)."""
        ts_begin = None
        if timestamps:
            if self._ts_begin is None:
                raise ValueError("timestamps=True but the tokenizer has no "
                                 "timestamp tokens (<|0.00|>...)")
            ts_begin = self._ts_begin
        return dict(
            eot_id=self.tok.eot,
            suppress_mask=self._suppress_ts if timestamps else self._suppress,
            max_depth=opt.max_depth, suppress_until_len=suppress_until_len,
            kv_quant=opt.kv_quant, self_quant=opt.self_quant,
            ts_begin=ts_begin, max_initial_ts_idx=max_initial_ts_idx,
            nospeech_id=(self.tok.special_token(SpecialToken.NO_SPEECH)
                         if quality else None),
            sot_pos=sot_pos)

    @_meshed
    def _decode(self, window: np.ndarray, prompt: torch.Tensor,
                suppress_until_len: int, opt: DecodeOptions,
                timestamps: bool = False, max_initial_ts_idx: int = 50,
                temperature: float = 0.0,
                generator: Optional[torch.Generator] = None,
                quality: bool = False, sot_pos: int = 0
                ) -> Tuple[List[int], float, float]:
        """One window, as the JAX window program runs it
        (transcribe.py:548-609): log-mel, clip + pad, encoder, then beam
        search at temperature 0 with strategy "beam", else greedy (sampling
        at temperature > 0 with `generator`), speculative greedy when a
        draft is attached and `_speculates` allows it (the draft encodes
        the same mel). Returns (the decoded sequence, prompt included;
        sum_logp; p(<|nospeech|>) at `sot_pos` when `quality`, -1 when not
        asked or when the tokenizer lacks the token)."""
        with scope("whisper.encode"):
            mel = self._window_mel(window[None, :], opt)
            enc = encoder_forward(self.params, mel, self.cfg)
        common = self._decode_args(opt, suppress_until_len, timestamps,
                                   max_initial_ts_idx, quality, sot_pos)
        if opt.strategy == "beam" and temperature == 0.0:
            with scope("whisper.decode"):
                out = beam_search(self.params, enc, prompt, self.cfg,
                                  beam_size=opt.beam_size, **common)
        elif self._speculates(opt, temperature, int(prompt.shape[0])):
            enc_d = encoder_forward(self._draft_params, mel, self._draft_cfg)
            out = speculative_greedy_decode(
                self.params, enc, prompt, self.cfg,
                draft_params=self._draft_params, draft_enc_out=enc_d,
                draft_cfg=self._draft_cfg, n_draft=self._draft_k, **common)
            out = [x[0] for x in out]
        else:
            with scope("whisper.decode"):
                out = greedy_decode(self.params, enc, prompt, self.cfg,
                                    temperature=temperature,
                                    generator=generator, **common)
            out = [x[0] for x in out]
        toks, length, logp = out[:3]
        ns = float(out[3]) if common["nospeech_id"] is not None else -1.0
        return toks[: int(length)].tolist(), float(logp), ns

    def _decode_window_ladder(self, i: int, window: np.ndarray,
                              prompt: torch.Tensor, n_cond: int, sup_len: int,
                              opt: DecodeOptions, temps, timestamps=False,
                              max_initial_ts_idx: int = 50):
        """The fallback ladder (transcribe.py:429-472): decode at temps[0];
        while the quality checks fail, decode again at the next (sampling)
        temperature, rung ti of window i drawing from the generator seeded
        from (opt.seed, i * 131 + ti). Returns (the stripped tokens, the
        accepted temperature, (avg_logprob, compression_ratio,
        no_speech_prob or None) of the accepted rung); [] means accepted
        as silence under the no-speech gate."""
        tok = self.tok
        n_prompt = int(prompt.shape[0])
        for ti, temp in enumerate(temps):
            gen = (_rung_generator(self.device, opt.seed, i * 131 + ti)
                   if temp > 0.0 else None)
            seq, logp, ns = self._decode(
                window, prompt, sup_len, opt, timestamps, max_initial_ts_idx,
                temp, gen, quality=True, sot_pos=n_cond)
            toks = seq[n_cond:]
            ok, silence, avg_lp, cr = evaluate_window_quality(
                opt, tok, toks, len(seq) - n_prompt, logp, ns)
            meta = (avg_lp, cr, ns if ns >= 0.0 else None)
            if silence:
                log.info("chunk %d: no speech (p=%.2f), skipping", i, ns)
                return [], temp, meta
            if ok or ti == len(temps) - 1:
                if ti:
                    log.info("chunk %d: accepted at temperature %.1f "
                             "(avg_logprob %.2f, compression %.2f)",
                             i, temp, avg_lp, cr)
                return toks, temp, meta
            log.info("chunk %d: t=%.1f failed checks (avg_logprob %.2f, "
                     "compression %.2f), retrying", i, temp, avg_lp, cr)
        raise AssertionError("unreachable: the last rung always returns")

    @staticmethod
    def _ladder_temps(opt: DecodeOptions):
        """(temps tuple, ladder active?) from DecodeOptions.temperature
        (transcribe.py:475)."""
        temps = (tuple(float(t) for t in opt.temperature)
                 if isinstance(opt.temperature, (tuple, list))
                 else (float(opt.temperature),))
        active = (len(temps) > 1 or temps[0] != 0.0
                  or opt.no_speech_threshold is not None)
        return temps, active

    def _windows(self, waveform: np.ndarray, sample_rate: int,
                 opt: DecodeOptions) -> Iterator[Window]:
        """The windows of `plan_windows` that get decoded."""
        for w in plan_windows(waveform, sample_rate, self.cfg, opt):
            if w.kind in ("full", "tail"):
                yield w

    def _prev_prompt(self, opt: DecodeOptions, tokens: Sequence[int]):
        """(prompt, n_cond, suppression length) of a window conditioned on
        the non-special `tokens` decoded before it."""
        prompt, n_cond = self._build_prompt(opt, prev_tokens=[
            t for t in tokens if not self.tok.is_special(t)])
        return prompt, n_cond, opt.suppress_until_len + n_cond

    @_meshed
    def detect_language(self, waveform: np.ndarray,
                        sample_rate: int = SAMPLE_RATE,
                        vote_windows: int = 1,
                        vad_threshold_db: float = -40.0,
                        vad_min_speech_seconds: float = 0.1):
        """Identify the spoken language (transcribe.py:656). Returns (best
        code, {code: prob}): the language distribution averaged over up
        to `vote_windows` speech-bearing windows (the energy VAD), or the
        first window when all are below the VAD threshold."""
        from .detect import detect_language as _detect

        # back-to-back windows at the default padding of 10 frames
        opt = DecodeOptions(padding=10, chunk_overlap_seconds=0.0, vad=True,
                            vad_threshold_db=vad_threshold_db,
                            vad_min_speech_seconds=vad_min_speech_seconds)
        windows = plan_windows(waveform, sample_rate, self.cfg, opt)
        first = next(windows)
        if first.kind == "short":
            raise ValueError("audio too short for language detection")
        speech: List[np.ndarray] = []
        for w in itertools.chain([first], windows):
            if w.kind == "short":
                break
            if w.kind != "silent":
                speech.append(w.samples)
                if len(speech) >= max(1, int(vote_windows)):
                    break
        if not speech:
            # all silent: the first window is as good as any
            speech = [first.samples]
        acc: dict = {}
        dtype = self.params["decoder"]["tok_emb"].dtype
        with torch.inference_mode():
            for samples in speech:
                window = torch.from_numpy(samples)
                mel = prep_audio(window.to(self.device)[None, :],
                                 n_mels=self.cfg.n_mels)
                enc = encoder_forward(self.params, mel.to(dtype), self.cfg)
                _, dist = _detect(self.params, enc, self.cfg, self.tok)[0]
                for code, p in dist.items():
                    acc[code] = acc.get(code, 0.0) + p / len(speech)
        best = max(acc, key=acc.get)
        return best, acc

    def transcribe(self, waveform: np.ndarray, sample_rate: int = SAMPLE_RATE,
                   options: Optional[DecodeOptions] = None,
                   on_chunk: Optional[Callable[[int, str], None]] = None
                   ) -> Tuple[str, List[int]]:
        """Full long-form pipeline (src/transcribe.rs:23-74), with the
        fallback ladder when `options` turn it on and the
        `condition_on_previous_text` cut after a window accepted at a
        temperature above 0.5 (transcribe.py:705-866). Returns (text,
        tokens)."""
        opt = options or DecodeOptions()
        _check_supported(opt)
        if opt.clip_timestamps is not None:
            return self._transcribe_clips(waveform, sample_rate, opt,
                                          on_chunk)
        tok = self.tok
        prompt, n_cond = self._build_prompt(opt)
        sup_len = opt.suppress_until_len + n_cond
        temps, use_ladder = self._ladder_temps(opt)
        tokens: List[int] = []
        text = ""
        prompt_reset_at = 0  # OpenAI's prompt_reset_since: a permanent cut
        total_t0 = time.perf_counter()
        with torch.inference_mode():
            for i, start, end, window, _ in self._windows(
                    waveform, sample_rate, opt):
                t0 = time.perf_counter()
                prompt_i, n_cond_i, sup_i = prompt, n_cond, sup_len
                if opt.condition_on_previous_text:
                    prompt_i, n_cond_i, sup_i = self._prev_prompt(
                        opt, tokens[prompt_reset_at:])
                reset = False
                if use_ladder:
                    new_tokens, accepted_t, _ = self._decode_window_ladder(
                        i, window, prompt_i, n_cond_i, sup_i, opt, temps)
                    # a window that needed a high sampling temperature is
                    # an unreliable context: cut it from future prompts
                    reset = accepted_t > 0.5
                else:
                    new_tokens = self._decode(
                        window, prompt_i, sup_i, opt)[0][n_cond_i:]
                spliced = find_chunk_overlap(tokens, new_tokens,
                                             opt.stitch_max_offsets,
                                             opt.stitch_min_overlaps)
                if spliced is not None:
                    prev_index, curr_index = spliced
                    tokens = tokens[:prev_index] + new_tokens[curr_index:]
                else:
                    tokens.extend(new_tokens)
                if reset:
                    prompt_reset_at = len(tokens)
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

    def _clips(self, waveform, sample_rate: int, opt: DecodeOptions):
        """(start s, end s, samples, options without clips) of each range
        of `opt.clip_timestamps`."""
        sub = dataclasses.replace(opt, clip_timestamps=None)
        for s, e in parse_clip_timestamps(opt.clip_timestamps,
                                          len(waveform) / sample_rate):
            yield s, waveform[int(s * sample_rate): int(e * sample_rate)], sub

    def _transcribe_clips(self, waveform, sample_rate: int,
                          opt: DecodeOptions, on_chunk):
        """clip_timestamps (transcribe.py:869): each range is a long-form
        pass of its own; the texts are joined by a space."""
        texts: List[str] = []
        tokens: List[int] = []
        for _, clip, sub in self._clips(waveform, sample_rate, opt):
            text, toks = self.transcribe(clip, sample_rate, sub, on_chunk)
            if text.strip():
                texts.append(text.strip())
            tokens.extend(toks)
        return " ".join(texts), tokens

    def _transcribe_clips_with_timestamps(self, waveform, sample_rate: int,
                                          opt: DecodeOptions,
                                          word_timestamps: bool):
        """clip_timestamps on the timestamped path (transcribe.py:887):
        segment (and word) times are offset by each clip's start, so they
        stay absolute in the original audio's timeline."""
        texts: List[str] = []
        segments: List = []
        for s, clip, sub in self._clips(waveform, sample_rate, opt):
            text, segs = self.transcribe_with_timestamps(
                clip, sample_rate, sub, word_timestamps=word_timestamps)
            if text.strip():
                texts.append(text.strip())
            segments += [dataclasses.replace(
                seg, start=seg.start + s, end=seg.end + s,
                words=None if seg.words is None else [
                    WordTiming(w.word, w.start + s, w.end + s, w.tokens)
                    for w in seg.words]) for seg in segs]
        return " ".join(texts), segments

    def transcribe_with_timestamps(self, waveform: np.ndarray,
                                   sample_rate: int = SAMPLE_RATE,
                                   options: Optional[DecodeOptions] = None,
                                   word_timestamps: bool = False):
        """Timestamped transcription (transcribe.py:916): returns (text,
        segments). The prompt omits <|notimestamps|>, the timestamp rules
        govern the <|x.xx|> tokens, each window's tokens split into
        Segments with absolute times, windows joined by the token-overlap
        stitcher (segments.TimestampStitcher). Every segment carries the
        quality metadata of its window's decode (avg_logprob,
        compression_ratio, no_speech_prob), off the ladder too.
        `word_timestamps=True` fills each segment's `words` with
        [align.WordTiming] in absolute seconds (`_attach_words`)."""
        from .segments import TimestampStitcher

        opt = dataclasses.replace(options or DecodeOptions(), timestamps=True)
        _check_supported(opt)
        if opt.clip_timestamps is not None:
            return self._transcribe_clips_with_timestamps(
                waveform, sample_rate, opt, word_timestamps)
        tok = self.tok
        prompt, n_cond = self._build_prompt(opt)
        sup_len = opt.suppress_until_len + n_cond
        temps, use_ladder = self._ladder_temps(opt)
        max_ts_idx = max(0, int(round(opt.max_initial_timestamp / 0.02)))
        prompt_reset_at = 0
        stitcher = TimestampStitcher(tok, opt.stitch_max_offsets,
                                     opt.stitch_min_overlaps)
        with torch.inference_mode():
            for i, start, end, window, _ in self._windows(
                    waveform, sample_rate, opt):
                if opt.condition_on_previous_text:
                    prompt, n_cond, sup_len = self._prev_prompt(
                        opt, stitcher.all_tokens[prompt_reset_at:])
                reset = False
                if use_ladder:
                    new_tokens, accepted_t, meta = self._decode_window_ladder(
                        i, window, prompt, n_cond, sup_len, opt, temps,
                        timestamps=True, max_initial_ts_idx=max_ts_idx)
                    reset = accepted_t > 0.5
                else:
                    seq, logp, ns = self._decode(
                        window, prompt, sup_len, opt, timestamps=True,
                        max_initial_ts_idx=max_ts_idx, quality=True,
                        sot_pos=n_cond)
                    new_tokens = seq[n_cond:]
                    meta = (logp / max(len(seq) - int(prompt.shape[0]), 1),
                            compression_ratio(tok.decode(new_tokens,
                                                         skip_special=True)),
                            ns if ns >= 0.0 else None)
                stitcher.add_window(new_tokens, start / sample_rate,
                                    (end - start) / sample_rate, quality=meta)
                if reset:  # accepted at a high temperature: cut it
                    prompt_reset_at = len(stitcher.all_tokens)
        segs = stitcher.segments
        if word_timestamps and segs:
            self._attach_words(waveform, sample_rate, segs, opt)
        text = " ".join(s.text.strip() for s in segs)
        return text, segs

    @_meshed
    def align_words(self, window: np.ndarray, tokens: Sequence[int],
                    heads=None, offset_s: float = 0.0) -> List[WordTiming]:
        """Word timings of one decoded window (transcribe.py:616): the
        window's encoder output (the kernels on the flash config) and the
        cross-attention DTW alignment (`align.find_word_timings`) of
        `tokens`, its decoded sequence with the prompt, against it.
        `heads`: [(layer, head)], default the model's baked heads, else the
        top half. Times are window-relative plus `offset_s`."""
        cfg = self.cfg
        padding = 10
        wave = torch.from_numpy(np.ascontiguousarray(window, np.float32))
        with torch.inference_mode():
            mel = prep_audio(wave.to(self.device)[None, :], n_mels=cfg.n_mels)
            keep = min(mel.shape[2], cfg.encoder_ctx_size - padding)
            mel = F.pad(mel[:, :, :keep], (0, padding))
            enc = encoder_forward(self.params, mel, cfg)
        words = find_word_timings(self.params, enc, [int(t) for t in tokens],
                                  cfg, self.tok, num_frames=keep // 2,
                                  heads=heads)
        if offset_s:
            words = [dataclasses.replace(w, start=w.start + offset_s,
                                         end=w.end + offset_s) for w in words]
        return words

    def _attach_words(self, waveform, sample_rate: int, segs,
                      opt: DecodeOptions) -> None:
        """Fill each segment's `words` (transcribe.py:1025): ONE alignment
        pass per decode window -- segments are grouped by the window that
        holds their start, the window's tokens (the timestamped prompt,
        every segment's tokens, EOT) align once, and the words are handed
        back to the segments in token order."""
        n_window = window_samples(self.cfg, opt)
        prompt_ids = self.tok.prompt_ids(opt.lang, task=opt.task,
                                         timestamps=True)
        groups: dict = {}
        for si, seg in enumerate(segs):
            w0 = min(int(seg.start * sample_rate),
                     max(0, len(waveform) - n_window))
            groups.setdefault(w0, []).append(si)
        for w0, sis in groups.items():
            seq = list(prompt_ids)
            for si in sis:
                seq += segs[si].tokens
            seq.append(self.tok.eot)
            it = iter(self.align_words(waveform[w0:w0 + n_window], seq,
                                       offset_s=w0 / sample_rate))
            for si in sis:
                n_tok = len([x for x in segs[si].tokens
                             if not self.tok.is_special(x)])
                got, used = [], 0
                for w in it:
                    got.append(w)
                    used += len(w.tokens)
                    if used >= n_tok:
                        break
                segs[si].words = got


def waveform_to_text(params, cfg: WhisperConfig, tokenizer, lang: str,
                     waveform: np.ndarray, sample_rate: int, device=None,
                     **kwargs) -> Tuple[str, List[int]]:
    """One-shot entry with the reference's signature
    (`waveform_to_text(whisper, bpe, lang, waveform, sample_rate)`,
    src/transcribe.rs:23-29; JAX transcribe.py:1061): a `Transcriber` on
    `device` (the card unless given) transcribes with
    `DecodeOptions(lang=lang, **kwargs)`. Returns (text, tokens)."""
    return Transcriber(params, cfg, tokenizer, device=device).transcribe(
        waveform, sample_rate, DecodeOptions(lang=lang, **kwargs))
