"""Batched multi-stream transcription.

Counterpart of `whisper_tpu/pipeline/batch.py::BatchTranscriber` (:49-363)
without its quality ladder, timestamps or mesh. Every stream is windowed
as `Transcriber.transcribe` windows it (the same ~14.9 s windows, overlap
and zero padding); the FULL windows of all streams are packed into batches
of `batch_size` and each batch runs log-mel (per-sample dynamic-range
clamp, so a window's mel does not depend on its batch mates) -> encoder on
the batch -> `greedy_decode` or `beam_search_batched`. A short last batch
is padded by repeating its first window, as JAX pads it, so the encoder's
row count -- and with it the W8A8 kernel choice (K6 at <= 1024 rows, K7
above) -- is that of a full batch. Tail windows go one at a time through
`Transcriber._decode`, and each stream is stitched on its own.

The windows of a batch are independent, so `condition_on_previous_text`
cannot chain them: JAX's `transcribe_many` ignores the option without a
word (its CLI refuses it with `--parallel-windows`), and the port's raises
ValueError instead (`_check_batch_supported`), as `Transcriber.transcribe`
applies it. Options the port does not cover raise NotImplementedError: the
batched fallback ladder, timestamps (`transcribe_many_with_timestamps`) and
clip ranges, as well as `WindowPool` and `BatchingWorker`, are not ported
yet (ROADMAP queue 1 items 10 and 13).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SAMPLE_RATE
from ..decode.beam import beam_search_batched
from ..decode.greedy import greedy_decode
from ..models.whisper import encoder_forward
from ..ops.audio import max_waveform_samples, prep_audio
from . import vad
from .transcribe import (DecodeOptions, Transcriber, _check_supported,
                         find_chunk_overlap, window_waveform)

log = logging.getLogger(__name__)

Window = Tuple[int, int, np.ndarray]  # (stream, window index, samples)


def _check_batch_supported(opt: DecodeOptions) -> None:
    """Raise for the options the batched path does not cover (beyond
    `_check_supported`'s): `condition_on_previous_text`, which independent
    windows cannot apply (ValueError), and the JAX batched ladder,
    timestamps and clip ranges (NotImplementedError)."""
    _check_supported(opt)
    if opt.condition_on_previous_text:
        raise ValueError(
            "condition_on_previous_text needs each window decoded after the "
            "one before it; transcribe_many decodes windows independently "
            "(use Transcriber.transcribe)")
    todo = []
    if opt.timestamps:
        todo.append("timestamps (transcribe_many_with_timestamps)")
    if Transcriber._ladder_temps(opt)[1]:
        todo.append("temperature > 0, a temperature tuple or "
                    "no_speech_threshold (the batched fallback ladder)")
    if opt.clip_timestamps is not None:
        todo.append("clip_timestamps")
    if todo:
        raise NotImplementedError(
            "not ported to the batched path of whisper_tpu_torch yet "
            "(ROADMAP queue 1 item 10): " + "; ".join(todo))


class BatchTranscriber(Transcriber):
    """A Transcriber with a many-streams entry point: full windows decode
    `batch_size` at a time (greedy, or beam search over W x K lanes)."""

    def __init__(self, *args, batch_size: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = batch_size

    def _decode_batch(self, waves: np.ndarray, prompt: torch.Tensor,
                      suppress_until_len: int, opt: DecodeOptions):
        """(B, n) windows -> (tokens (B, ctx), lengths (B,)), prompt
        included (batch.py:114-154)."""
        cfg = self.cfg
        x = torch.from_numpy(waves).to(self.device)
        mel = prep_audio(x, per_sample_max=True, n_mels=cfg.n_mels)
        keep = min(mel.shape[2], cfg.encoder_ctx_size - opt.padding)
        mel = F.pad(mel[:, :, :keep], (0, opt.padding))
        enc = encoder_forward(self.params, mel, cfg)
        common = dict(eot_id=self.tok.eot, suppress_mask=self._suppress,
                      max_depth=opt.max_depth,
                      suppress_until_len=suppress_until_len,
                      kv_quant=opt.kv_quant, self_quant=opt.self_quant)
        if opt.strategy == "beam":
            toks, lengths, _ = beam_search_batched(
                self.params, enc, prompt, cfg, beam_size=opt.beam_size,
                **common)
        else:
            toks, lengths, _ = greedy_decode(self.params, enc, prompt, cfg,
                                             **common)
        return toks.cpu().numpy(), lengths.cpu().numpy()

    def _decode_windows(self, waveforms: Sequence[np.ndarray],
                        sample_rate: int, opt: DecodeOptions):
        """Window and decode N streams (batch.py:160-327, without the
        ladder). Returns (results, n_windows): results[(stream, window)]
        is the window's token list with the conditioning prefix stripped
        (absent for VAD-skipped and sub-n_fft windows), n_windows[s] the
        stream's window count."""
        cfg = self.cfg
        n_window = max_waveform_samples(cfg.encoder_ctx_size - opt.padding)
        overlap = int(sample_rate * opt.chunk_overlap_seconds)
        if overlap >= n_window:
            overlap = n_window // 2
        prompt, n_cond = self._build_prompt(opt)
        sup_len = opt.suppress_until_len + n_cond

        full: List[Window] = []
        tail: List[Window] = []
        n_windows = [0] * len(waveforms)
        for s, wave in enumerate(waveforms):
            wave = np.asarray(wave, np.float32)
            for i, (start, end) in enumerate(
                    window_waveform(wave, sample_rate, n_window, overlap)):
                chunk = np.ascontiguousarray(wave[start:end])
                n_windows[s] = i + 1
                if opt.vad and vad.is_silent(
                        chunk, sample_rate, opt.vad_threshold_db,
                        opt.vad_min_speech_seconds):
                    continue
                if len(chunk) == n_window:
                    full.append((s, i, chunk))
                elif len(chunk) >= 400:  # >= n_fft: one STFT frame at least
                    tail.append((s, i, chunk))

        results: Dict[Tuple[int, int], List[int]] = {}
        bsz = self.batch_size
        for i in range(0, len(full), bsz):
            group = full[i:i + bsz]
            waves = np.stack([g[2] for g in group])
            if len(group) < bsz:  # pad with the first window, discarded
                waves = np.concatenate(
                    [waves, np.repeat(waves[:1], bsz - len(group), axis=0)])
            t0 = time.perf_counter()
            toks, lengths = self._decode_batch(waves, prompt, sup_len, opt)
            for j, (s, w, _) in enumerate(group):
                results[(s, w)] = [int(t) for t in
                                   toks[j, :lengths[j]]][n_cond:]
            log.info("batch %d-%d/%d windows in %.2fs", i, i + len(group),
                     len(full), time.perf_counter() - t0)
        for s, w, chunk in tail:
            results[(s, w)] = self._decode(chunk, prompt, sup_len,
                                           opt)[0][n_cond:]
        return results, n_windows

    def transcribe_many(self, waveforms: Sequence[np.ndarray],
                        sample_rate: int = SAMPLE_RATE,
                        options: Optional[DecodeOptions] = None
                        ) -> List[Tuple[str, List[int]]]:
        """Transcribe N independent streams; returns [(text, tokens)] in
        input order, stitched per stream as `transcribe` stitches
        (src/transcribe.rs:56-63)."""
        opt = options or DecodeOptions()
        _check_batch_supported(opt)
        with torch.inference_mode():
            results, n_windows = self._decode_windows(waveforms, sample_rate,
                                                      opt)
        out: List[Tuple[str, List[int]]] = []
        for s in range(len(waveforms)):
            tokens: List[int] = []
            for w in range(n_windows[s]):
                new_tokens = results.get((s, w))
                if new_tokens is None:
                    continue
                spliced = find_chunk_overlap(tokens, new_tokens,
                                             opt.stitch_max_offsets,
                                             opt.stitch_min_overlaps)
                if spliced is not None:
                    prev_index, curr_index = spliced
                    tokens = tokens[:prev_index] + new_tokens[curr_index:]
                else:
                    tokens.extend(new_tokens)
            out.append((self.tok.decode(tokens, skip_special=True), tokens))
        return out
