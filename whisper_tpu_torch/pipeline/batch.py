"""Batched multi-stream transcription.

Counterpart of `whisper_tpu/pipeline/batch.py::BatchTranscriber` (:49-426)
without its mesh. Every stream is windowed as `Transcriber.transcribe`
windows it (the same ~14.9 s windows, overlap and zero padding); the FULL
windows of all streams are packed into batches of `batch_size` and each
batch runs log-mel (per-sample dynamic-range clamp, so a window's mel does
not depend on its batch mates) -> encoder on the batch -> `greedy_decode`
or `beam_search_batched`. A short last batch is padded by repeating its
first window, as JAX pads it, so the encoder's row count -- and with it
the W8A8 kernel choice (K6 at <= 1024 rows, K7 above) -- is that of a full
batch. Tail windows go one at a time through the single-window path, and
each stream is stitched on its own.

The fallback ladder runs batched (`_decode_windows`): a first pass decodes
every full window at temps[0], the host-side quality gates judge each
window, and only the windows that failed decode again -- batched again --
at the next (sampling) temperature. `transcribe_many_with_timestamps`
gives each stream the segments, quality metadata and (with
`word_timestamps`) word timings of `Transcriber.transcribe_with_timestamps`.

The windows of a batch are independent, so `condition_on_previous_text`
cannot chain them: JAX's `transcribe_many` ignores the option without a
word (its CLI refuses it with `--parallel-windows`), and the port's raises
ValueError instead; `transcribe_many_with_timestamps` runs each stream
through the sequential path, as JAX's does. Clip ranges raise ValueError
on the batched path (JAX's batched entries ignore them; its CLI refuses
`--clip` with `--parallel-windows`).

`WindowPool` is the open-ended version of `transcribe_many` that the
server's `BatchingWorker` (serve.py) drives: requests join at any time,
each `step()` decodes one batch of `batch_size` full windows drawn across
every admitted request, padded as `_decode_windows` pads a short batch,
and finished requests are stitched as `transcribe_many` stitches them.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SAMPLE_RATE
from ..decode.beam import beam_search_batched
from ..decode.greedy import greedy_decode
from ..ops.audio import max_waveform_samples
from . import vad
from .transcribe import (DecodeOptions, Transcriber, _check_supported,
                         _rung_generator, compression_ratio,
                         evaluate_window_quality, find_chunk_overlap,
                         window_waveform)

log = logging.getLogger(__name__)

Window = Tuple[int, int, np.ndarray]  # (stream, window index, samples)


def _check_batch_supported(opt: DecodeOptions) -> None:
    """Raise for the options the batched path does not take (beyond
    `_check_supported`'s): `condition_on_previous_text`, which independent
    windows cannot apply, and clip ranges (ValueError)."""
    _check_supported(opt)
    if opt.condition_on_previous_text:
        raise ValueError(
            "condition_on_previous_text needs each window decoded after the "
            "one before it; transcribe_many decodes windows independently "
            "(use Transcriber.transcribe)")
    if opt.clip_timestamps is not None:
        raise ValueError(
            "clip_timestamps is incompatible with the batched path (the JAX "
            "CLI refuses --clip with --parallel-windows); use "
            "Transcriber.transcribe")


class BatchTranscriber(Transcriber):
    """A Transcriber with many-streams entry points: full windows decode
    `batch_size` at a time (greedy, or beam search over W x K lanes)."""

    def __init__(self, *args, batch_size: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = batch_size

    def _decode_batch(self, waves: np.ndarray, prompt: torch.Tensor,
                      suppress_until_len: int, opt: DecodeOptions,
                      timestamps: bool = False, max_ts_idx: int = 50,
                      quality: bool = False, temperature: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      sot_pos: int = 0):
        """(B, n) windows -> (tokens (B, ctx), lengths (B,), sum_logp (B,),
        p(<|nospeech|>) (B,), -1 unless `quality` asks for it) as numpy,
        prompt included (batch.py:114-154): beam search over B x K lanes
        at temperature 0 with strategy "beam", else greedy (sampling at
        temperature > 0 from `generator`)."""
        enc = self._encode_windows(waves, opt)
        common = self._decode_args(opt, suppress_until_len, timestamps,
                                   max_ts_idx, quality, sot_pos)
        if opt.strategy == "beam" and temperature == 0.0:
            out = beam_search_batched(self.params, enc, prompt, self.cfg,
                                      beam_size=opt.beam_size, **common)
        else:
            out = greedy_decode(self.params, enc, prompt, self.cfg,
                                temperature=temperature, generator=generator,
                                **common)
        toks, lengths, logp = (t.cpu().numpy() for t in out[:3])
        ns = (out[3].float().cpu().numpy()
              if common["nospeech_id"] is not None
              else np.full(len(waves), -1.0, np.float32))
        return toks, lengths, logp, ns

    def _decode_windows(self, waveforms: Sequence[np.ndarray],
                        sample_rate: int, opt: DecodeOptions,
                        timestamps: bool = False, max_ts_idx: int = 50):
        """Window and decode N streams (batch.py:160-327); the engine under
        `transcribe_many` and `transcribe_many_with_timestamps`.

        Returns (results, meta, bounds, n_windows): results[(stream,
        window)] is the window's token list with the conditioning prefix
        stripped (absent for VAD-skipped and sub-n_fft windows; [] when the
        no-speech gate accepted it as silence), meta[(stream, window)] the
        (avg_logprob, compression_ratio, no_speech_prob or None) of its
        accepted decode (only when the quality path ran: the ladder or
        timestamps), bounds[(stream, window)] its (start, end) samples,
        n_windows[s] the stream's window count.

        With the ladder on (a temperature tuple, a temperature > 0 or
        `no_speech_threshold`), the first pass decodes every full window
        at temps[0]; the quality gates of `evaluate_window_quality` judge
        each, and only the failed windows decode again, batched, at the
        next temperature, until accepted or the temperatures run out.
        Sampling rung ti of the batch that starts at index i of the
        pending list draws from the generator seeded from (opt.seed,
        ti * 100003 + i), JAX's `fold_in(PRNGKey(seed), ti * 100003 + i)`.
        Tail windows take `_decode_window_ladder(s * 100003 + w, ...)`
        whenever the quality path runs."""
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
        bounds: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for s, wave in enumerate(waveforms):
            wave = np.asarray(wave, np.float32)
            for i, (start, end) in enumerate(
                    window_waveform(wave, sample_rate, n_window, overlap)):
                chunk = np.ascontiguousarray(wave[start:end])
                n_windows[s] = i + 1
                bounds[(s, i)] = (start, end)
                if opt.vad and vad.is_silent(
                        chunk, sample_rate, opt.vad_threshold_db,
                        opt.vad_min_speech_seconds):
                    continue
                if len(chunk) == n_window:
                    full.append((s, i, chunk))
                elif len(chunk) >= 400:  # >= n_fft: one STFT frame at least
                    tail.append((s, i, chunk))

        results: Dict[Tuple[int, int], List[int]] = {}
        meta: Dict[Tuple[int, int], tuple] = {}
        n_prompt = int(prompt.shape[0])
        temps, use_ladder = self._ladder_temps(opt)
        # the gates need the quality outputs, and so do the timestamped
        # path's per-segment metadata
        quality = use_ladder or timestamps
        bsz = self.batch_size
        pending = full
        for ti, temp in enumerate(temps):
            failures: List[Window] = []
            for i in range(0, len(pending), bsz):
                group = pending[i:i + bsz]
                waves = np.stack([g[2] for g in group])
                if len(group) < bsz:  # pad with the first window, discarded
                    waves = np.concatenate(
                        [waves, np.repeat(waves[:1], bsz - len(group),
                                          axis=0)])
                gen = (_rung_generator(self.device, opt.seed,
                                       ti * 100003 + i)
                       if temp > 0.0 else None)
                t0 = time.perf_counter()
                toks, lengths, logps, nss = self._decode_batch(
                    waves, prompt, sup_len, opt, timestamps, max_ts_idx,
                    quality, temp, gen, sot_pos=n_cond)
                for j, (s, w, chunk) in enumerate(group):
                    tl = [int(t) for t in toks[j, :lengths[j]]][n_cond:]
                    if not quality:
                        results[(s, w)] = tl
                        continue
                    ns = float(nss[j])
                    if not use_ladder:  # metadata only, no gating
                        results[(s, w)] = tl
                        meta[(s, w)] = (
                            float(logps[j]) / max(int(lengths[j]) - n_prompt,
                                                  1),
                            compression_ratio(
                                self.tok.decode(tl, skip_special=True)),
                            ns if ns >= 0.0 else None)
                        continue
                    ok, silence, avg_lp, cr = evaluate_window_quality(
                        opt, self.tok, tl, int(lengths[j]) - n_prompt,
                        logps[j], ns)
                    m = (avg_lp, cr, ns if ns >= 0.0 else None)
                    if silence:
                        log.info("stream %d window %d: no speech (p=%.2f), "
                                 "skipping", s, w, ns)
                        results[(s, w)], meta[(s, w)] = [], m
                    elif ok or ti == len(temps) - 1:
                        if ti:
                            log.info("stream %d window %d: accepted at "
                                     "t=%.1f (avg_logprob %.2f, compression "
                                     "%.2f)", s, w, temp, avg_lp, cr)
                        results[(s, w)], meta[(s, w)] = tl, m
                    else:
                        log.info("stream %d window %d: t=%.1f failed checks "
                                 "(avg_logprob %.2f, compression %.2f), "
                                 "queueing re-decode", s, w, temp, avg_lp, cr)
                        failures.append((s, w, chunk))
                log.info("batch %d-%d/%d windows (t=%.1f) in %.2fs", i,
                         i + len(group), len(pending), temp,
                         time.perf_counter() - t0)
            pending = failures
            if not pending:
                break

        for s, w, chunk in tail:
            if quality:
                results[(s, w)], _, meta[(s, w)] = self._decode_window_ladder(
                    s * 100003 + w, chunk, prompt, n_cond, sup_len, opt, temps,
                    timestamps=timestamps, max_initial_ts_idx=max_ts_idx)
            else:
                results[(s, w)] = self._decode(chunk, prompt, sup_len,
                                               opt)[0][n_cond:]
        return results, meta, bounds, n_windows

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
            results, _, _, n_windows = self._decode_windows(
                waveforms, sample_rate, opt)
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

    def transcribe_many_with_timestamps(
            self, waveforms: Sequence[np.ndarray],
            sample_rate: int = SAMPLE_RATE,
            options: Optional[DecodeOptions] = None,
            word_timestamps: bool = False) -> List[Tuple[str, list]]:
        """Timestamped transcription of N streams on the batched path
        (batch.py:365-426); returns [(text, [Segment])], stream for stream
        what `Transcriber.transcribe_with_timestamps` gives: the same
        windows, timestamp rules per lane (the timestamp-permitting
        suppress mask, `max_initial_timestamp` as max_ts_idx), quality
        metadata, and a `TimestampStitcher` of its own per stream.
        `word_timestamps` attaches word timings (one alignment pass per
        decode window). With `condition_on_previous_text` each stream runs
        through the sequential `transcribe_with_timestamps`, as in JAX."""
        from .segments import TimestampStitcher

        opt = dataclasses.replace(options or DecodeOptions(), timestamps=True)
        if opt.condition_on_previous_text:
            # window i+1's prompt needs window i's text: sequential
            log.info("condition_on_previous_text: each stream on the "
                     "sequential path")
            return [self.transcribe_with_timestamps(
                w, sample_rate, opt, word_timestamps=word_timestamps)
                for w in waveforms]
        _check_batch_supported(opt)
        max_ts_idx = max(0, int(round(opt.max_initial_timestamp / 0.02)))
        with torch.inference_mode():
            results, meta, bounds, n_windows = self._decode_windows(
                waveforms, sample_rate, opt, timestamps=True,
                max_ts_idx=max_ts_idx)
        out: List[Tuple[str, list]] = []
        for s in range(len(waveforms)):
            st = TimestampStitcher(self.tok, opt.stitch_max_offsets,
                                   opt.stitch_min_overlaps)
            for w in range(n_windows[s]):
                toks = results.get((s, w))
                if toks is None:
                    continue
                start, end = bounds[(s, w)]
                st.add_window(toks, start / sample_rate,
                              (end - start) / sample_rate,
                              quality=meta.get((s, w)))
            segs = st.segments
            if word_timestamps and segs:
                self._attach_words(np.asarray(waveforms[s], np.float32),
                                   sample_rate, segs, opt)
            out.append((" ".join(x.text.strip() for x in segs), segs))
        return out


class WindowPool:
    """Continuous batching at WINDOW granularity (batch.py:427-620 of the
    JAX package).

    Requests are `add`ed at any time; every `step()` decodes ONE batch of
    pending full windows drawn across all admitted requests (newest
    included), then the tail windows of requests whose full windows are
    done (one at a time, through `_decode`), and returns the requests that
    are complete, stitched. A short batch is padded to `batch_size` by
    repeating its first window, as `_decode_windows` pads it, so the
    encoder's row count -- and with it the GEMM shapes and the W8A8 kernel
    route -- are `transcribe_many`'s, and so are the texts and tokens.
    Scope: the plain single-temperature path; the ladder, timestamps,
    prev-text conditioning and clip ranges take the grouped path
    (`poolable()` says which). `step()` enters `torch.inference_mode()`
    itself: the serving worker calls it on its own thread."""

    def __init__(self, transcriber: BatchTranscriber,
                 options: Optional[DecodeOptions] = None,
                 sample_rate: int = SAMPLE_RATE):
        opt = options or DecodeOptions()
        reason = self.unpoolable_reason(opt)
        if reason:
            raise ValueError(f"WindowPool: {reason}")
        _check_supported(opt)
        self.t = transcriber
        self.opt = opt
        self.sr = sample_rate
        self._n_window = max_waveform_samples(
            transcriber.cfg.encoder_ctx_size - opt.padding)
        overlap = int(sample_rate * opt.chunk_overlap_seconds)
        if overlap >= self._n_window:
            overlap = self._n_window // 2
        self._overlap = overlap
        self._prompt, self._n_cond = transcriber._build_prompt(opt)
        self._sup_len = opt.suppress_until_len + self._n_cond
        # a 1-tuple temperature is poolable (no ladder)
        self._temperature = float(Transcriber._ladder_temps(opt)[0][0])
        self._queue: List[Tuple[object, int, np.ndarray]] = []  # full wins
        self._tails: dict = {}  # rid -> [(w, chunk)]
        self._results: dict = {}  # rid -> {w: tokens}
        self._n_windows: dict = {}  # rid -> window count
        self._undecoded: dict = {}  # rid -> full + tail windows left
        self._order: List[object] = []  # admission order

    @staticmethod
    def unpoolable_reason(opt: DecodeOptions) -> Optional[str]:
        _, use_ladder = Transcriber._ladder_temps(opt)
        if use_ladder:
            return "temperature ladder re-decodes failing windows"
        if opt.no_speech_threshold is not None:
            return "no-speech gate needs the quality decode"
        if opt.timestamps:
            return "timestamped decoding uses the segment pipeline"
        if opt.condition_on_previous_text:
            return "prev-text conditioning makes windows sequential"
        if opt.clip_timestamps is not None:
            return "clip ranges transcribe independently"
        return None

    @classmethod
    def poolable(cls, opt: DecodeOptions) -> bool:
        return cls.unpoolable_reason(opt) is None

    def add(self, rid, waveform: np.ndarray) -> None:
        """Admit one request's audio; its windows join the shared pool."""
        if rid in self._n_windows:
            raise ValueError(f"duplicate request id {rid!r}")
        wave = np.asarray(waveform, np.float32)
        self._results[rid] = {}
        self._n_windows[rid] = 0
        self._undecoded[rid] = 0
        self._tails[rid] = []
        self._order.append(rid)
        for w, (start, end) in enumerate(window_waveform(
                wave, self.sr, self._n_window, self._overlap)):
            chunk = np.ascontiguousarray(wave[start:end])
            self._n_windows[rid] = w + 1
            if self.opt.vad and vad.is_silent(
                    chunk, self.sr, self.opt.vad_threshold_db,
                    self.opt.vad_min_speech_seconds):
                continue  # stitching skips missing windows
            if len(chunk) == self._n_window:
                self._queue.append((rid, w, chunk))
                self._undecoded[rid] += 1
            elif len(chunk) >= 400:
                self._tails[rid].append((w, chunk))
                self._undecoded[rid] += 1

    def cancel(self, rid) -> None:
        """Drop a request's still-queued windows (an abandoned waiter)."""
        self._queue = [q for q in self._queue if q[0] != rid]
        self._tails.pop(rid, None)
        self._undecoded.pop(rid, None)
        self._n_windows.pop(rid, None)
        self._results.pop(rid, None)
        if rid in self._order:
            self._order.remove(rid)

    def pending(self) -> int:
        """Windows (full + tail) not yet decoded."""
        return len(self._queue) + sum(len(v) for v in self._tails.values())

    def step(self) -> List[Tuple[object, str, List[int]]]:
        """Decode ONE batch of pending windows (and the tails whose
        request's full windows are done); returns the newly completed
        requests as [(rid, text, tokens)] in admission order."""
        opt, t = self.opt, self.t
        with torch.inference_mode():
            if self._queue:
                group = self._queue[:t.batch_size]
                self._queue = self._queue[t.batch_size:]
                waves = np.stack([g[2] for g in group])
                if len(group) < t.batch_size:
                    waves = np.concatenate(
                        [waves, np.repeat(waves[:1],
                                          t.batch_size - len(group), axis=0)])
                toks, lengths, _, _ = t._decode_batch(
                    waves, self._prompt, self._sup_len, opt,
                    temperature=self._temperature, sot_pos=self._n_cond)
                for j, (rid, w, _) in enumerate(group):
                    if rid not in self._undecoded:  # cancelled mid-flight
                        continue
                    self._results[rid][w] = [
                        int(x) for x in toks[j, :lengths[j]]][self._n_cond:]
                    self._undecoded[rid] -= 1
            # tails take the single-window path once their request's full
            # windows are done (as `_decode_windows` decodes them last)
            for rid in list(self._order):
                if self._undecoded.get(rid, 1) == len(
                        self._tails.get(rid, ())):
                    for w, chunk in self._tails.pop(rid, ()):
                        self._results[rid][w] = t._decode(
                            chunk, self._prompt, self._sup_len,
                            opt)[0][self._n_cond:]
                        self._undecoded[rid] -= 1
        return self.sweep()

    def sweep(self) -> List[Tuple[object, str, List[int]]]:
        """Collect the requests whose windows are all decoded (no
        decoding), stitched as `transcribe_many` stitches."""
        opt, t = self.opt, self.t
        done: List[Tuple[object, str, List[int]]] = []
        for rid in list(self._order):
            if self._undecoded.get(rid) != 0:
                continue
            res = self._results.pop(rid)
            tokens: List[int] = []
            for w in range(self._n_windows[rid]):
                new_tokens = res.get(w)
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
            done.append((rid, t.tok.decode(tokens, skip_special=True),
                         tokens))
            self._order.remove(rid)
            del self._n_windows[rid], self._undecoded[rid]
        return done

    def flush(self) -> List[Tuple[object, str, List[int]]]:
        """step() until the pool drains; returns every completion."""
        out: List[Tuple[object, str, List[int]]] = []
        while self.pending():
            out.extend(self.step())
        out.extend(self.sweep())  # zero-window requests
        return out
