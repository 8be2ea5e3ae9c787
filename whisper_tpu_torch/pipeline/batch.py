"""Batched multi-stream transcription.

Counterpart of `whisper_tpu/pipeline/batch.py::BatchTranscriber`
(:49-426). Every stream is windowed as `Transcriber.transcribe`
windows it (the same ~14.9 s windows, overlap and zero padding); the FULL
windows of all streams are packed into batches of `batch_size` and each
batch runs log-mel (per-sample dynamic-range clamp, so a window's mel does
not depend on its batch mates) -> encoder on the batch -> `greedy_decode`
or `beam_search_batched`. A short last batch is padded by repeating its
first window, as JAX pads it, so the encoder's row count -- and with it
the W8A8 kernel choice (K6 at <= 1024 rows, K7 above) -- is that of a full
batch. Tail windows go one at a time through the single-window path, and
each stream is stitched on its own.

A batch is built on the device (`_BatchRows`): its windows are slices of
the callers' samples, and consecutive windows of a stream overlap, so each
stretch of a stream that a batch's windows cover crosses the bus once,
through a pinned host buffer, and the rows are cut from it on the device.

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

Under a mesh (`Transcriber(mesh=)`), `batch_size` is rounded up to a
multiple of dp, and `_decode_batch` is the split point: each dp rank
decodes its rows of the batch, then the host outputs (tokens, lengths,
sum_logp, p(<|nospeech|>)) are gathered over dp before any decision, so
the ladder, the quality gates and the tails are decided identically on
every rank from the whole batch. A sampling rung draws the whole batch's
noise on every rank and keeps its rows (`decode/greedy.py::
sample_tokens`), so a meshed ladder draws what the meshless one draws.

`WindowPool` is the open-ended version of `transcribe_many` that the
server's `BatchingWorker` (serve.py) drives: requests join at any time,
each `step()` decodes one batch of `batch_size` full windows drawn across
every admitted request, padded as `_decode_windows` pads a short batch,
and finished requests are stitched as `transcribe_many` stitches them.

`transcribe_many` names its phases in a profiler's trace
(`utils/profiling.scope`, one attribute read when none records):
`whisper.transcribe_many` around the call, `whisper.window` around the
windowing, a `whisper.batch` a batch (inside it `whisper.batch.stack`,
`whisper.encode`, `whisper.decode` and `whisper.readback`), a
`whisper.tail` a tail window and a `whisper.stitch` a stream; the decode
loops add `whisper.decode.prefill`, `whisper.decode.step` and the step's
one blocking read, `whisper.decode.sync`.
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
from ..parallel.context import dp_all_gather, dp_axis, dp_rows
from ..utils.profiling import scope
from .transcribe import (DecodeOptions, Transcriber, Window,
                         _check_supported, _meshed, _rung_generator,
                         compression_ratio, evaluate_window_quality,
                         find_chunk_overlap, plan_windows, window_samples)

log = logging.getLogger(__name__)

WindowKey = Tuple[int, int]  # (stream, window index)
# (a stream's samples, contiguous writeable float32; a full window's start)
Row = Tuple[np.ndarray, int]


def _samples(wave) -> np.ndarray:
    """A stream's samples as `_BatchRows` reads them: contiguous writeable
    float32, copied only if the caller's array is not (torch wraps
    read-only memory with a warning)."""
    return np.require(wave, np.float32, ["C", "W"])


class _BatchRows:
    """Builds (B, n_window) float32 batches of full windows on `device`.

    A row is a stream's samples (`_samples`) and a window's start in them;
    the window is samples[start:start + n_window], and rows of one stream
    that overlap or touch form one stretch. `batch` writes each stretch
    once into a host buffer, enqueues one copy of them all to the device
    without waiting for it, and cuts the rows out of the device copy with
    slices, in row order, repeating the first row up to the batch size, as
    a short batch is padded. On a CUDA device the buffer is pinned memory
    from PyTorch's caching host allocator (the builders of later calls get
    the same block back), and a builder writes it again only after the
    copy out of it has finished."""

    def __init__(self, device, n_window: int):
        self.device = torch.device(device)
        self.n = n_window
        self._pin = self.device.type == "cuda"
        self._host: Optional[torch.Tensor] = None
        self._copied = None  # event after the last copy out of `_host`

    def _stage(self, rows: Sequence[Row]) -> Tuple[torch.Tensor, List[int]]:
        """(the rows' stretches on the device, each row's offset in it)."""
        runs: List[list] = []  # [samples, first sample, end, offset]
        offsets, total = [], 0
        for wave, start in rows:
            run = runs[-1] if runs else None
            if run is None or run[0] is not wave or not (
                    run[1] <= start <= run[2]):
                run = [wave, start, start, total]
                runs.append(run)
            end = max(run[2], start + self.n)
            total += end - run[2]
            run[2] = end
            offsets.append(run[3] + start - run[1])
        if self._copied is not None:
            self._copied.synchronize()
        if self._host is None or self._host.numel() < total:
            self._host = torch.empty(len(rows) * self.n, dtype=torch.float32,
                                     pin_memory=self._pin)
        for wave, lo, hi, at in runs:  # torch's copy runs on every core
            self._host[at:at + hi - lo].copy_(torch.from_numpy(wave[lo:hi]))
        audio = self._host[:total].to(self.device, non_blocking=True,
                                      copy=True)
        if self._pin:
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))
        return audio, offsets

    def batch(self, rows: Sequence[Row], batch_size: int) -> torch.Tensor:
        """The (batch_size, n_window) batch of `rows` on the device."""
        audio, offsets = self._stage(rows)
        offsets += offsets[:1] * (batch_size - len(offsets))
        return torch.stack([audio[o:o + self.n] for o in offsets])


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


def _splice(windows: Sequence[Optional[List[int]]],
            opt: DecodeOptions) -> List[int]:
    """One stream's tokens from its windows' (None: not decoded), each
    spliced onto the tokens before it where `find_chunk_overlap` finds an
    overlap, else appended."""
    tokens: List[int] = []
    for new_tokens in windows:
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
    return tokens


class BatchTranscriber(Transcriber):
    """A Transcriber with many-streams entry points: full windows decode
    `batch_size` at a time (greedy, or beam search over W x K lanes)."""

    def __init__(self, *args, batch_size: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if self.mesh is not None:
            dp = self.mesh.shape.get("dp", 1)
            if batch_size % dp != 0:
                rounded = -(-batch_size // dp) * dp
                log.info(
                    "batch_size %d rounded up to %d (multiple of dp=%d)",
                    batch_size, rounded, dp,
                )
                batch_size = rounded
        self.batch_size = batch_size

    @_meshed
    def _decode_batch(self, waves, prompt: torch.Tensor,
                      suppress_until_len: int, opt: DecodeOptions,
                      timestamps: bool = False, max_ts_idx: int = 50,
                      quality: bool = False, temperature: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      sot_pos: int = 0):
        """(B, n) windows (a tensor on the device, or numpy) -> (tokens (B,
        ctx), lengths (B,), sum_logp (B,), p(<|nospeech|>) (B,), -1 unless
        `quality` asks for it) as numpy, prompt included
        (batch.py:114-154): beam search over B x K lanes at temperature 0
        with strategy "beam", else greedy (sampling at temperature > 0 from
        `generator`). Under a mesh whose dp divides B, this rank decodes its
        B / dp rows and the outputs are gathered over dp; otherwise every
        rank decodes the whole batch."""
        args = (prompt, suppress_until_len, opt, timestamps, max_ts_idx,
                quality, temperature, generator, sot_pos)
        if self.mesh is None or dp_axis(self.mesh, len(waves)) is None:
            return self._decode_rows(waves, *args)
        n = len(waves) // self.mesh.shape["dp"]
        first = self.mesh.dp_rank * n
        with dp_rows(first, len(waves)):
            out = self._decode_rows(waves[first:first + n], *args)
        return tuple(dp_all_gather(list(out), self.mesh))

    def _decode_rows(self, waves, prompt, suppress_until_len, opt,
                     timestamps, max_ts_idx, quality, temperature, generator,
                     sot_pos):
        """`_decode_batch` over the rows this rank decodes."""
        enc = self._encode_windows(waves, opt)
        common = self._decode_args(opt, suppress_until_len, timestamps,
                                   max_ts_idx, quality, sot_pos)
        with scope("whisper.decode"):
            if opt.strategy == "beam" and temperature == 0.0:
                out = beam_search_batched(self.params, enc, prompt, self.cfg,
                                          beam_size=opt.beam_size, **common)
            else:
                out = greedy_decode(self.params, enc, prompt, self.cfg,
                                    temperature=temperature,
                                    generator=generator, **common)
        with scope("whisper.readback"):
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
        prompt, n_cond = self._build_prompt(opt)
        sup_len = opt.suppress_until_len + n_cond

        full: List[WindowKey] = []
        tail: List[Tuple[int, Window]] = []
        n_windows = [0] * len(waveforms)
        bounds: Dict[WindowKey, Tuple[int, int]] = {}
        with scope("whisper.window"):
            waves = [_samples(w) for w in waveforms]
            for s, wave in enumerate(waves):
                for w in plan_windows(wave, sample_rate, self.cfg, opt):
                    n_windows[s] = w.i + 1
                    bounds[(s, w.i)] = (w.start, w.end)
                    if w.kind == "full":
                        full.append((s, w.i))
                    elif w.kind == "tail":
                        tail.append((s, w))

        def rows(group: Sequence[WindowKey]) -> List[Row]:
            return [(waves[s], bounds[(s, w)][0]) for s, w in group]

        results: Dict[Tuple[int, int], List[int]] = {}
        meta: Dict[Tuple[int, int], tuple] = {}
        n_prompt = int(prompt.shape[0])
        temps, use_ladder = self._ladder_temps(opt)
        # the gates need the quality outputs, and so do the timestamped
        # path's per-segment metadata
        quality = use_ladder or timestamps
        bsz = self.batch_size
        builder = _BatchRows(self.device, window_samples(self.cfg, opt))
        pending = full
        for ti, temp in enumerate(temps):
            failures: List[WindowKey] = []
            for i in range(0, len(pending), bsz):
                with scope("whisper.batch"):
                    group = pending[i:i + bsz]
                    with scope("whisper.batch.stack"):
                        batch = builder.batch(rows(group), bsz)
                    gen = (_rung_generator(self.device, opt.seed,
                                           ti * 100003 + i)
                           if temp > 0.0 else None)
                    t0 = time.perf_counter()
                    toks, lengths, logps, nss = self._decode_batch(
                        batch, prompt, sup_len, opt, timestamps, max_ts_idx,
                        quality, temp, gen, sot_pos=n_cond)
                    for j, (s, w) in enumerate(group):
                        tl = [int(t) for t in toks[j, :lengths[j]]][n_cond:]
                        if not quality:
                            results[(s, w)] = tl
                            continue
                        ns = float(nss[j])
                        if not use_ladder:  # metadata only, no gating
                            results[(s, w)] = tl
                            n_sampled = max(int(lengths[j]) - n_prompt, 1)
                            meta[(s, w)] = (
                                float(logps[j]) / n_sampled,
                                compression_ratio(
                                    self.tok.decode(tl, skip_special=True)),
                                ns if ns >= 0.0 else None)
                            continue
                        ok, silence, avg_lp, cr = evaluate_window_quality(
                            opt, self.tok, tl, int(lengths[j]) - n_prompt,
                            logps[j], ns)
                        m = (avg_lp, cr, ns if ns >= 0.0 else None)
                        if silence:
                            log.info("stream %d window %d: no speech "
                                     "(p=%.2f), skipping", s, w, ns)
                            results[(s, w)], meta[(s, w)] = [], m
                        elif ok or ti == len(temps) - 1:
                            if ti:
                                log.info("stream %d window %d: accepted at "
                                         "t=%.1f (avg_logprob %.2f, "
                                         "compression %.2f)", s, w, temp,
                                         avg_lp, cr)
                            results[(s, w)], meta[(s, w)] = tl, m
                        else:
                            log.info("stream %d window %d: t=%.1f failed "
                                     "checks (avg_logprob %.2f, compression "
                                     "%.2f), queueing re-decode", s, w, temp,
                                     avg_lp, cr)
                            failures.append((s, w))
                    log.info("batch %d-%d/%d windows (t=%.1f) in %.2fs", i,
                             i + len(group), len(pending), temp,
                             time.perf_counter() - t0)
            pending = failures
            if not pending:
                break

        for s, w in tail:
            key = (s, w.i)
            with scope("whisper.tail"):
                if quality:
                    results[key], _, meta[key] = self._decode_window_ladder(
                        s * 100003 + w.i, w.samples, prompt, n_cond, sup_len,
                        opt, temps, timestamps=timestamps,
                        max_initial_ts_idx=max_ts_idx)
                else:
                    results[key] = self._decode(w.samples, prompt, sup_len,
                                                opt)[0][n_cond:]
        return results, meta, bounds, n_windows

    def transcribe_many(self, waveforms: Sequence[np.ndarray],
                        sample_rate: int = SAMPLE_RATE,
                        options: Optional[DecodeOptions] = None
                        ) -> List[Tuple[str, List[int]]]:
        """Transcribe N independent streams; returns [(text, tokens)] in
        input order, stitched per stream as `transcribe` stitches
        (src/transcribe.rs:56-63)."""
        with scope("whisper.transcribe_many"):
            opt = options or DecodeOptions()
            _check_batch_supported(opt)
            with torch.inference_mode():
                results, _, _, n_windows = self._decode_windows(
                    waveforms, sample_rate, opt)
            out: List[Tuple[str, List[int]]] = []
            for s in range(len(waveforms)):
                with scope("whisper.stitch"):
                    tokens = _splice([results.get((s, w))
                                      for w in range(n_windows[s])], opt)
                    out.append((self.tok.decode(tokens, skip_special=True),
                                tokens))
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
    are complete, stitched. A batch is built by `_BatchRows`, as
    `_decode_windows` builds it: a short one is padded to `batch_size` by
    repeating its first window, so the
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
        self._prompt, self._n_cond = transcriber._build_prompt(opt)
        self._sup_len = opt.suppress_until_len + self._n_cond
        # a 1-tuple temperature is poolable (no ladder)
        self._temperature = float(Transcriber._ladder_temps(opt)[0][0])
        self._queue: List[Tuple[object, int, int]] = []  # (rid, w, start)
        self._waves: dict = {}  # rid -> samples
        self._rows = _BatchRows(transcriber.device,
                                window_samples(transcriber.cfg, opt))
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
        wave = _samples(waveform)
        self._waves[rid] = wave
        self._results[rid] = {}
        self._n_windows[rid] = 0
        self._undecoded[rid] = 0
        self._tails[rid] = []
        self._order.append(rid)
        for w in plan_windows(wave, self.sr, self.t.cfg, self.opt):
            self._n_windows[rid] = w.i + 1  # skipped: a gap in the stitch
            if w.kind == "full":
                self._queue.append((rid, w.i, w.start))
            elif w.kind == "tail":
                self._tails[rid].append((w.i, w.samples))
            else:
                continue
            self._undecoded[rid] += 1

    def cancel(self, rid) -> None:
        """Drop a request's still-queued windows (an abandoned waiter)."""
        self._queue = [q for q in self._queue if q[0] != rid]
        self._waves.pop(rid, None)
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
                waves = self._rows.batch(
                    [(self._waves[rid], start) for rid, _, start in group],
                    t.batch_size)
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
            tokens = _splice([res.get(w)
                              for w in range(self._n_windows[rid])], opt)
            done.append((rid, t.tok.decode(tokens, skip_special=True),
                         tokens))
            self._order.remove(rid)
            del self._n_windows[rid], self._undecoded[rid], self._waves[rid]
        return done

    def flush(self) -> List[Tuple[object, str, List[int]]]:
        """step() until the pool drains; returns every completion."""
        out: List[Tuple[object, str, List[int]]] = []
        while self.pending():
            out.extend(self.step())
        out.extend(self.sweep())  # zero-window requests
        return out
