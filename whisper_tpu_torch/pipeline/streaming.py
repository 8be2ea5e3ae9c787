"""Streaming (incremental) transcription with local-agreement confirmation.

Counterpart of `whisper_tpu/pipeline/streaming.py`: audio arrives in
blocks of any size, each decode re-transcribes the current buffer, and a
segment becomes CONFIRMED once two consecutive decodes agree on its text
(LocalAgreement-2) and it ends clear of the buffer's live edge. Confirmed
text never changes afterwards. Every decode zero-pads the buffer to the
full window, so a stream always decodes one window shape; timestamped
decoding (pipeline/segments.py) gives the segment boundaries used for
agreement and for trimming confirmed audio off the buffer.

`StreamDecodeBatcher` merges concurrent sessions' window decodes into one
batched call of `BatchTranscriber._decode_batch`. Unlike the JAX batcher
it reads its client count under a lock, `decode()` waits with a timeout
and raises TimeoutError instead of hanging on a dead thread, every
exception of a group (BaseException included) becomes that group's error,
and `stop()` ends and joins its thread.

Decodes run on threads the public entry points never enter (the batcher's
thread, server handler threads), and PyTorch's grad mode is thread-local:
each decode enters `torch.inference_mode()` itself.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import HOP_LENGTH, SAMPLE_RATE
from ..ops.audio import max_waveform_samples
from ..utils.logging import get_logger
from . import vad
from .segments import Segment, segments_from_tokens
from .transcribe import DecodeOptions, Transcriber, compression_ratio

log = get_logger(__name__)

_STOP = object()  # the queue item that ends the batcher's thread


class StreamDecodeBatcher:
    """Batches CONCURRENT streaming sessions' window decodes into one
    `_decode_batch` call (streaming.py:46-176 of the JAX package).

    Sessions submit with `decode()` (blocking); the batcher's thread groups
    submissions with the same decode key up to `batch_size`, waiting up to
    `max_wait_s` for partners (skipped when `clients` says at most one
    session exists). A group runs at the smallest power of two >= its size
    (capped at `batch_size`), padded by repeating its first window, so
    partial demand pays for its rung only. `decode()` raises TimeoutError
    after `timeout_s`; `stop()` ends the thread, failing what is still
    queued."""

    def __init__(self, transcriber, batch_size: int = 8,
                 max_wait_s: float = 0.1, timeout_s: float = 600.0):
        if not hasattr(transcriber, "_decode_batch"):
            raise TypeError(
                "StreamDecodeBatcher needs a BatchTranscriber "
                "(the batched window decode lives there)")
        self.t = transcriber
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_s)
        self.timeout_s = float(timeout_s)
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._clients: Optional[int] = None
        self.batches = 0  # batched calls issued
        self.batched_requests = 0  # decodes they carried

    @property
    def clients(self) -> Optional[int]:
        """Open sessions, kept by the session registry
        (serve.StreamSessions); with <= 1 the coalescing wait is skipped.
        None (library callers): always wait."""
        with self._lock:
            return self._clients

    @clients.setter
    def clients(self, n: Optional[int]) -> None:
        with self._lock:
            self._clients = n

    def _ensure_started(self) -> None:
        with self._lock:
            if self._stopped:
                raise RuntimeError("StreamDecodeBatcher is stopped")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="stream-decode-batcher",
                    daemon=True)
                self._thread.start()

    def decode(self, window: np.ndarray, prompt: torch.Tensor,
               opt: DecodeOptions, sup_len: int, max_ts_idx: int):
        """Submit one full window (timestamped decode under `opt`); blocks
        until its batched call returns. Returns (tokens row (ctx,) numpy,
        length). Raises the group's error, or TimeoutError after
        `timeout_s`."""
        self._ensure_started()
        ids = tuple(int(t) for t in prompt.tolist())
        item = {
            "window": np.asarray(window, np.float32),
            "prompt": prompt, "opt": opt, "sup_len": int(sup_len),
            "max_ts_idx": int(max_ts_idx),
            "key": (len(ids), opt.strategy, opt.beam_size, opt.max_depth,
                    opt.padding, int(sup_len), opt.kv_quant, opt.self_quant,
                    int(max_ts_idx), ids),
            "done": threading.Event(), "out": None, "err": None,
        }
        self._q.put(item)
        if not item["done"].wait(self.timeout_s):
            alive = self._thread is not None and self._thread.is_alive()
            raise TimeoutError(
                f"stream decode not done after {self.timeout_s:g} s (batcher "
                f"thread {'alive' if alive else 'dead'})")
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def stop(self, timeout: float = 10.0) -> None:
        """End the thread after its current group and join it; decodes
        still queued fail with RuntimeError."""
        with self._lock:
            self._stopped = True
            thread = self._thread
        self._q.put(_STOP)
        if thread is not None:
            thread.join(timeout)
        self._fail_queued()

    def _fail_queued(self) -> None:
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                return
            if it is not _STOP:
                it["err"] = RuntimeError("StreamDecodeBatcher stopped")
                it["done"].set()

    def _run(self) -> None:
        while True:
            first = self._q.get()
            if first is _STOP:
                return
            group, spill = [first], []
            clients = self.clients
            deadline = (0.0 if clients is not None and clients <= 1
                        else time.monotonic() + self.max_wait_s)
            stop = False
            while len(group) < self.batch_size:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                (group if nxt["key"] == first["key"] else spill).append(nxt)
            for it in spill:  # other options: a later round
                self._q.put(it)
            try:
                self._run_group(group)
            except BaseException as e:  # the group's error, for its waiters
                for it in group:
                    it["err"] = e
                    it["done"].set()
                if not isinstance(e, Exception):
                    raise
            if stop:
                return

    def _run_group(self, group) -> None:
        it0 = group[0]
        size = 1
        while size < len(group):
            size *= 2
        size = min(size, self.batch_size)
        waves = np.stack([it["window"] for it in group])
        if len(group) < size:
            waves = np.concatenate(
                [waves, np.repeat(waves[:1], size - len(group), axis=0)])
        with torch.inference_mode():
            toks, lengths, _, _ = self.t._decode_batch(
                waves, it0["prompt"], it0["sup_len"], it0["opt"],
                timestamps=True, max_ts_idx=it0["max_ts_idx"])
        self.batches += 1
        self.batched_requests += len(group)
        for j, it in enumerate(group):
            it["out"] = (toks[j], int(lengths[j]))
            it["done"].set()


class StreamingTranscriber:
    """Incremental transcription over a growing audio stream.

    Usage::

        st = StreamingTranscriber(params, cfg, tokenizer)
        for block in audio_blocks:          # float32 mono @ 16 kHz
            for seg in st.push(block):      # newly CONFIRMED segments
                print(seg.text)
        for seg in st.finish():             # flush the unstable tail
            print(seg.text)

    `confirmed` accumulates every confirmed segment (absolute stream
    times). Confirmation requires two consecutive decodes to agree on a
    segment's text AND the segment to end at least
    `confirm_margin_seconds` before the live edge. When the buffer
    outgrows one window, segments entirely before the forced trim point
    are confirmed from the last hypothesis. A segment whose text fails the
    compression-ratio check is dropped instead of confirmed.

    A shared `transcriber` lets many streams reuse one model (params, cfg
    and tokenizer may then be None); its decodes are serialized by its
    lock. A shared `batcher` merges concurrent streams' decodes into
    batched calls instead. Without either, a Transcriber is built on
    `device` (the card unless given)."""

    def __init__(self, params, cfg, tokenizer,
                 options: Optional[DecodeOptions] = None,
                 min_step_seconds: float = 1.0,
                 confirm_margin_seconds: float = 0.3,
                 transcriber: Optional[Transcriber] = None,
                 batcher: Optional[StreamDecodeBatcher] = None,
                 device=None):
        self._t = transcriber or Transcriber(params, cfg, tokenizer,
                                             device=device)
        self._batcher = batcher
        self.opt = dataclasses.replace(options or DecodeOptions(),
                                       timestamps=True)
        self.min_step_seconds = float(min_step_seconds)
        self.confirm_margin_seconds = float(confirm_margin_seconds)
        self._n_window = max_waveform_samples(
            self._t.cfg.encoder_ctx_size - self.opt.padding)
        self._prompt, self._n_cond = self._t._build_prompt(self.opt)
        self._buffer = np.zeros(0, np.float32)
        self._offset = 0.0  # stream time (s) of buffer[0]
        self._pending = 0  # samples pushed since the last decode
        self._prev: List[Segment] = []  # last hypothesis (unconfirmed)
        self.confirmed: List[Segment] = []
        self.decodes = 0  # window decodes issued

    @property
    def text(self) -> str:
        """All confirmed text so far."""
        return " ".join(s.text.strip() for s in self.confirmed)

    def push(self, samples, sample_rate: int = SAMPLE_RATE) -> List[Segment]:
        """Append audio; returns the segments that just became confirmed.
        Decodes once at least `min_step_seconds` of new audio has
        accumulated."""
        if sample_rate != SAMPLE_RATE:
            raise ValueError(
                f"streaming expects {SAMPLE_RATE} Hz audio, got {sample_rate}")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buffer = np.concatenate([self._buffer, samples])
        self._pending += len(samples)
        if self._pending < int(self.min_step_seconds * SAMPLE_RATE):
            return []
        self._pending = 0
        return self._step()

    def finish(self) -> List[Segment]:
        """Decode whatever remains and confirm all of it: full windows of
        a backlog first (a silent one skipped under VAD), then the rest."""
        tail: List[Segment] = []
        while len(self._buffer) > self._n_window:
            if self.opt.vad and vad.is_silent(
                    self._buffer[:self._n_window], SAMPLE_RATE,
                    self.opt.vad_threshold_db,
                    self.opt.vad_min_speech_seconds):
                self._trim_to(self._offset + self._n_window / SAMPLE_RATE)
                self._prev = []
                continue
            tail.extend(s for s in self._decode() if self._confirm_ok(s))
            self._trim_to(self._offset + self._n_window / SAMPLE_RATE)
            self._prev = []
        if len(self._buffer) < 400:  # < n_fft: nothing left to decode
            tail.extend(s for s in self._prev if self._confirm_ok(s))
        elif not self._skip_silence():
            tail.extend(s for s in self._decode() if self._confirm_ok(s))
        self.confirmed.extend(tail)
        self._buffer = np.zeros(0, np.float32)
        self._prev = []
        self._pending = 0
        return tail

    def _confirm_ok(self, seg: Segment) -> bool:
        """The quality gate on permanent confirmation (streaming.py:291):
        a segment whose text trips the compression-ratio check is dropped,
        so a repetition loop never enters the immutable transcript."""
        thr = self.opt.compression_ratio_threshold
        if thr is not None and compression_ratio(seg.text) > thr:
            log.warning("dropping low-quality segment [%.2f-%.2f] at "
                        "confirmation (compression ratio %.2f > %.2f): %r",
                        seg.start, seg.end, compression_ratio(seg.text), thr,
                        seg.text[:80])
            return False
        return True

    def _decode(self) -> List[Segment]:
        """One timestamped decode of the buffer zero-padded to the full
        window; segments inside the padding are dropped and ends clamped
        to the live audio."""
        real = min(len(self._buffer), self._n_window)
        window = np.zeros(self._n_window, np.float32)
        window[:real] = self._buffer[:real]
        max_ts_idx = max(0, int(round(self.opt.max_initial_timestamp / 0.02)))
        sup_len = self.opt.suppress_until_len + self._n_cond
        self.decodes += 1
        if self._batcher is not None:
            row, length = self._batcher.decode(window, self._prompt, self.opt,
                                               sup_len, max_ts_idx)
            tokens = [int(t) for t in row[:length]]
        else:
            with self._t._decode_lock, torch.inference_mode():
                tokens = self._t._decode(
                    window, self._prompt, sup_len, self.opt, timestamps=True,
                    max_initial_ts_idx=max_ts_idx, sot_pos=self._n_cond)[0]
        tokens = tokens[self._n_cond:]  # drop the conditioning prefix
        real_s = real / SAMPLE_RATE
        segs = segments_from_tokens(tokens, self._t.tok,
                                    offset_s=self._offset, window_s=real_s)
        return [Segment(s.start, min(s.end, self._offset + real_s), s.text,
                        s.tokens)
                for s in segs if s.start - self._offset < real_s]

    def _trim_to(self, cut_time: float) -> None:
        """Drop buffer audio before `cut_time` (absolute stream seconds)."""
        cut = int(round((cut_time - self._offset) * SAMPLE_RATE))
        cut = max(0, min(cut, len(self._buffer)))
        self._buffer = self._buffer[cut:]
        self._offset += cut / SAMPLE_RATE

    def _skip_silence(self) -> bool:
        """Energy VAD for live sessions (DecodeOptions.vad): with no
        unstable hypothesis and a silent buffer, skip the decode and drop
        the dead air, keeping a tail of >= 0.5 s and >= the VAD speech
        floor so a word starting at the live edge is never cut."""
        if not self.opt.vad or self._prev:
            return False
        if not vad.is_silent(self._buffer, SAMPLE_RATE,
                             self.opt.vad_threshold_db,
                             self.opt.vad_min_speech_seconds):
            return False
        keep = max(SAMPLE_RATE // 2,
                   int(self.opt.vad_min_speech_seconds * SAMPLE_RATE)
                   + HOP_LENGTH)
        if len(self._buffer) > keep:
            self._trim_to(
                self._offset + (len(self._buffer) - keep) / SAMPLE_RATE)
        return True

    def _step(self) -> List[Segment]:
        if self._skip_silence():
            return []
        newly: List[Segment] = []
        # forced trim: audio beyond one window can never be decoded again,
        # so the last hypothesis is confirmed up to the cut
        over = len(self._buffer) - self._n_window
        if over > 0:
            cut_time = self._offset + over / SAMPLE_RATE
            while self._prev and self._prev[0].end <= cut_time:
                seg = self._prev.pop(0)
                if self._confirm_ok(seg):
                    newly.append(seg)
            self.confirmed.extend(newly)
            self._trim_to(cut_time)

        segs = self._decode()
        # LocalAgreement-2: the leading segments whose text matches the
        # previous hypothesis and which end clear of the live edge
        live_edge = self._offset + len(self._buffer) / SAMPLE_RATE
        margin_t = live_edge - self.confirm_margin_seconds
        n = 0
        for a, b in zip(self._prev, segs):
            if a.text.strip() == b.text.strip() and b.end <= margin_t:
                n += 1
            else:
                break
        if n:
            # a stable repetition loop agrees with itself: gate it too, but
            # trim past the agreed span so it is not re-decoded forever
            agreed = [s for s in segs[:n] if self._confirm_ok(s)]
            self.confirmed.extend(agreed)
            newly.extend(agreed)
            self._trim_to(segs[n - 1].end)
        self._prev = segs[n:]
        return newly
