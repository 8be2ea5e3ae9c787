"""Batching HTTP transcription server of the PyTorch/CUDA port (stdlib
HTTP, no framework).

Counterpart of `whisper_tpu/serve.py`: POST a WAV body to /transcribe and
get JSON back; concurrent requests share the batched path.

    python -m whisper_tpu_torch.serve <model> [--port 8000] [--batch-size 8]
        [--device cuda|cpu] ...
    python -m whisper_tpu_torch.cli serve <model> ...

Endpoints:
  POST /transcribe?lang=en[&greedy=1][&task=translate]
       [&initial_prompt=...][&vad=1]   body: WAV bytes -> {"text", "tokens"}
       lang=auto detects the spoken language (the response carries
       "language" and "language_probs"); &timestamps=1 returns {"text",
       "segments"} (&words=1 adds per-word timings); &format=srt|vtt|tsv
       returns the subtitle document raw (vtt + words=1: per-word cues)
  POST /stream/start?lang=en[&task=..][&greedy=1][&initial_prompt=..][&vad=1]
       -> {"session": id}
  POST /stream/<id>/push?format=f32|s16  body: raw PCM block
                                         -> {"confirmed": [segments]}
  POST /stream/<id>/finish               -> {"confirmed": [...], "text": ...}
  GET  /healthz                          -> {"status": "ok", ...}
  GET  /metrics                          -> Prometheus text exposition

Limits: bodies above --max-body-mb get 413, a full request queue 503, a
request not done within --request-timeout-s 504 (the worker then skips
it), more than --max-streams open sessions 409; a bad body, task or format
400, an unknown path or session 404.

`BatchingWorker` runs plain single-temperature requests through one
`pipeline.batch.WindowPool` per options key (continuous batching: one
window batch per loop iteration, round robin between pools, newcomers
admitted between batches) and the rest -- the ladder, timestamps,
lang=auto -- as one `transcribe_many*` call per same-options group.
`StreamSessions` keeps the live sessions (`pipeline/streaming.py`), all
sharing one model and one `StreamDecodeBatcher`. Beyond the JAX server,
the worker and the stream batcher have `stop()` and are joined on
shutdown, and `serve()` builds the kernels and decodes a first window
before it reports ready, so no request pays the build.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import secrets
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .pipeline.transcribe import DecodeOptions
from .utils.logging import get_logger

log = get_logger(__name__)


class _Request:
    def __init__(self, wave: np.ndarray, lang: str, greedy: bool,
                 task: str = "transcribe", initial_prompt=None,
                 timestamps: bool = False, words: bool = False,
                 vad: bool = False):
        self.wave = wave
        self.lang = lang
        self.greedy = greedy
        self.task = task
        self.initial_prompt = initial_prompt
        self.timestamps = timestamps
        self.words = words
        self.vad = vad
        self.done = threading.Event()
        self.result: Optional[tuple] = None
        self.segments = None  # timestamped path: [Segment]
        self.detected_lang: Optional[str] = None  # lang == "auto"
        self.detected_probs: Optional[dict] = None  # {code: p} when auto
        self.error: Optional[str] = None
        # set by the handler when its waiter gave up (504): the worker
        # drops abandoned requests instead of decoding them
        self.abandoned = False

    def opts_key(self):
        return (self.lang, self.greedy, self.task, self.initial_prompt,
                self.timestamps, self.words, self.vad)


class Metrics:
    """Lock-protected serving counters, exposed at /metrics (Prometheus
    text exposition format)."""

    # seconds; decode latency spans ~100 ms to minutes
    LATENCY_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                       60.0, 120.0)

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_total = 0  # accepted into the queue
        self.responses = {}  # status code -> count
        self.batches_total = 0
        self.batched_requests = 0  # sum of batch fills (for the average)
        self.audio_seconds_total = 0.0
        self.errors_total = 0
        self._lat_counts = [0] * (len(self.LATENCY_BUCKETS) + 1)
        self._lat_sum = 0.0
        self._lat_n = 0

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self._lat_sum += seconds
            self._lat_n += 1
            for i, b in enumerate(self.LATENCY_BUCKETS):
                if seconds <= b:
                    self._lat_counts[i] += 1
                    return
            self._lat_counts[-1] += 1

    def count_response(self, code: int) -> None:
        with self._lock:
            self.responses[code] = self.responses.get(code, 0) + 1

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def render(self, worker, streams) -> str:
        with self._lock:
            lines = [
                "# TYPE whisper_requests_total counter",
                f"whisper_requests_total {self.requests_total}",
                "# TYPE whisper_responses_total counter",
                *(f'whisper_responses_total{{code="{c}"}} {n}'
                  for c, n in sorted(self.responses.items())),
                "# TYPE whisper_batches_total counter",
                f"whisper_batches_total {self.batches_total}",
                "# TYPE whisper_batched_requests_total counter",
                f"whisper_batched_requests_total {self.batched_requests}",
                "# TYPE whisper_audio_seconds_total counter",
                f"whisper_audio_seconds_total {self.audio_seconds_total:.3f}",
                "# TYPE whisper_errors_total counter",
                f"whisper_errors_total {self.errors_total}",
                "# TYPE whisper_queue_depth gauge",
                f"whisper_queue_depth {worker.q.qsize()}",
                "# TYPE whisper_dropped_requests_total counter",
                f"whisper_dropped_requests_total {worker.dropped}",
                "# TYPE whisper_open_streams gauge",
                f"whisper_open_streams "
                f"{0 if streams is None else streams.open_count()}",
                "# TYPE whisper_request_latency_seconds histogram",
            ]
            acc = 0
            for b, n in zip(self.LATENCY_BUCKETS, self._lat_counts):
                acc += n
                lines.append(
                    f'whisper_request_latency_seconds_bucket{{le="{b}"}} '
                    f"{acc}")
            acc += self._lat_counts[-1]
            lines.append(
                f'whisper_request_latency_seconds_bucket{{le="+Inf"}} {acc}')
            lines.append(
                f"whisper_request_latency_seconds_sum {self._lat_sum:.3f}")
            lines.append(
                f"whisper_request_latency_seconds_count {self._lat_n}")
        return "\n".join(lines) + "\n"


class BatchingWorker(threading.Thread):
    """Batches concurrent requests onto the card.

    CONTINUOUS (default): plain single-temperature requests feed a shared
    `WindowPool` per options key; each loop iteration decodes ONE window
    batch of one pool (round robin), admitting new arrivals between
    batches. GROUPED (the ladder, timestamps, lang=auto, or
    continuous=False): same-options requests go out as one
    `transcribe_many*` call. The queue is bounded (503 when full);
    abandoned requests (504) are skipped before any decode. `stop()` ends
    the loop after its current batch, fails what is still queued or
    pooled, and `join()` waits for the thread."""

    POLL_S = 0.1  # how often an idle worker looks for stop()

    def __init__(self, transcriber, max_batch: int = 8,
                 max_wait_s: float = 0.05, max_queue: int = 256,
                 metrics: Optional[Metrics] = None,
                 continuous: bool = True):
        super().__init__(name="batching-worker", daemon=True)
        self.t = transcriber
        self.q: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.metrics = metrics or Metrics()
        self.processed = 0
        self.dropped = 0  # abandoned (504) requests skipped pre-dispatch
        self.continuous = continuous
        self._stop_event = threading.Event()
        # worker-thread-only state: opts_key -> (WindowPool, {rid: req})
        self._pools: dict = {}
        self._next_rid = 0

    def stop(self, timeout: float = 10.0) -> None:
        """End the loop and join the thread (within `timeout`)."""
        self._stop_event.set()
        if self.is_alive():
            self.join(timeout)

    # -- request intake -------------------------------------------------

    def _collect(self, block: bool) -> List[_Request]:
        """Drain up to max_batch arrivals; when idle, wait for the first
        (looking for stop() every POLL_S) and then max_wait_s for
        stragglers."""
        out: List[_Request] = []
        if block:
            while not out and not self._stop_event.is_set():
                try:
                    out.append(self.q.get(timeout=self.POLL_S))
                except queue.Empty:
                    pass
            deadline = time.monotonic() + self.max_wait_s
            while out and len(out) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    out.append(self.q.get(timeout=timeout))
                except queue.Empty:
                    break
        else:
            while len(out) < self.max_batch:
                try:
                    out.append(self.q.get_nowait())
                except queue.Empty:
                    break
        return out

    def _poolable(self, req: _Request) -> bool:
        from .pipeline.batch import WindowPool

        return (self.continuous
                # the pool drives BatchTranscriber internals (test fakes
                # and plain Transcribers take the grouped path)
                and hasattr(self.t, "_decode_batch")
                and req.lang != "auto"  # detection rides the grouped path
                and not req.timestamps and not req.words
                and WindowPool.poolable(self._opts(req)))

    def _admit(self, req: _Request) -> None:
        from .pipeline.batch import WindowPool

        pool = rid = None
        try:
            key = req.opts_key()
            entry = self._pools.get(key)
            if entry is None:
                pool = WindowPool(self.t, self._opts(req))
                entry = self._pools[key] = (pool, {})
            pool, members = entry
            rid = self._next_rid
            self._next_rid += 1
            pool.add(rid, req.wave)
        except Exception as e:  # the request's error, reported to its waiter
            if pool is not None and rid is not None:
                # add() may have queued windows before raising
                pool.cancel(rid)
            log.exception("admitting a request failed")
            req.error = str(e)
            self.metrics.add(errors_total=1)
            self._finish(req)
            return
        members[rid] = req

    # -- completion bookkeeping ------------------------------------------

    def _finish(self, req: _Request) -> None:
        self.processed += 1
        self.metrics.add(audio_seconds_total=len(req.wave) / 16000.0)
        req.done.set()

    def _step_pools(self) -> None:
        """One window batch of the first pool with work, moved to the end
        (round robin); the other pools are only swept."""
        for key in list(self._pools):
            pool, members = self._pools[key]
            for rid, r in list(members.items()):
                if r.abandoned:  # cancel before spending the card on it
                    pool.cancel(rid)
                    del members[rid]
                    self.dropped += 1
                    r.done.set()
            if not members:
                del self._pools[key]
        stepped = False
        for key in list(self._pools):
            pool, members = self._pools[key]
            try:
                if pool.pending() and not stepped:
                    stepped = True
                    self._pools[key] = self._pools.pop(key)
                    before = pool.pending()
                    done = pool.step()
                    # batch occupancy: the windows this batch decoded
                    self.metrics.add(batches_total=1,
                                     batched_requests=before - pool.pending())
                else:
                    done = pool.sweep()
            except Exception as e:  # the pool's error, for its waiters
                log.exception("a window batch failed")
                self.metrics.add(errors_total=len(members))
                for r in members.values():
                    if r.error is None and r.result is None:
                        r.error = str(e)
                    self._finish(r)
                del self._pools[key]
                continue
            for rid, text, tokens in done:
                r = members.pop(rid, None)
                if r is None:
                    continue
                r.result = (text, tokens)
                self._finish(r)
            if not members:
                del self._pools[key]

    def _has_pool_work(self) -> bool:
        return any(p.pending() or m for p, m in self._pools.values())

    def run(self) -> None:
        # grad mode is thread-local: this thread decodes in inference mode
        with torch.inference_mode():
            while not self._stop_event.is_set():
                arrivals = self._collect(block=not self._has_pool_work())
                legacy: List[_Request] = []
                for r in arrivals:
                    if r.abandoned:
                        self.dropped += 1
                        r.done.set()
                    elif self._poolable(r):
                        self._admit(r)
                    else:
                        legacy.append(r)
                groups: dict = {}
                for r in legacy:
                    groups.setdefault(r.opts_key(), []).append(r)
                for grp in groups.values():
                    self._dispatch_grouped(grp)
                self._step_pools()
        self._fail_pending("server shutting down")

    def _fail_pending(self, why: str) -> None:
        """Release every waiter still queued or pooled with `why`."""
        left = [r for _, members in self._pools.values()
                for r in members.values()]
        self._pools.clear()
        while True:
            try:
                left.append(self.q.get_nowait())
            except queue.Empty:
                break
        for r in left:
            if r.error is None and r.result is None:
                r.error = why
            r.done.set()

    def _dispatch_grouped(self, batch: List[_Request]) -> None:
        """One `transcribe_many*` call per same-options group; members
        whose waiter already gave up are dropped first."""
        for r in batch:
            if r.abandoned:
                self.dropped += 1
                r.done.set()
        batch = [r for r in batch if not r.abandoned]
        if not batch:
            return
        req = batch[0]
        try:
            # lang=auto: detect each request's language, then group by it
            # so every group still rides the batched path; a failed
            # detection fails only its own request
            if req.lang == "auto":
                ok = []
                for r in batch:
                    try:
                        r.detected_lang, r.detected_probs = \
                            self.t.detect_language(r.wave)
                        ok.append(r)
                    except Exception as e:  # that request's error
                        r.error = str(e)
                        self.metrics.add(errors_total=1)
                groups: dict = {}
                for r in ok:
                    groups.setdefault(r.detected_lang, []).append(r)
            else:
                groups = {req.lang: batch}
            for lang, grp in groups.items():
                self._run_group(grp, lang)
        except Exception as e:  # surface the error to every waiter
            log.exception("a grouped dispatch failed")
            for r in batch:
                if r.error is None and r.result is None:
                    r.error = str(e)
            self.metrics.add(errors_total=len(batch))
        finally:
            for r in batch:
                self._finish(r)

    @staticmethod
    def _opts(req: _Request, lang: Optional[str] = None) -> DecodeOptions:
        return DecodeOptions(
            lang=lang or req.lang,
            strategy="greedy" if req.greedy else "beam",
            task=req.task,
            initial_prompt=req.initial_prompt,
            vad=req.vad,
            # quantized client prompt lengths bound the distinct prompt
            # shapes a client can mint
            prompt_length_bucket=8)

    def _run_group(self, grp: List[_Request], lang: str) -> None:
        """One same-options, same-language group as ONE batched call,
        timestamped (and word-timestamped) requests included."""
        req = grp[0]
        opts = self._opts(req, lang=lang)
        if req.timestamps:
            results = self.t.transcribe_many_with_timestamps(
                [r.wave for r in grp], options=opts,
                word_timestamps=req.words)
            for r, (text, segs) in zip(grp, results):
                r.result = (text, None)
                r.segments = segs
        else:
            results = self.t.transcribe_many([r.wave for r in grp],
                                             options=opts)
            for r, (text, tokens) in zip(grp, results):
                r.result = (text, tokens)
        self.metrics.add(batches_total=1, batched_requests=len(grp))


class StreamSessions:
    """The live sessions of the /stream endpoints: each wraps a
    StreamingTranscriber, all share one transcriber (and, for a
    BatchTranscriber, one StreamDecodeBatcher). Bounded (`max_sessions`,
    409 when full), idle sessions evicted after `ttl_s`, ids unguessable;
    a per-session lock serializes pushes on one stream."""

    def __init__(self, transcriber, max_sessions: int = 16,
                 ttl_s: float = 300.0):
        self.shared_t = transcriber
        self.max_sessions = max_sessions
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._sessions = {}  # id -> dict(st, lock, last_used)
        self.batcher = None
        if hasattr(transcriber, "_decode_batch"):
            from .pipeline.streaming import StreamDecodeBatcher

            self.batcher = StreamDecodeBatcher(
                transcriber,
                batch_size=min(getattr(transcriber, "batch_size", 8),
                               max_sessions))

    def start(self, options) -> Optional[str]:
        from .pipeline.streaming import StreamingTranscriber

        with self._lock:
            self._evict_locked()
            if len(self._sessions) >= self.max_sessions:
                return None
            # unguessable: a session id gives access to its audio and text
            sid = secrets.token_urlsafe(16)
            st = StreamingTranscriber(None, None, None, options=options,
                                      transcriber=self.shared_t,
                                      batcher=self.batcher)
            self._sessions[sid] = {"st": st, "lock": threading.Lock(),
                                   "last_used": time.monotonic()}
            self._sync_batcher_clients()
            return sid

    def _sync_batcher_clients(self) -> None:
        # lone sessions skip the batcher's coalescing wait (holds _lock)
        if self.batcher is not None:
            self.batcher.clients = len(self._sessions)

    def _get(self, sid):
        with self._lock:
            s = self._sessions.get(sid)
            if s is not None:
                s["last_used"] = time.monotonic()
            return s

    def push(self, sid: str, samples: np.ndarray):
        s = self._get(sid)
        if s is None:
            return None
        with s["lock"]:
            return s["st"].push(samples)

    def finish(self, sid: str):
        s = self._get(sid)
        if s is None:
            return None
        with s["lock"]:
            tail = s["st"].finish()
            text = s["st"].text
        with self._lock:
            self._sessions.pop(sid, None)
            self._sync_batcher_clients()
        return tail, text

    def open_count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def stop(self, timeout: float = 10.0) -> None:
        """Stop and join the stream batcher's thread."""
        if self.batcher is not None:
            self.batcher.stop(timeout)

    def _evict_locked(self) -> None:
        now = time.monotonic()
        for sid in [k for k, v in self._sessions.items()
                    if now - v["last_used"] > self.ttl_s]:
            del self._sessions[sid]
        self._sync_batcher_clients()


def _top_probs(dist: dict, k: int = 5) -> dict:
    """Top-k language probabilities, rounded, for lang=auto responses."""
    top = sorted(dist.items(), key=lambda kv: -kv[1])[:k]
    return {code: round(p, 4) for code, p in top}


def _pcm_to_f32(data: bytes, fmt: str) -> np.ndarray:
    """Raw PCM body -> float32 waveform (f32le or s16le)."""
    if fmt == "s16":
        return np.frombuffer(data, "<i2").astype(np.float32) / 32767.0
    return np.frombuffer(data, "<f4").astype(np.float32)


def _flag(params: dict, name: str) -> bool:
    return params.get(name, ["0"])[0] in ("1", "true")


def make_handler(worker: BatchingWorker, sample_rate: int,
                 max_body_bytes: int = 64 * 1024 * 1024,
                 request_timeout_s: float = 120.0,
                 streams: Optional[StreamSessions] = None):
    from .io import wav as wavmod

    metrics = worker.metrics

    class Handler(BaseHTTPRequestHandler):
        timeout = 30.0  # drop half-open clients instead of pinning threads

        def _json(self, code: int, obj) -> None:
            self._raw(code, json.dumps(obj), "application/json")

        def _raw(self, code: int, body: str, content_type: str) -> None:
            data = body.encode()
            metrics.count_response(code)
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):  # quiet default logging
            pass

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok",
                                 "processed": worker.processed,
                                 "dropped": worker.dropped})
            elif path == "/metrics":
                self._raw(200, metrics.render(worker, streams),
                          "text/plain; version=0.0.4")
            else:
                self._json(404, {"error": "not found"})

        def _read_body(self) -> Optional[bytes]:
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._json(400, {"error": "bad Content-Length"})
                return None
            if length < 0 or length > max_body_bytes:
                self._json(413, {"error": f"body exceeds {max_body_bytes} "
                                          "bytes"})
                return None
            data = self.rfile.read(length) if length else b""
            if len(data) < length:
                self._json(400, {"error": "truncated body"})
                return None
            return data

        def _do_stream(self, parsed) -> None:
            if streams is None:
                self._json(404, {"error": "streaming disabled"})
                return
            parts = parsed.path.split("/")  # ["", "stream", ...]
            params = parse_qs(parsed.query)

            def seg_json(segs):
                return [{"start": round(s.start, 3), "end": round(s.end, 3),
                         "text": s.text} for s in segs]

            if parts[2:] == ["start"]:
                task = params.get("task", ["transcribe"])[0]
                if task not in ("transcribe", "translate"):
                    self._json(400, {"error": "task must be transcribe|"
                                              "translate"})
                    return
                opts = DecodeOptions(
                    lang=params.get("lang", ["en"])[0], task=task,
                    strategy="greedy" if _flag(params, "greedy") else "beam",
                    initial_prompt=params.get("initial_prompt", [None])[0],
                    vad=_flag(params, "vad"),
                    prompt_length_bucket=8)  # see BatchingWorker._opts
                sid = streams.start(opts)
                if sid is None:
                    self._json(409, {"error": "too many open streams"})
                else:
                    self._json(200, {"session": sid})
                return
            if len(parts) == 4 and parts[3] in ("push", "finish"):
                sid = parts[2]
                if parts[3] == "push":
                    data = self._read_body()
                    if data is None:
                        return
                    fmt = params.get("format", ["f32"])[0]
                    if fmt not in ("f32", "s16"):
                        self._json(400, {"error": "format must be f32|s16"})
                        return
                    try:
                        samples = _pcm_to_f32(data, fmt)
                    except ValueError as e:
                        self._json(400, {"error": f"bad pcm: {e}"})
                        return
                    out = streams.push(sid, samples)
                    if out is None:
                        self._json(404, {"error": "unknown session"})
                    else:
                        self._json(200, {"confirmed": seg_json(out)})
                    return
                res = streams.finish(sid)
                if res is None:
                    self._json(404, {"error": "unknown session"})
                else:
                    tail, text = res
                    self._json(200, {"confirmed": seg_json(tail),
                                     "text": text})
                return
            self._json(404, {"error": "not found"})

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path.startswith("/stream/"):
                self._do_stream(parsed)
                return
            if parsed.path != "/transcribe":
                self._json(404, {"error": "not found"})
                return
            params = parse_qs(parsed.query)
            lang = params.get("lang", ["en"])[0]
            task = params.get("task", ["transcribe"])[0]
            timestamps = _flag(params, "timestamps")
            out_format = params.get("format", ["json"])[0]
            if task not in ("transcribe", "translate"):
                self._json(400, {"error": f"bad task: {task}"})
                return
            if out_format not in ("json", "srt", "vtt", "tsv"):
                self._json(400, {"error": f"bad format: {out_format}"})
                return
            if out_format != "json" and not timestamps:
                self._json(400, {"error": f"format={out_format} requires "
                                          "timestamps=1"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._json(400, {"error": "bad Content-Length"})
                return
            if length <= 0:
                self._json(400, {"error": "empty body"})
                return
            if length > max_body_bytes:
                self._json(413, {"error": f"body exceeds {max_body_bytes} "
                                          "bytes"})
                return
            data = self.rfile.read(length)
            if len(data) < length:
                self._json(400, {"error": "truncated body"})
                return
            try:
                wave, rate = wavmod.decode_wav(data)  # in-memory parse
                if rate != sample_rate:
                    wave = wavmod.resample(wave, rate, sample_rate)
            except Exception as e:  # any parse failure is the client's 400
                self._json(400, {"error": f"bad audio: {e}"})
                return

            req = _Request(wave, lang, _flag(params, "greedy"), task,
                           params.get("initial_prompt", [None])[0],
                           timestamps=timestamps,
                           words=_flag(params, "words"),
                           vad=_flag(params, "vad"))
            t_enq = time.monotonic()
            try:
                worker.q.put_nowait(req)
            except queue.Full:
                self._json(503, {"error": "server overloaded, retry later"})
                return
            metrics.add(requests_total=1)
            if not req.done.wait(timeout=request_timeout_s):
                req.abandoned = True  # the worker skips it pre-dispatch
                req.error = "timeout"
                self._json(504, {"error": "transcription timed out"})
                return
            metrics.observe_latency(time.monotonic() - t_enq)
            if req.error is not None:
                self._json(500, {"error": req.error})
            elif req.segments is not None:
                self._respond_segments(req, out_format)
            else:
                text, tokens = req.result
                doc = {"text": text, "tokens": tokens}
                self._add_language(doc, req)
                self._json(200, doc)

        @staticmethod
        def _add_language(doc: dict, req: _Request) -> None:
            if req.detected_lang is not None:
                doc["language"] = req.detected_lang
            if req.detected_probs is not None:
                doc["language_probs"] = _top_probs(req.detected_probs)

        def _respond_segments(self, req: _Request, out_format: str) -> None:
            from .pipeline import formats

            if out_format == "srt":
                self._raw(200, formats.to_srt(req.segments),
                          "application/x-subrip")
            elif out_format == "vtt":
                self._raw(200, formats.to_vtt(req.segments,
                                              highlight_words=req.words),
                          "text/vtt")
            elif out_format == "tsv":
                self._raw(200, formats.to_tsv(req.segments),
                          "text/tab-separated-values")
            else:
                def seg_doc(s):
                    d = {"start": round(s.start, 3), "end": round(s.end, 3),
                         "text": s.text}
                    # decode-quality metadata: consumers filter
                    # low-confidence segments on these
                    for key in ("avg_logprob", "compression_ratio",
                                "no_speech_prob"):
                        if getattr(s, key) is not None:
                            d[key] = round(getattr(s, key), 4)
                    if s.words is not None:
                        d["words"] = [{"word": w.word,
                                       "start": round(w.start, 3),
                                       "end": round(w.end, 3)}
                                      for w in s.words]
                    return d

                doc = {"text": req.result[0],
                       "segments": [seg_doc(s) for s in req.segments]}
                self._add_language(doc, req)
                self._json(200, doc)

    return Handler


def warm_up(transcriber) -> float:
    """Decode one full window of quiet seeded noise with the default
    options (beam search, at a depth of 4) and return its seconds: on the
    card this builds the kernels (nvcc) and touches every kernel of the
    default path, so the first request pays none of it."""
    from .ops.audio import max_waveform_samples

    n = max_waveform_samples(transcriber.cfg.encoder_ctx_size - 10)
    wave = (np.random.default_rng(0).standard_normal(n) * 0.01).astype(
        np.float32)
    t0 = time.perf_counter()
    transcriber.transcribe_many([wave], options=DecodeOptions(max_depth=4))
    if transcriber.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def serve(model: str, host: str = "127.0.0.1", port: int = 8000,
          tokenizer: Optional[str] = None, batch_size: int = 8,
          max_wait_s: float = 0.05, dtype: Optional[str] = None,
          ready_event: Optional[threading.Event] = None,
          max_body_bytes: int = 64 * 1024 * 1024,
          request_timeout_s: float = 120.0, max_streams: int = 16,
          continuous: bool = True, stream_batch_wait_s: float = 0.1,
          device: str = "cuda") -> ThreadingHTTPServer:
    """Load `model`, warm up, serve until interrupted, then stop and join
    the worker and the stream batcher. `device` is the card
    unless "cpu" is asked for; `dtype` defaults to bfloat16 on the card
    (its kernels take only bfloat16) and float32 on the CPU."""
    from .config import SAMPLE_RATE
    from .io import checkpoint
    from .pipeline.batch import BatchTranscriber
    from .text.tokenizer import WhisperTokenizer

    tok_path = tokenizer or os.path.join(
        os.path.dirname(os.path.abspath(model)), "tokenizer.json")
    params, cfg = checkpoint.load_params(model)
    torch_dtype = getattr(torch, dtype or ("bfloat16" if device == "cuda"
                                           else "float32"))
    t = BatchTranscriber(params, cfg, WhisperTokenizer(tok_path),
                         batch_size=batch_size, dtype=torch_dtype,
                         device=device)
    print(f"warm-up: kernels built and one window decoded in "
          f"{warm_up(t):.1f} s", flush=True)
    worker = BatchingWorker(t, max_batch=batch_size, max_wait_s=max_wait_s,
                            continuous=continuous)
    streams = StreamSessions(t, max_sessions=max_streams)
    if streams.batcher is not None:
        streams.batcher.max_wait_s = float(stream_batch_wait_s)
    server = ThreadingHTTPServer(
        (host, port),
        make_handler(worker, SAMPLE_RATE, max_body_bytes=max_body_bytes,
                     request_timeout_s=request_timeout_s, streams=streams))
    worker.start()
    print(f"whisper_tpu_torch serving {model} on "
          f"http://{host}:{server.server_port} ({device})", flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        worker.stop()
        streams.stop()
        print("whisper_tpu_torch server stopped", flush=True)
    return server


def _interrupt(signum, frame):
    raise KeyboardInterrupt  # SIGTERM shuts down as Ctrl-C does


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="whisper_tpu_torch.serve")
    p.add_argument("model")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=50.0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (default: the CUDA card; the "
                        "CPU only when asked for)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="weight dtype (default: bfloat16 on the card, "
                        "float32 on the CPU)")
    p.add_argument("--max-body-mb", type=int, default=64,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--request-timeout-s", type=float, default=120.0,
                   help="per-request transcription deadline (504)")
    p.add_argument("--max-streams", type=int, default=16,
                   help="concurrent streaming sessions (409 when full)")
    p.add_argument("--no-continuous", action="store_true",
                   help="disable continuous window-pool batching (one-shot "
                        "grouped dispatch for every request)")
    p.add_argument("--stream-batch-wait-ms", type=float, default=100.0,
                   help="coalescing window for concurrent live streams' "
                        "batched decodes")
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("No CUDA device: whisper_tpu_torch serves on the card by "
              "default; pass --device cpu to serve on the CPU.",
              file=sys.stderr)
        return 1
    from .utils.logging import configure

    configure(args.verbose)
    signal.signal(signal.SIGTERM, _interrupt)
    serve(args.model, args.host, args.port, args.tokenizer, args.batch_size,
          args.max_wait_ms / 1000.0, args.dtype,
          max_body_bytes=args.max_body_mb * 1024 * 1024,
          request_timeout_s=args.request_timeout_s,
          max_streams=args.max_streams, continuous=not args.no_continuous,
          stream_batch_wait_s=args.stream_batch_wait_ms / 1000.0,
          device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
