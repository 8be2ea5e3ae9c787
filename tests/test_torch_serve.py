"""The port's serving path on the CPU: `WindowPool` against the JAX
package's and against the port's `transcribe_many`, the HTTP server of
`whisper_tpu_torch.serve` (the cases of tests/test_serve.py), the
worker's and the stream batcher's `stop()`, and the `serve` entry points
as processes.

Setup as tests/test_serve.py: the synthetic tokenizer and a 2-layer
n_state-8 model (64 audio frames, 32 text positions, PRNGKey(0)); the
pool's texts and tokens must EQUAL JAX's, request for request.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import wave as wave_mod
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest

from whisper_tpu.config import tiny_test_config
from whisper_tpu.models import whisper as JM
from whisper_tpu.pipeline import batch as JB
from whisper_tpu.pipeline import transcribe as JT
from whisper_tpu.text.tokenizer import WhisperTokenizer, build_test_tokenizer_json
from whisper_tpu_torch import serve as serve_mod
from whisper_tpu_torch.io import checkpoint as tcheckpoint
from whisper_tpu_torch.ops.audio import max_waveform_samples
from whisper_tpu_torch.pipeline import batch as TB
from whisper_tpu_torch.pipeline import transcribe as TT
from whisper_tpu_torch.pipeline.segments import Segment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve")
    build_test_tokenizer_json(str(d / "tokenizer.json"))
    tok = WhisperTokenizer(str(d / "tokenizer.json"))
    cfg = tiny_test_config(n_vocab=tok.vocab_size, n_audio_ctx=64,
                           n_text_ctx=32)
    params = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.PRNGKey(0), cfg))
    return params, cfg, tok, d


def _start(worker, **kw):
    """(url, httpd) of a server on a free port for `worker`."""
    worker.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                serve_mod.make_handler(worker, 16000, **kw))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_port}", httpd


def _shut(worker, httpd, streams=None):
    httpd.shutdown()
    httpd.server_close()
    worker.stop(timeout=30)
    if streams is not None:
        streams.stop(timeout=30)
    assert not worker.is_alive()


@pytest.fixture(scope="module")
def server(model):
    params, cfg, tok, _ = model
    t = TB.BatchTranscriber(params, cfg, tok, batch_size=4, device="cpu")
    worker = serve_mod.BatchingWorker(t, max_batch=4, max_wait_s=0.05)
    url, httpd = _start(worker)
    yield url, worker
    _shut(worker, httpd)


def _wav_bytes(n=4000, seed=0, rate=16000, silent=False):
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        x = (np.zeros(n) if silent
             else np.random.default_rng(seed).standard_normal(n) * 3000)
        w.writeframes(x.astype(np.int16).tobytes())
    return buf.getvalue()


def _wave_of(body):
    return np.frombuffer(body[44:], "<i2").astype(np.float32) / 32767.0


def _post(url, path, body, raw=False):
    req = urllib.request.Request(url + path, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            data = r.read()
            return r.status, (data.decode() if raw else json.loads(data)), \
                r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), None


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return r.status, r.read().decode(), r.headers["Content-Type"]


# ------------------------------------------------------------ WindowPool

@pytest.fixture(scope="module")
def pools(model):
    params, cfg, tok, _ = model
    return (JB.BatchTranscriber(params, cfg, tok, batch_size=3),
            TB.BatchTranscriber(params, cfg, tok, batch_size=3, device="cpu"))


def _waves(cfg, lengths, seed=0):
    n_window = max_waveform_samples(cfg.encoder_ctx_size - 10)
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(n_window * x)) * 0.3).astype(np.float32)
            for x in lengths]


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_pool_matches_jax_and_transcribe_many(model, pools, strategy):
    """Mixed window counts, a partial tail and a sub-window wave: the
    port's pool gives JAX's pool completions and its own transcribe_many
    results, request for request."""
    jt, tt = pools
    kw = dict(strategy=strategy, beam_size=2, max_depth=6,
              chunk_overlap_seconds=0.05)
    waves = _waves(model[1], [2.4, 1.0, 0.6, 3.0])
    jpool = JB.WindowPool(jt, JT.DecodeOptions(**kw))
    tpool = TB.WindowPool(tt, TT.DecodeOptions(**kw))
    for i, w in enumerate(waves):
        jpool.add(i, w)
        tpool.add(i, w)
    want = {rid: (text, toks) for rid, text, toks in jpool.flush()}
    got = {rid: (text, toks) for rid, text, toks in tpool.flush()}
    assert sorted(got) == [0, 1, 2, 3] and got == want
    many = tt.transcribe_many(waves, options=TT.DecodeOptions(**kw))
    assert [got[i] for i in range(4)] == [tuple(m) for m in many]
    assert any(toks for _, toks in got.values())


def test_pool_newcomer_and_cancel(model, pools):
    """A request added after decoding began matches its transcription; a
    cancelled request's windows leave the pool."""
    _, tt = pools
    opt = TT.DecodeOptions(strategy="greedy", max_depth=6,
                           chunk_overlap_seconds=0.05)
    waves = _waves(model[1], [3.0, 1.0], seed=7)
    want = tt.transcribe_many(waves, options=opt)
    pool = TB.WindowPool(tt, opt)
    pool.add(0, waves[0])
    first = pool.step()  # one batch of request 0's windows
    pool.add(1, waves[1])  # the newcomer joins mid-flight
    got = {rid: (text, toks) for rid, text, toks in first + pool.flush()}
    assert got == {0: tuple(want[0]), 1: tuple(want[1])}

    pool = TB.WindowPool(tt, opt)
    pool.add(0, _waves(model[1], [2.0], seed=3)[0])
    pool.add(1, waves[1])
    before = pool.pending()
    pool.cancel(0)
    assert pool.pending() < before
    assert {rid for rid, _, _ in pool.flush()} == {1}
    pool.add(2, waves[1])
    with pytest.raises(ValueError, match="duplicate"):
        pool.add(2, waves[1])


@pytest.mark.parametrize("opts,poolable", [
    (dict(), True), (dict(temperature=(0.0,)), True),
    (dict(temperature=(0.0, 0.2)), False), (dict(temperature=0.4), False),
    (dict(no_speech_threshold=0.6), False), (dict(timestamps=True), False),
    (dict(condition_on_previous_text=True), False),
    (dict(clip_timestamps="0,1"), False)])
def test_unpoolable_options(pools, opts, poolable):
    opt = TT.DecodeOptions(**opts)
    assert TB.WindowPool.poolable(opt) is poolable
    assert (JB.WindowPool.unpoolable_reason(JT.DecodeOptions(**opts))
            == TB.WindowPool.unpoolable_reason(opt))
    if not poolable:
        with pytest.raises(ValueError, match="WindowPool"):
            TB.WindowPool(pools[1], opt)


def test_one_tuple_temperature_pool(server):
    """temperature=(0.0,) has no ladder: the pool decodes it, as
    transcribe_many does."""
    _, worker = server
    opt = TT.DecodeOptions(strategy="greedy", max_depth=4,
                           temperature=(0.0,))
    wave = (np.random.default_rng(2).standard_normal(12000) * 0.2).astype(
        np.float32)
    pool = TB.WindowPool(worker.t, opt)
    pool.add(0, wave)
    done = pool.flush()
    assert [rid for rid, _, _ in done] == [0]
    assert (done[0][1], done[0][2]) == tuple(
        worker.t.transcribe_many([wave], options=opt)[0])


# ------------------------------------------------------------ HTTP server

def test_healthz_and_roundtrip(server):
    url, worker = server
    status, body, _ = _get(url, "/healthz")
    assert status == 200 and json.loads(body)["status"] == "ok"
    status, obj, _ = _post(url, "/transcribe?lang=en&greedy=1", _wav_bytes())
    assert status == 200 and isinstance(obj["tokens"], list)


def test_pooled_requests_match_transcribe_many(server):
    """Concurrent plain requests ride the continuous pool and each gets
    transcribe_many's text and tokens (greedy and beam)."""
    url, worker = server
    assert worker.continuous
    bodies = [_wav_bytes(n=20000, seed=i) for i in range(4)]
    results = [None] * 4

    def call(i):
        q = "greedy=1" if i % 2 == 0 else "greedy=0"
        results[i] = _post(url, f"/transcribe?lang=en&{q}", bodies[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    for i, (status, obj, _) in enumerate(results):
        assert status == 200
        req = serve_mod._Request(np.zeros(1, np.float32), "en", i % 2 == 0)
        want = worker.t.transcribe_many(
            [_wave_of(bodies[i])], options=serve_mod.BatchingWorker._opts(req))
        assert (obj["text"], obj["tokens"]) == (want[0][0], want[0][1])


def test_options_and_errors(server):
    url, _ = server
    status, obj, _ = _post(
        url, "/transcribe?lang=en&greedy=1&initial_prompt=hello+there",
        _wav_bytes())
    assert status == 200 and isinstance(obj["tokens"], list)
    for path, body, code, word in (
            ("/transcribe?lang=en&task=nonsense", _wav_bytes(), 400, "task"),
            ("/transcribe?lang=en&format=srt", _wav_bytes(), 400, "requires"),
            ("/transcribe?lang=en&format=pdf", _wav_bytes(), 400, "format"),
            ("/transcribe?lang=en", b"this is not a wav", 400, "audio"),
            ("/transcribe?lang=en", b"", 400, "empty"),
            ("/nope", b"", 404, "not found")):
        status, obj, _ = _post(url, path, body)
        assert status == code and word in obj["error"], path


def test_timestamps_json_and_raw_formats(server):
    url, _ = server
    status, obj, _ = _post(
        url, "/transcribe?lang=en&greedy=1&timestamps=1&words=1",
        _wav_bytes())
    assert status == 200 and isinstance(obj["segments"], list)
    for s in obj["segments"]:
        assert s["start"] <= s["end"]
        assert "avg_logprob" in s and s["avg_logprob"] <= 0.0
        assert "compression_ratio" in s
    for fmt, ctype, sniff in (
            ("srt", "application/x-subrip", None),
            ("vtt", "text/vtt", "WEBVTT"),
            ("tsv", "text/tab-separated-values", "start\tend\ttext")):
        status, body, got_type = _post(
            url, f"/transcribe?lang=en&greedy=1&timestamps=1&format={fmt}",
            _wav_bytes(), raw=True)
        assert status == 200 and got_type == ctype
        assert sniff is None or sniff in body


def test_auto_language_vad_and_resample(server):
    url, _ = server
    status, obj, _ = _post(url, "/transcribe?lang=auto&greedy=1",
                           _wav_bytes())
    assert status == 200 and obj["language"] in obj["language_probs"]
    assert all(0.0 <= p <= 1.0 for p in obj["language_probs"].values())
    status, obj, _ = _post(url, "/transcribe?lang=en&greedy=1&vad=1",
                           _wav_bytes(n=8000, silent=True))
    assert status == 200 and obj["text"] == "" and obj["tokens"] == []
    status, _, _ = _post(url, "/transcribe?lang=en&greedy=1",
                         _wav_bytes(rate=22050))
    assert status == 200


def test_metrics(server):
    url, _ = server
    _post(url, "/transcribe?lang=en&greedy=1", _wav_bytes())
    status, body, ctype = _get(url, "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    m = {}
    for line in body.splitlines():
        if line.strip() and not line.startswith("#"):
            name, val = line.rsplit(" ", 1)
            m[name] = float(val)
    assert m["whisper_requests_total"] >= 1
    assert m["whisper_batches_total"] >= 1
    assert m["whisper_audio_seconds_total"] > 0
    assert m['whisper_request_latency_seconds_bucket{le="+Inf"}'] == m[
        "whisper_request_latency_seconds_count"] >= 1
    assert m['whisper_responses_total{code="200"}'] >= 1


def test_round_robin_between_pools(server):
    """Two options keys under load: both make progress."""
    url, _ = server
    import concurrent.futures as cf

    def req(i):
        q = "greedy=1" if i % 2 == 0 else "greedy=0"
        return _post(url, f"/transcribe?{q}", _wav_bytes(n=16000, seed=i))[0]

    with cf.ThreadPoolExecutor(8) as ex:
        codes = list(ex.map(req, range(8)))
    assert codes == [200] * 8


@pytest.fixture(scope="module")
def small_server(model):
    params, cfg, tok, _ = model
    t = TB.BatchTranscriber(params, cfg, tok, batch_size=2, device="cpu")
    worker = serve_mod.BatchingWorker(t, max_batch=2, max_wait_s=0.01)
    url, httpd = _start(worker, max_body_bytes=5000, request_timeout_s=60.0)
    yield url
    _shut(worker, httpd)


def test_body_limit(small_server):
    status, obj, _ = _post(small_server, "/transcribe?lang=en",
                           b"\x00" * 10000)
    assert status == 413 and "error" in obj
    body = _wav_bytes(n=2000)
    assert len(body) <= 5000
    assert _post(small_server, "/transcribe?lang=en&greedy=1", body)[0] == 200


class _BlockingT:
    """A transcriber whose calls wait for `release`."""

    def __init__(self):
        self.calls = []
        self.release = threading.Event()

    def transcribe_many(self, waves, options=None):
        self.calls.append(len(waves))
        assert self.release.wait(timeout=30)
        return [("x", [1])] * len(waves)


def _wait_for(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond() and time.monotonic() - t0 < timeout:
        time.sleep(0.005)
    assert cond()


def test_timeout_504_and_abandoned_requests_skipped():
    """A waiter that gives up answers 504; the worker never decodes a
    request whose waiter has gone."""
    ft = _BlockingT()
    worker = serve_mod.BatchingWorker(ft, max_batch=4, max_wait_s=0.01)
    url, httpd = _start(worker, request_timeout_s=0.3)
    try:
        status, obj, _ = _post(url, "/transcribe?lang=en&greedy=1",
                               _wav_bytes())
        assert status == 504 and "timed out" in obj["error"]
        _wait_for(lambda: ft.calls == [1])  # blocked inside the fake

        wave = np.zeros(10, np.float32)
        timed_out = serve_mod._Request(wave, "en", True)
        timed_out.abandoned = True
        live = serve_mod._Request(wave, "en", True)
        worker.q.put(timed_out)
        worker.q.put(live)
        ft.release.set()
        assert timed_out.done.wait(30) and live.done.wait(30)
        assert live.result == ("x", [1]) and timed_out.result is None
        assert worker.dropped == 1 and sum(ft.calls) == 2
    finally:
        ft.release.set()
        _shut(worker, httpd)


def test_full_queue_503():
    ft = _BlockingT()
    worker = serve_mod.BatchingWorker(ft, max_batch=1, max_wait_s=0.0,
                                      max_queue=1)
    url, httpd = _start(worker, request_timeout_s=30.0)
    try:
        worker.q.put(serve_mod._Request(np.zeros(10, np.float32), "en", True))
        _wait_for(lambda: ft.calls == [1])
        worker.q.put(serve_mod._Request(np.zeros(10, np.float32), "en", True))
        status, obj, _ = _post(url, "/transcribe?lang=en", _wav_bytes())
        assert status == 503 and "overloaded" in obj["error"]
    finally:
        ft.release.set()
        _shut(worker, httpd)


@pytest.mark.parametrize("case", ["timestamps", "words", "auto",
                                  "auto_failure"])
def test_grouped_dispatch(case):
    """Timestamped and lang=auto requests go out as one batched call per
    group: timestamped ones coalesce, --words propagates, lang=auto groups
    by the detected language, and a failed detection fails only its own
    request."""
    calls = []

    class FakeT:
        def __init__(self):
            self._langs = iter(["en", "de", "en"])

        def transcribe_many_with_timestamps(self, waves, options=None,
                                            word_timestamps=False):
            calls.append(("ts", len(waves), word_timestamps))
            return [(f"t{i}", [Segment(0.0, 1.0, f"t{i}", [1])])
                    for i in range(len(waves))]

        def detect_language(self, wave):
            if len(wave) < 5:
                raise ValueError("audio too short")
            return next(self._langs), {}

        def transcribe_many(self, waves, options=None):
            calls.append((options.lang, len(waves)))
            return [("x", [1])] * len(waves)

    worker = serve_mod.BatchingWorker(FakeT(), max_batch=4, max_wait_s=0.2)
    wave = np.zeros(10, np.float32)
    if case in ("timestamps", "words"):
        reqs = [serve_mod._Request(wave, "en", True, timestamps=True,
                                   words=case == "words") for _ in range(3)]
    elif case == "auto":
        reqs = [serve_mod._Request(wave, "auto", True) for _ in range(3)]
    else:
        reqs = [serve_mod._Request(wave, "auto", True),
                serve_mod._Request(np.zeros(2, np.float32), "auto", True)]
    for r in reqs:  # queued before the start: one coalesced group
        worker.q.put(r)
    worker.start()
    try:
        for r in reqs:
            assert r.done.wait(timeout=30)
    finally:
        worker.stop()
    if case in ("timestamps", "words"):
        assert calls == [("ts", 3, case == "words")]
        assert worker.metrics.batches_total == 1
        assert [r.result[0] for r in reqs] == ["t0", "t1", "t2"]
    elif case == "auto":
        assert sorted(calls) == [("de", 1), ("en", 2)]
        assert [r.detected_lang for r in reqs] == ["en", "de", "en"]
    else:
        assert reqs[0].result == ("x", [1])
        assert reqs[1].error is not None and "short" in reqs[1].error


# ------------------------------------------------------------- streaming

@pytest.fixture(scope="module")
def stream_server(model):
    params, cfg, tok, _ = model
    t = TB.BatchTranscriber(params, cfg, tok, batch_size=2, device="cpu")
    worker = serve_mod.BatchingWorker(t, max_batch=2, max_wait_s=0.02)
    streams = serve_mod.StreamSessions(t, max_sessions=2)
    url, httpd = _start(worker, streams=streams)
    yield url, streams
    _shut(worker, httpd, streams)
    assert not streams.batcher._thread.is_alive()


def test_stream_lifecycle(stream_server):
    url, streams = stream_server
    code, out, _ = _post(url, "/stream/start?lang=en&greedy=1", b"")
    assert code == 200
    sid = out["session"]
    assert len(sid) >= 16 and streams.batcher.clients == 1
    block = np.random.default_rng(0).standard_normal(17000).astype("<f4")
    code, out, _ = _post(url, f"/stream/{sid}/push", block.tobytes())
    assert code == 200 and isinstance(out["confirmed"], list)
    s16 = (np.random.default_rng(1).standard_normal(17000) * 3000).astype(
        "<i2")
    code, _, _ = _post(url, f"/stream/{sid}/push?format=s16", s16.tobytes())
    assert code == 200
    code, out, _ = _post(url, f"/stream/{sid}/push?format=mp3", b"")
    assert code == 400
    code, out, _ = _post(url, f"/stream/{sid}/finish", b"")
    assert code == 200 and "text" in out
    assert streams.batcher.batches >= 1 and streams.batcher.clients == 0
    assert _post(url, f"/stream/{sid}/push", block.tobytes())[0] == 404
    assert _post(url, "/stream/nope/finish", b"")[0] == 404
    code, out, _ = _post(
        url, "/stream/start?lang=en&greedy=1&initial_prompt=hi+there", b"")
    assert code == 200
    assert _post(url, f"/stream/{out['session']}/finish", b"")[0] == 200


def test_stream_session_limit_409(stream_server):
    url, _ = stream_server
    codes, sids = [], []
    for _ in range(3):
        code, out, _ = _post(url, "/stream/start", b"")
        codes.append(code)
        if code == 200:
            sids.append(out["session"])
    assert codes.count(409) >= 1
    for sid in sids:
        _post(url, f"/stream/{sid}/finish", b"")


# ------------------------------------------------- stop() and the processes

def test_stop_leaves_no_thread(model):
    """stop() ends and joins the worker and the stream batcher; a request
    still queued is released with an error, not left waiting."""
    params, cfg, tok, _ = model
    t = TB.BatchTranscriber(params, cfg, tok, batch_size=2, device="cpu")
    worker = serve_mod.BatchingWorker(t, max_batch=2)
    streams = serve_mod.StreamSessions(t, max_sessions=2)
    worker.start()
    sid = streams.start(TT.DecodeOptions(strategy="greedy", max_depth=4))
    streams.push(sid, np.random.default_rng(0).standard_normal(
        20000).astype(np.float32))
    assert streams.batcher._thread.is_alive()
    worker.stop(timeout=10)
    streams.stop(timeout=10)
    assert not worker.is_alive() and not streams.batcher._thread.is_alive()
    late = serve_mod._Request(np.zeros(10, np.float32), "en", True)
    worker.q.put(late)
    worker._fail_pending("server shutting down")
    assert late.done.is_set() and late.error == "server shutting down"


@pytest.mark.parametrize("entry", [["-m", "whisper_tpu_torch.serve"],
                                   ["-m", "whisper_tpu_torch.cli", "serve"]])
def test_serve_entry_points(model, entry):
    """`python -m whisper_tpu_torch.serve` and `cli serve` on --port 0
    --device cpu: warm up, report ready, answer, stop on SIGTERM with exit
    code 0."""
    params, cfg, tok, d = model
    ckpt = d / "model.safetensors"
    if not ckpt.exists():
        tcheckpoint.save_safetensors(params, cfg, str(ckpt))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, *entry, str(d / "model"), "--port", "0",
         "--device", "cpu", "--batch-size", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(d))
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if " serving " in line:
                break
        assert any(line.startswith("warm-up:") for line in lines), lines
        url = lines[-1].split(" on ")[1].split()[0]
        assert json.loads(_get(url, "/healthz")[1])["status"] == "ok"
        status, obj, _ = _post(url, "/transcribe?lang=en&greedy=1",
                               _wav_bytes())
        assert status == 200 and isinstance(obj["tokens"], list)
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0, rest
        assert "server stopped" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_serve_refuses_without_a_card(model, monkeypatch, capsys):
    """No CUDA device and no --device cpu: exit 1, no fallback."""
    monkeypatch.setattr(serve_mod.torch.cuda, "is_available", lambda: False)
    assert serve_mod.main([str(model[3] / "model"), "--port", "0"]) == 1
    assert "--device cpu" in capsys.readouterr().err
