"""The port's streaming transcription vs the JAX package's, f32 on the CPU,
and the port's StreamDecodeBatcher.

Setup as tests/test_streaming.py: the synthetic tokenizer, a 2-layer
n_state-64 model (64 audio frames, 32 text positions, PRNGKey(0)), greedy
with max_depth 6. One Transcriber per package is shared by every session
(its window program compiles once). The same pushes must confirm the same
segments: text and tokens equal, times within 1e-6 s.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import tiny_test_config
from whisper_tpu.models import whisper as JM
from whisper_tpu.pipeline import streaming as JS
from whisper_tpu.pipeline import transcribe as JT
from whisper_tpu.text.tokenizer import WhisperTokenizer, build_test_tokenizer_json
from whisper_tpu_torch.pipeline import batch as TB
from whisper_tpu_torch.pipeline import streaming as TS
from whisper_tpu_torch.pipeline import transcribe as TT

TIME_ATOL = 1e-6


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_stream")
    build_test_tokenizer_json(str(d / "tokenizer.json"))
    tok = WhisperTokenizer(str(d / "tokenizer.json"))
    cfg = tiny_test_config(n_state=64, n_head=2, n_vocab=tok.vocab_size,
                           n_audio_ctx=64, n_text_ctx=32)
    params = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.PRNGKey(0), cfg))
    return (params, cfg, tok, JT.Transcriber(params, cfg, tok),
            TB.BatchTranscriber(params, cfg, tok, batch_size=2,
                                device="cpu"))


def _opts(**kw):
    return dict(lang="en", strategy="greedy", max_depth=6,
                chunk_overlap_seconds=0.01, **kw)


def _loop_seq(tok):
    """A window decode whose text is a repetition loop (compression ratio
    above 2.4), as tests/test_streaming.py scripts it."""
    ts = tok.timestamp_begin
    return (tok.prompt_ids("en", timestamps=True) + [ts]
            + tok.encode("a" * 40) + [ts + 1, tok.eot])


def _jax_session(setup, opts, loop=False, **kw):
    params, cfg, tok, jt, _ = setup
    if loop:
        seq = np.asarray(_loop_seq(tok), np.int32)

        class LoopWindows(JT.Transcriber):
            def _window_fn(self, *a, quality=False, **k):
                return lambda *args, **kws: (seq, len(seq))

        jt = LoopWindows(params, cfg, tok)
    return JS.StreamingTranscriber(None, None, None, options=opts,
                                   transcriber=jt, **kw)


def _port_session(setup, opts, loop=False, batcher=None, **kw):
    params, cfg, tok, _, bt = setup
    if loop:
        seq = _loop_seq(tok)

        class LoopWindows(TT.Transcriber):
            def _decode(self, *a, **k):
                return list(seq), 0.0, -1.0

        bt = LoopWindows(params, cfg, tok, device="cpu")
    return TS.StreamingTranscriber(None, None, None, options=opts,
                                   transcriber=bt, batcher=batcher, **kw)


def _audio(seed, n):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _tone(seed, n=24000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.4 * np.sin(2 * np.pi * (200 + 40 * seed) * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _drive(st, blocks):
    segs = []
    for b in blocks:
        segs.extend(st.push(b))
    segs.extend(st.finish())
    assert st.confirmed == segs  # the confirmed list is never retracted
    return [(s.text, tuple(s.tokens), s.start, s.end) for s in segs]


def _same(got, want):
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2:] for g in got], [w[2:] for w in want],
                               atol=TIME_ATOL, rtol=0)


CASES = {
    # pushes of 2000 samples, a decode at every push
    "pushes": (dict(), dict(min_step_seconds=0.1),
               lambda n_win: [_audio(0, 2000) for _ in range(4)]),
    # six thirds of a window: the forced trim past one window
    "overflow": (dict(), dict(min_step_seconds=0.05),
                 lambda n_win: [_audio(2, n_win // 3) for _ in range(6)]),
    # pushes accumulate below the step: finish drains a 2-window backlog
    "backlog": (dict(), dict(min_step_seconds=1e9),
                lambda n_win: [_audio(7, 2 * n_win + 1000)]),
    # leading silence skipped by the VAD, then speech
    "vad": (dict(vad=True), dict(min_step_seconds=0.1),
            lambda n_win: [np.zeros(8000, np.float32), _audio(5, 8000)]),
    # agreement with a near margin over a tone
    "agreement": (dict(), dict(min_step_seconds=0.1,
                               confirm_margin_seconds=0.01),
                  lambda n_win: np.split(_tone(3), 8)),
    # a repetition loop never confirmed (the compression-ratio gate)
    "loop_gated": (dict(), dict(min_step_seconds=0.4),
                   lambda n_win: [_audio(0, 8000) for _ in range(3)]),
    # the same loop confirmed with the gate off
    "loop_ungated": (dict(compression_ratio_threshold=None),
                     dict(min_step_seconds=0.4),
                     lambda n_win: [_audio(0, 8000) for _ in range(3)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(setup, case):
    opt_kw, kw, blocks = CASES[case]
    loop = case.startswith("loop")
    jst = _jax_session(setup, JT.DecodeOptions(**_opts(**opt_kw)), loop, **kw)
    tst = _port_session(setup, TT.DecodeOptions(**_opts(**opt_kw)), loop,
                        **kw)
    assert tst._n_window == jst._n_window
    pushes = blocks(jst._n_window)
    want, got = _drive(jst, pushes), _drive(tst, pushes)
    _same(got, want)
    assert tst.text == jst.text
    if case == "loop_gated":
        assert got == []
    else:
        assert got  # not vacuous
    if case == "loop_ungated":
        assert any("a" * 40 in g[0] for g in got)
    if case == "backlog":
        assert tst.decodes == 3 and len(tst._buffer) == 0


def test_silent_stream_decodes_nothing(setup):
    """Under the VAD a silent stream (and a silent backlog at finish)
    issues no decode and confirms nothing."""
    st = _port_session(setup, TT.DecodeOptions(**_opts(vad=True)),
                       min_step_seconds=0.1)
    for _ in range(10):
        assert st.push(np.zeros(3200, np.float32)) == []
    st.push(np.zeros(3 * st._n_window, np.float32))
    assert st.finish() == [] and st.decodes == 0 and st.confirmed == []


def test_batched_session_matches_unbatched(setup):
    bt = setup[4]
    batcher = TS.StreamDecodeBatcher(bt, batch_size=2)
    opts = TT.DecodeOptions(**_opts())
    blocks = np.split(_tone(3), 8)
    try:
        ref = _drive(_port_session(setup, opts, min_step_seconds=0.1), blocks)
        got = _drive(_port_session(setup, opts, batcher=batcher,
                                   min_step_seconds=0.1), blocks)
    finally:
        batcher.stop()
    assert got == ref and batcher.batches > 0


def test_concurrent_sessions_share_batches(setup):
    """Two sessions on two threads: each confirms its unbatched segments,
    and their decodes share batched calls."""
    bt = setup[4]
    opts = TT.DecodeOptions(**_opts())
    waves = [np.split(_tone(5), 8), np.split(_tone(6), 8)]
    refs = [_drive(_port_session(setup, opts, min_step_seconds=0.1), w)
            for w in waves]
    # a long coalescing window: the two sessions' decodes must meet
    batcher = TS.StreamDecodeBatcher(bt, batch_size=2, max_wait_s=3.0)
    outs = [None, None]

    def run(i):
        outs[i] = _drive(_port_session(setup, opts, batcher=batcher,
                                       min_step_seconds=0.1), waves[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
    finally:
        batcher.stop()
    assert outs == refs
    assert batcher.batched_requests > batcher.batches


class _Fatal(BaseException):
    """Stands for an error that ends a thread (not an Exception)."""


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_decode_times_out_when_the_batcher_thread_died(setup):
    """A BaseException in a group is that group's error and ends the
    thread; the next decode raises TimeoutError instead of hanging."""
    bt = setup[4]
    batcher = TS.StreamDecodeBatcher(bt, batch_size=2, max_wait_s=0.0,
                                     timeout_s=0.5)

    def fatal(group):
        raise _Fatal("device lost")

    batcher._run_group = fatal
    st = _port_session(setup, TT.DecodeOptions(**_opts()), batcher=batcher)
    st._buffer = _audio(1, 4000)
    with pytest.raises(_Fatal):
        st._decode()
    batcher._thread.join(timeout=10)
    assert not batcher._thread.is_alive()
    with pytest.raises(TimeoutError, match="dead"):
        st._decode()
    batcher.stop()


def test_stop_joins_the_thread(setup):
    bt = setup[4]
    batcher = TS.StreamDecodeBatcher(bt, batch_size=2)
    st = _port_session(setup, TT.DecodeOptions(**_opts()), batcher=batcher)
    st._buffer = _audio(1, 4000)
    st._decode()
    thread = batcher._thread
    assert thread.is_alive()
    batcher.clients = 1  # read and written under the batcher's lock
    assert batcher.clients == 1
    batcher.stop(timeout=10)
    assert not thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        st._decode()


def test_construction_checks(setup):
    params, cfg, tok, _, _ = setup
    with pytest.raises(TypeError, match="BatchTranscriber"):
        TS.StreamDecodeBatcher(TT.Transcriber(params, cfg, tok,
                                              device="cpu"))
    if not torch.cuda.is_available():  # the card unless asked otherwise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TS.StreamingTranscriber(params, cfg, tok)
    st = TS.StreamingTranscriber(params, cfg, tok, device="cpu",
                                 options=TT.DecodeOptions(**_opts()))
    assert st.opt.timestamps and st._t.device.type == "cpu"
    with pytest.raises(ValueError, match="16000 Hz"):
        st.push(np.zeros(10, np.float32), sample_rate=8000)
