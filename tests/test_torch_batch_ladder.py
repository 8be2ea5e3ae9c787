"""The port's batched fallback ladder and `transcribe_many_with_timestamps`
vs the JAX package's, f32 on the CPU (the rest of the batched path:
tests/test_torch_batch.py, whose setup this file shares: the synthetic
tokenizer, a 2-layer n_state-32 model, PRNGKey(7), ENC_CTX 96, two streams
of 3 + 2 windows).

Tokens must be EQUAL; the per-window quality metadata and segment fields
agree to LOGP_ATOL = 1e-4 (f32, summation order); word times within one
20 ms frame (test_torch_align.py). Sampling rungs cannot draw JAX's tokens
(another generator), so these tests swap both samplers for argmax.
"""

import numpy as np
import pytest

from test_torch_align import WORD_TIME_ATOL
from test_torch_batch import ENC_CTX, LOGP_ATOL, _streams, setup  # noqa: F401
from test_torch_timestamps import argmax_samplers  # noqa: F401 (fixture)
from whisper_tpu.ops.audio import max_waveform_samples
from whisper_tpu.pipeline import batch as JB
from whisper_tpu.pipeline import transcribe as JT
from whisper_tpu_torch.pipeline import batch as TB
from whisper_tpu_torch.pipeline import transcribe as TT

from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def batchers(setup):
    """JAX's and the port's BatchTranscriber in batches of 2 (the 3 full
    windows of `_streams()` leave a short last batch), kept for the module
    so JAX compiles each program once."""
    params, _, cfg, tok, _ = setup
    return (JB.BatchTranscriber(params, cfg, tok, batch_size=2,
                                attention="xla", matmul_precision="highest"),
            TB.BatchTranscriber(params, cfg, tok, batch_size=2,
                                attention="flash", device="cpu"))


# The three options the batched path refused before the ladder and
# timestamps were ported; each result now equals JAX's.
@pytest.mark.parametrize("change", [
    dict(timestamps=True), dict(temperature=(0.0, 0.2),
                                logprob_threshold=0.0),
    dict(no_speech_threshold=0.6)])
def test_transcribe_many_options_match_jax(batchers, argmax_samplers,
                                           change):
    jb, tb = batchers
    opts = dict(strategy="greedy", max_depth=8, chunk_overlap_seconds=0.15,
                **change)
    want = jb.transcribe_many(_streams(), options=JT.DecodeOptions(**opts))
    got = tb.transcribe_many(_streams(), options=TT.DecodeOptions(**opts))
    assert got == want and all(g[1] for g in got)


def _rung_spies(monkeypatch, windows):
    """Record, per window, the temperatures it was decoded at, in order,
    on both packages' batched and single-window paths: {lib: {window
    index in `windows` (full) or window length (tail): [T, ...]}}."""
    seen = {"jax": {}, "torch": {}}

    def note(lib, temp, waves):
        hit = {i for row in np.asarray(waves) for i, w in enumerate(windows)
               if np.array_equal(row, w)}
        for i in sorted(hit):
            seen[lib].setdefault(i, []).append(float(temp))

    real_bfn = JB.BatchTranscriber._batch_window_fn
    real_wfn = JT.Transcriber._window_fn
    real_batch = TB.BatchTranscriber._decode_batch
    real_decode = TT.Transcriber._decode

    def jax_bfn(self, *a, **kw):
        fn = real_bfn(self, *a, **kw)

        def run(params, waves, *rest):
            note("jax", kw["temperature"], waves)
            return fn(params, waves, *rest)
        return run

    def jax_wfn(self, *a, **kw):
        seen["jax"].setdefault(a[0], []).append(kw.get("temperature", 0.0))
        return real_wfn(self, *a, **kw)

    def torch_batch(self, waves, *a, **kw):
        note("torch", a[6], waves)
        return real_batch(self, waves, *a, **kw)

    def torch_decode(self, window, *a, **kw):
        seen["torch"].setdefault(len(window), []).append(a[5])
        return real_decode(self, window, *a, **kw)

    monkeypatch.setattr(JB.BatchTranscriber, "_batch_window_fn", jax_bfn)
    monkeypatch.setattr(JT.Transcriber, "_window_fn", jax_wfn)
    monkeypatch.setattr(TB.BatchTranscriber, "_decode_batch", torch_batch)
    monkeypatch.setattr(TT.Transcriber, "_decode", torch_decode)
    return seen


def _check_meta(got, want, atol=LOGP_ATOL):
    assert set(got) == set(want)
    for key, w in want.items():
        for a, b in zip(got[key], w, strict=True):
            assert (a is None) == (b is None), key
            if a is not None:
                assert abs(a - b) <= atol, (key, a, b)


@pytest.mark.parametrize("outcome", ["mixed", "last rung", "silence"])
@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_batched_ladder_rungs_match_jax(batchers, argmax_samplers,
                                        monkeypatch, strategy, outcome):
    """The batched ladder (temperatures 0, 0.2, 0.4) under thresholds that
    force each outcome: a logprob threshold between the windows' rung-0
    scores (some windows accepted at rung 0, the others decoded again,
    batched, at each rung), one no rung passes, and the no-speech gate.
    `_decode_windows` gives JAX's results, metadata, bounds and window
    counts; each window -- full ones on the batched path, tails on the
    single-window ladder -- decodes at the same temperatures in the same
    order; silence leaves [] for every window."""
    jb, tb = batchers
    waves = _streams()
    base = dict(strategy=strategy, max_depth=8, chunk_overlap_seconds=0.15,
                temperature=(0.0, 0.2, 0.4))
    if outcome == "mixed":
        first = tb._decode_windows(waves, 16000, TT.DecodeOptions(
            **dict(base, temperature=(0.0,)), no_speech_threshold=1.0))[1]
        lps = sorted(m[0] for m in first.values())
        forced = dict(logprob_threshold=(lps[1] + lps[2]) / 2)
    elif outcome == "last rung":
        forced = dict(logprob_threshold=0.0)  # every avg_logprob < 0
    else:
        forced = dict(logprob_threshold=0.0, no_speech_threshold=0.0)
    n_window = max_waveform_samples(ENC_CTX - 10)
    full = [w[a:b] for w in waves for a, b in JT.window_waveform(
        w, 16000, n_window, int(16000 * 0.15)) if b - a == n_window]
    seen = _rung_spies(monkeypatch, full)
    want = jb._decode_windows(waves, 16000, JT.DecodeOptions(**base,
                                                             **forced))
    got = tb._decode_windows(waves, 16000, TT.DecodeOptions(**base,
                                                            **forced))
    assert got[0] == want[0] and got[2:] == want[2:]
    _check_meta(got[1], want[1])
    assert seen["torch"] == seen["jax"] and len(seen["torch"]) == 5
    rungs = [len(r) for r in seen["torch"].values()]
    if outcome == "mixed":
        assert 1 in rungs and 3 in rungs, seen
    else:
        assert rungs == [1 if outcome == "silence" else 3] * 5
    if outcome == "silence":
        assert all(r == [] for r in got[0].values())
    else:
        assert all(got[0].values())


@pytest.mark.parametrize("case", ["greedy", "beam", "ladder_words",
                                  "condition_on_previous_text"])
def test_transcribe_many_with_timestamps_matches_jax(batchers,
                                                     argmax_samplers, case):
    """Segments of 2 streams on the batched timestamped path: greedy and
    beam 5 (text, times, tokens and quality fields), the ladder with word
    timings (every window decoded again at 0.2), and the sequential
    fallback of `condition_on_previous_text`; greedy also stream for
    stream equal to the port's `transcribe_with_timestamps`."""
    jb, tb = batchers
    opts = dict(max_depth=8, chunk_overlap_seconds=0.15)
    words = case == "ladder_words"
    if case != "beam":
        opts["strategy"] = "greedy"
    if words:
        opts.update(temperature=(0.0, 0.2), logprob_threshold=0.0)
    if case == "condition_on_previous_text":
        opts.update(condition_on_previous_text=True, initial_prompt="hi")
    waves = _streams()
    want = jb.transcribe_many_with_timestamps(
        waves, options=JT.DecodeOptions(**opts), word_timestamps=words)
    got = tb.transcribe_many_with_timestamps(
        waves, options=TT.DecodeOptions(**opts), word_timestamps=words)
    assert len(got) == len(want) == 2
    for (gtext, gsegs), (wtext, wsegs) in zip(got, want):
        assert gtext == wtext and gsegs
        assert ([(s.start, s.end, s.text, s.tokens) for s in gsegs]
                == [(s.start, s.end, s.text, s.tokens) for s in wsegs])
        for g, w in zip(gsegs, wsegs):
            _check_meta({0: (g.avg_logprob, g.compression_ratio,
                             g.no_speech_prob)},
                        {0: (w.avg_logprob, w.compression_ratio,
                             w.no_speech_prob)})
            assert (g.words is None) == (w.words is None) == (not words)
            for gw, ww in zip(g.words or (), w.words or (), strict=True):
                assert (gw.word, gw.tokens) == (ww.word, ww.tokens)
                assert abs(gw.start - ww.start) <= WORD_TIME_ATOL
                assert abs(gw.end - ww.end) <= WORD_TIME_ATOL
    if case == "greedy":
        for wave, (text, segs) in zip(waves, got):
            one = tb.transcribe_with_timestamps(
                wave, options=TT.DecodeOptions(**opts))
            assert one[0] == text
            assert ([(s.start, s.end, s.tokens) for s in one[1]]
                    == [(s.start, s.end, s.tokens) for s in segs])
