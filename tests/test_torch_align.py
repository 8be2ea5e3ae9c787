"""Word timestamps (`whisper_tpu_torch/align.py`, `Transcriber.align_words`,
`transcribe_with_timestamps(word_timestamps=True)`, `--words`) and the
one-shot `waveform_to_text` vs the JAX package's, f32 on the CPU.

Setup as tests/test_torch_timestamps.py (ENC_CTX 96, 3 windows, the
synthetic tokenizer, a 2-layer n_state-32 model, PRNGKey(7)). The
cross-attention weights agree within WEIGHTS_ATOL = 1e-5 (f32, summation
order); `median_filter` (odd widths, torch in the port) and `dtw` are
bit-equal on the same inputs; words, their text and tokens are identical,
and their times equal within one 20 ms encoder frame (WORD_TIME_ATOL: the
DTW path may step one frame apart on weights that differ in the last
bits).
"""

import dataclasses
import json
import wave as wave_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_transcribe import ENC_CTX, OVERLAP_S, _multiwindow_wave
from whisper_tpu import align as JA
from whisper_tpu import cli as jax_cli
from whisper_tpu import quantize as JQ
from whisper_tpu.config import tiny_test_config
from whisper_tpu.io import npy_tree
from whisper_tpu.models import whisper as JM
from whisper_tpu.ops.audio import max_waveform_samples, prep_audio
from whisper_tpu.pipeline import transcribe as JT
from whisper_tpu.text.tokenizer import WhisperTokenizer, build_test_tokenizer_json
from whisper_tpu_torch import align as TA
from whisper_tpu_torch import cli as torch_cli
from whisper_tpu_torch.params import from_numpy_tree
from whisper_tpu_torch.pipeline import transcribe as TT

WEIGHTS_ATOL = 1e-5
WORD_TIME_ATOL = TA.FRAME_SECONDS + 1e-6
BASE = dict(max_depth=12, chunk_overlap_seconds=OVERLAP_S)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_align")
    tok_path = str(d / "tokenizer.json")
    build_test_tokenizer_json(tok_path)
    tok = WhisperTokenizer(tok_path)
    cfg = tiny_test_config(n_state=32, n_head=2, n_layer=2,
                           n_vocab=tok.vocab_size, n_audio_ctx=ENC_CTX,
                           n_text_ctx=48)
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(7),
                                                     cfg))
    jt = JT.Transcriber(params, cfg, tok, attention="xla",
                        matmul_precision="highest")
    tt = TT.Transcriber(params, cfg, tok, matmul_precision="highest",
                        device="cpu")
    return jt, tt, tok, d, params, cfg


def _check_words(got, want):
    assert [(w.word, w.tokens) for w in got] == [(w.word, w.tokens)
                                                  for w in want]
    for g, w in zip(got, want):
        assert abs(g.start - w.start) <= WORD_TIME_ATOL, (g, w)
        assert abs(g.end - w.end) <= WORD_TIME_ATOL, (g, w)


def _window_and_tokens(tt, tok):
    """The first window and its timestamped greedy decode (the port's,
    which equals JAX's: test_torch_timestamps.py), prompt and EOT
    included."""
    window = _multiwindow_wave()[:max_waveform_samples(ENC_CTX - 10)]
    _, segs = tt.transcribe_with_timestamps(
        window, options=TT.DecodeOptions(strategy="greedy", **BASE))
    seq = list(tok.prompt_ids("en", timestamps=True))
    for s in segs:
        seq += s.tokens
    return window, seq + [tok.eot]


@pytest.mark.parametrize("quantized", [False, True])
def test_cross_attention_weights_match_jax(setup, quantized):
    """(L, H, S, Sa) f32 softmax of every layer on one window's encoder
    output and decoded sequence, with f32 weights and with int8 weights
    (the dequant matmul in both packages)."""
    _, tt, tok, _, params, cfg = setup
    window, seq = _window_and_tokens(tt, tok)
    if quantized:
        params = jax.tree.map(np.asarray, JQ.quantize_params(params, bits=8))
    with jax.default_matmul_precision("highest"):
        mel = prep_audio(jnp.asarray(window)[None])
        mel = jnp.pad(mel[:, :, :ENC_CTX - 10], ((0, 0), (0, 0), (0, 10)))
        jp = jax.tree.map(jnp.asarray, params)
        enc = JM.encoder_forward(jp, mel, cfg)
        want = np.asarray(JA.cross_attention_weights(
            jp, enc, jnp.asarray(seq, jnp.int32), cfg))
    got = TA.cross_attention_weights(
        from_numpy_tree(params), torch.from_numpy(np.array(enc)),
        torch.tensor(seq), cfg)
    assert got.dtype == torch.float32 and want.shape == (2, 2, len(seq),
                                                         ENC_CTX // 2)
    np.testing.assert_allclose(got.numpy(), want, atol=WEIGHTS_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, atol=1e-5)


def test_median_filter_and_dtw_are_bit_equal():
    rng = np.random.default_rng(0)
    for width in (1, 3, 7):
        x = rng.standard_normal((3, 5, 20)).astype(np.float32)
        np.testing.assert_array_equal(TA.median_filter(x, width),
                                      JA.median_filter(x, width))
    with pytest.raises(ValueError, match="odd width"):
        TA.median_filter(x, 4)
    for shape in ((1, 1), (4, 9), (12, 30), (30, 12)):
        for cost in (rng.standard_normal(shape),
                     rng.integers(0, 3, shape).astype(np.float64)):  # ties
            for a, b in zip(TA.dtw(cost), JA.dtw(cost)):
                np.testing.assert_array_equal(a, b)


def test_word_split_and_punctuation_merge_match_jax(setup):
    """`split_tokens_on_spaces` on token lists with spaces, punctuation,
    special tokens and split UTF-8 codepoints; `merge_punctuations` on the
    words they give."""
    tok = setup[2]
    rng = np.random.default_rng(1)
    texts = [" Hello, world. (Yes)", "¿Qué? “sí”!",
             " a - b 'c' [d]", "你好 。ok"]
    for i in range(12):
        toks = tok.encode(texts[i % len(texts)])
        toks = [t if rng.random() > 0.15 else tok.eot for t in toks]
        got = TA.split_tokens_on_spaces(toks, tok)
        assert got == JA.split_tokens_on_spaces(toks, tok)
        words = [(w, t, float(i), float(i) + 0.5) for i, (w, t, _) in
                 enumerate(got)]
        tw = TA.merge_punctuations([TA.WordTiming(w, a, b, t)
                                    for w, t, a, b in words])
        jw = JA.merge_punctuations([JA.WordTiming(w, a, b, t)
                                    for w, t, a, b in words])
        assert [dataclasses.astuple(w) for w in tw] == [
            dataclasses.astuple(w) for w in jw]


@pytest.mark.parametrize("heads", ["default", "baked", "explicit"])
def test_find_word_timings_match_jax(setup, heads):
    """One window's words through `Transcriber.align_words` (encoder, then
    `find_word_timings`) in both packages: the top-half default heads, the
    config's baked heads, and heads passed in."""
    jt, tt, tok, _, params, cfg = setup
    window, seq = _window_and_tokens(tt, tok)
    arg = [(0, 1), (1, 0)] if heads == "explicit" else None
    if heads == "baked":
        jt = JT.Transcriber(params, dataclasses.replace(
            cfg, alignment_heads=((1, 1),)), tok, attention="xla",
            matmul_precision="highest")
        tt = TT.Transcriber(params, dataclasses.replace(
            tt.cfg, alignment_heads=((1, 1),)), tok,
            matmul_precision="highest", device="cpu")
    want = jt.align_words(window, seq, heads=arg, offset_s=1.5)
    got = tt.align_words(window, seq, heads=arg, offset_s=1.5)
    assert got and all(1.5 <= w.start <= w.end for w in got)
    _check_words(got, want)


@pytest.mark.parametrize("opts", [
    dict(strategy="greedy"),
    dict(strategy="greedy", clip_timestamps="0.2,1.9"),
])
def test_transcribe_with_word_timestamps_matches_jax(setup, opts):
    """`transcribe_with_timestamps(word_timestamps=True)` over 3 windows,
    and over clip ranges (word times offset by the clip's start): the same
    segments, and each segment's words. (Beam 5 with words: the batched
    entry in test_torch_batch.py.)"""
    jt, tt, *_ = setup
    wave = _multiwindow_wave()
    wtext, wsegs = jt.transcribe_with_timestamps(
        wave, options=JT.DecodeOptions(**BASE, **opts), word_timestamps=True)
    gtext, gsegs = tt.transcribe_with_timestamps(
        wave, options=TT.DecodeOptions(**BASE, **opts), word_timestamps=True)
    assert gtext == wtext
    assert ([(s.start, s.end, s.text, s.tokens) for s in gsegs]
            == [(s.start, s.end, s.text, s.tokens) for s in wsegs])
    assert sum(len(s.words) for s in gsegs) > 0
    for g, w in zip(gsegs, wsegs):
        _check_words(g.words, w.words)


def test_waveform_to_text_matches_jax(setup):
    """The one-shot entry (src/transcribe.rs:23-29) with DecodeOptions
    keywords: the same (text, tokens) as JAX's."""
    _, _, tok, _, params, cfg = setup
    wave = _multiwindow_wave()
    want = JT.waveform_to_text(params, cfg, tok, "en", wave, 16000,
                               strategy="greedy", **BASE)
    got = TT.waveform_to_text(params, cfg, tok, "en", wave, 16000,
                              device="cpu", strategy="greedy", **BASE)
    assert got == want and got[1]


@pytest.fixture(scope="module")
def cli_dir(setup):
    _, _, _, d, params, cfg = setup
    npy_tree.save_whisper(params, cfg, str(d / "dump"))
    with wave_mod.open(str(d / "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((_multiwindow_wave() * 20000).astype(np.int16).tobytes())
    return d


@pytest.mark.parametrize("out,flags", [
    ("out.json", ["--json"]), ("out.vtt", ["--format", "vtt"])])
def test_cli_words_match_jax_cli(cli_dir, monkeypatch, capsys, out, flags):
    """`transcribe ... --timestamps --words` through both CLIs: the JSON
    document with a words list per segment (word times within
    WORD_TIME_ATOL, quality fields within 1e-4) and the highlighted VTT
    cues (the text form's word lines: test_torch_timestamps.py)."""
    monkeypatch.chdir(cli_dir)
    argv = ["transcribe", "dump", "audio.wav", "en"]
    flags = ["--timestamps", "--words", "--greedy", "--max-depth", "8",
             *flags]
    assert jax_cli.main([*argv, f"jax_{out}", *flags]) == 0
    assert torch_cli.main([*argv, f"torch_{out}", *flags, "--device",
                           "cpu"]) == 0
    assert "Transcription finished." in capsys.readouterr().out
    want = (cli_dir / f"jax_{out}").read_text()
    got = (cli_dir / f"torch_{out}").read_text()
    if out.endswith(".json"):
        want, got = json.loads(want), json.loads(got)
        assert got["text"] == want["text"]
        n_words = 0
        for g, w in zip(got["segments"], want["segments"], strict=True):
            assert set(g) == set(w) and "words" in w
            for key in ("start", "end", "text"):
                assert g[key] == w[key]
            for key in ("avg_logprob", "compression_ratio", "no_speech_prob"):
                assert abs(g[key] - w[key]) <= 1e-4
            for gw, ww in zip(g["words"], w["words"], strict=True):
                assert gw["word"] == ww["word"]
                assert abs(gw["start"] - ww["start"]) <= WORD_TIME_ATOL
                assert abs(gw["end"] - ww["end"]) <= WORD_TIME_ATOL
                n_words += 1
        assert n_words
    else:
        assert got == want and "<u>" in got
