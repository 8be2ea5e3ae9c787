"""The rest of the port's `transcribe` path vs the JAX package's, f32 on
the CPU (`attention="xla"`, `matmul_precision="highest"`, device="cpu"):
timestamped segments, the temperature fallback ladder and its quality
gates, the sampler, language detection, clip ranges, the host helpers and
the CLI's flags.

Setup as tests/test_torch_transcribe.py (ENC_CTX 96, 3 windows, the
synthetic tokenizer, a 2-layer n_state-32 model, PRNGKey(7)). At
temperature 0 tokens, texts and segment times are held exactly; the
quality fields (f32 sums in another order) to QUALITY_ATOL. Sampled tokens
cannot equal JAX's (another generator), so where a test needs the same
tokens from a sampling rung it swaps both samplers for argmax; the
sampler itself is held to its distribution.
"""

import json
import wave as wave_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_transcribe import ENC_CTX, OVERLAP_S, _multiwindow_wave
from whisper_tpu import cli as jax_cli
from whisper_tpu.config import tiny_test_config
from whisper_tpu.io import npy_tree
from whisper_tpu.models import whisper as JM
from whisper_tpu.ops.audio import max_waveform_samples
from whisper_tpu.pipeline import formats as JF
from whisper_tpu.pipeline import segments as JS
from whisper_tpu.pipeline import transcribe as JT
from whisper_tpu.text.tokenizer import WhisperTokenizer, build_test_tokenizer_json
from whisper_tpu_torch import cli as torch_cli
from whisper_tpu_torch.decode import greedy as tgreedy
from whisper_tpu_torch.pipeline import formats as TF
from whisper_tpu_torch.pipeline import segments as TS
from whisper_tpu_torch.pipeline import transcribe as TT

QUALITY_ATOL = 1e-5
BASE = dict(max_depth=12, chunk_overlap_seconds=OVERLAP_S)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ts")
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


@pytest.fixture
def argmax_samplers(monkeypatch):
    """Both samplers replaced by argmax: a sampling rung then decodes the
    same tokens in both packages."""
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1, **kw:
                        jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(tgreedy, "sample_tokens",
                        lambda logp, t, g: torch.argmax(logp, dim=-1))


def _segs(segs):
    return [(s.start, s.end, s.text, s.tokens) for s in segs]


def _check_segments(got, want):
    (gtext, gsegs), (wtext, wsegs) = got, want
    assert gtext == wtext and _segs(gsegs) == _segs(wsegs)
    for g, w in zip(gsegs, wsegs):
        for key in ("avg_logprob", "compression_ratio", "no_speech_prob"):
            a, b = getattr(g, key), getattr(w, key)
            assert (a is None) == (b is None), key
            if a is not None:
                assert abs(a - b) <= QUALITY_ATOL, (key, a, b)
        assert g.words is None


@pytest.mark.parametrize("opts", [
    dict(strategy="greedy"), dict(),  # beam 5
    dict(strategy="greedy", temperature=(0.0, 0.2),
         condition_on_previous_text=True, initial_prompt="hi"),
])
def test_transcribe_with_timestamps_matches_jax(setup, opts):
    """Segments over 3 windows (text, times, tokens, quality fields);
    greedy and beam, the quality metadata off the ladder, and the ladder
    whose first rung passes."""
    jt, tt, *_ = setup
    wave = _multiwindow_wave()
    want = jt.transcribe_with_timestamps(
        wave, options=JT.DecodeOptions(**BASE, **opts))
    got = tt.transcribe_with_timestamps(
        wave, options=TT.DecodeOptions(**BASE, **opts))
    _check_segments(got, want)
    assert got[1] and all(s.avg_logprob is not None for s in got[1])


def test_word_timestamps_raise_naming_the_roadmap_item(setup):
    """Word timestamps no longer raise: the segments are those of the call
    without them, each with its words (parity with JAX:
    test_torch_align.py)."""
    _, tt, *_ = setup
    wave = _multiwindow_wave()
    opts = TT.DecodeOptions(strategy="greedy", **BASE)
    text, segs = tt.transcribe_with_timestamps(wave, options=opts,
                                               word_timestamps=True)
    plain = tt.transcribe_with_timestamps(wave, options=opts)
    assert text == plain[0] and _segs(segs) == _segs(plain[1])
    assert all(isinstance(s.words, list) for s in segs)
    assert sum(len(s.words) for s in segs) > 0


# The five options that raised before the ladder, timestamps and clips were
# ported; each `transcribe` result now equals JAX's.
@pytest.mark.parametrize("change", [
    dict(timestamps=True), dict(temperature=(0.0, 0.2)),
    dict(temperature=0.5), dict(no_speech_threshold=0.6),
    dict(clip_timestamps="0,1"),
])
def test_ported_options_match_jax(setup, argmax_samplers, change):
    jt, tt, *_ = setup
    wave = _multiwindow_wave()
    opts = {"strategy": "greedy", **BASE, **change}
    want = jt.transcribe(wave, options=JT.DecodeOptions(**opts),
                         on_chunk=lambda i, s: None)
    got = tt.transcribe(wave, options=TT.DecodeOptions(**opts),
                        on_chunk=lambda i, s: None)
    assert got == want and got[1]


def _first_window() -> np.ndarray:
    return _multiwindow_wave()[:max_waveform_samples(ENC_CTX - 10)]


@pytest.mark.parametrize("thresholds,outcome", [
    (dict(), "first rung"),
    (dict(logprob_threshold=0.0), "last rung"),  # every avg_logprob < 0
    (dict(compression_ratio_threshold=0.0), "last rung"),
    (dict(logprob_threshold=0.0, no_speech_threshold=0.0), "silence"),
    (dict(logprob_threshold=None, no_speech_threshold=0.0), "silence"),
    (dict(logprob_threshold=0.0, no_speech_threshold=1.0), "last rung"),
])
def test_ladder_rungs_and_silence_gate_match_jax(setup, monkeypatch,
                                                 thresholds, outcome):
    """Thresholds that force each outcome: the rung sequence (the
    temperatures decoded, in order), the accepted temperature, [] for
    silence, and the accepted rung's quality metadata."""
    jt, tt, *_ = setup
    window = _first_window()
    temps = (0.0, 0.2, 0.4)
    opts = dict(strategy="greedy", **BASE, **thresholds)
    seen = {"jax": [], "torch": []}
    real_fn = JT.Transcriber._window_fn
    real_decode = TT.Transcriber._decode

    def jax_fn(self, *a, **kw):
        seen["jax"].append(kw["temperature"])
        return real_fn(self, *a, **kw)

    def torch_decode(self, *a, **kw):
        seen["torch"].append(a[6] if len(a) > 6 else kw.get("temperature"))
        return real_decode(self, *a, **kw)

    monkeypatch.setattr(JT.Transcriber, "_window_fn", jax_fn)
    monkeypatch.setattr(TT.Transcriber, "_decode", torch_decode)
    jprompt, _ = jt._build_prompt(JT.DecodeOptions(**opts))
    tprompt, _ = tt._build_prompt(TT.DecodeOptions(**opts))
    want = jt._decode_window_ladder(0, window, jprompt, 0, 5,
                                    JT.DecodeOptions(**opts), temps,
                                    jt._prec_ctx())
    got = tt._decode_window_ladder(0, window, tprompt, 0, 5,
                                   TT.DecodeOptions(**opts), temps)
    assert seen["torch"] == seen["jax"]
    assert got[1] == want[1]
    n_rungs = {"first rung": 1, "silence": 1, "last rung": 3}[outcome]
    assert len(seen["torch"]) == n_rungs
    if outcome == "silence":
        assert got[0] == want[0] == []
    elif outcome == "first rung":
        assert got[0] == want[0] and got[0]
    for a, b in zip(got[2], want[2]):
        assert (a is None) == (b is None)
        if a is not None and outcome != "last rung":
            assert abs(a - b) <= QUALITY_ATOL


def test_ladder_reruns_draw_the_same_tokens(setup):
    """The sampling rungs' generators are seeded from (seed, window, rung):
    a rerun gives the same text, another seed (almost surely) another."""
    _, tt, *_ = setup
    wave = _multiwindow_wave()
    opts = dict(strategy="greedy", **BASE, temperature=(0.0, 1.0),
                logprob_threshold=0.0)
    a = tt.transcribe(wave, options=TT.DecodeOptions(**opts),
                      on_chunk=lambda i, s: None)
    b = tt.transcribe(wave, options=TT.DecodeOptions(**opts),
                      on_chunk=lambda i, s: None)
    c = tt.transcribe(wave, options=TT.DecodeOptions(**opts, seed=5),
                      on_chunk=lambda i, s: None)
    assert a == b and a[1] != c[1]


def test_sampler_distribution_and_suppression():
    """sample_tokens draws from softmax(logp / T): over 40000 draws each
    frequency is within 0.01 (about 4.5 standard deviations at p = 0.25)
    of its probability; -inf tokens are never drawn; a seed fixes the
    draws."""
    logits = torch.tensor([2.0, 1.0, float("-inf"), 0.0, -1.0,
                           float("-inf")])
    logp = torch.log_softmax(logits, -1).expand(40000, -1)
    for temp in (0.5, 1.0):
        gen = torch.Generator().manual_seed(3)
        tok = tgreedy.sample_tokens(logp, temp, gen)
        freq = torch.bincount(tok, minlength=6).double() / len(tok)
        want = torch.softmax(logp[0].double() / temp, -1)
        assert float((freq - want).abs().max()) < 0.01
        assert freq[2] == 0 and freq[5] == 0
        again = tgreedy.sample_tokens(logp, temp,
                                      torch.Generator().manual_seed(3))
        assert torch.equal(tok, again)


def test_greedy_sampling_through_a_hooked_distribution(setup):
    """greedy_decode at T > 0 with a logits hook that leaves 4 tokens:
    only those are drawn, sum_logp adds the UNSCALED log-probs of the
    drawn tokens, the generator fixes the draws, and T > 0 without a
    generator raises."""
    _, tt, tok, *_ = setup
    allowed = torch.tensor([10, 11, 12, 13])
    bias = torch.full((tok.vocab_size,), float("-inf"))
    bias[allowed] = torch.tensor([1.0, 0.5, 0.0, -0.5])

    def hook(x, tokens, seq_len):
        return torch.zeros_like(x) + bias

    enc = torch.zeros(1, ENC_CTX // 2, 32)
    prompt = torch.tensor(tok.prompt_ids("en"))
    runs = []
    for seed in (0, 0, 1):
        runs.append(tgreedy.greedy_decode(
            tt.params, enc, prompt, tt.cfg, tok.eot, batch=64, max_depth=6,
            temperature=0.7, generator=torch.Generator().manual_seed(seed),
            logits_hook=hook))
    toks, length, sum_logp = runs[0]
    drawn = toks[:, 4:int(length[0])]
    assert bool(torch.isin(drawn, allowed).all())
    logp = torch.log_softmax(bias, -1)
    torch.testing.assert_close(sum_logp, logp[drawn].sum(1))
    assert torch.equal(runs[0][0], runs[1][0])
    assert not torch.equal(runs[0][0], runs[2][0])
    with pytest.raises(ValueError, match="Generator"):
        tgreedy.greedy_decode(tt.params, enc, prompt, tt.cfg, tok.eot,
                              temperature=0.5)


def test_detect_language_matches_jax(setup):
    """The distribution averaged over two speech-bearing windows."""
    jt, tt, *_ = setup
    wave = _multiwindow_wave()
    wcode, wdist = jt.detect_language(wave, vote_windows=2)
    gcode, gdist = tt.detect_language(wave, vote_windows=2)
    assert gcode == wcode and set(gdist) == set(wdist) and len(gdist) > 50
    for code, p in wdist.items():
        assert abs(gdist[code] - p) <= 1e-5, code
    with pytest.raises(ValueError, match="too short"):
        tt.detect_language(np.zeros(100, np.float32))


@pytest.mark.parametrize("clips", ["0.2,0.9,1.3"])
def test_clips_match_jax(setup, clips):
    """transcribe and transcribe_with_timestamps over clip ranges (the odd
    count leaves the last one open): texts, tokens and segments with
    absolute times. `parse_clip_timestamps` alone takes the other forms
    (test_host_helpers_match_jax)."""
    jt, tt, *_ = setup
    wave = _multiwindow_wave()
    opts = dict(strategy="greedy", **BASE, clip_timestamps=clips)
    want = jt.transcribe(wave, options=JT.DecodeOptions(**opts),
                         on_chunk=lambda i, s: None)
    got = tt.transcribe(wave, options=TT.DecodeOptions(**opts),
                        on_chunk=lambda i, s: None)
    assert got == want
    _check_segments(
        tt.transcribe_with_timestamps(wave, options=TT.DecodeOptions(**opts)),
        jt.transcribe_with_timestamps(wave, options=JT.DecodeOptions(**opts)))


def test_host_helpers_match_jax(setup):
    """compression_ratio, evaluate_window_quality and parse_clip_timestamps
    on the same inputs as JAX's."""
    tok = setup[2]
    rng = np.random.default_rng(0)
    for text in ("", "abc", "la " * 50, "the quick brown fox " * 3):
        assert TT.compression_ratio(text) == JT.compression_ratio(text)
    for _ in range(50):
        toks = [int(t) for t in rng.integers(0, 200, rng.integers(0, 20))]
        kw = dict(logprob_threshold=[None, -1.0][int(rng.integers(2))],
                  no_speech_threshold=[None, 0.5][int(rng.integers(2))],
                  compression_ratio_threshold=[None, 1.5][
                      int(rng.integers(2))])
        args = (toks, int(rng.integers(0, 20)), float(rng.normal(-15, 15)),
                float(rng.choice([-1.0, rng.random()])))
        assert (TT.evaluate_window_quality(TT.DecodeOptions(**kw), tok, *args)
                == JT.evaluate_window_quality(JT.DecodeOptions(**kw), tok,
                                              *args))
    for clips, total in (("0,1", 3.0), ("1", 3.0), ("", 3.0),
                         ([0.5, 2, 2.5], 3.0), ("0,5", 3.0),
                         ("0,1,2.5,5", 3.0)):
        assert (TT.parse_clip_timestamps(clips, total)
                == JT.parse_clip_timestamps(clips, total))
    for bad in ("1,0", "0,2,1,3", "-1,2", "0,1,4,5"):
        for mod in (TT, JT):
            with pytest.raises(ValueError):
                mod.parse_clip_timestamps(bad, 3.0)


def test_stitcher_and_formats_match_jax(setup):
    """Segments with positions, the stitcher's splices (trimmed boundary
    segments) and the srt/vtt/tsv writers on random timestamped windows."""
    tok = setup[2]
    tsb = tok.timestamp_begin
    rng = np.random.default_rng(1)
    for _ in range(20):
        js = JS.TimestampStitcher(tok, 40, 3)
        ts = TS.TimestampStitcher(tok, 40, 3)
        for w in range(3):
            toks = [int(t) if rng.random() > 0.25 else tsb + int(t)
                    for t in rng.integers(0, 30, rng.integers(0, 25))]
            quality = (float(rng.normal()), float(rng.random()), None)
            want = JS.segments_with_positions(toks, tok, w * 0.7, 0.87)
            got = TS.segments_with_positions(toks, tok, w * 0.7, 0.87)
            assert ([(_segs([s]), p) for s, p in got]
                    == [(_segs([s]), p) for s, p in want])
            assert (_segs(TS.segments_from_tokens(toks, tok, w * 0.7))
                    == _segs(JS.segments_from_tokens(toks, tok, w * 0.7)))
            js.add_window(toks, w * 0.7, 0.87, quality=quality)
            ts.add_window(toks, w * 0.7, 0.87, quality=quality)
        assert ts.all_tokens == js.all_tokens
        assert _segs(ts.segments) == _segs(js.segments)
        for fmt in ("to_srt", "to_vtt", "to_tsv"):
            assert (getattr(TF, fmt)(ts.segments)
                    == getattr(JF, fmt)(js.segments))
    assert TF.srt_timestamp(3725.4567) == JF.srt_timestamp(3725.4567)
    assert TF.vtt_timestamp(-1.0) == JF.vtt_timestamp(-1.0)


# ---------------------------------------------------------------- the CLI


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


CLI_CASES = {
    "srt_auto_ladder": ["auto", "out.srt", "--timestamps", "--format", "srt",
                        "--temperature", "0,0.2", "--no-speech-threshold",
                        "0.6", "--greedy"],
    "json_clip_prompt": ["en", "out.json", "--timestamps", "--json",
                         "--clip", "0,1.5", "--initial-prompt", "hi",
                         "--condition-on-previous-text", "--greedy"],
    "vtt_translate_vad": ["en", "out.vtt", "--timestamps", "--format", "vtt",
                          "--task", "translate", "--vad",
                          "--vad-threshold-db", "-30"],
    "tsv_beam": ["en", "out.tsv", "--timestamps", "--format", "tsv"],
    "txt_segments": ["en", "out.txt", "--timestamps", "--greedy"],
    "parallel_windows": ["en", "out.txt", "--parallel-windows", "--greedy"],
    "parallel_ladder": ["en", "out.txt", "--parallel-windows",
                        "--temperature", "0,0.2", "--no-speech-threshold",
                        "0.6", "--greedy"],
    "txt_words": ["en", "out.txt", "--timestamps", "--words", "--greedy"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_flags_match_jax_cli(cli_dir, monkeypatch, capsys, request,
                                 case):
    """The same flags through the JAX CLI and the port's (on the CPU): the
    output files are equal (JSON: equal up to the quality fields, which
    are held to QUALITY_ATOL). The batched ladder runs with both samplers
    swapped for argmax."""
    if case == "parallel_ladder":
        request.getfixturevalue("argmax_samplers")
    monkeypatch.chdir(cli_dir)
    lang, out, *flags = CLI_CASES[case]
    flags += ["--max-depth", "8"]
    assert jax_cli.main(["transcribe", "dump", "audio.wav", lang, f"jax_{out}",
                         *flags]) == 0
    assert torch_cli.main(["transcribe", "dump", "audio.wav", lang,
                           f"torch_{out}", *flags, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "Transcription finished." in printed
    if lang == "auto":
        assert printed.count("Detected language:") == 2
    want = (cli_dir / f"jax_{out}").read_text()
    got = (cli_dir / f"torch_{out}").read_text()
    if out.endswith(".json"):
        want, got = json.loads(want), json.loads(got)
        assert got["text"] == want["text"]
        for g, w in zip(got["segments"], want["segments"], strict=True):
            for key in w:
                if key in ("avg_logprob", "compression_ratio",
                           "no_speech_prob"):
                    assert abs(g[key] - w[key]) <= 1e-4
                else:
                    assert g[key] == w[key]
    else:
        assert got == want and got.strip()


@pytest.mark.parametrize("flags,message", [
    (["--format", "srt"], "requires --timestamps"),
    (["--clip", "0,1", "--parallel-windows"], "incompatible"),
    (["--draft", "dump"], "--draft requires --greedy"),
    (["--clip", "2,1"], "Bad --clip"),
    (["--timestamps", "--parallel-windows"], "incompatible"),
    (["--condition-on-previous-text", "--parallel-windows"],
     "incompatible"),
])
def test_cli_error_exits(cli_dir, monkeypatch, capsys, flags, message):
    monkeypatch.chdir(cli_dir)
    rc = torch_cli.main(["transcribe", "dump", "audio.wav", "en", "err.txt",
                         *flags, "--device", "cpu"])
    assert rc == 1
    assert message in capsys.readouterr().err
    assert not (cli_dir / "err.txt").exists()


def test_cli_detect_lang_matches_jax_cli(cli_dir, monkeypatch, capsys):
    monkeypatch.chdir(cli_dir)
    for flags in ([], ["--top", "3", "--vote-windows", "2"]):
        assert jax_cli.main(["detect-lang", "dump", "audio.wav", *flags]) == 0
        want = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert torch_cli.main(["detect-lang", "dump", "audio.wav", *flags,
                               "--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert got["language"] == want["language"]
        assert list(got["probs"]) == list(want["probs"])
        for code, p in want["probs"].items():
            assert abs(got["probs"][code] - p) <= 1e-4
