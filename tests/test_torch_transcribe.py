"""The port's greedy decode and long-form pipeline (beam and greedy) vs the
JAX package's, same weights and audio, f32 on the CPU (device="cpu" and
--device cpu, since the port's entry points default to the card).

Setup as tests/test_golden_oracle.py: ENC_CTX 96 (0.87 s windows), the
synthetic test tokenizer, a 2-layer n_state-32 model, PRNGKey(7). Random
weights tie-collapse, so besides token equality the per-step logits are
held within LOGIT_ATOL = 1e-4 (f32, summation order), and a logits hook
forces the EOT and suppression paths.
"""

import os
import subprocess
import sys
import wave as wave_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu import cli as jax_cli
from whisper_tpu.config import tiny_test_config
from whisper_tpu.decode import beam as jbeam
from whisper_tpu.decode import greedy as jgreedy
from whisper_tpu.io import npy_tree
from whisper_tpu.models import whisper as JM
from whisper_tpu.ops.audio import max_waveform_samples
from whisper_tpu.pipeline import transcribe as JT
from whisper_tpu.text.tokenizer import WhisperTokenizer, build_test_tokenizer_json
from whisper_tpu_torch import cli as torch_cli
from whisper_tpu_torch.decode import greedy as tgreedy
from whisper_tpu_torch.params import from_numpy_tree
from whisper_tpu_torch.pipeline import transcribe as TT

ENC_CTX = 96
OVERLAP_S = 0.15
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_gold")
    tok_path = str(d / "tokenizer.json")
    build_test_tokenizer_json(tok_path)
    tok = WhisperTokenizer(tok_path)
    cfg = tiny_test_config(n_state=32, n_head=2, n_layer=2,
                           n_vocab=tok.vocab_size, n_audio_ctx=ENC_CTX,
                           n_text_ctx=48)
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(7),
                                                     cfg))
    return params, cfg, tok, d


def _audio(n_samples: int, seed: int) -> np.ndarray:
    """Speech-shaped synthetic audio: tones + amplitude bursts + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220.0 * t)
         + 0.2 * np.sin(2 * np.pi * 880.0 * t
                        * (1 + 0.3 * np.sin(2 * np.pi * 2.0 * t)))
         + 0.1 * rng.standard_normal(n_samples))
    envelope = 0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 1.3 * t))
    return (x * envelope).astype(np.float32)


def _multiwindow_wave():
    n_window = max_waveform_samples(ENC_CTX - 10)
    shift = n_window - int(16000 * OVERLAP_S)
    return _audio(2 * shift + 7000, seed=3)  # 3 windows, last partial


@pytest.fixture(scope="module")
def jax_transcript(setup):
    params, cfg, tok, _ = setup
    t = JT.Transcriber(params, cfg, tok, attention="xla",
                       matmul_precision="highest")
    chunks = []
    text, tokens = t.transcribe(
        _multiwindow_wave(), options=JT.DecodeOptions(
            strategy="greedy", max_depth=12, chunk_overlap_seconds=OVERLAP_S),
        on_chunk=lambda i, s: chunks.append(s))
    return text, tokens, chunks


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_multiwindow_greedy_token_exact(setup, jax_transcript, attention):
    """3 windows through the whole pipeline; "flash" runs the kernel paths'
    plain versions on the CPU."""
    params, cfg, tok, _ = setup
    t = TT.Transcriber(params, cfg, tok, attention=attention,
                       matmul_precision="highest", device="cpu")
    chunks = []
    text, tokens = t.transcribe(
        _multiwindow_wave(), options=TT.DecodeOptions(
            strategy="greedy", max_depth=12, chunk_overlap_seconds=OVERLAP_S),
        on_chunk=lambda i, s: chunks.append(s))
    want_text, want_tokens, want_chunks = jax_transcript
    assert len(chunks) == 3
    assert tokens == want_tokens
    assert text == want_text and chunks == want_chunks
    assert len(tokens) > len(tok.prompt_ids("en"))  # not vacuous


@pytest.fixture(scope="module")
def jax_beam_transcript(setup):
    params, cfg, tok, _ = setup
    t = JT.Transcriber(params, cfg, tok, attention="xla",
                       matmul_precision="highest")
    chunks = []
    text, tokens = t.transcribe(
        _multiwindow_wave(), options=JT.DecodeOptions(
            max_depth=12, chunk_overlap_seconds=OVERLAP_S),
        on_chunk=lambda i, s: chunks.append(s))
    return text, tokens, chunks


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_multiwindow_default_beam_token_exact(setup, jax_beam_transcript,
                                              attention):
    """Default options (beam search, 5 beams) over 3 windows against the
    JAX Transcriber's."""
    params, cfg, tok, _ = setup
    assert TT.DecodeOptions().strategy == "beam"
    t = TT.Transcriber(params, cfg, tok, attention=attention,
                       matmul_precision="highest", device="cpu")
    chunks = []
    text, tokens = t.transcribe(
        _multiwindow_wave(), options=TT.DecodeOptions(
            max_depth=12, chunk_overlap_seconds=OVERLAP_S),
        on_chunk=lambda i, s: chunks.append(s))
    want_text, want_tokens, want_chunks = jax_beam_transcript
    assert len(chunks) == 3
    assert tokens == want_tokens
    assert text == want_text and chunks == want_chunks
    assert len(tokens) > len(tok.prompt_ids("en"))  # not vacuous


def test_transcriber_defaults_to_the_card(setup, monkeypatch):
    """device=None means "cuda": without a card the constructor raises
    instead of running on the CPU."""
    params, cfg, tok, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.Transcriber(params, cfg, tok)
    assert TT.Transcriber(params, cfg, tok, device="cpu").device.type == "cpu"


def _jnp(params):
    """Device arrays for the JAX decode loops (they index inside a trace)."""
    return jax.tree.map(jnp.asarray, params)


def _window_enc(params, cfg, seed, batch=1):
    """JAX encoder output for `batch` windows of synthetic audio."""
    from whisper_tpu.ops.audio import prep_audio

    n = max_waveform_samples(ENC_CTX - 10)
    wave = np.stack([_audio(n, seed + i) for i in range(batch)])
    with jax.default_matmul_precision("highest"):
        mel = prep_audio(jnp.asarray(wave))
        mel = jnp.pad(mel[:, :, :ENC_CTX - 10], ((0, 0), (0, 0), (0, 10)))
        return np.array(JM.encoder_forward(params, mel, cfg))  # writable


def test_per_step_logits_match_teacher_forced_jax(setup):
    """Every greedy step's logits (as the hook sees them, after
    suppression) against JAX's full recompute over the decoded tokens."""
    params, cfg, tok, _ = setup
    enc = _window_enc(params, cfg, seed=5)
    sup = tok.suppress_mask()
    prompt = tok.prompt_ids("en")
    seen = []

    def record(x, tokens, seq_len):
        seen.append((seq_len, x.clone()))
        return x

    toks, length, _ = tgreedy.greedy_decode(
        from_numpy_tree(params), torch.from_numpy(enc),
        torch.tensor(prompt), cfg, tok.eot, torch.from_numpy(sup),
        max_depth=10, logits_hook=record)
    n = int(length[0])
    seq = toks[:, :n].numpy()
    with jax.default_matmul_precision("highest"):
        full = np.asarray(JM.decoder_forward(params, jnp.asarray(seq),
                                             jnp.asarray(enc), cfg))
    assert len(seen) >= n - len(prompt)
    for seq_len, x in seen[: n - len(prompt)]:
        want = full[:, seq_len - 1] + (sup if seq_len <= 5 else 0.0)
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(x.numpy()), fin)
        np.testing.assert_allclose(x.numpy()[fin], want[fin],
                                   atol=LOGIT_ATOL, rtol=0)


def _hooks(tsb_none_eot):
    """The same logits hook for both packages: while suppression is on it
    boosts EOT (which the -inf mask must still block); at seq_len 8 it
    forces EOT on row 0 only; at seq_len 10 on every row."""
    eot = tsb_none_eot

    def j_hook(x, tokens, seq_len):
        row = jnp.arange(x.shape[0])[:, None]
        col = jnp.arange(x.shape[1])[None, :]
        boost = jnp.where((seq_len <= 5) & (col == eot), 100.0, 0.0)
        force = (((seq_len == 8) & (row == 0)) | (seq_len == 10)) & (col == eot)
        return jnp.where(force, 1e4, x + boost)

    def t_hook(x, tokens, seq_len):
        row = torch.arange(x.shape[0])[:, None]
        col = torch.arange(x.shape[1])[None, :]
        boost = torch.where((col == eot) & (seq_len <= 5),
                            torch.tensor(100.0), torch.tensor(0.0))
        force = (((row == 0) & (seq_len == 8)) | (seq_len == 10)) & (col == eot)
        return torch.where(force, torch.tensor(1e4), x + boost)

    return j_hook, t_hook


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_hook_forced_eot_and_suppression(setup, attention):
    """Two rows: row 0 is forced to stop first and keeps emitting EOT while
    row 1 runs on; tokens, lengths, summed logprobs and p(nospeech) agree."""
    import dataclasses

    params, cfg, tok, _ = setup
    cfg = dataclasses.replace(cfg, attention=attention)
    enc = _window_enc(params, cfg, seed=8, batch=2)
    sup = tok.suppress_mask()
    prompt = tok.prompt_ids("en")
    ns_id = tok.special_token("<|nospeech|>")
    j_hook, t_hook = _hooks(tok.eot)
    with jax.default_matmul_precision("highest"):
        jt, jl, jlp, jns = jgreedy.greedy_decode(
            _jnp(params), jnp.asarray(enc), jnp.asarray(prompt, jnp.int32),
            cfg, tok.eot, jnp.asarray(sup), max_depth=20, logits_hook=j_hook,
            nospeech_id=ns_id)
    tt, tl, tlp, tns = tgreedy.greedy_decode(
        from_numpy_tree(params), torch.from_numpy(enc), torch.tensor(prompt),
        cfg, tok.eot, torch.from_numpy(sup), max_depth=20, logits_hook=t_hook,
        nospeech_id=ns_id)
    jl = np.asarray(jl)
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert list(jl) == [9, 11]  # the hook stops row 0 at seq_len 8, row 1 at 10
    for r in range(2):
        np.testing.assert_array_equal(tt[r, :jl[1]].numpy(),
                                      np.asarray(jt)[r, :jl[1]])
    assert int(tt[0, jl[0]]) == tok.eot  # finished row keeps emitting EOT
    assert all(int(t) != tok.eot for t in tt[1, len(prompt):jl[1] - 1])
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4)
    np.testing.assert_allclose(tns.numpy(), np.asarray(jns), atol=1e-6)


def test_timestamp_rules_match_jax():
    """200 random (logits, history) cases, as test_golden_oracle holds the
    JAX rules against its oracle."""
    v, eot, tsb, p, ctx = 24, 5, 14, 3, 16
    rng = np.random.default_rng(0)
    for _ in range(200):
        seq_len = int(rng.integers(p, ctx - 1))
        toks = rng.integers(0, v, size=(2, ctx)).astype(np.int64)
        logits = (rng.standard_normal((2, v)) * 3).astype(np.float32)
        want = np.asarray(jbeam.apply_timestamp_rules(
            jnp.asarray(logits), jnp.asarray(toks, jnp.int32),
            jnp.int32(seq_len), p, tsb, eot, 6))
        got = tgreedy.apply_timestamp_rules(
            torch.from_numpy(logits), torch.from_numpy(toks), seq_len, p,
            tsb, eot, 6).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = ~np.isneginf(want)
        np.testing.assert_array_equal(got[fin], want[fin])


def test_timestamped_greedy_decode_token_exact(setup):
    params, cfg, tok, _ = setup
    enc = _window_enc(params, cfg, seed=29)
    tsb = tok.timestamp_begin
    sup = tok.suppress_mask().copy()
    sup[tsb:] = 0.0
    prompt = tok.prompt_ids("en", timestamps=True)
    with jax.default_matmul_precision("highest"):
        jt, jl, _ = jgreedy.greedy_decode(
            _jnp(params), jnp.asarray(enc), jnp.asarray(prompt, jnp.int32),
            cfg, tok.eot, jnp.asarray(sup), max_depth=12, ts_begin=tsb,
            max_initial_ts_idx=3)
    tt, tl, _ = tgreedy.greedy_decode(
        from_numpy_tree(params), torch.from_numpy(enc), torch.tensor(prompt),
        cfg, tok.eot, torch.from_numpy(sup), max_depth=12, ts_begin=tsb,
        max_initial_ts_idx=3)
    n = int(np.asarray(jl)[0])
    assert int(tl[0]) == n
    got = tt[0, :n].tolist()
    assert got == [int(x) for x in np.asarray(jt)[0, :n]]
    assert any(t >= tsb for t in got[len(prompt):])  # not vacuous


@pytest.mark.parametrize("seq_len", [4, 5, 6])
def test_masked_log_softmax_matches_jax(seq_len):
    rng = np.random.default_rng(seq_len)
    logits = rng.standard_normal((3, 30)).astype(np.float32)
    mask = np.where(rng.random(30) < 0.2, -np.inf, 0.0).astype(np.float32)
    want = np.asarray(jbeam._masked_log_softmax(
        jnp.asarray(logits), jnp.int32(seq_len), jnp.asarray(mask), 5))
    logp_fn = tgreedy.make_logp_fn(0, 0, torch.from_numpy(mask), 5, None, 50,
                                   None)
    got = logp_fn(torch.from_numpy(logits), None, seq_len).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_stitching_and_windowing_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(100):
        prev = list(rng.integers(0, 6, size=int(rng.integers(0, 30))))
        curr = list(rng.integers(0, 6, size=int(rng.integers(0, 30))))
        assert (TT.find_chunk_overlap(prev, curr, 40, 3)
                == JT.find_chunk_overlap(prev, curr, 40, 3))
    w = np.zeros(100_000, np.float32)
    for win, ov in ((30_000, 5_000), (13_919, 2_400), (50, 80)):
        assert (list(TT.window_waveform(w, 16000, win, ov))
                == list(JT.window_waveform(w, 16000, win, ov)))


@pytest.mark.parametrize("n_samples,overlap_s,vad,kinds", [
    # shift 11519: the third window holds 300 samples
    pytest.param(23338, OVERLAP_S, False, ["full", "tail", "short"],
                 id="short-tail"),
    # 1 s >= the 13919-sample window: clamped to 6959
    pytest.param(27838, 1.0, False, ["full", "full", "tail", "tail"],
                 id="overlap-clamp"),
    pytest.param(3 * 13919, 0.0, True, ["full", "silent", "full"],
                 id="vad-silent-middle"),
    pytest.param(13919, 0.0, False, ["full"], id="one-window"),
])
def test_window_plan(setup, monkeypatch, caplog, n_samples, overlap_s, vad,
                     kinds):
    """`plan_windows` against `window_waveform` with the rule written out
    (the overlap clamped to half a window, a window under n_fft = 400
    samples skipped, then a silent one under VAD, the rest full or tail),
    its samples views of the stream; and `_decode_windows` and
    `WindowPool.add` decode the same windows as full and as tails."""
    from whisper_tpu_torch.pipeline import batch as TB
    from whisper_tpu_torch.pipeline import vad as tvad

    params, cfg, tok, _ = setup
    opt = TT.DecodeOptions(strategy="greedy", chunk_overlap_seconds=overlap_s,
                           vad=vad)
    wave = _audio(n_samples, seed=5)
    if vad:
        wave[n_samples // 3:2 * n_samples // 3] = 0.0
    n = max_waveform_samples(ENC_CTX - 10)
    overlap = int(16000 * overlap_s)
    overlap = n // 2 if overlap >= n else overlap
    want = []
    for i, (a, b) in enumerate(TT.window_waveform(wave, 16000, n, overlap)):
        if b - a < 400:
            kind = "short"
        elif vad and tvad.is_silent(wave[a:b], 16000, opt.vad_threshold_db,
                                    opt.vad_min_speech_seconds):
            kind = "silent"
        else:
            kind = "full" if b - a == n else "tail"
        want.append((i, a, b, kind))
    assert [k for *_, k in want] == kinds  # each case is what it says

    caplog.clear()
    plan = list(TT.plan_windows(wave, 16000, cfg, opt))
    assert [(w.i, w.start, w.end, w.kind) for w in plan] == want
    assert all(w.samples.base is wave for w in plan)  # views, not copies
    assert sum("clamping" in r.getMessage() for r in caplog.records) == (
        overlap_s == 1.0)
    full = [w.i for w in plan if w.kind == "full"]
    tails = [w.i for w in plan if w.kind == "tail"]

    bt = TB.BatchTranscriber(params, cfg, tok, batch_size=2, device="cpu")
    pool = TB.WindowPool(bt, opt)
    pool.add("r", wave)
    assert [w for _, w, _ in pool._queue] == full
    assert [w for w, _ in pool._tails["r"]] == tails
    assert pool._n_windows["r"] == len(want)

    def batch(waves, *args, **kwargs):  # every full window decodes to [1]
        rows = len(waves)
        return (np.ones((rows, 1), np.int64), np.ones(rows, np.int64),
                np.zeros(rows, np.float32), np.full(rows, -1.0, np.float32))

    monkeypatch.setattr(bt, "_decode_batch", batch)
    monkeypatch.setattr(bt, "_decode", lambda *a, **k: ([2], 0.0, -1.0))
    results, _, bounds, n_windows = bt._decode_windows([wave], 16000, opt)
    assert sorted(w for (_, w), r in results.items() if r == [1]) == full
    assert sorted(w for (_, w), r in results.items() if r == [2]) == tails
    assert n_windows == [len(want)]
    assert bounds == {(0, i): (a, b) for i, a, b, _ in want}


def test_condition_on_previous_text_matches_jax(setup):
    params, cfg, tok, _ = setup
    opts = dict(strategy="greedy", max_depth=8, chunk_overlap_seconds=OVERLAP_S,
                condition_on_previous_text=True, initial_prompt="hi")
    wave = _multiwindow_wave()
    want = JT.Transcriber(params, cfg, tok, attention="xla",
                          matmul_precision="highest").transcribe(
        wave, options=JT.DecodeOptions(**opts), on_chunk=lambda i, s: None)
    got = TT.Transcriber(params, cfg, tok, device="cpu").transcribe(
        wave, options=TT.DecodeOptions(**opts), on_chunk=lambda i, s: None)
    assert got == want


# timestamps, the temperature ladder, no_speech_threshold and clips are
# ported: tests/test_torch_timestamps.py::test_ported_options_match_jax
@pytest.mark.parametrize("change,ported", [
    pytest.param(dict(strategy="sample"), False, id="change0"),
    pytest.param(dict(self_quant="int4"), True, id="change1"),
    pytest.param(dict(kv_quant="int4", self_quant="int4"), True,
                 id="change2"),
])
def test_unported_options_raise(setup, change, ported):
    """A strategy other than "beam" or "greedy" raises ValueError (JAX
    decodes it greedily: a documented difference); a ported option (the
    int4 self cache, with or without the int4 cross cache) transcribes as
    the JAX Transcriber does."""
    params, cfg, tok, _ = setup
    opts = {"strategy": "greedy", "max_depth": 8, **change}
    t = TT.Transcriber(params, cfg, tok, device="cpu")
    wave = _audio(8000, 0)
    if not ported:
        with pytest.raises(ValueError, match='"beam" or "greedy"'):
            t.transcribe(wave, options=TT.DecodeOptions(**opts))
        return
    want = JT.Transcriber(params, cfg, tok, attention="xla",
                          matmul_precision="highest").transcribe(
        wave, options=JT.DecodeOptions(**opts), on_chunk=lambda i, s: None)
    got = t.transcribe(wave, options=TT.DecodeOptions(**opts),
                       on_chunk=lambda i, s: None)
    assert got == want and got[1]


def test_draft_raises(setup):
    """Speculative decoding is ported (tests/test_torch_speculative.py);
    a draft still raises on a block size below 1, as in JAX."""
    params, cfg, tok, _ = setup
    with pytest.raises(ValueError, match="draft_k"):
        TT.Transcriber(params, cfg, tok, draft=(params, cfg), draft_k=0,
                       device="cpu")


@pytest.fixture(scope="module")
def cli_dir(setup):
    params, cfg, tok, d = setup
    npy_tree.save_whisper(params, cfg, str(d / "dump"))
    with wave_mod.open(str(d / "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((_multiwindow_wave() * 20000).astype(np.int16).tobytes())
    return d


def _cli_pair(decode_args, capsys):
    """The same transcription through the JAX CLI and the port's CLI (on
    the CPU); returns both output files' text."""
    args = ["dump", "audio.wav", "en"]
    opts = [*decode_args, "--max-depth", "8"]
    name = "greedy" if decode_args else "beam"
    assert jax_cli.main(["transcribe", *args, f"jax_{name}.txt", *opts]) == 0
    assert torch_cli.main(["transcribe", *args, f"torch_{name}.txt", *opts,
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Loading waveform..." in out and "Loading model..." in out
    assert "Transcription finished." in out
    with open(f"jax_{name}.txt") as a, open(f"torch_{name}.txt") as b:
        return a.read(), b.read()


def test_cli_transcribe_matches_jax_cli(cli_dir, monkeypatch, capsys):
    monkeypatch.chdir(cli_dir)
    want, got = _cli_pair(["--greedy"], capsys)
    assert got == want and got


def test_cli_beam_search_matches_jax_cli(cli_dir, monkeypatch, capsys):
    """Without --greedy both CLIs run beam search (5 beams)."""
    monkeypatch.chdir(cli_dir)
    want, got = _cli_pair([], capsys)
    assert got == want and got


def test_cli_without_a_card_exits_nonzero(cli_dir, monkeypatch, capsys):
    """--device cuda is the default; with no card the CLI says so and
    exits non-zero instead of falling back to the CPU."""
    monkeypatch.chdir(cli_dir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"]):
        rc = torch_cli.main(["transcribe", "dump", "audio.wav", "en",
                             "nocard.txt", *extra])
        assert rc != 0
        assert "--device cpu" in capsys.readouterr().err
    assert not os.path.exists("nocard.txt")


def test_cli_process_never_imports_jax(cli_dir):
    """The CLI loads weights and audio with the port's own io modules."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "from whisper_tpu_torch.cli import main\n"
            "rc = main(['transcribe', 'dump', 'audio.wav', 'en', 'sub.txt', "
            "'--greedy', '--max-depth', '4', '--device', 'cpu'])\n"
            "print(rc, 'jax' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=cli_dir, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.stdout.splitlines()[-1] == "0 False", proc.stderr
