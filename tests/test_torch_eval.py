"""The port's `eval` package and its two CLI commands vs the JAX package, on
the CPU: the quantization agreement report (`decode_agreement`) and `gate`,
the WER harness and the text normalizers (the port's own copies), and
`quant-check` / `eval` against the JAX CLI's output on a tiny checkpoint.

Tolerances. Token rates and window counts are held EQUAL: both packages
decode the same seeded audio to the same tokens. `max_logit_delta_rel` is
a ratio of two maxima of teacher-forced logits (the test model's against
the reference's); the two packages compute each logit to f32 summation
order (bf16 in the CLI), so the ratio is held within DELTA_ATOL = 1e-3
(absolute; the ratio itself is 1e-2 to 1e-1 here). WER results and normalized text are equal.
"""

import dataclasses
import json
import wave as wave_mod

import jax
import numpy as np
import pytest
import torch

from whisper_tpu import cli as jax_cli
from whisper_tpu import config as jcfg
from whisper_tpu import quantize as JQ
from whisper_tpu.eval import agreement as JA
from whisper_tpu.eval import normalizer as JN
from whisper_tpu.eval import wer as JW
from whisper_tpu.io import npy_tree
from whisper_tpu.models import whisper as JM
from whisper_tpu.text.tokenizer import build_test_tokenizer_json
from whisper_tpu_torch import cli as torch_cli
from whisper_tpu_torch import config as tcfg
from whisper_tpu_torch.eval import agreement as TA
from whisper_tpu_torch.eval import normalizer as TN
from whisper_tpu_torch.eval import wer as TW
from whisper_tpu_torch.params import from_numpy_tree

DELTA_ATOL = 1e-3


def _same_report(got, want):
    assert set(got) == set(want)
    for strategy in ("greedy", "beam"):
        assert got[strategy] == want[strategy], strategy
    assert abs(got["max_logit_delta_rel"]
               - want["max_logit_delta_rel"]) <= DELTA_ATOL


# ------------------------------------------------------------- agreement

def test_decode_agreement_report_matches_jax():
    """tests/test_quantize.py's int4 self-KV gate: int8 weight-only params,
    an int4 cross and an int4 self cache, greedy and beam 3 over 6 windows.
    (int4 weights under int8_impl="pallas" against JAX's Pallas path:
    test_torch_w8a8.py; `decode_agreement` over them on the card against
    the CPU: test_torch_cuda.py.)"""
    cfg_dims = dict(n_state=64, n_head=2, n_vocab=128, n_audio_ctx=64,
                    n_text_ctx=32)
    jc = jcfg.tiny_test_config(**cfg_dims)
    tc = tcfg.tiny_test_config(**cfg_dims)
    p = JM.init_params(jax.random.PRNGKey(2), jc)
    qp = JQ.quantize_params(p)
    kw = dict(eot_id=5, prompt=[1, 2, 3], max_depth=10, n_windows=6,
              beam_size=3, kv_quant_test="int4", self_quant_test="int4")
    with jax.default_matmul_precision("highest"):
        want = JA.decode_agreement(p, qp, jc, **kw)
    got = TA.decode_agreement(
        from_numpy_tree(jax.tree.map(np.asarray, p)),
        from_numpy_tree(jax.tree.map(np.asarray, qp)), tc, **kw)
    _same_report(got, want)
    assert got["greedy"]["n_windows"] == 6


@pytest.mark.parametrize("greedy,beam,delta", [
    (1.0, 1.0, 0.05), (0.98, 1.0, 0.05), (1.0, 0.95, 0.0),
    (1.0, 1.0, 0.2), (0.995, 0.991, 0.1)])
def test_gate_matches_jax(greedy, beam, delta):
    """The same reports pass or fail the same way, with the same message."""
    report = {"greedy": {"token_match_rate": greedy},
              "beam": {"token_match_rate": beam},
              "max_logit_delta_rel": delta}
    errors = []
    for gate in (JA.gate, TA.gate):
        try:
            gate(report)
            errors.append(None)
        except AssertionError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]


# ---------------------------------------------------------- WER, normalizers

WER_PAIRS = [
    ("hello world", "hello world"), ("the cat sat", "the dog sat"),
    ("a b c d", "a b d"), ("a b d", "a b c d"),
    ("Hello, World!", "hello world"), ("don't stop", "do not stop"),
    ("one two three", ""),
    ("Mr. Brown paid one hundred and twenty dollars, didn't he?",
     "mister brown paid $120 did not he"),
]

NORMALIZER_INPUTS = [
    "I won't go", "they're here, we've left", "Mr. Smith met Dr. Jones",
    "let's can't don't", "hello [noise] world (laughs)", "um hello uh world",
    "one hundred and twenty three", "twenty one", "nineteen sixty four",
    "three point one four", "seven percent", "minus five degrees",
    "the twentieth century", "chapter first", "two thousand and five",
    "five million people", "double oh seven", "five dollars",
    "it cost one dollar and fifty cents", "the colour of the theatre",
    "he travelled to the centre", "she must recognise the flavour",
    "1,000 years.", "hello!!! world???",
]


@pytest.mark.parametrize("english", [True, False])
@pytest.mark.parametrize("ref,hyp", WER_PAIRS)
def test_wer_matches_jax(ref, hyp, english):
    want = JW.WerResult(english=english).add(ref, hyp)
    got = TW.WerResult(english=english).add(ref, hyp)
    assert (got.errors, got.words, got.utterances, got.wer) == (
        want.errors, want.words, want.utterances, want.wer)
    assert TW.wer(ref, hyp) == JW.wer(ref, hyp)


@pytest.mark.parametrize("text", NORMALIZER_INPUTS)
def test_normalizers_match_jax(text):
    assert TN.EnglishTextNormalizer()(text) == JN.EnglishTextNormalizer()(text)
    assert TN.BasicTextNormalizer()(text) == JN.BasicTextNormalizer()(text)
    assert (TW.normalize_text(text, english=False)
            == JW.normalize_text(text, english=False))


def test_dataset_readers_and_evaluate_match_jax(tmp_path):
    """The manifest readers (TSV and JSONL), the LibriSpeech walk and the
    `evaluate` runner over the same files give the same items and
    results."""
    (tmp_path / "a.wav").write_bytes(b"")
    (tmp_path / "m.tsv").write_text("a.wav\thello there\n\nb.wav\tbye\n")
    (tmp_path / "m.jsonl").write_text('{"audio": "a.wav", "text": "hi"}\n')
    d = tmp_path / "ls" / "19" / "198"
    d.mkdir(parents=True)
    (d / "19-198.trans.txt").write_text(
        "19-198-0000 HELLO WORLD\n19-198-0001 MISSING AUDIO\n")
    with wave_mod.open(str(d / "19-198-0000.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(100, np.int16).tobytes())
    for name in ("m.tsv", "m.jsonl"):
        path = str(tmp_path / name)
        assert list(TW.iter_manifest(path)) == list(JW.iter_manifest(path))
    root = str(tmp_path / "ls")
    items = list(TW.iter_librispeech(root))
    assert items == list(JW.iter_librispeech(root)) and len(items) == 1
    pairs = [("x.wav", "a b c"), ("y.wav", "d e"), ("z.wav", "f")]
    fn = {"x.wav": "a b c", "y.wav": "d x", "z.wav": "g"}.get
    for limit in (None, 2):
        got = TW.evaluate(fn, pairs, limit=limit)
        want = JW.evaluate(fn, pairs, limit=limit)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ------------------------------------------------------------------ CLIs

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny random checkpoint (JAX's npy dump) with the synthetic
    tokenizer beside it, and two utterances of speech-shaped audio."""
    d = tmp_path_factory.mktemp("torch_eval")
    build_test_tokenizer_json(str(d / "tokenizer.json"))
    from whisper_tpu.text.tokenizer import WhisperTokenizer

    tok = WhisperTokenizer(str(d / "tokenizer.json"))
    cfg = jcfg.tiny_test_config(n_state=32, n_head=2, n_layer=2,
                                n_vocab=tok.vocab_size, n_audio_ctx=96,
                                n_text_ctx=48)
    npy_tree.save_whisper(jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(7), cfg)), cfg, str(d / "dump"))
    for i, (seconds, hz) in enumerate(((1.2, 220.0), (0.8, 330.0))):
        n = int(16000 * seconds)
        t = np.arange(n) / 16000.0
        x = 0.3 * np.sin(2 * np.pi * hz * t) + 0.1 * np.random.default_rng(
            i).standard_normal(n)
        with wave_mod.open(str(d / f"u{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((x * 20000).astype(np.int16).tobytes())
    (d / "manifest.tsv").write_text("u0.wav\thello world\n"
                                    "u1.wav\tone two three\n")
    return d


def _json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def test_cli_quant_check_matches_jax_cli(ckpt, monkeypatch, capsys):
    """`--kv int4` (and the default int8 self cache): the same report
    line and exit code (random weights: the gate's verdict is whatever the
    tokens say, the same for both)."""
    monkeypatch.chdir(ckpt)
    args = ["quant-check", "dump", "--windows", "2", "--max-depth", "6",
            "--kv", "int4"]
    with jax.default_matmul_precision("highest"):
        want_rc = jax_cli.main(args)
    want = _json_line(capsys.readouterr().out)
    got_rc = torch_cli.main([*args, "--device", "cpu"])
    out, err = capsys.readouterr()
    got = _json_line(out)
    assert got_rc == want_rc
    assert ("PASS" if got_rc == 0 else "FAIL:") in err
    _same_report(got, want)


def test_cli_eval_matches_jax_cli(ckpt, monkeypatch, capsys):
    """WER over a two-item manifest, greedy: the same JSON line (the
    transcripts are the same, so errors and words are)."""
    monkeypatch.chdir(ckpt)
    args = ["eval", "dump", "manifest.tsv", "en", "--dtype", "float32",
            "--greedy"]
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert torch_cli.main([*args, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want
    # "one two three" normalizes to "123": 2 + 1 reference words
    assert json.loads(got)["utterances"] == 2 and json.loads(got)["words"] == 3


def test_cli_refuses_without_a_card_unless_asked_for_the_cpu(ckpt, capsys):
    """Both new commands default to the card: with none they exit 1 and
    say so, rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for args in (["quant-check", str(ckpt / "dump")],
                 ["eval", str(ckpt / "dump"), str(ckpt / "manifest.tsv")]):
        assert torch_cli.main(args) == 1
        assert "No CUDA device" in capsys.readouterr().err
