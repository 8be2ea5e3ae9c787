"""The port's speculative greedy decoding vs the JAX package's, and vs the
port's own plain greedy loop, f32 on the CPU.

Setup as tests/test_speculative.py: a 2-layer target and a 1-layer draft
(n_state 8, a 32-token vocabulary, 48 text positions, 16 audio frames),
weights from PRNGKey(3) and PRNGKey(11), converted with `from_numpy_tree`.
Against JAX, tokens and lengths must be EQUAL and sum_logp agree to
rtol 1e-4; acceptance is never compared, because the port writes the
draft row that JAX leaves unwritten on full acceptance (see
test_draft_cache_has_no_unwritten_row). Against the port's greedy loop
the tokens and lengths are equal and sum_logp agrees to 1e-5.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import tiny_test_config
from whisper_tpu.decode import speculative as jspec
from whisper_tpu.models import whisper as JM
from whisper_tpu.text.tokenizer import WhisperTokenizer, build_test_tokenizer_json
from whisper_tpu_torch import cli as torch_cli
from whisper_tpu_torch.decode import greedy as tgreedy
from whisper_tpu_torch.decode import speculative as tspec
from whisper_tpu_torch.io import checkpoint as tcheckpoint
from whisper_tpu_torch.params import from_numpy_tree
from whisper_tpu_torch.pipeline import transcribe as TT

CFG = tiny_test_config(n_vocab=32, n_text_ctx=48, n_audio_ctx=16)
DRAFT_CFG = tiny_test_config(n_vocab=32, n_text_ctx=48, n_audio_ctx=16,
                             n_layer=1)
EOT = 7
SUPPRESS = [5, 6, 7, 30, 31]
PROMPT = [1, 2, 3]
LOGP_RTOL = 1e-4


def _enc(params, cfg, seed=7):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal(
        (1, 80, cfg.audio_encoder_config.n_audio_ctx)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        return np.array(JM.encoder_forward(params, jnp.asarray(mel), cfg))


@pytest.fixture(scope="module")
def models():
    """(numpy tree, encoder output) of the target and the draft."""
    t = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(3), CFG))
    d = jax.tree.map(np.asarray,
                     JM.init_params(jax.random.PRNGKey(11), DRAFT_CFG))
    return {"target": (t, _enc(t, CFG), CFG),
            "random": (d, _enc(d, DRAFT_CFG), DRAFT_CFG),
            "self": (t, _enc(t, CFG), CFG)}


def _mask(ids=SUPPRESS):
    m = np.zeros((CFG.text_decoder_config.n_vocab,), np.float32)
    m[list(ids)] = -np.inf
    return m


def _port(models, draft="random", attention="flash", mask=None, **kw):
    """The port's speculative decode (numpy outputs); `attention` "flash"
    sends the draft's S = 1 steps through the fused path (the kernels'
    plain versions on the CPU)."""
    tp, te, _ = models["target"]
    dp, de, dcfg = models[draft]
    out = tspec.speculative_greedy_decode(
        from_numpy_tree(tp), torch.from_numpy(te), torch.tensor(PROMPT),
        dataclasses.replace(CFG, attention=attention), EOT,
        draft_params=from_numpy_tree(dp), draft_enc_out=torch.from_numpy(de),
        draft_cfg=dataclasses.replace(dcfg, attention=attention),
        suppress_mask=torch.from_numpy(_mask() if mask is None else mask),
        **kw)
    return [o.numpy() for o in out]


def _greedy(models, attention="flash", mask=None, **kw):
    tp, te, _ = models["target"]
    out = tgreedy.greedy_decode(
        from_numpy_tree(tp), torch.from_numpy(te), torch.tensor(PROMPT),
        dataclasses.replace(CFG, attention=attention), EOT,
        suppress_mask=torch.from_numpy(_mask() if mask is None else mask),
        **kw)
    return [o.numpy() for o in out]


def _assert_same(want, got, rtol=LOGP_RTOL):
    np.testing.assert_array_equal(got[1], want[1])
    n = int(want[1][0])
    np.testing.assert_array_equal(got[0][0, :n], want[0][0, :n])
    np.testing.assert_allclose(got[2], want[2], rtol=rtol, atol=1e-6)
    return n


# ------------------------------------------------------------ against JAX

@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("draft", ["random", "self"])
def test_matches_jax(models, draft, k, attention):
    tp, te, _ = models["target"]
    dp, de, dcfg = models[draft]
    with jax.default_matmul_precision("highest"):
        want = jspec.speculative_greedy_decode(
            jax.tree.map(jnp.asarray, tp), jnp.asarray(te),
            jnp.asarray(PROMPT, jnp.int32), CFG, eot_id=EOT,
            draft_params=jax.tree.map(jnp.asarray, dp),
            draft_enc_out=jnp.asarray(de), draft_cfg=dcfg,
            suppress_mask=jnp.asarray(_mask()), n_draft=k, max_depth=16)
    got = _port(models, draft, attention, n_draft=k, max_depth=16)
    n = _assert_same([np.asarray(w) for w in want], got)
    assert n > len(PROMPT)


# ------------------------------------------------- against the port's greedy

def _ts_case():
    m = _mask([5, 6, 7])  # timestamp ids (>= 20) stay emittable
    return dict(mask=m, max_depth=12, ts_begin=20, max_initial_ts_idx=5)


def _eot_hook(x, tokens, seq_len):
    """EOT becomes the argmax from 6 tokens past the prompt on."""
    if seq_len >= len(PROMPT) + 6:
        return x + torch.where(torch.arange(x.shape[1]) == EOT, 1e4, 0.0)
    return x


CASES = {
    "timestamps": (_ts_case, "random", 4),
    "nospeech": (lambda: dict(max_depth=8, nospeech_id=3), "random", 3),
    "eot_mid_block": (lambda: dict(max_depth=16, logits_hook=_eot_hook),
                      "self", 4),
    "depth_1": (lambda: dict(max_depth=1), "self", 4),
    "depth_2": (lambda: dict(max_depth=2), "self", 4),
    "depth_5": (lambda: dict(max_depth=5), "self", 4),
    "int8_cross_int8_self": (lambda: dict(max_depth=10, kv_quant=True,
                                          self_quant=True), "random", 4),
    "int4_cross": (lambda: dict(max_depth=10, kv_quant="int4"), "random", 4),
}


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_port_greedy(models, case, attention):
    make, draft, k = CASES[case]
    kw = make()
    want = _greedy(models, attention, **kw)
    got = _port(models, draft, attention, n_draft=k, **kw)
    n = _assert_same(want, got, rtol=1e-5)
    if "nospeech_id" in kw:
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    if case == "timestamps":
        assert int(got[0][0, len(PROMPT)]) >= 20  # a timestamp first
    if case == "eot_mid_block":
        assert int(got[0][0, n - 1]) == EOT and n < len(PROMPT) + 16
    if case.startswith("depth_"):
        assert n == len(PROMPT) + int(case[-1])  # no EOT: the full budget


def test_hostile_draft_hook_changes_acceptance_only(models):
    """A draft hook forcing garbage proposals costs acceptance, never
    correctness."""
    v = CFG.text_decoder_config.n_vocab

    def garbage(x, tokens, seq_len):
        tok = (seq_len * 13 + 1) % v
        return torch.where(torch.arange(v)[None, :] == tok, 1e4, -1e4)

    fn = tspec.speculative_greedy_decode
    fn.iterations = fn.accepted = 0
    got = _port(models, "self", n_draft=4, max_depth=12,
                draft_logits_hook=garbage)
    assert fn.iterations > 0
    _assert_same(_greedy(models, max_depth=12), got, rtol=1e-5)


# ------------------------------------------------------- the draft cache

def _jax_draft_self_k(models, k, depth):
    """JAX's final draft self cache (L, C, d) of batch row 0, recorded with
    a debug callback around the draft's decoder steps."""
    tp, te, _ = models["target"]
    dcfg = dataclasses.replace(CFG)  # a distinct object marks the draft
    seen = []
    real = JM.decoder_step

    def spy(params, tokens, pos, cache, cfg, *a, **kw):
        logits, new = real(params, tokens, pos, cache, cfg, *a, **kw)
        if cfg is dcfg:
            jax.debug.callback(lambda sk: seen.append(np.array(sk)),
                               new.self_k)
        return logits, new

    fake_m = types.SimpleNamespace(**{n: getattr(JM, n) for n in dir(JM)
                                      if not n.startswith("__")})
    fake_m.decoder_step = spy
    orig = jspec.M
    jspec.M = fake_m
    try:
        with jax.default_matmul_precision("highest"):
            out = jspec.speculative_greedy_decode(
                jax.tree.map(jnp.asarray, tp), jnp.asarray(te),
                jnp.asarray(PROMPT, jnp.int32), CFG, eot_id=EOT,
                draft_params=jax.tree.map(jnp.asarray, tp),
                draft_enc_out=jnp.asarray(te), draft_cfg=dcfg,
                suppress_mask=jnp.asarray(_mask()), n_draft=k,
                max_depth=depth)
            jax.block_until_ready(out)
    finally:
        jspec.M = orig
    # the callbacks may run out of order: the final cache has the most
    # written rows (rows are overwritten, never cleared)
    final = max(seen, key=lambda sk: int((np.abs(sk).max(axis=(0, 1, 3))
                                          > 0).sum()))
    return final[0], int(np.asarray(out[1])[0])


def _zero_rows(self_k, lo, hi):
    """Positions in [lo, hi) whose row is all zero in every layer."""
    rows = np.abs(self_k[:, lo:hi]).max(axis=(0, 2))
    return [lo + i for i in np.flatnonzero(rows == 0)]


def test_draft_cache_has_no_unwritten_row(models):
    """Self-draft, k = 4: every block is accepted in full. JAX's draft
    never writes the last candidate of such a block, so its cache keeps a
    zero row at seq_len + k - 1 of every block but the last; the port
    writes it, and each row equals the target's (same weights)."""
    k, depth = 4, 16
    jax_k, jax_len = _jax_draft_self_k(models, k, depth)
    p = len(PROMPT)
    assert _zero_rows(jax_k, p, jax_len - 1) == list(
        range(p + k - 1, jax_len - 1, k))

    fn = tspec.speculative_greedy_decode
    fn.iterations = fn.accepted = 0
    caches = {}
    got = _port(models, "self", n_draft=k, max_depth=depth, caches=caches)
    n = int(got[1][0])
    assert n == jax_len
    assert fn.accepted == fn.iterations * (k - 1)  # full acceptance
    draft_k = caches["draft"].self_k[0].numpy()
    assert _zero_rows(draft_k, p, n - 1) == []
    np.testing.assert_allclose(draft_k[:, p:n - 1],
                               caches["target"].self_k[0, :, p:n - 1].numpy(),
                               rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ validation

@pytest.mark.parametrize("case,match", [
    ("batched", "B=1"), ("vocab", "vocab"),
    ("context", "fit in the decoder context"), ("n_draft", "n_draft")])
def test_validation_errors(models, case, match):
    tp, te, _ = models["target"]
    dp, de, dcfg = models["random"]
    kw = dict(n_draft=4, max_depth=8)
    if case == "batched":
        te = np.concatenate([te, te])
    elif case == "vocab":
        dcfg = tiny_test_config(n_vocab=16, n_text_ctx=48, n_audio_ctx=16)
        dp = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.PRNGKey(0), dcfg))
    elif case == "context":
        kw = dict(n_draft=8, max_depth=48)
    else:
        kw["n_draft"] = 0
    with pytest.raises(ValueError, match=match):
        tspec.speculative_greedy_decode(
            from_numpy_tree(tp), torch.from_numpy(te), torch.tensor(PROMPT),
            CFG, EOT, draft_params=from_numpy_tree(dp),
            draft_enc_out=torch.from_numpy(de), draft_cfg=dcfg, **kw)


# -------------------------------------------------- Transcriber and the CLI

@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spec_pipe")
    tok_path = str(d / "tokenizer.json")
    build_test_tokenizer_json(tok_path)
    tok = WhisperTokenizer(tok_path)
    cfg = tiny_test_config(n_vocab=tok.vocab_size, n_audio_ctx=64,
                           n_text_ctx=32, n_state=8)
    dcfg = tiny_test_config(n_vocab=tok.vocab_size, n_audio_ctx=64,
                            n_text_ctx=32, n_state=8, n_layer=1)
    params = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.PRNGKey(0), cfg))
    dparams = jax.tree.map(np.asarray,
                           JM.init_params(jax.random.PRNGKey(9), dcfg))
    return params, cfg, dparams, dcfg, tok, d


def _wave(seed, n):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("case", ["greedy", "beam", "oversized_prompt",
                                  "timestamps"])
def test_transcriber_draft_matches_draftless(pipe, case):
    """Greedy windows decode speculatively with the draftless output; beam
    search ignores the draft; a prompt + depth + k past the context falls
    back to the plain greedy loop; timestamped greedy (the quality
    variant, p(<|nospeech|>) at the SOT) speculates too."""
    params, cfg, dparams, dcfg, tok, _ = pipe
    opt = TT.DecodeOptions(lang="en", strategy="greedy", max_depth=6,
                           chunk_overlap_seconds=0.02)
    if case == "beam":
        opt = dataclasses.replace(opt, strategy="beam", beam_size=2,
                                  max_depth=5)
    elif case == "oversized_prompt":
        opt = dataclasses.replace(opt, max_depth=26)  # 4 + 26 + 4 > 32
    plain = TT.Transcriber(params, cfg, tok, device="cpu")
    spec = TT.Transcriber(params, cfg, tok, device="cpu",
                          draft=(dparams, dcfg), draft_k=4)
    fn = tspec.speculative_greedy_decode
    fn.iterations = 0
    wave = _wave(2, 9000)
    if case == "timestamps":
        want = plain.transcribe_with_timestamps(wave, 16000, opt)
        got = spec.transcribe_with_timestamps(wave, 16000, opt)
        assert [(s.start, s.end, s.text, s.tokens) for s in got[1]] == [
            (s.start, s.end, s.text, s.tokens) for s in want[1]]
    else:
        want = plain.transcribe(wave, 16000, opt)
        got = spec.transcribe(wave, 16000, opt)
    assert got[0] == want[0] and got[1] == want[1]
    assert (fn.iterations > 0) == (case in ("greedy", "timestamps"))


def test_transcriber_draft_validation(pipe):
    params, cfg, dparams, dcfg, tok, _ = pipe
    bad_cfg = tiny_test_config(n_vocab=16, n_text_ctx=32, n_audio_ctx=64)
    bad = jax.tree.map(np.asarray,
                       JM.init_params(jax.random.PRNGKey(1), bad_cfg))
    with pytest.raises(ValueError, match="vocab"):
        TT.Transcriber(params, cfg, tok, device="cpu", draft=(bad, bad_cfg))
    mel_cfg = dataclasses.replace(dcfg, audio_encoder_config=dataclasses.replace(
        dcfg.audio_encoder_config, n_mels=128))
    with pytest.raises(ValueError, match="n_mels"):
        TT.Transcriber(params, cfg, tok, device="cpu",
                       draft=(dparams, mel_cfg))
    with pytest.raises(ValueError, match="draft_k"):
        TT.Transcriber(params, cfg, tok, device="cpu",
                       draft=(dparams, dcfg), draft_k=0)
    if not torch.cuda.is_available():  # the card unless asked otherwise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TT.Transcriber(params, cfg, tok, draft=(dparams, dcfg))


def test_cli_transcribe_draft(pipe, monkeypatch, capsys):
    """`transcribe --greedy --draft M --draft-k N` on checkpoints written by
    the port's writer writes the draftless text; --draft without --greedy
    and with --parallel-windows exits 1 (cli.py:188-206 of the JAX
    package)."""
    import wave as wave_mod

    params, cfg, dparams, dcfg, tok, d = pipe
    monkeypatch.chdir(d)
    tcheckpoint.save_safetensors(params, cfg, "target.safetensors")
    tcheckpoint.save_safetensors(dparams, dcfg, "draft.safetensors")
    x = _wave(4, 20000) * 0.3
    with wave_mod.open("audio.wav", "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 20000).clip(-32767, 32767).astype(np.int16)
                      .tobytes())
    base = ["transcribe", "target", "audio.wav", "en"]
    tail = ["--greedy", "--max-depth", "6", "--device", "cpu"]
    assert torch_cli.main(base + ["plain.txt"] + tail) == 0
    assert torch_cli.main(base + ["spec.txt"] + tail
                          + ["--draft", "draft", "--draft-k", "3"]) == 0
    assert open("spec.txt").read() == open("plain.txt").read()
    capsys.readouterr()
    assert torch_cli.main(base + ["x.txt", "--draft", "draft", "--device",
                                  "cpu"]) == 1
    assert "--draft requires --greedy" in capsys.readouterr().err
    assert torch_cli.main(base + ["x.txt"] + tail + [
        "--draft", "draft", "--parallel-windows"]) == 1
    assert "--parallel-windows" in capsys.readouterr().err
