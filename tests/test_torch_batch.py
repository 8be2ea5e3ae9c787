"""The port's batched path vs the JAX package, f32 on the CPU: the top-k
helpers of the batched beam search, `beam_search_batched` over W = 3
windows, `BatchTranscriber.transcribe_many` and `cli.py transcribe-many`
(the batched fallback ladder and `transcribe_many_with_timestamps`:
tests/test_torch_batch_ladder.py, a file of its own so the two run on
separate workers).

Setup as tests/test_torch_beam.py (the synthetic tokenizer, a 2-layer
n_state-32 model, PRNGKey(7), ENC_CTX 96: ~0.87 s windows). Tokens and
lengths must be EQUAL; summed log-probs agree to LOGP_ATOL = 1e-4 (f32,
summation order; 1e-3 over the int8 caches, whose JAX kernels score through
a bf16 hi/lo split, see tests/test_torch_fused_beam.py). The top-k
helpers are held element-identical (values and indices).
"""

import dataclasses
import wave as wave_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu import quantize as JQ
from whisper_tpu.config import tiny_test_config
from whisper_tpu.decode import beam as jbeam
from whisper_tpu.io import npy_tree
from whisper_tpu.models import whisper as JM
from whisper_tpu.ops.audio import max_waveform_samples, prep_audio
from whisper_tpu.pipeline import batch as JB
from whisper_tpu.pipeline import transcribe as JT
from whisper_tpu.text.tokenizer import WhisperTokenizer, build_test_tokenizer_json
from whisper_tpu_torch import cli as torch_cli
from whisper_tpu_torch.decode import beam as tbeam
from whisper_tpu_torch.params import from_numpy_tree
from whisper_tpu_torch.pipeline import batch as TB
from whisper_tpu_torch.pipeline import transcribe as TT

from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

ENC_CTX = 96
LOGP_ATOL = 1e-4
MAX_DEPTH = 12


# ------------------------------------------------------------- top-k helpers

def _topk_inputs(n):
    """Rows with many ties, one all -inf row, one with fewer finite entries
    than k, and one with its maximum in the padded last segment."""
    rng = np.random.default_rng(n)
    x = rng.integers(-4, 4, size=(6, n)).astype(np.float32)
    x[1] = -np.inf
    x[2, 3:] = -np.inf
    x[3, -1] = 10.0
    x[4] = rng.standard_normal(n).astype(np.float32)
    return x


@pytest.mark.parametrize("n", [40, 700, 51865])
@pytest.mark.parametrize("k", [1, 5])
def test_top_k_helpers_match_jax(n, k):
    x = _topk_inputs(n)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for jfn, tfn in ((jbeam._top_k_iter, tbeam._top_k_iter),
                     (jbeam._top_k, tbeam._top_k)):
        wv, wi = jfn(jx, k)
        gv, gi = tfn(tx, k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    wv, wi, wl = jbeam._topk_lse(jx, k)
    gv, gi, gl = tbeam._topk_lse(tx, k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-6)
    assert np.isneginf(gl.numpy()[1])  # all -inf: -inf, no NaN
    if k == 5:  # the duplicate-0 quirk on the -inf tail
        assert gi.numpy()[1].tolist() == [0] * 5
        assert gi.numpy()[2, 3:].tolist() == [0, 0]


# ------------------------------------------------------------- batched beam

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_batch")
    tok_path = str(d / "tokenizer.json")
    build_test_tokenizer_json(tok_path)
    tok = WhisperTokenizer(tok_path)
    cfg = tiny_test_config(n_state=32, n_head=2, n_layer=2,
                           n_vocab=tok.vocab_size, n_audio_ctx=ENC_CTX,
                           n_text_ctx=48)
    params = JM.init_params(jax.random.PRNGKey(7), cfg)
    qparams = jax.tree.map(np.asarray, JQ.quantize_params(params, bits=8))
    return jax.tree.map(np.asarray, params), qparams, cfg, tok, d


def _enc(params, cfg, seeds):
    """JAX encoder output of one window of synthetic audio per seed."""
    n = max_waveform_samples(ENC_CTX - 10)
    t = np.arange(n) / 16000.0
    waves = np.stack([(0.3 * np.sin(2 * np.pi * (180.0 + 40 * s) * t)
                       + 0.1 * np.random.default_rng(s).standard_normal(n))
                      for s in seeds]).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        mel = prep_audio(jnp.asarray(waves), per_sample_max=True)
        mel = jnp.pad(mel[:, :, :ENC_CTX - 10], ((0, 0), (0, 0), (0, 10)))
        return np.array(JM.encoder_forward(params, mel, cfg))


def _eot_hook(eot, prompt_len, lib):
    """tests/test_torch_beam.py's hook over the flat W x K lanes: the EOT
    boost grows with the lane index, so the windows stop at different
    depths."""
    if lib == "jax":
        def hook(x, tokens, seq_len):
            row = jnp.arange(x.shape[0], dtype=jnp.float32)[:, None]
            col = jnp.arange(x.shape[1])[None, :]
            on = (seq_len >= prompt_len + 2) & (col == eot)
            return jnp.where(on, x + 12.0 + 8.0 * row, x)
        return hook

    def hook(x, tokens, seq_len):
        row = torch.arange(x.shape[0], dtype=torch.float32)[:, None]
        col = torch.arange(x.shape[1])[None, :]
        on = (col == eot) & (seq_len >= prompt_len + 2)
        return torch.where(on, x + 12.0 + 8.0 * row, x)
    return hook


def _batched_both(setup, seeds, hook=False, timestamps=False,
                  quantized=False, jax_attention="xla",
                  torch_attention="flash", logp_atol=LOGP_ATOL, **opts):
    params, qparams, cfg, tok, _ = setup
    p = qparams if quantized else params
    enc = _enc(params, cfg, seeds)
    sup = tok.suppress_mask().copy()
    prompt = tok.prompt_ids("en", timestamps=timestamps)
    if timestamps:
        sup[tok.timestamp_begin:] = 0.0
        opts.update(ts_begin=tok.timestamp_begin, max_initial_ts_idx=3)
    common = dict(beam_size=5, max_depth=MAX_DEPTH,
                  nospeech_id=tok.special_token("<|nospeech|>"), **opts)
    with jax.default_matmul_precision("highest"):
        want = jbeam.beam_search_batched(
            jax.tree.map(jnp.asarray, p), jnp.asarray(enc),
            jnp.asarray(prompt, jnp.int32),
            dataclasses.replace(cfg, attention=jax_attention), tok.eot,
            jnp.asarray(sup), logits_hook=_eot_hook(
                tok.eot, len(prompt), "jax") if hook else None, **common)
    tcfg = dataclasses.replace(cfg, attention=torch_attention)
    tp = from_numpy_tree(p)
    thook = _eot_hook(tok.eot, len(prompt), "torch") if hook else None
    got = tbeam.beam_search_batched(
        tp, torch.from_numpy(enc), torch.tensor(prompt), tcfg, tok.eot,
        torch.from_numpy(sup), logits_hook=thook, **common)
    (jt, jl, jlp, jns) = [np.asarray(w) for w in want]
    (tt, tl, tlp, tns) = [g.numpy() for g in got]
    np.testing.assert_array_equal(tl, jl)
    for w in range(len(seeds)):
        np.testing.assert_array_equal(tt[w, :jl[w]], jt[w, :jl[w]])
    np.testing.assert_allclose(tlp, jlp, atol=logp_atol, rtol=0)
    np.testing.assert_allclose(tns, jns, atol=1e-5)
    # the same search window by window through the single-window beam
    # search (without the hook, whose boost depends on the flat lane index)
    if not hook:
        for w in range(len(seeds)):
            one = tbeam.beam_search(
                tp, torch.from_numpy(enc[w:w + 1]), torch.tensor(prompt),
                tcfg, tok.eot, torch.from_numpy(sup), **common)
            n = int(one[1])
            assert n == tl[w]
            np.testing.assert_array_equal(one[0].numpy()[:n], tt[w, :n])
    return tl, len(prompt)


def test_beam_search_batched_matches_jax(setup):
    lengths, p = _batched_both(setup, seeds=(5, 6, 7))
    assert (lengths > p).all()


def test_beam_search_batched_staggered_stops_match_jax(setup):
    """The hook makes windows stop at different depths: stopped windows
    are frozen while the others go on."""
    lengths, p = _batched_both(setup, seeds=(5, 6, 7), hook=True)
    assert len(set(lengths.tolist())) > 1 and lengths.max() < p + MAX_DEPTH


def test_beam_search_batched_timestamps_match_jax(setup):
    _batched_both(setup, seeds=(29, 30, 31), timestamps=True)


@pytest.mark.parametrize("fuse,self_quant", [
    (None, True), (False, True), (None, "int4")])
def test_beam_search_batched_quantized_caches_match_jax(setup, fuse,
                                                        self_quant):
    """int8 weights, an int4 cross cache and an int8 self cache: the fused
    copy-on-write path (K5) by default, K4's prefix reshuffle with
    fuse_reshuffle=False; and an int4 self cache through K5 (its K4 path:
    test_torch_fused_beam.py). JAX runs attention="flash" in interpret
    mode."""
    _batched_both(setup, seeds=(5, 6, 7), hook=True, quantized=True,
                  jax_attention="flash", kv_quant="int4",
                  self_quant=self_quant, fuse_reshuffle=fuse, logp_atol=1e-3)


# ------------------------------------------------------------- pipeline

def _streams():
    """Two streams of speech-shaped audio: 3 windows (2 full + a tail) and
    2 windows (1 full + a tail) at a 0.15 s overlap."""
    n_window = max_waveform_samples(ENC_CTX - 10)
    shift = n_window - int(16000 * 0.15)
    out = []
    for n, seed in ((2 * shift + 7000, 3), (shift + 9000, 4)):
        rng = np.random.default_rng(seed)
        t = np.arange(n) / 16000.0
        x = (0.3 * np.sin(2 * np.pi * (200.0 + 20 * seed) * t)
             + 0.2 * np.sin(2 * np.pi * 880.0 * t)
             + 0.1 * rng.standard_normal(n))
        out.append((x * (0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 1.3 * t))))
                   .astype(np.float32))
    return out


@pytest.mark.parametrize("strategy,batch_size", [
    ("greedy", 2), ("greedy", 3), ("beam", 2), ("beam", 3)])
def test_transcribe_many_matches_jax(setup, strategy, batch_size):
    """3 full windows in batches of 2 (the last padded) or 3, 2 tail
    windows on the single path; the same texts and tokens as JAX's
    transcribe_many and, stream by stream, as the port's transcribe."""
    params, _, cfg, tok, _ = setup
    opts = dict(strategy=strategy, max_depth=8, chunk_overlap_seconds=0.15)
    waves = _streams()
    want = JB.BatchTranscriber(
        params, cfg, tok, batch_size=batch_size, attention="xla",
        matmul_precision="highest").transcribe_many(
            waves, options=JT.DecodeOptions(**opts))
    bt = TB.BatchTranscriber(params, cfg, tok, batch_size=batch_size,
                             attention="flash", device="cpu")
    got = bt.transcribe_many(waves, options=TT.DecodeOptions(**opts))
    assert got == want and all(g[1] for g in got)
    for w, (text, tokens) in zip(waves, got):
        assert bt.transcribe(w, options=TT.DecodeOptions(**opts),
                             on_chunk=lambda i, s: None) == (text, tokens)


def test_transcribe_many_refuses_what_it_does_not_cover(setup):
    """Clip ranges (which JAX's batched entries ignore and its CLI refuses
    with --parallel-windows) raise ValueError on both batched entries,
    before any window is decoded; so does batch_size 0."""
    params, _, cfg, tok, _ = setup
    bt = TB.BatchTranscriber(params, cfg, tok, batch_size=2, device="cpu")
    calls = []
    bt._decode_batch = lambda *a, **kw: calls.append(a)
    opt = TT.DecodeOptions(clip_timestamps="0,1")
    for entry in (bt.transcribe_many, bt.transcribe_many_with_timestamps):
        with pytest.raises(ValueError, match="--parallel-windows"):
            entry(_streams(), options=opt)
    assert calls == []
    with pytest.raises(ValueError, match="batch_size"):
        TB.BatchTranscriber(params, cfg, tok, batch_size=0, device="cpu")


def test_transcribe_many_refuses_condition_on_previous_text(setup):
    """JAX's transcribe_many ignores the option without a word; the port's
    refuses it, before any window is decoded."""
    params, _, cfg, tok, _ = setup
    bt = TB.BatchTranscriber(params, cfg, tok, batch_size=2, device="cpu")
    calls = []
    bt._decode_batch = lambda *a, **kw: calls.append(a)
    with pytest.raises(ValueError, match="condition_on_previous_text"):
        bt.transcribe_many(_streams(), options=TT.DecodeOptions(
            condition_on_previous_text=True))
    assert calls == []


def test_cli_transcribe_many_writes_the_files(setup, monkeypatch, capsys):
    params, _, cfg, tok, d = setup
    npy_tree.save_whisper(params, cfg, str(d / "dump"))
    names = []
    for i, w in enumerate(_streams()):
        names.append(f"s{i}.wav")
        with wave_mod.open(str(d / names[-1]), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes((w * 20000).astype(np.int16).tobytes())
    monkeypatch.chdir(d)
    assert torch_cli.main(["transcribe-many", "dump", "en", "out", *names,
                           "--greedy", "--batch-size", "2",
                           "--device", "cpu"]) == 0
    assert "Transcribed 2 files" in capsys.readouterr().out
    for i in range(2):
        assert (d / "out" / f"s{i}.txt").read_text()
