"""The port's beam search vs the JAX package's, same weights and encoder
output, f32 on the CPU.

Setup as tests/test_torch_transcribe.py: the synthetic test tokenizer, a
2-layer n_state-32 model, PRNGKey(7), ENC_CTX 96. The JAX search runs
with the "xla" attention config (its permute kernel in interpret mode);
the port runs both configs, "flash" taking the kernels' plain versions on
the CPU. Tokens and lengths must be equal; summed log-probs agree to
LOGP_ATOL = 1e-4 (f32, summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import tiny_test_config
from whisper_tpu.decode import beam as jbeam
from whisper_tpu.models import whisper as JM
from whisper_tpu.ops.audio import max_waveform_samples, prep_audio
from whisper_tpu.text.tokenizer import WhisperTokenizer, build_test_tokenizer_json
from whisper_tpu_torch.decode import beam as tbeam
from whisper_tpu_torch.params import from_numpy_tree

ENC_CTX = 96
LOGP_ATOL = 1e-4
MAX_DEPTH = 12


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_beam")
    tok_path = str(d / "tokenizer.json")
    build_test_tokenizer_json(tok_path)
    tok = WhisperTokenizer(tok_path)
    cfg = tiny_test_config(n_state=32, n_head=2, n_layer=2,
                           n_vocab=tok.vocab_size, n_audio_ctx=ENC_CTX,
                           n_text_ctx=48)
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(7),
                                                     cfg))
    return params, cfg, tok


def _enc(params, cfg, seed):
    """JAX encoder output of one window of speech-shaped synthetic audio."""
    n = max_waveform_samples(ENC_CTX - 10)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    wave = (0.3 * np.sin(2 * np.pi * 220.0 * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        mel = prep_audio(jnp.asarray(wave[None]))
        mel = jnp.pad(mel[:, :, :ENC_CTX - 10], ((0, 0), (0, 0), (0, 10)))
        return np.array(JM.encoder_forward(params, mel, cfg))


def _eot_hook(eot, prompt_len, lib):
    """The same hook for both packages: from two tokens past the prompt on,
    boost EOT by an amount that grows with the lane index, so lanes finish
    at different depths and the finished pool and stop rule both act."""
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


def _run_both(setup, attention, seed, timestamps=False, hook=False,
              beam_size=5):
    params, cfg, tok = setup
    enc = _enc(params, cfg, seed)
    sup = tok.suppress_mask().copy()
    prompt = tok.prompt_ids("en", timestamps=timestamps)
    ts = {}
    if timestamps:
        sup[tok.timestamp_begin:] = 0.0
        ts = dict(ts_begin=tok.timestamp_begin, max_initial_ts_idx=3)
    ns_id = tok.special_token("<|nospeech|>")
    common = dict(beam_size=beam_size, max_depth=MAX_DEPTH,
                  nospeech_id=ns_id, **ts)
    with jax.default_matmul_precision("highest"):
        want = jbeam.beam_search(
            jax.tree.map(jnp.asarray, params), jnp.asarray(enc),
            jnp.asarray(prompt, jnp.int32), cfg, tok.eot, jnp.asarray(sup),
            logits_hook=_eot_hook(tok.eot, len(prompt), "jax") if hook
            else None, **common)
    got = tbeam.beam_search(
        from_numpy_tree(params), torch.from_numpy(enc), torch.tensor(prompt),
        dataclasses.replace(cfg, attention=attention), tok.eot,
        torch.from_numpy(sup),
        logits_hook=_eot_hook(tok.eot, len(prompt), "torch") if hook
        else None, **common)
    return [np.asarray(w) for w in want], [g.numpy() for g in got], prompt


def _assert_same(want, got):
    (jt, jl, jlp, jns), (tt, tl, tlp, tns) = want, got
    n = int(jl)
    assert int(tl) == n
    np.testing.assert_array_equal(tt[:n], jt[:n])
    np.testing.assert_allclose(tlp, jlp, atol=LOGP_ATOL, rtol=0)
    np.testing.assert_allclose(tns, jns, atol=1e-6)
    return n


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_beam_search_matches_jax(setup, attention):
    want, got, prompt = _run_both(setup, attention, seed=5)
    assert _assert_same(want, got) > len(prompt)  # not vacuous


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_beam_search_staggered_eot_matches_jax(setup, attention):
    """The hook makes lanes end at different depths: the finished pool
    fills and the stop rule ends the search before max_depth."""
    _, _, tok = setup
    want, got, prompt = _run_both(setup, attention, seed=6, hook=True)
    n = _assert_same(want, got)
    assert n < len(prompt) + MAX_DEPTH
    assert int(got[0][n - 1]) == tok.eot


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_beam_search_timestamps_match_jax(setup, attention):
    _, _, tok = setup
    want, got, prompt = _run_both(setup, attention, seed=29,
                                  timestamps=True)
    n = _assert_same(want, got)
    assert any(t >= tok.timestamp_begin for t in got[0][len(prompt):n])


def test_beam_search_beam_size_two_matches_jax(setup):
    want, got, _ = _run_both(setup, "flash", seed=11, beam_size=2)
    _assert_same(want, got)


def test_top_k_stable_matches_lax_top_k():
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 3, size=(6, 40)).astype(np.float32)  # many ties
    x[2] = -np.inf  # a row of only -inf
    x[3, 5:] = -np.inf  # fewer finite entries than k
    for k in (1, 5, 8):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tbeam.top_k_stable(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert len(set(gi[2].tolist())) == 8  # distinct even where all -inf


def test_cache_gather_matches_jax():
    """One reshuffle step: the port's K4 path (plain on the CPU) writes the
    same permuted pair into its out buffers as JAX's _cache_gather."""
    rng = np.random.default_rng(1)
    shape = (5, 2, 16, 128)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    parents = np.array([3, 3, 0, 4, 1], np.int32)
    jk, jv = jbeam._cache_gather(jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(parents))
    out_k, out_v = torch.zeros(shape), torch.zeros(shape)
    tk, tv = tbeam._cache_gather(torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(parents), out_k, out_v)
    assert tk is out_k and tv is out_v
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_quantized_and_fused_options_raise(setup):
    """Cache flavours JAX refuses raise ValueError; the int4 self cache,
    which JAX has, searches as JAX's does (the same tokens and length)."""
    params, cfg, tok = setup
    enc = torch.zeros(1, ENC_CTX // 2, 32)
    prompt = tok.prompt_ids("en")
    for opt, err, match in ((dict(kv_quant="int2"), ValueError, "kv_quant"),
                            (dict(self_quant="fp8"), ValueError,
                             "self_quant")):
        with pytest.raises(err, match=match):
            tbeam.beam_search(from_numpy_tree(params), enc,
                              torch.tensor(prompt), cfg, tok.eot, **opt)
    opt = dict(self_quant="int4", fuse_reshuffle=True, max_depth=6)
    with jax.default_matmul_precision("highest"):
        jt, jl, _ = jbeam.beam_search(
            jax.tree.map(jnp.asarray, params), jnp.asarray(enc.numpy()),
            jnp.asarray(prompt, jnp.int32), cfg, tok.eot, **opt)
    tt, tl, _ = tbeam.beam_search(from_numpy_tree(params), enc,
                                  torch.tensor(prompt), cfg, tok.eot, **opt)
    n = int(jl)
    assert int(tl) == n
    np.testing.assert_array_equal(tt[:n].numpy(), np.asarray(jt)[:n])
