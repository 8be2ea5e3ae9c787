"""The quantized decode path of the port vs the JAX package, f32 on the
CPU: K5 (the fused reshuffle + append + attention, over int8 and packed
int4 caches) and `_cow_assign`, beam search over int8/int4 cross caches
and an int8 or int4 self cache through the fused copy-on-write path and
through K4's prefix reshuffle, greedy with an int8 or int4 self cache, the
Transcriber and the CLI with quantized caches, and beam 10 (past the
grouped kernel's old 8-lane cap).

Setup as tests/test_torch_beam.py (the synthetic tokenizer, a 2-layer
n_state-32 model, PRNGKey(7), ENC_CTX 96), with int8 weights
(`quantize_params`). The JAX side runs attention="flash" where the fused
path is meant: its `_fuse_reshuffle` keys on it, and its kernels run in
interpret mode on the CPU; the port's wrappers take their plain versions.

Tolerances: beam and greedy tokens and lengths EQUAL; summed log-probs
within LOGP_ATOL = 1e-3 (JAX's f32-query kernels score through a bf16
hi/lo split, ~2^-17 relative per product, so int8-cache logits move by up
to ~5e-3 over a sequence's steps; see tests/test_torch_quantize.py). K5:
the attention output within decode_attention.TOL (bf16 query: one bf16
step), the cache rows it writes and their scales EQUAL.
"""

import dataclasses
import wave as wave_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu import cli as jax_cli
from whisper_tpu import quantize as JQ
from whisper_tpu.config import tiny_test_config
from whisper_tpu.decode import beam as jbeam
from whisper_tpu.decode import greedy as jgreedy
from whisper_tpu.io import npy_tree
from whisper_tpu.models import whisper as JM
from whisper_tpu.ops.audio import max_waveform_samples, prep_audio
from whisper_tpu.ops.pallas.permute_attention import (
    decode_attention_permute_fused as j_fused)
from whisper_tpu.pipeline import transcribe as JT
from whisper_tpu.text.tokenizer import WhisperTokenizer, build_test_tokenizer_json
from whisper_tpu_torch import cli as torch_cli
from whisper_tpu_torch.decode import beam as tbeam
from whisper_tpu_torch.decode import greedy as tgreedy
from whisper_tpu_torch.models import whisper as TM
from whisper_tpu_torch.ops.kernels import decode_attention as KC
from whisper_tpu_torch.ops.kernels import permute_attention as KF
from whisper_tpu_torch.params import from_numpy_tree
from whisper_tpu_torch.pipeline import transcribe as TT
from whisper_tpu_torch.quantize import int_values, pack_int4

from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

ENC_CTX = 96
LOGP_ATOL = 1e-3
MAX_DEPTH = 12


# ---------------------------------------------------------------- K5 + COW

def _k5_parents(kind, rng, nw, k):
    if kind == "random":
        p = rng.integers(0, k, (nw, k))
    elif kind == "cycle":
        p = np.stack([np.roll(np.arange(k), 1)] * nw)
    elif kind == "collapse":
        p = np.full((nw, k), 2)
    else:  # identity
        p = np.stack([np.arange(k)] * nw)
    return p.astype(np.int32)


K5_KINDS = ["random", "cycle", "collapse", "identity"]


# int8: every kind with and without COW dests; int4: every kind with COW
# dests (the beam path) and random parents with dests=None
@pytest.mark.parametrize("cow,kind,storage", [
    *[(c, k, "int8") for c in (True, False) for k in K5_KINDS],
    *[(True, k, "int4") for k in K5_KINDS], (False, "random", "int4")])
def test_k5_plain_matches_pallas(kind, cow, storage):
    """Two windows of 5 lanes, per-lane pos, parents of each kind; with
    `cow` the parents and dests come from `_cow_assign` over a shuffled
    slot map (as after earlier steps), else dests=None (identity slots).
    Held: the attention output, every row [0, pos] that a lane writes, and
    every slot and layer the call must leave alone. An int4 cache and new
    rows hold values in [-7, 7]: JAX takes them as `jnp.int4`, the port
    packed (a row of d / 2 bytes); the written rows are compared as
    values."""
    rng = np.random.default_rng(K5_KINDS.index(kind) * 2 + cow)
    k, nw, n_layer, c, d, heads, layer = 5, 2, 2, 64, 128, 2, 1
    b = k * nw
    int4 = storage == "int4"
    lim = 7 if int4 else 127
    kc = rng.integers(-lim, lim + 1, (b, n_layer, c, d)).astype(np.int8)
    vc = rng.integers(-lim, lim + 1, (b, n_layer, c, d)).astype(np.int8)
    ks = rng.uniform(0.01, 0.05, (b, n_layer, c)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, (b, n_layer, c)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    nk = rng.integers(-lim, lim + 1, (b, d)).astype(np.int8)
    nv = rng.integers(-lim, lim + 1, (b, d)).astype(np.int8)
    nks = rng.uniform(0.01, 0.05, b).astype(np.float32)
    nvs = rng.uniform(0.01, 0.05, b).astype(np.float32)
    pos = rng.integers(0, 40, b).astype(np.int32)
    parent = _k5_parents(kind, rng, nw, k)
    offs = (np.arange(nw) * k)[:, None]
    if cow:
        phys = np.stack([rng.permutation(k) for _ in range(nw)]).astype(
            np.int32)
        src, dest = jbeam._cow_assign(jnp.asarray(parent), jnp.asarray(phys))
        parents = (np.asarray(src) + offs).reshape(b).astype(np.int32)
        dests = (np.asarray(dest) + offs).reshape(b).astype(np.int32)
    else:
        parents = (parent + offs).reshape(b)
        dests = None
    jq = jnp.asarray(q, jnp.bfloat16)
    jdt = jnp.int4 if int4 else jnp.int8
    want = j_fused(jq, jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
                   jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(nk, jdt),
                   jnp.asarray(nv, jdt), jnp.asarray(nks), jnp.asarray(nvs),
                   jnp.asarray(parents), jnp.asarray(pos), jnp.int32(layer),
                   heads, k,
                   dests=None if dests is None else jnp.asarray(dests),
                   interpret=True)

    def stored(a):  # the port's storage of int values
        t = torch.from_numpy(a.copy())
        return pack_int4(t) if int4 and a.dtype == np.int8 else t

    t = [stored(a) for a in (kc, vc, ks, vs)]
    got = KF.decode_attention_permute_fused(
        torch.from_numpy(q).to(torch.bfloat16), *t, stored(nk), stored(nv),
        torch.from_numpy(nks), torch.from_numpy(nvs),
        torch.from_numpy(parents), torch.from_numpy(pos), layer, heads, k,
        dests=None if dests is None else torch.from_numpy(dests))
    assert all(g is tt for g, tt in zip(got[1:], t))  # updated in place
    atol, rtol = KC.TOL[torch.bfloat16]
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32), atol=atol,
                               rtol=rtol)
    slots = np.arange(b) if dests is None else dests
    for g, w, before in zip(got[1:], want[1:], (kc, vc, ks, vs)):
        g = int_values(g).numpy() if g.dtype == torch.uint8 else g.numpy()
        w = np.asarray(w)
        if w.dtype == jnp.int4:
            w = w.astype(np.int8)
        for i, s in enumerate(slots):
            np.testing.assert_array_equal(g[s, layer, :pos[i] + 1],
                                          w[s, layer, :pos[i] + 1])
        for s in set(range(b)) - set(slots.tolist()):
            np.testing.assert_array_equal(g[s], before[s])
        np.testing.assert_array_equal(g[:, 1 - layer], before[:, 1 - layer])


def test_k5_refuses_a_batch_that_is_not_whole_windows():
    z = torch.zeros(6, 1, 32, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="beam_k"):
        KF.decode_attention_permute_fused(
            torch.zeros(6, 128), z, z, torch.ones(6, 1, 32),
            torch.ones(6, 1, 32), z[:, 0, 0], z[:, 0, 0], torch.ones(6),
            torch.ones(6), torch.zeros(6, dtype=torch.int32), 3, 0, 2, 4)


@pytest.mark.parametrize("identity", [False, True])
def test_cow_assign_matches_jax(identity):
    rng = np.random.default_rng(8 + identity)
    w, k = 7, 5
    for _ in range(10):
        parent = rng.integers(0, k, (w, k)).astype(np.int32)
        if identity:
            parent[:] = np.arange(k)
        phys = np.stack([rng.permutation(k) for _ in range(w)]).astype(
            np.int32)
        js, jd = jbeam._cow_assign(jnp.asarray(parent), jnp.asarray(phys))
        ts, td = tbeam._cow_assign(torch.from_numpy(parent),
                                   torch.from_numpy(phys))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        if identity:
            np.testing.assert_array_equal(td.numpy(), phys)  # all stay


# ------------------------------------------------------------- decoders

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fused_beam")
    tok_path = str(d / "tokenizer.json")
    build_test_tokenizer_json(tok_path)
    tok = WhisperTokenizer(tok_path)
    cfg = tiny_test_config(n_state=32, n_head=2, n_layer=2,
                           n_vocab=tok.vocab_size, n_audio_ctx=ENC_CTX,
                           n_text_ctx=48)
    params = JM.init_params(jax.random.PRNGKey(7), cfg)
    qparams = jax.tree.map(np.asarray, JQ.quantize_params(params, bits=8))
    return jax.tree.map(np.asarray, params), qparams, cfg, tok, d


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
    """tests/test_torch_beam.py's hook: from two tokens past the prompt on,
    boost EOT by an amount that grows with the lane index, so lanes finish
    at different depths."""
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


def _beam_both(setup, seed, jax_attention, torch_attention, hook=False,
               quantized=True, **opts):
    params, qparams, cfg, tok, _ = setup
    p = qparams if quantized else params
    enc = _enc(params, cfg, seed)
    sup = tok.suppress_mask().copy()
    prompt = tok.prompt_ids("en")
    common = dict(max_depth=MAX_DEPTH, nospeech_id=tok.special_token(
        "<|nospeech|>"), **opts)
    with jax.default_matmul_precision("highest"):
        want = jbeam.beam_search(
            jax.tree.map(jnp.asarray, p), jnp.asarray(enc),
            jnp.asarray(prompt, jnp.int32),
            dataclasses.replace(cfg, attention=jax_attention), tok.eot,
            jnp.asarray(sup), logits_hook=_eot_hook(
                tok.eot, len(prompt), "jax") if hook else None, **common)
    got = tbeam.beam_search(
        from_numpy_tree(p), torch.from_numpy(enc), torch.tensor(prompt),
        dataclasses.replace(cfg, attention=torch_attention), tok.eot,
        torch.from_numpy(sup), logits_hook=_eot_hook(
            tok.eot, len(prompt), "torch") if hook else None, **common)
    (jt, jl, jlp, jns), (tt, tl, tlp, tns) = ([np.asarray(w) for w in want],
                                              [g.numpy() for g in got])
    n = int(jl)
    assert int(tl) == n
    np.testing.assert_array_equal(tt[:n], jt[:n])
    np.testing.assert_allclose(tlp, jlp, atol=LOGP_ATOL, rtol=0)
    np.testing.assert_allclose(tns, jns, atol=1e-5)
    return n, len(prompt), tt


@pytest.mark.parametrize("kv_quant,self_quant", [
    ("int8", True), ("int4", True), ("int4", "int4")])
@pytest.mark.parametrize("fuse", [None, False])
def test_quantized_beam_search_matches_jax(setup, kv_quant, self_quant,
                                           fuse):
    """int8 weights, an int8/int4 cross cache and an int8 or int4 self
    cache, with the EOT-staggering hook: fuse=None is the default fused
    COW path (K5) on both sides, fuse=False the K4 prefix reshuffle (of
    packed rows, as bytes, for int4)."""
    n, p, _ = _beam_both(setup, seed=6, jax_attention="flash",
                         torch_attention="flash", hook=True,
                         kv_quant=kv_quant, self_quant=self_quant,
                         fuse_reshuffle=fuse)
    assert p < n < p + MAX_DEPTH  # lanes ended early: the pool and stop rule


def test_fused_beam_search_through_k5(setup, monkeypatch):
    """The default quantized beam path runs the fused kernel's wrapper (and
    no K4); the separate path runs K4 and never the fused one."""
    calls = {"fused": 0, "gather": 0}
    fused, gather = KF.decode_attention_permute_fused, tbeam._cache_gather

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr("whisper_tpu_torch.models.whisper."
                        "decode_attention_permute_fused",
                        count("fused", fused))
    monkeypatch.setattr(tbeam, "_cache_gather", count("gather", gather))
    params, qparams, cfg, tok, _ = setup
    enc = torch.from_numpy(_enc(params, cfg, 5))
    flash = dataclasses.replace(cfg, attention="flash")
    prompt = torch.tensor(tok.prompt_ids("en"))
    tbeam.beam_search(from_numpy_tree(qparams), enc, prompt, flash, tok.eot,
                      max_depth=4, self_quant=True)
    assert calls == {"fused": 3 * 2, "gather": 0}  # 3 steps x 2 layers
    tbeam.beam_search(from_numpy_tree(qparams), enc, prompt, flash, tok.eot,
                      max_depth=4, self_quant=True, fuse_reshuffle=False)
    assert calls == {"fused": 6, "gather": 3}


@pytest.mark.parametrize("self_quant", [True, "int4"])
def test_k5_takes_int64_and_int32_indices_alike(setup, self_quant):
    """K5's plain version and the fused decoder step give the same result
    whether the parents and dests come as `_cow_assign` returns them
    (int64, as the beam loops pass them, and as the kernel reads them) or
    as int32 (which the kernel's wrapper converts): the attention, the
    logits and every cache array equal."""
    params, qparams, cfg, tok, _ = setup
    flash = dataclasses.replace(cfg, attention="flash")
    tp = from_numpy_tree(qparams)
    enc = torch.from_numpy(_enc(params, cfg, 4))
    k = 5
    rng = np.random.default_rng(12)
    src, dest = tbeam._cow_assign(
        torch.from_numpy(rng.integers(0, k, (1, k))),
        torch.from_numpy(rng.permutation(k)[None]))
    assert src.dtype == dest.dtype == torch.int64
    prompt = torch.tensor(tok.prompt_ids("en"))[None].repeat(k, 1)
    p = prompt.shape[1]
    q = torch.from_numpy(rng.standard_normal((k, 32)).astype(
        np.float32)).to(torch.bfloat16)
    runs = []
    for dt in (torch.int64, torch.int32):
        cache = TM.init_cache(tp, enc, flash, batch=k, cache_len=16,
                              kv_quant="int4", self_quant=self_quant)
        _, cache = TM.decoder_step(tp, prompt, 0, cache, flash)
        arrays = [cache.self_k.q, cache.self_v.q, cache.self_k.scale,
                  cache.self_v.scale]
        rows = [a[:, 0, p].clone() for a in arrays]  # layer 0's row p
        attn = KF.decode_attention_permute_fused(
            q, *[a.clone() for a in arrays], *rows, src[0].to(dt), p, 0, 2,
            k, dests=dest[0].to(dt))
        logits, cache = TM.decoder_step(
            tp, torch.full((k, 1), 7), p, cache, flash,
            parents=src[0].to(dt), dests=dest[0].to(dt))
        runs.append([*attn, logits, cache.self_k.q, cache.self_v.q,
                     cache.self_k.scale, cache.self_v.scale])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_beam_size_ten_matches_jax(setup):
    """beam 10 (bf16-path caches): the grouped cross attention takes
    R = 10 lanes per window, past the 8-lane cap the card once had."""
    _beam_both(setup, seed=9, jax_attention="xla", torch_attention="flash",
               quantized=False, beam_size=10)


@pytest.mark.parametrize("kv_quant,self_quant", [
    (True, True), ("int4", True), ("int4", "int4")])
def test_quantized_greedy_matches_jax(setup, kv_quant, self_quant):
    """Two windows, int8 weights, an int8/int4 cross cache and an int8
    or int4 self cache (K3s over either on the flash step)."""
    params, qparams, cfg, tok, _ = setup
    enc = np.concatenate([_enc(params, cfg, 11), _enc(params, cfg, 12)])
    sup = tok.suppress_mask()
    prompt = tok.prompt_ids("en")
    kw = dict(max_depth=MAX_DEPTH, kv_quant=kv_quant, self_quant=self_quant)
    flash = dataclasses.replace(cfg, attention="flash")
    with jax.default_matmul_precision("highest"):
        jt, jl, jlp = jgreedy.greedy_decode(
            jax.tree.map(jnp.asarray, qparams), jnp.asarray(enc),
            jnp.asarray(prompt, jnp.int32), flash, tok.eot, jnp.asarray(sup),
            **kw)
    tt, tl, tlp = tgreedy.greedy_decode(
        from_numpy_tree(qparams), torch.from_numpy(enc), torch.tensor(prompt),
        flash, tok.eot, torch.from_numpy(sup), **kw)
    jl = np.asarray(jl)
    np.testing.assert_array_equal(tl.numpy(), jl)
    for r in range(2):
        np.testing.assert_array_equal(tt[r, :jl[r]].numpy(),
                                      np.asarray(jt)[r, :jl[r]])
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=LOGP_ATOL)
    assert jl.max() > len(prompt)


def _multiwindow_wave():
    """3 windows of speech-shaped audio (as tests/test_torch_transcribe.py)."""
    n_window = max_waveform_samples(ENC_CTX - 10)
    shift = n_window - int(16000 * 0.15)
    n = 2 * shift + 7000
    rng = np.random.default_rng(3)
    t = np.arange(n) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 220.0 * t)
         + 0.2 * np.sin(2 * np.pi * 880.0 * t)
         + 0.1 * rng.standard_normal(n))
    return (x * (0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 1.3 * t)))).astype(
        np.float32)


def test_transcriber_with_quantized_caches_matches_jax(setup):
    """Both Transcribers on the same int8 weights, int8 cross and self
    caches, beam search over 3 windows; the port runs the fused COW path
    ("flash" on the CPU takes the plain versions), JAX the K4 reshuffle.
    Then the same with an int4 cross and an int4 self cache
    (`DecodeOptions(self_quant="int4")`, as JAX's)."""
    _, qparams, cfg, tok, _ = setup
    wave = _multiwindow_wave()
    jtr = JT.Transcriber(qparams, cfg, tok, attention="xla",
                         matmul_precision="highest")
    tr = TT.Transcriber(qparams, cfg, tok, attention="flash", device="cpu")
    for kv, self_kv in ((True, True), ("int4", "int4")):
        opts = dict(max_depth=8, chunk_overlap_seconds=0.15, kv_quant=kv,
                    self_quant=self_kv)
        want = jtr.transcribe(wave, options=JT.DecodeOptions(**opts),
                              on_chunk=lambda i, s: None)
        got = tr.transcribe(wave, options=TT.DecodeOptions(**opts),
                            on_chunk=lambda i, s: None)
        assert got == want and got[1], self_kv


def test_cli_quantized_caches_match_jax_cli(setup, monkeypatch, capsys):
    params, _, cfg, tok, d = setup
    npy_tree.save_whisper(params, cfg, str(d / "dump"))
    with wave_mod.open(str(d / "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((_multiwindow_wave() * 20000).astype(np.int16)
                      .tobytes())
    monkeypatch.chdir(d)
    args = ["dump", "audio.wav", "en"]
    opts = ["--kv-quant", "--self-quant", "--max-depth", "8"]
    assert jax_cli.main(["transcribe", *args, "jax.txt", *opts]) == 0
    assert torch_cli.main(["transcribe", *args, "torch.txt", *opts,
                           "--device", "cpu"]) == 0
    assert "Transcription finished." in capsys.readouterr().out
    with open("jax.txt") as a, open("torch.txt") as b:
        want, got = a.read(), b.read()
    assert got == want and got
