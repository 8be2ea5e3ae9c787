"""The port's quantization (weights, int4 packing, KV caches) and the K3s
(int8 and packed-int4 self caches) and integer-storage K3/K3g plain
versions vs the JAX package, f32 on the CPU; the JAX kernels run in
interpret mode, as tests/test_pallas.py runs them.

Tolerances. Integer values and scales quantized from the same f32 inputs
are held EQUAL (both packages divide in IEEE f32 and round half to even).
Self-cache rows quantized inside a decoder step come from projections
that differ by summation order, so a value at a rounding midpoint may
land one step away: at most Q_FLIPS (0.1%) of the int8 elements may
differ, by exactly 1, and the row scales agree to SCALE_RTOL = 2e-6. f32
attention outputs agree to summation order (ATOL_F32 = 2e-5, and relative
1e-5 for outputs that carry int8 magnitudes); logits (magnitude up to ~60
with random weights) within LOGIT_ATOL = 1e-3. With an f32 query, JAX's
K3/K3g/K3s take the TPU's slow path, which scores through a bf16 hi/lo split of
k * q (~2^-17 relative per product); over int8 keys that moves the
"flash" logits of an int8 self cache by up to ~5e-3, so those are held
within LOGIT_ATOL_SPLIT = 1e-2, and an f32 query's outputs over an
integer cache (values up to lim = 127 or 7) within atol 1e-5 * lim.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu import quantize as JQ
from whisper_tpu.config import tiny_test_config
from whisper_tpu.models import whisper as JM
from whisper_tpu.ops.pallas.decode_attention import (
    decode_attention_stacked as j_decode)
from whisper_tpu_torch import quantize as TQ
from whisper_tpu_torch.models import whisper as TM
from whisper_tpu_torch.ops.kernels import decode_attention as KC
from whisper_tpu_torch.params import from_numpy_tree

ATOL_F32 = 2e-5
LOGIT_ATOL = 1e-3
LOGIT_ATOL_SPLIT = 1e-2
Q_FLIPS = 1e-3
SCALE_RTOL = 2e-6
CFG = tiny_test_config(n_state=128, n_head=2, n_layer=2, n_vocab=80,
                       n_audio_ctx=32, n_text_ctx=24)
PROMPT, STEPS = 4, 3


def _ints(q) -> np.ndarray:
    """int8 values of a JAX (int8/int4) or port (int8/packed) q array."""
    if isinstance(q, torch.Tensor):
        return TQ.int_values(q).numpy()
    return np.asarray(q).astype(np.int8)


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(jax.random.PRNGKey(0), CFG)


def test_int4_pack_round_trip_and_layout():
    vals = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)  # (3, 32)
    packed = TQ.pack_int4(vals)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 16)
    assert int(packed[0, 0]) == 0x98  # -8 (0x8) low, -7 (0x9) high
    assert torch.equal(TQ.unpack_int4(packed), vals)
    with pytest.raises(ValueError, match="even"):
        TQ.pack_int4(vals[:, :3])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_matches_jax(jparams, bits):
    want = JQ.quantize_params(jparams, bits=bits)
    got = TQ.quantize_params(from_numpy_tree(jax.tree.map(np.asarray,
                                                          jparams)), bits=bits)
    blocks = got["decoder"]["blocks"]
    for key in TQ._DECODER_KEYS:
        w, g = want["decoder"]["blocks"][key], blocks[key]
        assert isinstance(g, TQ.QTensor), key
        assert g.q.dtype == (torch.uint8 if bits == 4 else torch.int8)
        np.testing.assert_array_equal(_ints(g.q), _ints(w.q), err_msg=key)
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
    # encoder and the other decoder leaves stay as they were
    assert not isinstance(got["encoder"]["blocks"]["qkv_w"], TQ.QTensor)
    assert not isinstance(blocks["attn_ln_g"], TQ.QTensor)


def test_quantize_tensor_and_dequantize_match_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    w[:, 3] = 0  # an all-zero column keeps scale 1
    want = JQ.quantize_tensor(jnp.asarray(w))
    got = TQ.quantize_tensor(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert float(got.scale[3]) == 1.0
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            TQ.dequantize(got, dt).float().numpy(),
            np.asarray(JQ.dequantize(want, jdt), np.float32))


@pytest.mark.parametrize("bits", [8, 4])
def test_from_numpy_tree_of_a_jax_quantized_tree(jparams, bits):
    """The JAX package's quantized pytree as numpy: QTensor leaves carry
    across (int4 packed), and a dtype cast leaves q and the f32 scale
    alone while it casts every floating weight."""
    jq = jax.tree.map(np.asarray, JQ.quantize_params(jparams, bits=bits))
    tp = from_numpy_tree(jq, dtype=torch.bfloat16)
    leaf = tp["decoder"]["blocks"]["qkv_w"]
    want = jq["decoder"]["blocks"]["qkv_w"]
    assert leaf.scale.dtype == torch.float32
    np.testing.assert_array_equal(_ints(leaf.q), _ints(want.q))
    np.testing.assert_array_equal(leaf.scale.numpy(), want.scale)
    assert tp["decoder"]["blocks"]["attn_ln_g"].dtype == torch.bfloat16
    tp = tp.to(dtype=torch.float32).to(dtype=torch.bfloat16)
    again = tp["decoder"]["blocks"]["qkv_w"]
    assert again.scale.dtype == torch.float32
    np.testing.assert_array_equal(again.scale.numpy(), want.scale)
    views = tp["decoder"]["blocks"].layers()
    assert isinstance(views[1]["mlp1_w"], TQ.QTensor)
    assert torch.equal(views[1]["mlp1_w"].q,
                       tp["decoder"]["blocks"]["mlp1_w"].q[1])
    assert set(tp.tree()["decoder"]["blocks"]) == set(
        jq["decoder"]["blocks"])


@pytest.mark.parametrize("storage", ["int8", "int4"])
def test_q8_rows_matches_jax(storage):
    """Per-row quantization to the cache's storage: int8, or int4 (limit
    7) packed two channels a byte; values and scales equal."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32) * 3
    x[1, 2] = 0  # an all-zero row keeps scale 1
    int4 = storage == "int4"
    wq, ws = JM._q8_rows(jnp.asarray(x), jnp.int4 if int4 else jnp.int8)
    gq, gs = TM._q8_rows(torch.from_numpy(x),
                         torch.uint8 if int4 else torch.int8)
    assert gs.shape == (3, 5)
    assert gq.dtype == (torch.uint8 if int4 else torch.int8)
    assert gq.shape == (3, 5, 64 if int4 else 128)
    np.testing.assert_array_equal(_ints(gq), _ints(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert np.abs(_ints(gq)).max() == (7 if int4 else 127)


CACHE_FLAVOURS = [(True, False), ("int8", True), ("int4", False),
                  ("int4", True), (False, True), ("int4", "int4")]


@pytest.mark.parametrize("kv_quant,self_quant", CACHE_FLAVOURS)
def test_init_cache_matches_jax(jparams, kv_quant, self_quant):
    """Dyadic encoder output and cross-KV weights make the cross
    projections exact in f32 whatever the summation order, so the
    quantized caches and their scales are held equal."""
    rng = np.random.default_rng(2)
    enc = rng.integers(-3, 4, (2, 15, 128)).astype(np.float32)
    params = jax.tree.map(np.asarray, jparams)
    blocks = params["decoder"]["blocks"]
    blocks["cross_kv_w"] = (rng.integers(-8, 9, blocks["cross_kv_w"].shape)
                            / 16).astype(np.float32)
    blocks["cross_kv_b"] = (rng.integers(-8, 9, blocks["cross_kv_b"].shape)
                            / 4).astype(np.float32)
    want = JM.init_cache(jax.tree.map(jnp.asarray, params), jnp.asarray(enc),
                         CFG, batch=4, cache_len=16, kv_quant=kv_quant,
                         self_quant=self_quant)
    got = TM.init_cache(from_numpy_tree(params), torch.from_numpy(enc), CFG,
                        batch=4, cache_len=16, kv_quant=kv_quant,
                        self_quant=self_quant)
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        w, g = getattr(want, name), getattr(got, name)
        quant = kv_quant if name.startswith("cross") else self_quant
        if not quant:
            assert not isinstance(g, TQ.QTensor)
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=ATOL_F32, rtol=0)
            continue
        assert isinstance(g, TQ.QTensor), name
        np.testing.assert_array_equal(_ints(g.q), _ints(w.q), err_msg=name)
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
        assert g.scale.shape == w.scale.shape


def test_init_cache_rejects_unsupported_flavours(jparams):
    tp = from_numpy_tree(jax.tree.map(np.asarray, jparams))
    xa = torch.zeros(1, 15, 128)
    with pytest.raises(ValueError, match="kv_quant"):
        TM.init_cache(tp, xa, CFG, kv_quant="int2")
    with pytest.raises(ValueError, match="self_quant"):
        TM.init_cache(tp, xa, CFG, self_quant="fp8")
    # int4 is taken: a packed (B, L, C, d / 2) uint8 cache, f32 row scales
    cache = TM.init_cache(tp, xa, CFG, batch=2, cache_len=16,
                          self_quant="int4")
    for t in (cache.self_k, cache.self_v):
        assert t.q.dtype == torch.uint8 and t.q.shape == (2, 2, 16, 64)
        assert t.scale.dtype == torch.float32 and t.scale.shape == (2, 2, 16)
        assert bool((t.q == 0).all()) and bool((t.scale == 1).all())


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("kv_quant,self_quant", CACHE_FLAVOURS)
def test_quantized_decoder_steps_match_jax(jparams, attention, kv_quant,
                                           self_quant):
    """int8 weights and each cache flavour: prefill (the einsum path with
    the scale folds and the sanitised row scales) and S = 1 steps (the
    fused step, K3s over int8 or int4 and integer K3 under "flash", whose
    JAX side runs in interpret mode): logits within LOGIT_ATOL, the self
    cache's integer rows and scales equal."""
    cfg = dataclasses.replace(CFG, attention=attention)
    jq = JQ.quantize_params(jparams, bits=8)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jq))
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, 15, 128)).astype(np.float32)
    toks = rng.integers(0, 80, (2, PROMPT + STEPS))
    kw = dict(cache_len=16, kv_quant=kv_quant, self_quant=self_quant)
    spans = [(0, PROMPT)] + [(i, 1) for i in range(PROMPT, PROMPT + STEPS)]
    with jax.default_matmul_precision("highest"):
        jc = JM.init_cache(jq, jnp.asarray(enc), cfg, **kw)
        want = []
        for i, n in spans:
            logits, jc = JM.decoder_step(jq, jnp.asarray(toks[:, i:i + n]),
                                         jnp.int32(i), jc, cfg)
            want.append(np.asarray(logits))
    tc = TM.init_cache(tp, torch.from_numpy(enc), cfg, **kw)
    atol = (LOGIT_ATOL_SPLIT if self_quant and attention == "flash"
            else LOGIT_ATOL)
    for (i, n), w in zip(spans, want):
        logits, tc = TM.decoder_step(tp, torch.from_numpy(toks[:, i:i + n]),
                                     i, tc, cfg)
        np.testing.assert_allclose(logits.numpy(), w, atol=atol, rtol=0)
    if self_quant:
        n = PROMPT + STEPS
        for name in ("self_k", "self_v"):
            g, w = getattr(tc, name), getattr(jc, name)
            diff = np.abs(_ints(g.q)[:, :, :n].astype(np.int32)
                          - _ints(w.q)[:, :, :n])
            assert diff.max() <= 1 and diff.mean() <= Q_FLIPS, name
            np.testing.assert_allclose(g.scale.numpy(), np.asarray(w.scale),
                                       rtol=SCALE_RTOL, atol=0)


def test_quantized_weights_refuse_the_fused_mlp():
    w1 = TQ.QTensor(torch.zeros(4, 8, dtype=torch.int8), torch.ones(8))
    x = torch.zeros(1, 2, 4)
    assert not TM._use_fused_mlp(x, w1, "flash")


def _k3s_inputs(rng, dtype, b=4, n_layer=3, c=64, d=128, lim=127):
    kc = rng.integers(-lim, lim + 1, (b, n_layer, c, d)).astype(np.int8)
    vc = rng.integers(-lim, lim + 1, (b, n_layer, c, d)).astype(np.int8)
    ks = rng.uniform(0.01, 0.05, (b, n_layer, c)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, (b, n_layer, c)).astype(np.float32)
    q = (rng.standard_normal((b, d)) * 0.125).astype(np.float32)
    return q, kc, vc, ks, vs


@pytest.mark.parametrize("storage", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_used", [None, 32])
def test_k3s_plain_matches_pallas(dtype, c_used, storage):
    """K3s: an int8 or packed-int4 batch-major self cache with per-row K
    and V scales, mixed pos, and a NaN scale on a masked row of every lane
    (the uninitialised tail of a prefix-only reshuffle) that must not
    reach the output. The int4 cache holds values in [-7, 7] (what
    `_q8_rows` writes); JAX takes them as `jnp.int4`, the port packed."""
    rng = np.random.default_rng(4)
    int4 = storage == "int4"
    q, kc, vc, ks, vs = _k3s_inputs(rng, dtype, lim=7 if int4 else 127)
    hi = (c_used or 64) - 1
    pos = np.array([0, 9, hi // 2, hi - 1], np.int32)
    layer, heads = 1, 2
    for i, p in enumerate(pos):
        ks[i, layer, p + 1] = np.nan
        vs[i, layer, p + 1] = np.nan
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jdt = jnp.int4 if int4 else jnp.int8
    want = j_decode(jnp.asarray(q, jd), jnp.asarray(kc, jdt),
                    jnp.asarray(vc, jdt), jnp.asarray(pos), jnp.int32(layer),
                    heads, interpret=True, batch_major=True,
                    k_rowscale=jnp.asarray(ks), v_rowscale=jnp.asarray(vs),
                    c_used=c_used)
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    if int4:
        tk, tv = TQ.pack_int4(tk), TQ.pack_int4(tv)
    got = KC.decode_attention_stacked(
        torch.from_numpy(q).to(dtype), tk, tv, torch.from_numpy(pos), layer,
        heads, batch_major=True, k_rowscale=torch.from_numpy(ks),
        v_rowscale=torch.from_numpy(vs), c_used=c_used)
    assert got.dtype == dtype and got.shape == (4, 128)
    assert bool(torch.isfinite(got).all())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32,
                                   rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   **dict(zip(("atol", "rtol"),
                                              KC.TOL[dtype])))


def test_k3s_refuses_what_jax_refuses():
    rng = np.random.default_rng(5)
    q, kc, vc, ks, vs = (torch.from_numpy(a) for a in _k3s_inputs(
        rng, torch.float32))
    with pytest.raises(ValueError, match="batch_major and kv_rep=1"):
        KC.decode_attention_stacked(q, kc, vc, 3, 0, 2, k_rowscale=ks,
                                    v_rowscale=vs)
    with pytest.raises(ValueError, match="both"):
        KC.decode_attention_stacked(q, kc, vc, 3, 0, 2, batch_major=True,
                                    k_rowscale=ks)


@pytest.mark.parametrize("storage", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 5, 10])
def test_k3_k3g_integer_cross_cache_plain_matches_pallas(storage, dtype,
                                                         rep):
    """K3 (rep 1) and K3g (rep 5 and 10, past the old 8-lane cap) over an
    int8 or packed-int4 layer-major cross cache: the output is in the
    query's dtype."""
    rng = np.random.default_rng(rep)
    bk, n_layer, c, d, heads, layer = 2, 2, 40, 128, 2, 1
    lim = 7 if storage == "int4" else 127
    kc = rng.integers(-lim, lim + 1, (n_layer, bk, c, d)).astype(np.int8)
    vc = rng.integers(-lim, lim + 1, (n_layer, bk, c, d)).astype(np.int8)
    # queries at the size the model's per-channel K scale folds give them
    q = (rng.standard_normal((bk * rep, d)) * 0.5 / lim).astype(np.float32)
    pos = np.full(bk * rep, c - 1, np.int32)
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jdt = jnp.int4 if storage == "int4" else jnp.int8
    want = j_decode(jnp.asarray(q, jd), jnp.asarray(kc, jdt),
                    jnp.asarray(vc, jdt), jnp.asarray(pos), jnp.int32(layer),
                    heads, interpret=True, kv_rep=rep)
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    if storage == "int4":
        tk, tv = TQ.pack_int4(tk), TQ.pack_int4(tv)
    got = KC.decode_attention_stacked(torch.from_numpy(q).to(dtype), tk, tv,
                                      torch.from_numpy(pos), layer, heads,
                                      kv_rep=rep)
    assert got.dtype == dtype and got.shape == (bk * rep, d)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == torch.float32:  # outputs carry the cache's magnitudes
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * lim,
                                   rtol=1e-5)
    else:
        atol, rtol = KC.TOL[dtype]
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                                   rtol=rtol)
