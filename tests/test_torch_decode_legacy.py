"""K8 (flat single-query decode attention) and K9 (legacy flash attention)
of the port vs the JAX Pallas kernels they replace, run as
tests/test_pallas.py runs them on the CPU (interpret=True), plus their call
sites: `_cached_attention(impl="flash")` at S = 1 and the encoder under
`KernelKnobs(flash_impl="legacy")`.

Tolerances: with bf16-exact inputs (bf16, int8 and int4 storage, bf16
queries) both sides compute exact f32 scores and round the softmax weights
and the output once at the same points, so K8's plain version is held
bit-equal, as K3's is. f32 inputs agree to summation order (ATOL_F32).
K9 with bf16 inputs can land one bf16 step apart (BF16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import tiny_test_config
from whisper_tpu.models import whisper as JM
from whisper_tpu.ops.pallas.decode_attention import decode_attention as j_flat
from whisper_tpu.ops.pallas.flash_attention import attention_bhsd as j_bhsd
from whisper_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from whisper_tpu.quantize import QTensor as JQTensor
from whisper_tpu_torch import config as tcfg
from whisper_tpu_torch.models import whisper as TM
from whisper_tpu_torch.ops.kernels import decode_attention as KC
from whisper_tpu_torch.ops.kernels import flash_attention as KA
from whisper_tpu_torch.params import from_numpy_tree
from whisper_tpu_torch.quantize import QTensor, pack_int4

ATOL_F32 = 1e-5
BF16 = dict(atol=1e-2, rtol=1e-2)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat_inputs(rng, storage, b=3, c=40, d=128):
    """(JAX q, k, v), (port q, k, v) of one flat cache: bf16/f32 values,
    or int8 / int4 integers (packed two a byte on the port's side) with a
    bf16 query at the size a folded K scale gives it."""
    if storage in ("bf16", "f32"):
        dt = torch.bfloat16 if storage == "bf16" else torch.float32
        k = rng.standard_normal((b, c, d)).astype(np.float32)
        v = (1 + rng.standard_normal((b, c, d))).astype(np.float32)
        q = (0.125 * rng.standard_normal((b, d))).astype(np.float32)
        jx = [jnp.asarray(a, JDT[dt]) for a in (q, k, v)]
        tx = [torch.from_numpy(a).to(dt) for a in (q, k, v)]
        return jx, tx
    lim = 7 if storage == "int4" else 127
    k, v = (rng.integers(-lim, lim + 1, (b, c, d)).astype(np.int8)
            for _ in "kv")
    q = (rng.standard_normal((b, d)) * 0.5 / lim).astype(np.float32)
    jdt = jnp.int4 if storage == "int4" else jnp.int8
    jx = [jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jdt),
          jnp.asarray(v, jdt)]
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if storage == "int4":
        tk, tv = pack_int4(tk), pack_int4(tv)
    return jx, [torch.from_numpy(q).to(torch.bfloat16), tk, tv]


@pytest.mark.parametrize("storage", ["bf16", "f32", "int8", "int4"])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_plain_matches_pallas(storage, per_row):
    """K8: scalar and (B,) pos; output in v's dtype, or q's for integer
    storage."""
    rng = np.random.default_rng(len(storage) + per_row)
    (jq, jk, jv), (tq, tk, tv) = _flat_inputs(rng, storage)
    pos = np.array([0, 17, 39], np.int32) if per_row else 25
    want = j_flat(jq, jk, jv, jnp.asarray(pos), 2, interpret=True)
    got = KC.decode_attention(tq, tk, tv, torch.as_tensor(pos), 2)
    assert got.shape == (3, 128)
    assert got.dtype == (torch.float32 if storage == "f32" else torch.bfloat16)
    assert str(want.dtype) == str(got.dtype).replace("torch.", "")
    if storage == "f32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL_F32,
                                   rtol=0)
    else:
        np.testing.assert_array_equal(_f32(got), _f32(want))


def test_decode_attention_is_the_stacked_plain_on_a_layer_view():
    """A layer sliced out of a (B, L, C, D) stacked cache gives K8 the same
    answer as K3 reading that layer in place; the K3 counter does not
    move."""
    rng = np.random.default_rng(9)
    stacked = torch.from_numpy(rng.standard_normal((2, 3, 16, 128)).astype(
        np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    before = (KC.decode_attention_stacked.launches,
              KC.decode_attention.flat_launches)
    a = KC.decode_attention(q, stacked[:, 1], stacked[:, 2], 9, 2)
    b = KC.decode_attention_stacked(q, stacked, stacked.roll(-1, 1), 9, 1, 2,
                                    batch_major=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (KC.decode_attention_stacked.launches,
            KC.decode_attention.flat_launches) == before == (0, 0)
    with pytest.raises(ValueError, match="flat caches"):
        KC.decode_attention(q, stacked, stacked, 9, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(24, 24, False), (130, 130, True),
                                          (5, 37, False), (37, 37, True)])
def test_flash_attention_plain_matches_pallas(dtype, sq, sk, causal):
    """K9 on (B, H, S, hd) with q pre-scaled; Sk is never a multiple of
    128, so the TPU kernel's padded keys are masked."""
    rng = np.random.default_rng(sq + sk + causal)
    q, k, v = (rng.standard_normal((2, 2, n, 64)).astype(np.float32)
               for n in (sq, sk, sk))
    q *= 0.125
    want = j_flash(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)),
                   causal=causal, interpret=True)
    got = KA.flash_attention(*(torch.from_numpy(a).to(dtype)
                               for a in (q, k, v)), causal)
    assert got.dtype == dtype and got.shape == (2, 2, sq, 64)
    if dtype == torch.float32:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL_F32,
                                   rtol=0)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


@pytest.mark.parametrize("causal", [False, True])
def test_legacy_attention_bhsd_matches_jax_legacy(causal, monkeypatch):
    """attention_bhsd(impl="legacy") against the JAX attention_bhsd under
    WHISPER_TPU_FLASH_IMPL=legacy, on the strided q/k/v slices of one fused
    projection."""
    monkeypatch.setenv("WHISPER_TPU_FLASH_IMPL", "legacy")
    rng = np.random.default_rng(11)
    qkv = rng.standard_normal((2, 30, 3, 128)).astype(np.float32)
    want = j_bhsd(*(jnp.asarray(qkv[:, :, i]) for i in range(3)), 2,
                  causal=causal, interpret=True)
    t = torch.from_numpy(qkv)
    got = KA.attention_bhsd(t[:, :, 0], t[:, :, 1], t[:, :, 2], 2,
                            causal=causal, impl="legacy")
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=ATOL_F32,
                               rtol=0)
    with pytest.raises(ValueError, match="flash impl"):
        KA.attention_bhsd(t[:, :, 0], t[:, :, 1], t[:, :, 2], 2,
                          impl="fast")


def test_kernel_knobs_flash_impl():
    assert tcfg.KernelKnobs().flash_impl == "bsd"
    assert tcfg.WhisperConfig().knobs.flash_impl == "bsd"
    assert tcfg.KernelKnobs(flash_impl="legacy").flash_impl == "legacy"
    for bad in ("xla", "LEGACY", ""):
        with pytest.raises(ValueError, match="flash_impl"):
            tcfg.KernelKnobs(flash_impl=bad)


CFG = tiny_test_config(n_state=128, n_head=2, n_layer=2, n_vocab=80,
                       n_audio_ctx=32, n_text_ctx=24)


@pytest.fixture(scope="module")
def params():
    jp = JM.init_params(jax.random.PRNGKey(3), CFG)
    return jp, from_numpy_tree(jax.tree.map(np.asarray, jp))


def test_legacy_encoder_matches_jax(params, monkeypatch):
    """The encoder with KernelKnobs(flash_impl="legacy") (the port's
    config; no environment read) against the JAX encoder under its
    environment override, and against the port's default "bsd" encoder."""
    jp, tp = params
    mel = np.random.default_rng(0).standard_normal((2, 80, 30)).astype(
        np.float32)
    flash = dataclasses.replace(CFG, attention="flash")
    monkeypatch.setenv("WHISPER_TPU_FLASH_IMPL", "legacy")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JM.encoder_forward(jp, jnp.asarray(mel), flash))
    monkeypatch.delenv("WHISPER_TPU_FLASH_IMPL")
    tflash = dataclasses.replace(tcfg.tiny_test_config(
        n_state=128, n_head=2, n_layer=2, n_vocab=80, n_audio_ctx=32,
        n_text_ctx=24), attention="flash")
    legacy = dataclasses.replace(
        tflash, knobs=tcfg.KernelKnobs(flash_impl="legacy"))
    calls = []
    real = KA.flash_attention_plain
    monkeypatch.setattr(KA, "flash_attention_plain",
                        lambda *a: calls.append(1) or real(*a))
    got = TM.encoder_forward(tp, torch.from_numpy(mel), legacy)
    assert len(calls) == CFG.audio_encoder_config.n_audio_layer
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    bsd = TM.encoder_forward(tp, torch.from_numpy(mel), tflash)
    assert len(calls) == CFG.audio_encoder_config.n_audio_layer
    np.testing.assert_allclose(bsd.numpy(), want, atol=1e-4, rtol=0)


def _cache_pair(rng, kind, b=2, c=12, d=128):
    """(JAX, port) caches of one layer: bf16, f32, or a cross cache
    quantized per channel (int8 / int4), or an int8 self cache with per-row
    scales."""
    if kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        k, v = (rng.standard_normal((b, c, d)).astype(np.float32)
                for _ in "kv")
        return ([jnp.asarray(a, JDT[dt]) for a in (k, v)],
                [torch.from_numpy(a).to(dt) for a in (k, v)])
    lim = 7 if kind == "int4" else 127
    k, v = (rng.integers(-lim, lim + 1, (b, c, d)).astype(np.int8)
            for _ in "kv")
    if kind == "rows":  # int8 self cache, one scale per row
        ks, vs = (0.01 * rng.random((b, c)).astype(np.float32) + 1e-3
                  for _ in "kv")
    else:
        ks, vs = (0.05 * rng.random(d).astype(np.float32) + 1e-3
                  for _ in "kv")
    jdt = jnp.int4 if kind == "int4" else jnp.int8
    j = [JQTensor(jnp.asarray(a, jdt), jnp.asarray(s))
         for a, s in ((k, ks), (v, vs))]
    t = []
    for a, s in ((k, ks), (v, vs)):
        q = torch.from_numpy(a)
        t.append(QTensor(pack_int4(q) if kind == "int4" else q,
                         torch.from_numpy(s)))
    return j, t


@pytest.mark.parametrize("kind,dtype,rep,kernel", [
    ("bf16", torch.bfloat16, 1, True), ("f32", torch.float32, 1, True),
    ("int8", torch.bfloat16, 1, True), ("int4", torch.float32, 1, True),
    ("rows", torch.float32, 1, False),  # per-row scales: the einsum path
    ("bf16", torch.bfloat16, 2, False),  # rep 2: the einsum path
])
def test_cached_attention_flash_at_s1_matches_jax(kind, dtype, rep, kernel,
                                                  monkeypatch):
    """`_cached_attention(..., impl="flash")` at S = 1 against JAX's: K8
    under JAX's exact condition (S = 1, rep 1, no row scales), the einsum
    path otherwise."""
    rng = np.random.default_rng(rep + len(kind))
    (jk, jv), (tk, tv) = _cache_pair(rng, kind)
    b = 2 * rep
    q = rng.standard_normal((b, 1, 128)).astype(np.float32)
    last = np.array([7])
    with jax.default_matmul_precision("highest"):
        want = JM._cached_attention(jnp.asarray(q, JDT[dtype]), jk, jv,
                                    jnp.asarray(last), 2, "flash")
    calls = []
    real = TM.decode_attention
    monkeypatch.setattr(TM, "decode_attention",
                        lambda *a: calls.append(1) or real(*a))
    got = TM._cached_attention(torch.from_numpy(q).to(dtype), tk, tv,
                               torch.from_numpy(last), 2, "flash")
    assert len(calls) == int(kernel)
    assert got.shape == (b, 1, 128)
    assert str(want.dtype) == str(got.dtype).replace("torch.", "")
    if dtype == torch.float32:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4,
                                   rtol=1e-5)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), **BF16)
    xla = TM._cached_attention(torch.from_numpy(q).to(dtype), tk, tv,
                               torch.from_numpy(last), 2, "xla")
    assert len(calls) == int(kernel)  # "xla" never takes the kernel branch
    np.testing.assert_allclose(_f32(xla), _f32(got), **BF16)
