"""The port's model functions vs the JAX package's, same weights, same
inputs, f32 on the CPU.

Both configs are held: attention="xla" (plain einsum paths) and
attention="flash" (the kernel paths; JAX runs its Pallas kernels in
interpret mode, the port its kernels' plain versions). Tolerances: f32
agrees to summation order; encoder outputs (unit-variance after ln_post)
to ENC_ATOL = 1e-4, logits (magnitude up to ~60 with random weights) to
LOGIT_ATOL = 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import tiny_test_config
from whisper_tpu.models import whisper as JM
from whisper_tpu_torch import quantize as TQ
from whisper_tpu_torch.models import whisper as TM
from whisper_tpu_torch.params import from_numpy_tree

ENC_ATOL = 1e-4
LOGIT_ATOL = 1e-3
# head dim 64 (n_state 128, 2 heads), as every Whisper size
CFG = tiny_test_config(n_state=128, n_head=2, n_layer=2, n_vocab=80,
                       n_audio_ctx=32, n_text_ctx=24)
PROMPT, STEPS = 4, 3


@pytest.fixture(scope="module")
def setup():
    jp = JM.init_params(jax.random.PRNGKey(0), CFG)
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 80, 30)).astype(np.float32)
    toks = rng.integers(0, 80, (2, PROMPT + STEPS))
    return jp, tp, mel, toks


def _jax_run(jp, mel, toks, cfg):
    """JAX encoder, full decoder, and the cached path: prefill of PROMPT
    tokens then STEPS single-token steps."""
    with jax.default_matmul_precision("highest"):
        enc = JM.encoder_forward(jp, jnp.asarray(mel), cfg)
        full = JM.decoder_forward(jp, jnp.asarray(toks), enc, cfg)
        cache = JM.init_cache(jp, enc, cfg, cache_len=16)
        logits, cache = JM.decoder_step(
            jp, jnp.asarray(toks[:, :PROMPT]), jnp.int32(0), cache, cfg)
        steps = [logits]
        for i in range(PROMPT, PROMPT + STEPS):
            logits, cache = JM.decoder_step(
                jp, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i), cache, cfg)
            steps.append(logits)
    return (np.asarray(enc), np.asarray(full),
            [np.asarray(s) for s in steps], cache)


@pytest.fixture(scope="module", params=["xla", "flash"])
def runs(request, setup):
    jp, tp, mel, toks = setup
    cfg = dataclasses.replace(CFG, attention=request.param)
    j = _jax_run(jp, mel, toks, cfg)
    enc = TM.encoder_forward(tp, torch.from_numpy(mel), cfg)
    # the decoder runs on JAX's encoder output, so each stage is held alone
    xa = torch.tensor(j[0])
    full = TM.decoder_forward(tp, torch.from_numpy(toks), xa, cfg)
    cache = TM.init_cache(tp, xa, cfg, cache_len=16)
    logits, cache2 = TM.decoder_step(tp, torch.from_numpy(toks[:, :PROMPT]),
                                     0, cache, cfg)
    assert cache2 is cache  # appended in place
    steps = [logits]
    for i in range(PROMPT, PROMPT + STEPS):
        logits, cache = TM.decoder_step(
            tp, torch.from_numpy(toks[:, i:i + 1]), i, cache, cfg)
        steps.append(logits)
    return j, (enc, full, steps, cache)


def test_encoder_forward(runs):
    (j_enc, *_), (t_enc, *_) = runs
    assert t_enc.shape == j_enc.shape == (2, 15, 128)
    np.testing.assert_allclose(t_enc.numpy(), j_enc, atol=ENC_ATOL, rtol=0)


def test_decoder_forward(runs):
    (_, j_full, *_), (_, t_full, *_) = runs
    assert t_full.dtype == torch.float32
    np.testing.assert_allclose(t_full.numpy(), j_full, atol=LOGIT_ATOL, rtol=0)


def test_prefill_decoder_step(runs):
    (_, _, j_steps, _), (_, _, t_steps, _) = runs
    assert t_steps[0].shape == (2, PROMPT, 80)
    np.testing.assert_allclose(t_steps[0].numpy(), j_steps[0],
                               atol=LOGIT_ATOL, rtol=0)


def test_single_token_steps(runs):
    """S = 1 steps: the fused stacked-cache step under "flash", the general
    path under "xla"."""
    (_, _, j_steps, _), (_, _, t_steps, _) = runs
    for got, want in zip(t_steps[1:], j_steps[1:]):
        np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


def test_cache_contents(runs):
    (*_, j_cache), (*_, t_cache) = runs
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        got, want = getattr(t_cache, name), np.asarray(getattr(j_cache, name))
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, atol=ENC_ATOL, rtol=0)


def test_cached_path_matches_own_full_recompute(runs):
    """The port's cached path (prefill + steps) against its own
    decoder_forward: causal masking makes them the same computation."""
    _, (_, t_full, t_steps, _) = runs
    cached = torch.cat(t_steps, dim=1)
    torch.testing.assert_close(cached, t_full, atol=LOGIT_ATOL, rtol=0)


def test_whisper_forward_and_conv_layout(setup):
    jp, tp, mel, toks = setup
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JM.whisper_forward(jp, jnp.asarray(mel),
                                             jnp.asarray(toks), CFG))
    got = TM.whisper_forward(tp, torch.from_numpy(mel),
                             torch.from_numpy(toks), CFG)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)
    # the conv stem hands the blocks a contiguous (B, T, C) stream, which
    # the CUDA kernels' row-major operands need
    enc = tp["encoder"]
    x = TM._conv1d_nhc(torch.from_numpy(mel).transpose(1, 2),
                       enc["conv1_w"], enc["conv1_b"], 1)
    assert x.is_contiguous()


def test_unported_cache_options_raise(setup):
    """A decode batch that is not a multiple of the windows raises; the
    int4 self cache beside an int8 cross cache is JAX's (packed to d / 2
    bytes a row, row scales at 1)."""
    jp, tp, mel, _ = setup
    xa = np.zeros((2, 15, 128), np.float32)
    want = JM.init_cache(jp, jnp.asarray(xa), CFG, kv_quant=True,
                         self_quant="int4")
    got = TM.init_cache(tp, torch.from_numpy(xa), CFG, kv_quant=True,
                        self_quant="int4")
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        w, g = getattr(want, name), getattr(got, name)
        assert g.q.dtype == (torch.uint8 if name.startswith("self")
                             else torch.int8), name
        np.testing.assert_array_equal(TQ.int_values(g.q).numpy(),
                                      np.asarray(w.q).astype(np.int8))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
    with pytest.raises(ValueError, match="multiple"):
        TM.init_cache(tp, torch.from_numpy(xa), CFG, batch=5)


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_beam_lanes_share_one_cross_cache(setup, attention):
    """R = 3 decode lanes per window over 2 windows: the cross cache keeps
    one row per window and lane i reads window i // 3, in the prefill
    (einsum path) and in the S = 1 steps (the grouped kernel's plain
    version under "flash"), as in the JAX package."""
    jp, tp, mel, _ = setup
    cfg = dataclasses.replace(CFG, attention=attention)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 80, (6, PROMPT + STEPS))
    with jax.default_matmul_precision("highest"):
        enc = JM.encoder_forward(jp, jnp.asarray(mel), cfg)
        cache = JM.init_cache(jp, enc, cfg, batch=6, cache_len=16)
        want = []
        for i in [0, *range(PROMPT, PROMPT + STEPS)]:
            n = PROMPT if i == 0 else 1
            logits, cache = JM.decoder_step(
                jp, jnp.asarray(toks[:, i:i + n]), jnp.int32(i), cache, cfg)
            want.append(np.asarray(logits))
    cache = TM.init_cache(tp, torch.tensor(np.asarray(enc)), cfg, batch=6,
                          cache_len=16)
    assert cache.cross_k.shape[1] == 2 and cache.self_k.shape[0] == 6
    for j, i in enumerate([0, *range(PROMPT, PROMPT + STEPS)]):
        n = PROMPT if i == 0 else 1
        logits, cache = TM.decoder_step(
            tp, torch.from_numpy(toks[:, i:i + n]), i, cache, cfg)
        np.testing.assert_allclose(logits.numpy(), want[j], atol=LOGIT_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grad", [False, True])
def test_logits_keep_the_f32_product_off_the_card(dtype, grad):
    """On the CPU, and wherever autograd records, the tied head is the f32
    product of the operands bit for bit, counted by `_logits.f32_calls`
    alone; the bf16 GEMM with an f32 output is the card's route."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 64), generator=gen).to(dtype)
    emb = torch.randn((77, 64), generator=gen).to(dtype)
    emb.requires_grad_(grad)
    before = (TM._logits.tensor_core_calls, TM._logits.f32_calls)
    with torch.set_grad_enabled(grad):
        got = TM._logits(x, {"tok_emb": emb})
    want = torch.matmul(x.float(), emb.detach().float().t())
    assert got.dtype == torch.float32 and got.shape == (2, 3, 77)
    assert torch.equal(got.detach(), want)
    assert got.requires_grad == grad
    assert (TM._logits.tensor_core_calls, TM._logits.f32_calls) == (
        before[0], before[1] + 1)


# (function, the weight's out shape): `_linear` and the fused projections
PROJECTIONS = [(TM._linear, (256,)), (TM._qkv_proj, (3, 128)),
               (TM._kv_proj, (2, 128))]
# route cases: (dtype, grad, QTensor weight, rows, `_on_tensor_cores`
# forced true, tp); all but those in BIAS_FUSED keep the separate add
BIAS_CASES = {
    "cpu-f32": (torch.float32, False, False, 6, False, 1),
    "cpu-f32-grad": (torch.float32, True, False, 6, False, 1),
    "cpu-bf16": (torch.bfloat16, False, False, 6, False, 1),
    "cpu-bf16-grad": (torch.bfloat16, True, False, 6, False, 1),
    "qtensor": (torch.bfloat16, False, True, 6, True, 1),
    "one-row": (torch.bfloat16, False, False, 1, True, 1),
    "tp2": (torch.bfloat16, False, False, 6, True, 2),
    "epilogue": (torch.bfloat16, False, False, 6, True, 1),
}
BIAS_FUSED = ("one-row", "epilogue")


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 (8 significant bits) at each element of v."""
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32),
                       torch.frexp(v.float()).exponent - 8)


@pytest.mark.parametrize("case", list(BIAS_CASES))
@pytest.mark.parametrize("proj,out_shape", PROJECTIONS,
                         ids=["linear", "qkv", "kv"])
def test_projection_bias_keeps_the_separate_add_off_the_card(
        proj, out_shape, case, monkeypatch):
    """A projection's bias: on the CPU, in f32 or bf16, with grad on or
    off, and (with the card's test forced true) for a QTensor weight and
    tp = 2, the result is `_matmul(x, w) + b` bit for bit, counted by
    `_linear.bias_add_calls` alone. Only the card's route (bf16, no grad,
    a plain weight, no tp; six rows or one) takes one `torch.addmm` of the
    2-D operands, counted by `_linear.epilogue_bias_calls` alone, in the
    separate add's layout, and within one bf16 ulp of the f32 product
    plus the bias rounded once."""
    dtype, grad, quant, rows, forced, tp = BIAS_CASES[case]
    if forced:
        monkeypatch.setattr(TM, "_on_tensor_cores", lambda a, b: True)
    monkeypatch.setattr(TM.pctx, "tp_size", lambda mesh=None: tp)
    gen = torch.Generator().manual_seed(0)
    k = 128
    x = torch.randn((rows, 1, k), generator=gen).to(dtype)
    w = torch.randn((k, *out_shape), generator=gen).to(dtype)
    b = torch.randn(out_shape, generator=gen).to(dtype)
    impl = "xla"
    if quant:  # the W8A8 route: no `_mm_f32`, which the CPU cannot force
        w, impl = TQ.quantize_tensor(w), "w8a8"
    else:
        w.requires_grad_(grad)
        b.requires_grad_(grad)
    fused = case in BIAS_FUSED
    before = (TM._linear.epilogue_bias_calls, TM._linear.bias_add_calls)
    with torch.set_grad_enabled(grad):
        got = proj(x, w, b, impl)
        if fused:
            y = (x.float().reshape(-1, k) @ w.float().reshape(k, -1)
                 + b.float().reshape(-1)).to(dtype)
            y = y.reshape(*x.shape[:-1], *out_shape)
        else:
            y = TM._matmul(x, w, impl) + b
    got = got if isinstance(got, tuple) else (got,)
    want = y.unbind(-2) if len(out_shape) == 2 else (y,)
    assert len(got) == len(want)
    for g, v in zip(got, want):
        assert g.dtype == dtype and g.shape == (rows, 1, out_shape[-1])
        if fused:
            err = (g.float() - v.float()).abs()
            assert bool((err <= _bf16_ulp(v)).all())
        else:
            assert torch.equal(g.detach(), v.detach())
        assert g.requires_grad == grad
    assert (TM._linear.epilogue_bias_calls, TM._linear.bias_add_calls) == (
        before[0] + fused, before[1] + (not fused))
