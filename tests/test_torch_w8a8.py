"""The port's W8A8 path (`cfg.knobs.int8_impl="pallas"`) vs the JAX package
on the CPU: K6/K7's plain versions against the Pallas kernels in interpret
mode over int8 and packed-int4 weights, `_matmul`'s dispatch, the
`init_cache` cross-KV projection, and the model functions over
`quantize_params(..., quantize_encoder=True)` weights.

JAX routes "pallas" to its kernels only when `jax.default_backend()` is
"tpu". The model-level tests replace the name `jax` inside
`whisper_tpu.models.whisper` only (monkeypatch) by a proxy that answers
"tpu" and forwards everything else; the Pallas modules keep the real `jax`
and so run in interpret mode. Nothing in the JAX package changes. JAX runs
attention="xla" here, and so does the port.

Tolerances. The kernels' plain versions are held BIT-EQUAL to the Pallas
kernels on the same inputs (both divide or multiply in IEEE f32, round half
to even and sum integers exactly). Through the model, an activation that
differs by one f32 ulp (summation order in layer norm, attention, the f32
products) can land one int8 step away in the row quantization, which moves
that row's product by up to xs * ws * |w| (about 1/127 of one term): the
encoder output (magnitude up to ~4.4; 1.7e-3 apart at most on this seed)
is held within ENC_ATOL = 5e-3, and the logits (magnitude up to ~110;
4e-5 apart at prefill) within LOGIT_ATOL = 5e-3. The cross-KV
projection of `init_cache`, which takes JAX's vmap fallback and no W8A8
kernel, agrees to f32 summation order (ATOL_F32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu import config as jcfg
from whisper_tpu import quantize as JQ
from whisper_tpu.models import whisper as JM
from whisper_tpu.ops.pallas import dequant_matmul as JK
from whisper_tpu_torch import config as tcfg
from whisper_tpu_torch import quantize as TQ
from whisper_tpu_torch.models import whisper as TM
from whisper_tpu_torch.ops.kernels import dequant_matmul as KQ
from whisper_tpu_torch.params import from_numpy_tree

ATOL_F32 = 2e-5
ENC_ATOL = 5e-3
LOGIT_ATOL = 5e-3
# 2 layers at n_state 128; a mel of 600 frames gives 300 encoder rows, so 4
# windows put 1200 rows (> 1024: K7) through every encoder matmul
DIMS = dict(n_state=128, n_head=2, n_layer=2, n_vocab=96, n_audio_ctx=600,
            n_text_ctx=24)
JCFG = dataclasses.replace(
    jcfg.tiny_test_config(**DIMS),
    knobs=jcfg.KernelKnobs(int8_impl="pallas"))
TCFG = dataclasses.replace(
    tcfg.tiny_test_config(**DIMS),
    knobs=tcfg.KernelKnobs(int8_impl="pallas"))


class _TpuJax:
    """`jax`, except that the default backend reads "tpu"."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture
def on_tpu(monkeypatch):
    monkeypatch.setattr(JM, "jax", _TpuJax())


def _operands(rng, m, k, n, dtype, bits=8):
    """x with a zero row and a row of exact half quantization steps (an
    absmax of 127 makes the steps 1), int8 (or int4: JAX's `jnp.int4`, the
    port's packed uint8) weights, f32 column scales."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0] = 0
    if m > 1:
        x[1] = 0
        x[1, 0] = 127.0
        x[1, 1:41] = np.arange(40) + 0.5
        x[1, 41:81] = -(np.arange(40) + 0.5)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    lim = 2 ** (bits - 1) - 1
    wq = rng.integers(-lim, lim + 1, (k, n)).astype(np.int8)
    s = rng.uniform(0.001, 0.01, n).astype(np.float32)
    tw = torch.from_numpy(wq)
    if bits == 4:
        return (xj, jnp.asarray(wq, jnp.int4), jnp.asarray(s)), (
            xt, TQ.pack_int4(tw), torch.from_numpy(s))
    return (xj, jnp.asarray(wq), jnp.asarray(s)), (
        xt, tw, torch.from_numpy(s))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else a.astype(jnp.float32))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("big,m", [(False, 1), (False, 5), (False, 37),
                                   (False, 1024), (True, 1025),
                                   (True, 1100)])
def test_w8a8_plain_matches_pallas_interpret(big, m, dtype, bits):
    """Bit-equal, int8 weights and packed int4 ones (a (K, N / 2) uint8
    weight against the Pallas kernels' `jnp.int4` (K, N))."""
    rng = np.random.default_rng(m)
    jargs, targs = _operands(rng, m, 256, 384, dtype, bits)
    if big:
        want = JK.quantized_matmul_big(*jargs, interpret=True)
        got = KQ.quantized_matmul_big(*targs)
    else:
        want = JK.quantized_matmul(*jargs, interpret=True)
        got = KQ.quantized_matmul(*targs)
    assert got.dtype == targs[0].dtype
    np.testing.assert_array_equal(_f32(got), _f32(want))
    if m > 1:  # the half steps round to even: 0.5 -> 0, 1.5 -> 2, ...
        xq, _ = KQ.quantize_rows_plain(targs[0][1:2], big)
        np.testing.assert_array_equal(
            xq[0, 1:9].numpy(), [0, 2, 2, 4, 4, 6, 6, 8])


# large-v2's decoder weights (K x N): qkv, attn_o / cross_q / cross_o,
# mlp1, mlp2
DECODE_SHAPES = [(1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280)]


@pytest.mark.parametrize("m", [1, 5, 16, 17, 20, 64, 65])
@pytest.mark.parametrize("k,n", DECODE_SHAPES + [(128, 128), (256, 384),
                                                 (640, 384), (5376, 256),
                                                 (10240, 256)])
def test_k6_plan(m, k, n):
    """`plan_small`, the plan of K6's one-launch kernel: every split
    divides K's steps of 32 into whole steps, the cluster is a portable
    one (<= 8 blocks) whose blocks' shared memory fits with an f32 x read
    whole where the plan says so (`csrc/dequant_matmul.cu::splitk_smem`),
    M > 64 and K past 8 x 640 take the two-launch tile path (0), and at
    the decode shapes half of a block's 8 warps have a step and the grid
    holds a third of the SMs or more, one block an SM where a split allows
    it."""
    ksplit, whole = KQ.plan_small(m, k, n, 4)
    if m > KQ.SMALL_M or k > KQ.MAX_KSPLIT * KQ.MAX_SLICE:
        assert (ksplit, whole) == (0, False)
        return
    assert 1 <= ksplit <= KQ.MAX_KSPLIT
    assert whole == (m * k * 4 <= KQ.WHOLE_ROWS_BYTES)
    steps = k // 32
    assert steps % ksplit == 0
    ks = k // ksplit
    rows = KQ.SPLIT_ROWS
    xraw = max(rows * ks, rows * k if whole else 0) * 4
    region = max(xraw + rows * (ks + 16), 8 * rows * 148 * 4)
    smem = (region + 8 * (rows * 128 // 8 + 4) * 4 + 8 * rows * 4
            + 2 * rows * 4 + 3 * 8)
    assert ks <= KQ.MAX_SLICE and smem <= 227 * 1024
    blocks = (n // KQ.SPLIT_COLS) * ksplit * -(-m // rows)
    if (k, n) in DECODE_SHAPES:
        assert steps // ksplit >= 4
        assert blocks >= KQ.N_SM // 3
        smallest = min(s for s in range(1, 9)
                       if steps % s == 0 and k // s <= KQ.MAX_SLICE)
        assert blocks <= KQ.N_SM or ksplit == smallest


@pytest.mark.parametrize("m,n,tile", [
    (3000, 3840, 256),  # four windows' qkv: 360 wide tiles, 3 waves at 91%
    (3000, 1280, 256),  # attn_o, mlp2: 120 wide tiles
    (3000, 5120, 256),  # mlp1
    (750, 3840, 256),   # one window: 90 wide or 180 narrow, both 68%
    (750, 1280, 128),   # 30 wide tiles, 60 narrow
    (750, 5120, 256),
    (1500, 3840, 128),  # two windows: 180 wide (68%), 360 narrow (91%)
    (1500, 1280, 128),
    (1500, 5120, 256),
    (65, 384, 128),     # N = 384: no 256-wide tile
    (65, 256, 128),     # one wide tile, two narrow
])
def test_k7_plan(m, n, tile):
    """`plan_big`, the tile width of the large-M route: 256 (a divisor of
    N) unless 128-wide tiles keep more than 1.05 times the share of the
    SMs busy in the grid's waves."""
    assert KQ.plan_big(m, n) == tile
    assert n % tile == 0


@pytest.mark.parametrize("lead,route", [
    ((64,), "split"), ((2, 32), "split"), ((65,), "tiles"), ((1024,), "tiles"),
    ((1025,), "k7"), ((5, 205), "k7")])
def test_w8a8_route_at_the_row_boundaries(lead, route, monkeypatch):
    """`_matmul` under int8_impl="pallas" sends up to 1024 rows to K6 and
    more to K7; K6 plans its one-launch split-K kernel up to 64 rows and
    the two-launch tile route (ksplit 0, then `plan_big`'s tiles) above."""
    calls = []
    for name in ("quantized_matmul", "quantized_matmul_big"):
        fn = getattr(TM, name)
        monkeypatch.setattr(TM, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    m = int(np.prod(lead))
    k, n = 128, 256
    rng = np.random.default_rng(m)
    w = TQ.QTensor(torch.from_numpy(rng.integers(-127, 128, (k, n),
                                                 dtype=np.int8)),
                   torch.full((n,), 0.01))
    x = torch.from_numpy(rng.standard_normal((*lead, k)).astype(np.float32))
    y = TM._matmul(x, w, "pallas")
    assert y.shape == (*lead, n)
    assert calls == (["quantized_matmul_big"] if route == "k7"
                     else ["quantized_matmul"])
    ksplit, _ = KQ.plan_small(m, k, n, 4)
    assert (ksplit > 0) == (route == "split")
    if route != "split":
        assert KQ.plan_big(m, n) in (128, 256)


def test_the_two_roundings_differ():
    """K6 divides by the row scale, K7 multiplies by 127 / absmax: on
    random rows some element lands on different sides of a midpoint."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (512, 256)).astype(np.float32))
    q6, s6 = KQ.quantize_rows_plain(x, big=False)
    q7, s7 = KQ.quantize_rows_plain(x, big=True)
    assert torch.equal(s6, s7) and not torch.equal(q6, q7)
    assert int((q6.int() - q7.int()).abs().max()) == 1


def _qweight(rng, k, n_shape, bits=8):
    w = rng.standard_normal((k, *n_shape)).astype(np.float32) * 0.05
    jq = JQ.quantize_tensor(jnp.asarray(w))
    if bits == 4:
        return None, TQ.QTensor(TQ.pack_int4(torch.from_numpy(
            np.asarray(jq.q).clip(-7, 7))), torch.from_numpy(
                np.asarray(jq.scale)))
    return jq, TQ.QTensor(torch.from_numpy(np.asarray(jq.q)),
                          torch.from_numpy(np.asarray(jq.scale)))


@pytest.mark.parametrize("lead,k,n_shape,route", [
    ((1024,), 128, (3, 128), "k6"),
    ((4, 256), 128, (3, 128), "k6"),
    ((1025,), 128, (256,), "k7"),
    ((5, 205), 128, (256,), "k7"),
    ((7,), 96, (256,), "dequant"),  # K not a multiple of 128
    ((7,), 128, (200,), "dequant"),  # N not a multiple of 128
])
def test_matmul_dispatch_matches_jax(on_tpu, monkeypatch, lead, k, n_shape,
                                     route):
    """At the M = 1024 / 1025 boundary and for unaligned widths, the port
    takes the branch JAX takes and computes the same numbers."""
    calls = []
    for name in ("quantized_matmul", "quantized_matmul_big"):
        fn = getattr(TM, name)
        monkeypatch.setattr(TM, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    rng = np.random.default_rng(len(lead) * 1000 + lead[-1])
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    jw, tw = _qweight(rng, k, n_shape)
    with jcfg.active_knobs(jcfg.KernelKnobs(int8_impl="pallas")):
        want = np.asarray(JM._matmul(jnp.asarray(x), jw))
    got = TM._matmul(torch.from_numpy(x), tw, "pallas")
    assert calls == {"k6": ["quantized_matmul"],
                     "k7": ["quantized_matmul_big"], "dequant": []}[route]
    assert got.shape == want.shape
    if route == "dequant":
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_int4_weights_under_pallas_raise(on_tpu, monkeypatch):
    """int4 weights under int8_impl="pallas" raise nothing: a (k, 3, d)
    weight packs to (k, 3, d / 2) and flattens to the kernels' (k, n / 2)
    with its column pairs intact. K6 (M = 5) and K7 (M = 1100) take it and
    equal JAX's `_matmul` over the same `jnp.int4` weight on its Pallas
    path; int8_impl="xla" keeps the dequant product."""
    calls = []
    for name in ("quantized_matmul", "quantized_matmul_big"):
        fn = getattr(TM, name)
        monkeypatch.setattr(TM, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    rng = np.random.default_rng(0)
    k, n_shape = 128, (3, 128)
    w = rng.standard_normal((k, *n_shape)).astype(np.float32) * 0.05
    scale = np.abs(w).max(axis=0) / 7
    q = np.clip(np.round(w / scale), -7, 7).astype(np.int8)
    jw = JQ.QTensor(jnp.asarray(q, jnp.int4), jnp.asarray(scale))
    tw = TQ.QTensor(TQ.pack_int4(torch.from_numpy(q)),
                    torch.from_numpy(scale))
    for m in (5, 1100):
        x = rng.standard_normal((m, k)).astype(np.float32)
        with jcfg.active_knobs(jcfg.KernelKnobs(int8_impl="pallas")):
            want = np.asarray(JM._matmul(jnp.asarray(x), jw))
        got = TM._matmul(torch.from_numpy(x), tw, "pallas")
        assert got.shape == want.shape == (m, 3, 128)
        np.testing.assert_array_equal(got.numpy(), want)
    assert calls == ["quantized_matmul", "quantized_matmul_big"]
    assert TM._matmul(torch.zeros(3, 128), tw, "xla").shape == (3, 3, 128)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_matmul_keeps_f32_product(bits):
    """int8_impl="xla" with a bf16 x: the product stays f32 until after the
    scale, as JAX's `preferred_element_type=f32` keeps it, so the port
    equals JAX's `_matmul` up to the one final bf16 rounding (at most one
    bf16 step, 2^-7 relative)."""
    rng = np.random.default_rng(bits)
    k, n_shape = 128, (3, 64)
    w = rng.standard_normal((k, *n_shape)).astype(np.float32) * 0.05
    lim = 2 ** (bits - 1) - 1
    scale = np.abs(w).max(axis=0) / lim
    q = np.clip(np.round(w / scale), -lim, lim).astype(np.int8)
    jw = JQ.QTensor(jnp.asarray(q, jnp.int4 if bits == 4 else jnp.int8),
                    jnp.asarray(scale))
    tq = torch.from_numpy(q)
    tw = TQ.QTensor(TQ.pack_int4(tq) if bits == 4 else tq,
                    torch.from_numpy(scale))
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = _f32(JM._matmul(xj, jw))
    got = TM._matmul(torch.from_numpy(_f32(xj)).bfloat16(), tw, "xla")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(_f32(got), want, rtol=2 ** -7, atol=1e-6)
    assert np.mean(_f32(got) == want) > 0.98


def test_kernel_knobs():
    assert tcfg.WhisperConfig().knobs.int8_impl == "xla"
    for impl in ("w8a8", "auto"):  # JAX's XLA routes, ported
        assert tcfg.KernelKnobs(int8_impl=impl).int8_impl == impl
    with pytest.raises(ValueError, match="int8_impl"):
        tcfg.KernelKnobs(int8_impl="cuda")
    assert TCFG.to_cfg_dict() == tcfg.tiny_test_config(**DIMS).to_cfg_dict()


@pytest.fixture(scope="module", params=[8, 4], ids=["int8", "int4"])
def model(request):
    """Random params (f32), their JAX `quantize_params(quantize_encoder=
    True, bits=8 or 4)` tree as numpy, and 4 windows of mel."""
    params = JM.init_params(jax.random.PRNGKey(3), JCFG)
    qp = jax.tree.map(np.asarray, JQ.quantize_params(
        params, quantize_encoder=True, bits=request.param))
    mel = np.random.default_rng(5).standard_normal(
        (4, 80, 600)).astype(np.float32) * 0.5
    return qp, from_numpy_tree(qp), mel


def test_quantized_tree_carries_over(model):
    """A JAX quantize_params(quantize_encoder=True) tree, int8 or int4,
    converts with from_numpy_tree (int4 packed to uint8, values equal) and
    gives the same encoder output on the dequant path (the default
    knobs)."""
    qp, tp, mel = model
    jc, tc = (dataclasses.replace(c, knobs=k.KernelKnobs())
              for c, k in ((JCFG, jcfg), (TCFG, tcfg)))
    int4 = qp["encoder"]["blocks"]["qkv_w"].q.dtype == jnp.int4
    for key in ("qkv_w", "mlp1_w", "mlp2_w"):
        w = tp["encoder"]["blocks"][key]
        assert isinstance(w, TQ.QTensor)
        assert w.q.dtype == (torch.uint8 if int4 else torch.int8)
        np.testing.assert_array_equal(
            TQ.int_values(w.q).numpy(),
            qp["encoder"]["blocks"][key].q.astype(np.int8))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JM.encoder_forward(jax.tree.map(jnp.asarray, qp),
                                             jnp.asarray(mel[:1]), jc))
    got = TM.encoder_forward(tp, torch.from_numpy(mel[:1]), tc)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32 * 10)


def test_w8a8_model_matches_jax(model, on_tpu, monkeypatch):
    """encoder_forward over 4 windows (1200 rows: K7), init_cache (the
    cross-KV vmap fallback), the prefill decoder_step (M = 4 x 4 rows: K6)
    and three S = 1 steps, all under int8_impl="pallas", over int8 and
    over int4 weights."""
    qp, tp, mel = model
    calls = {"quantized_matmul": 0, "quantized_matmul_big": 0}
    for name in calls:
        fn = getattr(TM, name)

        def count(*a, _f=fn, _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(TM, name, count)
    jp = jax.tree.map(jnp.asarray, qp)
    with jax.default_matmul_precision("highest"):
        jenc = JM.encoder_forward(jp, jnp.asarray(mel), JCFG)
    tenc = TM.encoder_forward(tp, torch.from_numpy(mel), TCFG)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), atol=ENC_ATOL)
    # 2 layers x 4 matmuls, all with 1200 rows
    assert calls == {"quantized_matmul": 0, "quantized_matmul_big": 8}

    enc = np.asarray(jenc)  # the same encoder output into both decoders
    with jax.default_matmul_precision("highest"):
        jcache = JM.init_cache(jp, jnp.asarray(enc), JCFG, cache_len=16)
    tcache = TM.init_cache(tp, torch.from_numpy(enc), TCFG, cache_len=16)
    for j, t in ((jcache.cross_k, tcache.cross_k),
                 (jcache.cross_v, tcache.cross_v)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL_F32)
    assert calls["quantized_matmul"] == 0  # the fallback launches nothing

    tokens = np.random.default_rng(6).integers(0, 96, (4, 7))
    with jax.default_matmul_precision("highest"):
        jl, jcache = JM.decoder_step(jp, jnp.asarray(tokens[:, :4]),
                                     jnp.int32(0), jcache, JCFG)
    tl, tcache = TM.decoder_step(tp, torch.from_numpy(tokens[:, :4]), 0,
                                 tcache, TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for pos in range(4, 7):
        with jax.default_matmul_precision("highest"):
            jl, jcache = JM.decoder_step(
                jp, jnp.asarray(tokens[:, pos:pos + 1]), jnp.int32(pos),
                jcache, JCFG)
        tl, tcache = TM.decoder_step(
            tp, torch.from_numpy(tokens[:, pos:pos + 1]), pos, tcache, TCFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
    # 4 steps x 2 layers x 6 decoder matmuls (qkv, attn_o, cross_q,
    # cross_o, mlp1, mlp2), all at M <= 16 rows
    assert calls == {"quantized_matmul": 48, "quantized_matmul_big": 8}


def test_w8a8_transcribe_many_matches_jax(on_tpu, monkeypatch, tmp_path):
    """The slice as a whole on the CPU: W8A8 weights (encoder included),
    `BatchTranscriber.transcribe_many` with beam search over two streams
    (3 full windows in batches of 2, the last padded; 2 tail windows), the
    same texts and tokens as JAX's under int8_impl="pallas"."""
    from whisper_tpu.pipeline import batch as JB
    from whisper_tpu.pipeline import transcribe as JT
    from whisper_tpu.text.tokenizer import (WhisperTokenizer,
                                            build_test_tokenizer_json)
    from whisper_tpu_torch.ops.audio import max_waveform_samples
    from whisper_tpu_torch.pipeline import batch as TB
    from whisper_tpu_torch.pipeline import transcribe as TT

    build_test_tokenizer_json(str(tmp_path / "tokenizer.json"))
    tok = WhisperTokenizer(str(tmp_path / "tokenizer.json"))
    dims = dict(DIMS, n_vocab=tok.vocab_size, n_audio_ctx=96, n_text_ctx=48)
    jc = dataclasses.replace(jcfg.tiny_test_config(**dims), knobs=JCFG.knobs)
    tc = dataclasses.replace(tcfg.tiny_test_config(**dims), knobs=TCFG.knobs)
    qp = jax.tree.map(np.asarray, JQ.quantize_params(
        JM.init_params(jax.random.PRNGKey(7), jc), quantize_encoder=True,
        bits=8))
    shift = max_waveform_samples(86) - 2400
    waves = []
    for n, seed in ((2 * shift + 7000, 3), (shift + 9000, 4)):
        t = np.arange(n) / 16000.0
        waves.append((0.3 * np.sin(2 * np.pi * (200.0 + 20 * seed) * t)
                      + 0.1 * np.random.default_rng(seed).standard_normal(n))
                     .astype(np.float32))
    opts = dict(max_depth=6, chunk_overlap_seconds=0.15)
    calls = []
    k6 = TM.quantized_matmul
    monkeypatch.setattr(TM, "quantized_matmul", lambda *a, **kw: (
        calls.append(a[0].shape[0]), k6(*a, **kw))[1])
    want = JB.BatchTranscriber(
        qp, jc, tok, batch_size=2, attention="xla",
        matmul_precision="highest").transcribe_many(
            waves, options=JT.DecodeOptions(**opts))
    got = TB.BatchTranscriber(qp, tc, tok, batch_size=2, attention="flash",
                              device="cpu").transcribe_many(
        waves, options=TT.DecodeOptions(**opts))
    assert got == want and all(g[1] for g in got)
    # K6 ran the batched encoder (2 windows x 48 rows), the beam steps of
    # the batch (2 x 5 lanes) and of a tail (5), and the tails' encoders
    assert {96, 10, 5} < set(calls)
