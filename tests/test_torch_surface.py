"""The rest of the JAX surface in the port, against the JAX package on the
CPU: `KernelKnobs(int8_impl="w8a8" | "auto")` (JAX's XLA routes,
whisper.py:173-221: per-row int8 activations and an s8 x s8 -> s32
product) and the native loader's `available`, `window`, `flac_available`,
`load_flac_raw` and `verify_flac_md5` over `native/libwhisper_io.so`
(built by tests/conftest.py) on FLAC streams that tests/flac_ref.py
writes.

Tolerances. The w8a8 product is exact integer arithmetic between the same
f32 row scales; the scaled result is held to W8A8_RTOL (one f32 rounding
of the scale products), and at least W8A8_EQUAL_SHARE of it bit-equal.
Through the model (int8 weights, f32 activations), an activation one ulp
apart can land one int8 step away in the row quantization: the encoder
output is held within ENC_ATOL, as tests/test_torch_w8a8.py holds the
W8A8 kernels' path. The native functions are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.io.native as jnative
from whisper_tpu import config as jcfg
from whisper_tpu import quantize as JQ
from whisper_tpu.models import whisper as JM
from whisper_tpu_torch import config as tcfg
from whisper_tpu_torch import quantize as TQ
from whisper_tpu_torch.io import native as tnative
from whisper_tpu_torch.models import whisper as TM
from whisper_tpu_torch.params import from_numpy_tree, init_params, numpy_tree

from flac_ref import encode_flac
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

W8A8_RTOL = 1e-6
W8A8_EQUAL_SHARE = 0.99
ENC_ATOL = 5e-3


def _weights(rng, k, n, bits):
    w = rng.standard_normal((k, n)).astype(np.float32)
    lim = 2 ** (bits - 1) - 1
    scale = (np.abs(w).max(axis=0) / lim).astype(np.float32)
    q = np.clip(np.round(w / scale), -lim, lim).astype(np.int8)
    jw = JQ.QTensor(jnp.asarray(q, jnp.int4 if bits == 4 else jnp.int8),
                    jnp.asarray(scale))
    tq = torch.from_numpy(q)
    tw = TQ.QTensor(TQ.pack_int4(tq) if bits == 4 else tq,
                    torch.from_numpy(scale))
    return jw, tw


def _jax_matmul(x, w, impl):
    with jcfg.active_knobs(jcfg.KernelKnobs(int8_impl=impl)):
        return np.asarray(JM._matmul(x, w).astype(jnp.float32))


@pytest.mark.parametrize("impl,m", [("w8a8", 7), ("w8a8", 1024),
                                    ("w8a8", 1025), ("auto", 4096),
                                    ("auto", 300)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_impl_routes_match_jax(impl, m, bits, dtype):
    """`_matmul` under "w8a8" and "auto" equals JAX's at the rows where
    each takes the int8 product (w8a8 to 1024 rows, auto from 4096) and
    where each falls back to the dequant product; a zero row included."""
    rng = np.random.default_rng(m + bits)
    k, n = 128, 256
    jw, tw = _weights(rng, k, n, bits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[3] = 0.0
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want = _jax_matmul(xj, jw, impl)
    got = TM._matmul(xt, tw, impl)
    assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=W8A8_RTOL if dtype ==
                               "float32" else 2 ** -7, atol=1e-6)
    assert np.mean(got == want) >= W8A8_EQUAL_SHARE


def test_int8_impl_takes_the_int_product_where_jax_does(monkeypatch):
    """The route, not only the values: `_w8a8` runs for w8a8 at <= 1024
    rows and auto at >= 4096, and never for widths off 128."""
    calls = []
    real = TM._w8a8
    monkeypatch.setattr(TM, "_w8a8",
                        lambda x, w: calls.append(x.shape) or real(x, w))
    rng = np.random.default_rng(0)
    _, tw = _weights(rng, 128, 256, 8)
    _, odd = _weights(rng, 96, 256, 8)
    for impl, m, want in (("w8a8", 1024, 1), ("w8a8", 1025, 0),
                          ("auto", 4095, 0), ("auto", 4096, 1),
                          ("xla", 8, 0), ("w8a8", 8, 1)):
        calls.clear()
        TM._matmul(torch.zeros(m, 128), tw, impl)
        assert len(calls) == want, (impl, m)
    calls.clear()
    TM._matmul(torch.zeros(8, 96), odd, "w8a8")
    assert not calls


def test_encoder_under_w8a8_matches_jax():
    """The encoder over int8 weights (quantize_encoder) with
    int8_impl="w8a8": every projection at 2 x 64 rows takes the int8
    product in both packages."""
    dims = dict(n_state=128, n_head=2, n_layer=1, n_vocab=96,
                n_audio_ctx=128, n_text_ctx=24)
    jc = dataclasses.replace(jcfg.tiny_test_config(**dims),
                             knobs=jcfg.KernelKnobs(int8_impl="w8a8"))
    tc = dataclasses.replace(tcfg.tiny_test_config(**dims),
                             knobs=tcfg.KernelKnobs(int8_impl="w8a8"))
    params = numpy_tree(init_params(tc, torch.Generator().manual_seed(2)))
    qtree = jax.tree.map(np.asarray, jax.jit(
        lambda p: JQ.quantize_params(p, bits=8, quantize_encoder=True))(
            params))
    mel = np.random.default_rng(1).standard_normal((2, 80, 128)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: JM.encoder_forward(p, x, jc))(
        jax.tree.map(jnp.asarray, qtree), jnp.asarray(mel)))
    got = TM.encoder_forward(from_numpy_tree(qtree), torch.from_numpy(mel),
                             tc).numpy()
    np.testing.assert_allclose(got, want, atol=ENC_ATOL)


# ------------------------------------------------------------ native


def test_native_library_available_as_in_jax():
    assert tnative.available() == jnative.available()
    assert tnative.flac_available() == jnative.flac_available()


@pytest.mark.parametrize("start,count", [(100, 200), (50, 100), (100, 16),
                                         (0, 0), (300, 10)])
def test_window_matches_jax(start, count):
    wave = np.random.default_rng(start).standard_normal(150).astype(
        np.float32)
    got = tnative.window(wave, start, count)
    np.testing.assert_array_equal(got, jnative.window(wave, start, count))
    assert got.dtype == np.float32 and got.shape == (count,)


def _flac_file(tmp_path, name, md5=True, **kw):
    rng = np.random.default_rng(len(name))
    amp = 3000 if kw.get("bps", 16) == 16 else 40  # within the bit width
    x = (rng.standard_normal((kw.pop("channels", 1), 3000)) * amp).astype(
        np.int64)
    p = tmp_path / name
    p.write_bytes(encode_flac(x, md5=md5, **kw))
    return str(p)


@pytest.mark.parametrize("kw", [
    dict(), dict(channels=2, channel_mode="mid_side"),
    dict(bps=8, subframe="verbatim"), dict(md5=False)],
    ids=["mono16", "stereo_mid_side", "mono8_verbatim", "no_md5"])
def test_flac_raw_and_md5_match_jax(tmp_path, kw):
    if not jnative.flac_available():
        pytest.skip("native/libwhisper_io.so was not built")
    path = _flac_file(tmp_path, "t.flac", **kw)
    got, ginfo = tnative.load_flac_raw(path)
    want, winfo = jnative.load_flac_raw(path)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int32
    assert ([getattr(ginfo, f) for f, _ in ginfo._fields_]
            == [getattr(winfo, f) for f, _ in winfo._fields_])
    ok = tnative.verify_flac_md5(path)
    assert ok == jnative.verify_flac_md5(path)
    assert ok is (None if kw.get("md5") is False else True)
    if ok:  # one flipped bit in the last frame's samples fails the MD5
        data = bytearray(open(path, "rb").read())
        data[-6] ^= 0x40
        bad = tmp_path / "bad.flac"
        bad.write_bytes(bytes(data))
        try:
            want_bad = jnative.verify_flac_md5(str(bad))
        except Exception as e:  # the corrupted frame may not decode
            with pytest.raises(type(e)):
                tnative.verify_flac_md5(str(bad))
        else:
            assert tnative.verify_flac_md5(str(bad)) == want_bad
            assert want_bad is False
